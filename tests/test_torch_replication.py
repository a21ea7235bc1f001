"""The placement layer of the port on the CPU, held to the JAX package's:

* ``distribution/oneagent.py`` and ``adhoc.py`` (and ``_costs.py``): the
  same Distribution (computation → agent), the same infeasibility and the
  same costs, on the six test instances, for the factor graph and the
  constraint graph; an unported strategy name raises ``NotPortedError``;
* ``replication/__init__.py``: ``route_distances`` and ``place_replicas``
  equal the JAX package's on the instances and on seeded agent sets with
  routes, hosting costs and capacities; ``replication/yamlformat.py``
  writes the same YAML and reads the same errors;
* ``reparation/__init__.py``: the repair DCOP has the JAX package's
  variables and constraints, name for name, with the same cost tables,
  and its MGM solution equals the JAX package's on the tuto instance.

All exact: placements are host arithmetic.
"""
import itertools
import os

import numpy as np
import pytest

from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import AgentDef as JaxAgentDef
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.distribution import load_distribution_module as jax_dist
from pydcop_tpu.distribution._costs import distribution_cost as jax_cost
from pydcop_tpu.distribution.objects import Distribution as JaxDistribution
from pydcop_tpu.distribution.objects import \
    ImpossibleDistributionException as JaxImpossible
from pydcop_tpu.graph import load_graph_module as jax_graph_module
from pydcop_tpu.replication import place_replicas as jax_place
from pydcop_tpu.replication import route_distances as jax_routes
from pydcop_tpu.replication import yamlformat as jax_ryaml
from pydcop_tpu.reparation import build_repair_dcop as jax_build_repair
from pydcop_tpu.reparation import solve_repair_dcop as jax_solve_repair
from pydcop_tpu_torch.algorithms import load_algorithm_module
from pydcop_tpu_torch.dcop import AgentDef, load_dcop_from_file
from pydcop_tpu_torch.distribution import (
    UNPORTED_STRATEGIES,
    Distribution,
    ImpossibleDistributionException,
    list_available_distributions,
    load_distribution_module,
)
from pydcop_tpu_torch.distribution._costs import distribution_cost
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.graph import load_graph_module
from pydcop_tpu_torch.replication import (
    ReplicaDistribution,
    place_replicas,
    route_distances,
)
from pydcop_tpu_torch.replication import yamlformat as ryaml
from pydcop_tpu_torch.reparation import (
    build_repair_dcop,
    repair_shape,
    solve_repair_dcop,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
#: an algorithm of each computation graph
ALGOS = ["maxsum", "mgm"]
#: the (instance, algorithm) pairs adhoc can place (secp_small's factor
#: graph overflows its agents' capacities in both packages, which
#: test_distribution_equals_jax pins)
PLACEABLE = [(n, a) for n in NAMES for a in ALGOS
             if (n, a) != ("secp_small", "maxsum")]


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _both(name, algo):
    """(dcop, cg, algo module) of each package, port first."""
    out = []
    for load, graphs, algos in ((load_dcop_from_file, load_graph_module,
                                 load_algorithm_module),
                                (jax_load_dcop, jax_graph_module,
                                 jax_algo_module)):
        dcop = load(_path(name))
        mod = algos(algo)
        cg = graphs(mod.GRAPH_TYPE).build_computation_graph(dcop)
        out.append((dcop, cg, mod))
    return out


def _distribute(strategy, dcop, cg, mod, loader):
    return loader(strategy).distribute(
        cg, dcop.agents.values(), hints=getattr(dcop, "dist_hints", None),
        computation_memory=mod.computation_memory,
        communication_load=mod.communication_load)


# ---------------------------------------------------------------------------
# distribution strategies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("strategy", ["oneagent", "adhoc"])
def test_distribution_equals_jax(strategy, name, algo):
    (pd, pcg, pm), (jd, jcg, jm) = _both(name, algo)
    try:
        ref = _distribute(strategy, jd, jcg, jm, jax_dist)
    except JaxImpossible as e:
        with pytest.raises(ImpossibleDistributionException) as got:
            _distribute(strategy, pd, pcg, pm, load_distribution_module)
        assert str(got.value) == str(e)
        return
    got = _distribute(strategy, pd, pcg, pm, load_distribution_module)
    assert got.mapping() == ref.mapping()
    cost = load_distribution_module(strategy).distribution_cost(
        got, pcg, pd.agents.values(), pm.computation_memory,
        pm.communication_load)
    assert cost == jax_dist(strategy).distribution_cost(
        ref, jcg, jd.agents.values(), jm.computation_memory,
        jm.communication_load)
    assert distribution_cost(got, pcg, pd.agents.values(),
                             pm.computation_memory,
                             pm.communication_load) == \
        jax_cost(ref, jcg, jd.agents.values(), jm.computation_memory,
                 jm.communication_load)


def test_available_strategies():
    assert list_available_distributions() == ["adhoc", "oneagent"]
    assert load_distribution_module("adhoc").__name__ == \
        "pydcop_tpu_torch.distribution.adhoc"
    with pytest.raises(ImportError, match="no_such"):
        load_distribution_module("no_such")


@pytest.mark.parametrize("name", UNPORTED_STRATEGIES)
def test_unported_strategy_refused(name):
    """Every other strategy of the JAX package is refused by name (the
    (o)ilp ones need ``pulp``; the greedy heuristics wait too)."""
    jax_dist(name) if not name.startswith(("ilp", "oilp")) else None
    with pytest.raises(NotPortedError, match=name):
        load_distribution_module(name)


@pytest.mark.parametrize("name", ["oneagent", "adhoc"])
def test_solve_result_validates_a_strategy(name):
    """A strategy name is computed and validated, as in the JAX package:
    the single-device solve runs the same."""
    from pydcop_tpu_torch.runtime import solve_result

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    a = solve_result(dcop, "mgm", distribution=name, cycles=5,
                     device="cpu")
    b = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                     "mgm", cycles=5, device="cpu")
    assert a.assignment == b.assignment


def test_solve_result_refuses_an_unported_strategy():
    from pydcop_tpu_torch.runtime import solve_result

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    with pytest.raises(NotPortedError, match="heur_comhost"):
        solve_result(dcop, "mgm", distribution="heur_comhost", device="cpu")


# ---------------------------------------------------------------------------
# replication
# ---------------------------------------------------------------------------


def _agents(n, seed, routes=True, hosting=True, capacity=None):
    """Seeded agent sets of both packages: random sparse routes (so the
    shortest routes go through other agents), hosting costs on a few
    computations and optional capacities."""
    rng = np.random.default_rng(seed)
    names = [f"a{i:02d}" for i in range(n)]
    specs = []
    for i, name in enumerate(names):
        r = {}
        if routes:
            for j in rng.choice(n, size=max(1, n // 3), replace=False):
                if j != i:
                    r[names[j]] = float(np.round(rng.uniform(0.1, 5), 2))
        h = {}
        if hosting:
            for c in ("v1", "v2", "v3", "c_1_2", "x", "y"):
                if rng.uniform() < 0.4:
                    h[c] = float(rng.integers(0, 4))
        specs.append(dict(
            name=name, capacity=capacity, default_route=float(
                rng.choice([1.0, 2.5, 10.0])),
            routes=r, default_hosting_cost=float(rng.integers(0, 3)),
            hosting_costs=h))
    return ([AgentDef(**s) for s in specs],
            [JaxAgentDef(**s) for s in specs])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [2, 7, 15])
def test_route_distances_equal_jax(n, seed):
    port, jax_ = _agents(n, seed)
    assert route_distances(port) == jax_routes(jax_)


@pytest.mark.parametrize("name", NAMES)
def test_route_distances_on_the_instances(name):
    pd, jd = load_dcop_from_file(_path(name)), jax_load_dcop(_path(name))
    assert route_distances(list(pd.agents.values())) == \
        jax_routes(list(jd.agents.values()))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name,algo", PLACEABLE)
def test_place_replicas_on_the_instances(name, algo, k):
    (pd, pcg, pm), (jd, jcg, jm) = _both(name, algo)
    ref_dist = _distribute("adhoc", jd, jcg, jm, jax_dist)
    dist = _distribute("adhoc", pd, pcg, pm, load_distribution_module)
    got = place_replicas(
        [n.name for n in pcg.nodes], dist, pd.agents.values(), k,
        computation_memory=lambda c: pm.computation_memory(
            pcg.computation(c)))
    ref = jax_place(
        [n.name for n in jcg.nodes], ref_dist, jd.agents.values(), k,
        computation_memory=lambda c: jm.computation_memory(
            jcg.computation(c)))
    assert got.mapping() == ref.mapping()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("capacity", [None, 4.0, 9.0])
def test_place_replicas_on_seeded_agents(seed, capacity):
    """Routes, hosting costs and capacities together: the same k
    cheapest feasible agents, ties on name, capacity consumed in order;
    a host outside the agent list routes by the agents' own tables."""
    port, jax_ = _agents(9, seed, capacity=capacity)
    comps = ["v1", "v2", "v3", "x", "y", "c_1_2", "z"]
    rng = np.random.default_rng(seed + 100)
    hosts = [a.name for a in port] + ["gone"]
    mapping = {}
    for c in comps[:-1]:
        mapping.setdefault(str(rng.choice(hosts)), []).append(c)
    mem = {c: float(rng.integers(1, 4)) for c in comps}
    for hw, rw in ((1.0, 1.0), (0.5, 2.0)):
        got = place_replicas(comps, Distribution(mapping), port, 3,
                             computation_memory=mem.get,
                             hosting_weight=hw, route_weight=rw)
        ref = jax_place(comps, JaxDistribution(mapping), jax_, 3,
                        computation_memory=mem.get, hosting_weight=hw,
                        route_weight=rw)
        assert got.mapping() == ref.mapping()


def test_replica_distribution_queries():
    r = ReplicaDistribution({"c1": ["a1", "a2"], "c2": ["a2"]})
    assert r.replicas("c1") == ["a1", "a2"] and r.replicas("x") == []
    assert r.agents_holding("a2") == ["c1", "c2"]
    assert r.mapping() == {"c1": ["a1", "a2"], "c2": ["a2"]}


def test_replica_yaml_equals_jax(tmp_path):
    from pydcop_tpu.replication import ReplicaDistribution as JaxReplicas

    mapping = {"c1": ["a1", "a2"], "c2": ["a3"], "v1": []}
    inputs = {"dcop": ["x.yaml"], "algo": "mgm", "k": 2}
    text = ryaml.yaml_replica_dist(ReplicaDistribution(mapping), inputs)
    assert text == jax_ryaml.yaml_replica_dist(JaxReplicas(mapping), inputs)
    path = tmp_path / "r.yaml"
    path.write_text(text)
    assert ryaml.load_replica_dist_from_file(str(path)).mapping() == \
        jax_ryaml.load_replica_dist_from_file(str(path)).mapping()


@pytest.mark.parametrize("bad", ["- 1\n", "replica_dist: 3\n",
                                 "replica_dist:\n  c1: a1\n", "x: 1\n"])
def test_replica_yaml_errors_equal_jax(bad):
    with pytest.raises(ValueError) as ref:
        jax_ryaml.load_replica_dist(bad)
    with pytest.raises(ValueError) as got:
        ryaml.load_replica_dist(bad)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# reparation
# ---------------------------------------------------------------------------


def _repair_inputs(name, algo, victim_index=0, k=2):
    """The repair DCOP's inputs in each package after the removal of one
    agent (adhoc placement, k replicas), built as the orchestrator does."""
    out = []
    for (dcop, cg, mod), dist_loader, place in (
            (_both(name, algo)[0], load_distribution_module, place_replicas),
            (_both(name, algo)[1], jax_dist, jax_place)):
        dist = _distribute("adhoc", dcop, cg, mod, dist_loader)
        reps = place([n.name for n in cg.nodes], dist, dcop.agents.values(),
                     k, computation_memory=lambda c, cg=cg, mod=mod:
                     mod.computation_memory(cg.computation(c)))
        hosting = sorted(a for a in dist.agents
                         if dist.computations_hosted(a))
        victim = hosting[victim_index % len(hosting)]
        orphans = dist.remove_agent(victim)
        surviving = {a.name: a for a in dcop.agents.values()
                     if a.name != victim}
        cand = {c: [a for a in reps.replicas(c) if a in surviving]
                or sorted(surviving) for c in orphans}
        out.append(dict(
            orphaned=orphans, candidates=cand, agents=surviving,
            distribution=dist,
            computation_memory=lambda c, cg=cg, mod=mod:
            mod.computation_memory(cg.computation(c)),
            communication_load=lambda c, t, cg=cg, mod=mod:
            mod.communication_load(cg.computation(c), t),
            neighbors={c: list(cg.computation(c).neighbors)
                       for c in orphans}))
    return out


def _tables(dcop):
    """Each constraint's scope names and its cost on every assignment."""
    out = {}
    for name, c in dcop.constraints.items():
        scope = [v.name for v in c.dimensions]
        costs = [c(**dict(zip(scope, vals)))
                 for vals in itertools.product(
                     *[list(v.domain) for v in c.dimensions])]
        out[name] = (scope, costs)
    return out


@pytest.mark.parametrize("victim", [0, 1])
@pytest.mark.parametrize("name,algo", PLACEABLE)
def test_repair_dcop_equals_jax(name, algo, victim):
    port_in, jax_in = _repair_inputs(name, algo, victim)
    repair, by_comp = build_repair_dcop(**port_in)
    jrepair, jby_comp = jax_build_repair(**jax_in)
    assert sorted(repair.variables) == sorted(jrepair.variables)
    assert {c: sorted(v) for c, v in by_comp.items()} == \
        {c: sorted(v) for c, v in jby_comp.items()}
    if sum(2 ** c.arity for c in repair.constraints.values()) <= 50_000:
        assert _tables(repair) == _tables(jrepair)
    else:
        assert sorted(repair.constraints) == sorted(jrepair.constraints)
    shape = repair_shape(repair)
    assert shape["variables"] == len(jrepair.variables)
    assert shape["max_arity"] == max(
        (c.arity for c in jrepair.constraints.values()), default=0)


def test_repair_solution_equals_jax_on_tuto():
    port_in, jax_in = _repair_inputs("graph_coloring_tuto", "maxsum", 0)
    repair, by_comp = build_repair_dcop(**port_in)
    jrepair, jby_comp = jax_build_repair(**jax_in)
    assert solve_repair_dcop(repair, by_comp, seed=0, device="cpu") == \
        jax_solve_repair(jrepair, jby_comp, seed=0)


@pytest.mark.parametrize("extra", [0, 1])
def test_repair_arity_limit(extra):
    """A capacity constraint of MAX_REPAIR_ARITY candidates builds; one
    more is refused before any table is built, naming the agent."""
    from pydcop_tpu_torch.reparation import MAX_REPAIR_ARITY

    n = MAX_REPAIR_ARITY + extra
    orphans = [f"o{i:02d}" for i in range(n)]
    kw = dict(orphaned=orphans, candidates={o: ["a1", "a2"]
                                            for o in orphans},
              agents={a: AgentDef(a) for a in ("a1", "a2")},
              distribution=Distribution({"a1": [], "a2": []}))
    if extra:
        with pytest.raises(ValueError, match=f"arity {n}.*'a1'"):
            build_repair_dcop(**kw)
    else:
        assert repair_shape(build_repair_dcop(**kw)[0])["max_arity"] == n


def test_repair_respects_capacity():
    """The JAX package's own case (tests/unit/test_runtime.py): a1 is
    full, so the orphan goes to a2."""
    agents = {"a1": AgentDef("a1", capacity=1), "a2": AgentDef("a2",
                                                               capacity=5)}
    dist = Distribution({"a1": ["k1"], "a2": []})
    repair, by_comp = build_repair_dcop(
        orphaned=["o1"], candidates={"o1": ["a1", "a2"]}, agents=agents,
        distribution=dist, computation_memory=lambda c: 1.0)
    assert solve_repair_dcop(repair, by_comp, seed=0,
                             device="cpu") == {"o1": "a2"}
