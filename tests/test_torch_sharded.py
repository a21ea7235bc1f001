"""The port's sharded engines (``parallel/mesh.py``: ``ShardedMaxSum``,
``ShardedLocalSearch``, the placement-driven ``solve_result`` and
``solve -d``) against the JAX package on its 8-device virtual CPU mesh
(``tests/conftest.py``), on the CPU (the per-shard kernels' plain
versions).

The JAX side runs its generic sharded engine (``use_packed=False``,
dense collectives): XLA code, fast on the CPU, and the engine JAX picks
on a CPU mesh.  Its per-shard Pallas kernels are held to the port's in
``tests/test_torch_sharded_kernels.py``.  Both packages run on the same
compiled arrays with the same factor→shard assignment.  Values and
assignments are compared exactly (the JAX package's own packed-vs-
generic check pins values exactly and beliefs at atol 1e-4), costs and
stop cycles exactly.  Local search starts from JAX's
``random_valid_values(PRNGKey(seed + 17))`` and, for DSA/ADSA, takes the
coins JAX's generic engine draws: one ``(V,)`` uniform row per cycle
from ``split(PRNGKey(seed), cycles)`` (ADSA: the wake and move rows of
``split(key)``).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms._local_search import random_valid_values
from pydcop_tpu.dcop import dcop_yaml
from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.distribution.objects import Distribution as JaxDistribution
from pydcop_tpu.generators import generate_graph_coloring
from pydcop_tpu.ops.compile import compile_binary_from_arrays as \
    jax_compile_binary
from pydcop_tpu.ops.compile import compile_constraint_graph as \
    jax_compile_cg
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.parallel.mesh import ShardedLocalSearch as JaxLocalSearch
from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
from pydcop_tpu.parallel.partition import partition_factors as \
    jax_partition
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.dcop import load_dcop, load_dcop_from_file
from pydcop_tpu_torch.distribution import Distribution, yaml_dist
from pydcop_tpu_torch.errors import DeviceUnavailableError, NotPortedError
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel import (
    ShardedLocalSearch,
    ShardedMaxSum,
    build_mesh,
    partition_factors,
)
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INST = os.path.join(ROOT, "tests", "instances")
#: the all-binary test instances (the others hold unary or n-ary factors)
BINARY_INSTANCES = ["coloring_csp", "coloring_intention",
                    "graph_coloring_tuto", "meeting_scheduling"]


def _coloring(V, E, seed, soft=True, n_agents=4):
    return generate_graph_coloring(n_variables=V, n_colors=3, n_edges=E,
                                   soft=soft, n_agents=n_agents, seed=seed)


GRAPHS = {
    "coloring_60": lambda: _coloring(60, 150, 1),
    "coloring_40_hard": lambda: _coloring(40, 90, 2, soft=False),
    "tuto": lambda: jax_load(os.path.join(INST, "graph_coloring_tuto.yaml")),
    "meeting": lambda: jax_load(os.path.join(INST,
                                             "meeting_scheduling.yaml")),
}


def _cpu(n):
    return build_mesh(n, "cpu")


def _maxsum_pair(name, n_shards, own_partition=False, damping=0.5,
                 assign=None):
    jt = jax_compile(GRAPHS[name]())
    vi = np.asarray(jt.buckets[0].var_idx)
    if assign is None:
        assigns = (partition_factors([vi], jt.n_vars, n_shards)
                   if own_partition else
                   jax_partition([vi], jt.n_vars, n_shards))
    else:
        assigns = [assign]
    jax_engine = JaxMaxSum(jt, jax_build_mesh(n_shards), damping=damping,
                           assigns=assigns, use_packed=False, overlap="off")
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    port = ShardedMaxSum(t, _cpu(n_shards), damping=damping,
                         assigns=assigns)
    return jax_engine, port


@pytest.mark.parametrize("own_partition", [False, True])
@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_maxsum_values_equal_jax(name, n_shards, own_partition):
    jax_engine, port = _maxsum_pair(name, n_shards, own_partition)
    jv, _, _ = jax_engine.run(cycles=8)
    v, q, r = port.run(cycles=8)
    assert np.array_equal(v, np.asarray(jv))
    # 4 + 4 cycles through the continuation state == 8 cycles
    v4, q4, r4 = port.run(cycles=4)
    v44, _, _ = port.run(cycles=4, q=q4, r=r4)
    assert np.array_equal(v44, v)


def test_maxsum_damping_zero_equals_jax():
    jax_engine, port = _maxsum_pair("coloring_60", 8, damping=0.0)
    jv, _, _ = jax_engine.run(cycles=8)
    assert np.array_equal(port.run(cycles=8)[0], np.asarray(jv))


def test_maxsum_with_empty_shards_equals_jax():
    """Shards 1 and 3 hold no factor, and S = 6 > F on a one-factor
    problem: they launch nothing and add nothing; a variable no factor
    touches keeps its unary cost as its belief."""
    jt = jax_compile(GRAPHS["coloring_60"]())
    F = jt.buckets[0].n_factors
    assign = np.where(np.arange(F) % 2 == 0, 0, 2).astype(np.int32)
    jax_engine, port = _maxsum_pair("coloring_60", 4, assign=assign)
    assert [sh.N for sh in port.packs.shards][1::2] == [0, 0]
    before = K.device_fused_ba.launches
    jv, _, _ = jax_engine.run(cycles=8)
    v, (r_u, bel), _ = port.run(cycles=8)
    assert np.array_equal(v, np.asarray(jv))
    assert K.device_fused_ba.launches == before  # CPU: the plain versions
    # one factor on 6 shards, and a variable no factor touches
    d = load_dcop("""
name: untouched
objective: min
domains: {d: {values: [0, 1, 2]}}
variables:
  x: {domain: d}
  y: {domain: d}
  z: {domain: d, cost_function: "3 - z"}
constraints:
  c: {type: intention, function: "10 if x == y else 0"}
agents: [a1, a2]
""")
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    t = compile_factor_graph(d, device="cpu")
    eng = ShardedMaxSum(t, _cpu(6))
    assert sum(sh.N > 0 for sh in eng.packs.shards) == 1
    v, (_, bel), _ = eng.run(cycles=5)
    z = t.var_names.index("z")
    assert torch.equal(bel[0][:, z], t.unary_costs[z])
    assert v[z] == 2


def _ls_pair(name, n_shards, rule, **kw):
    jt = jax_compile_cg(GRAPHS[name]())
    jax_engine = JaxLocalSearch(jt, jax_build_mesh(n_shards), rule=rule,
                                use_packed=False, overlap="off", **kw)
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    return jt, jax_engine, ShardedLocalSearch(t, _cpu(n_shards), rule=rule,
                                              **kw)


def _jax_coins(rule, V, cycles, seed):
    """The generic engine's per-cycle draws, in variable order."""
    keys = jax.random.split(jax.random.PRNGKey(seed), cycles)
    if rule == "dsa":
        return np.stack([np.asarray(jax.random.uniform(k, (V,)))
                         for k in keys])
    wake, move = [], []
    for k in keys:
        k_wake, k_move = jax.random.split(k)
        wake.append(np.asarray(jax.random.uniform(k_wake, (V,))))
        move.append(np.asarray(jax.random.uniform(k_move, (V,))))
    return np.stack(wake), np.stack(move)


LS_CASES = {
    "mgm": dict(rule="mgm"),
    "dsa": dict(rule="dsa"),
    "dsa_p1": dict(rule="dsa", probability=1.0),
    "adsa_B": dict(rule="adsa"),
    "adsa_C_p1_a1": dict(rule="adsa", probability=1.0,
                         algo_params={"variant": "C", "activation": 1.0}),
    "adsa_A": dict(rule="adsa", algo_params={"variant": "A"}),
}


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("case", sorted(LS_CASES))
@pytest.mark.parametrize("name", ["coloring_60", "coloring_40_hard"])
def test_local_search_equals_jax(name, case, n_shards):
    kw = dict(LS_CASES[case])
    rule = kw.pop("rule")
    jt, jax_engine, port = _ls_pair(name, n_shards, rule, **kw)
    seed, cycles = 3, 12
    jv, _, _ = jax_engine.run_chunked(cycles, seed=seed)
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(seed + 17)))
    coins = (None if rule == "mgm"
             else _jax_coins(rule, jt.n_vars, cycles, seed))
    v, x, aux = port.run_chunked(cycles, x=port.state_from_values(x0),
                                 coins=coins)
    assert np.array_equal(v, np.asarray(jv))
    assert aux == () and np.array_equal(port.state_values(x), v)


def test_mgm_chunked_equals_one_run():
    _, _, port = _ls_pair("coloring_60", 4, "mgm")
    v = port.run(cycles=10, seed=1)
    _, x, aux = port.run_chunked(4, seed=1)
    v2, _, _ = port.run_chunked(6, x=x, aux=aux, seed=1)
    assert np.array_equal(v, v2)


def test_drawn_coins_repeat_per_seed():
    _, _, port = _ls_pair("coloring_60", 4, "dsa")
    assert np.array_equal(port.run(cycles=10, seed=2),
                          port.run(cycles=10, seed=2))


def _full_distribution(dcop, n_agents, cls):
    """Round-robin placement of all computations (vars + constraints)."""
    comps = sorted(dcop.variables) + sorted(dcop.constraints)
    agents = [f"a{i:02d}" for i in range(n_agents)]
    mapping = {a: [] for a in agents}
    for i, c in enumerate(comps):
        mapping[agents[i % n_agents]].append(c)
    return cls(mapping)


PLACEMENT = {
    **{n: (lambda n=n: jax_load(os.path.join(INST, n + ".yaml")))
       for n in BINARY_INSTANCES},
    # tests/unit/test_placement_driven.py's 12-variable colouring
    "coloring_12": lambda: _coloring(12, 20, 7),
}


@pytest.mark.parametrize("cycles", [None, 25])
@pytest.mark.parametrize("name", sorted(PLACEMENT))
def test_placement_solve_equals_jax(name, cycles):
    jd = PLACEMENT[name]()
    d = load_dcop(dcop_yaml(jd))
    want = jax_solve_result(
        jd, "maxsum", distribution=_full_distribution(jd, 5,
                                                      JaxDistribution),
        cycles=cycles)
    got = solve_result(d, "maxsum",
                       distribution=_full_distribution(d, 5, Distribution),
                       cycles=cycles, n_shards=8, device="cpu")
    assert got.assignment == want.assignment
    assert got.cost == want.cost and got.cycle == want.cycle
    assert got.status == want.status == "FINISHED"
    assert got.msg_count == want.msg_count
    m = got.metrics()
    assert m["config"]["engine"] == "sharded_mesh"
    # JAX's auto policy: exact at or under the cut threshold (C-w3); JAX
    # runs its generic engine on the CPU mesh and the port its packed
    # one, whose column counts differ (V against V + 1)
    ws = want.metrics()["shard"]
    assert m["shard"]["mode"] == ws["mode"] and m["shard"]["n_shards"] == 8
    assert m["shard"]["mode"] == (
        "compact-exact" if ws["cut_fraction"] <= 0.5 else "dense")
    layout = {"total_columns", "bytes_per_cycle_dense",
              "bytes_per_cycle_compact"}
    assert {k: v for k, v in m["shard"].items() if k not in layout} == \
        {k: v for k, v in ws.items() if k not in layout}
    assert set(m["shard"]) == set(ws)


def test_placement_solve_with_timeout_runs_in_chunks():
    jd = PLACEMENT["coloring_12"]()
    d = load_dcop(dcop_yaml(jd))
    dist = _full_distribution(d, 4, Distribution)
    a = solve_result(d, "maxsum", distribution=dist, cycles=25,
                     n_shards=4, device="cpu")
    b = solve_result(d, "maxsum", distribution=dist, cycles=25,
                     timeout=600, n_shards=4, device="cpu")
    assert (a.assignment, a.cycle, b.status) == (b.assignment, b.cycle,
                                                 "FINISHED")


def test_placement_stale_per_cycle_metrics_keep_the_halo():
    """Per-cycle metrics run the placement solve one cycle a chunk; stale's
    halo goes on across the chunks, so the run equals the unchunked one
    and is stale throughout (``metrics()["shard"]["mode"]``)."""
    jd = PLACEMENT["coloring_12"]()
    d = load_dcop(dcop_yaml(jd))
    dist = _full_distribution(d, 4, Distribution)
    runs = [solve_result(d, "maxsum", distribution=dist, cycles=12,
                         n_shards=4, device="cpu", shard_overlap="stale",
                         collect_cycles=collect)
            for collect in (False, True)]
    for res in runs:
        assert res.metrics()["shard"]["mode"] == "compact-stale"
    assert runs[0].assignment == runs[1].assignment
    assert runs[0].cost == runs[1].cost
    assert len(runs[1].history) == 12


def test_cli_distribution_file_round_trip(tmp_path):
    jd = PLACEMENT["coloring_12"]()
    prob = tmp_path / "prob.yaml"
    prob.write_text(dcop_yaml(jd))
    d = load_dcop_from_file([str(prob)])
    dist = _full_distribution(d, 4, Distribution)
    dist_f = tmp_path / "dist.yaml"
    dist_f.write_text(yaml_dist(dist))
    cmd = [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a",
           "maxsum", "--device", "cpu", "--cycles", "10", "-d",
           str(dist_f), str(prob)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(out.stdout)
    want = solve_result(d, "maxsum", distribution=dist, cycles=10,
                        device="cpu")
    assert data["assignment"] == want.assignment
    assert data["cost"] == want.cost and data["cycle"] == 10
    assert data["shard"]["n_shards"] == 1  # one device: the CPU
    # a placement that misses computations fails loudly
    bad_f = tmp_path / "bad.yaml"
    bad_f.write_text("distribution:\n  a0: [v00]\n")
    for extra in (["-d", str(bad_f)], ["-d", "gh_cgdp"],
                  ["--shard-overlap", "off"]):
        out = subprocess.run(cmd[:8] + extra + [str(prob)],
                             capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        assert out.returncode != 0, extra
        assert json.loads(out.stdout)["status"] == "ERROR", extra
    # the compact modes run: exact is the dense run
    out = subprocess.run(cmd[:10] + ["-d", str(dist_f), "--shard-overlap",
                                     "exact", str(prob)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    exact = json.loads(out.stdout)
    assert exact["assignment"] == want.assignment
    assert exact["shard"]["n_shards"] == 1


# -- refusals -----------------------------------------------------------------


def _binary_tensors():
    return tensors_from_numpy(numpy_fields(jax_compile_cg(
        GRAPHS["tuto"]())), device="cpu")


def _secp_tensors():
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    return compile_factor_graph(
        load_dcop_from_file([os.path.join(INST, "secp_small.yaml")]),
        device="cpu")


def _wide_nary_tensors(arity=3, D=6):
    """One factor of ``arity`` over D values: out of the packers' scope
    (D <= 5 with a ternary or quaternary factor, arity <= 4)."""
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    names = "xyzuvw"[:arity]
    return compile_factor_graph(load_dcop(f"""
name: wide
objective: min
domains: {{d: {{values: {list(range(D))}}}}}
variables:
{chr(10).join(f"  {n}: {{domain: d}}" for n in names)}
constraints:
  c: {{type: intention, function: "{' + '.join(names)}"}}
agents: [a1]
"""), device="cpu")


REFUSALS = {
    "precision_bf16": lambda t: ShardedMaxSum(t, _cpu(2), precision="bf16"),
    "sentinel": lambda t: ShardedMaxSum(t, _cpu(2), sentinel=True),
    "ls_precision": lambda t: ShardedLocalSearch(
        t, _cpu(2), algo_params={"precision": "bf16"}),
}
#: what the refusals above used to hold and now runs: amaxsum's
#: activation and mixed-arity graphs on both engines, the compact
#: collectives, and the generic engine (use_packed=False, dba and gdba,
#: the graphs out of the packers' scope)
LIFTED = {
    "activation": lambda t: ShardedMaxSum(t, _cpu(2), activation=0.5),
    "mixed_maxsum": lambda t: ShardedMaxSum(_secp_tensors(), _cpu(2)),
    "mixed_local_search": lambda t: ShardedLocalSearch(_secp_tensors(),
                                                       _cpu(2)),
    "overlap_exact": lambda t: ShardedMaxSum(t, _cpu(2), overlap="exact"),
    "overlap_stale": lambda t: ShardedMaxSum(t, _cpu(2), overlap="stale"),
    "exchange": lambda t: ShardedMaxSum(t, _cpu(2), overlap="exact",
                                        exchange=True),
    "generic_engine": lambda t: ShardedMaxSum(t, _cpu(2), use_packed=False),
    "ls_overlap_stale": lambda t: ShardedLocalSearch(t, _cpu(2),
                                                     overlap="stale"),
    "ls_generic_engine": lambda t: ShardedLocalSearch(t, _cpu(2),
                                                      use_packed=False),
    "dba": lambda t: ShardedLocalSearch(t, _cpu(2), rule="dba"),
    "gdba": lambda t: ShardedLocalSearch(t, _cpu(2), rule="gdba"),
    "mixed_wide_ternary_maxsum": lambda t: ShardedMaxSum(
        _wide_nary_tensors(), _cpu(2)),
    "mixed_wide_ternary_local_search": lambda t: ShardedLocalSearch(
        _wide_nary_tensors(), _cpu(2)),
    "arity_5": lambda t: ShardedMaxSum(_wide_nary_tensors(5, 2), _cpu(2)),
}
#: the cases of LIFTED that run the generic engine
GENERIC = {"generic_engine", "ls_generic_engine", "dba", "gdba",
           "mixed_wide_ternary_maxsum", "mixed_wide_ternary_local_search",
           "arity_5"}
#: the operand editing of the packed engine raises the JAX package's
#: errors: an unknown operand, a wrong shape, an edit of the packed layout,
#: a state that is not the engine's
JAX_ERRORS = {
    "get_operand": (lambda t: ShardedMaxSum(t, _cpu(2)).get_operand(
        "bucket0"), ValueError),
    "set_operand": (lambda t: ShardedLocalSearch(t, _cpu(2)).set_operand(
        "cost", np.zeros(3, np.float32)), ValueError),
    "edit_factor": (lambda t: ShardedMaxSum(t, _cpu(2)).edit_factor(
        0, 0, 0), NotImplementedError),
    "state_to_host": (lambda t: ShardedMaxSum(t, _cpu(2)).state_to_host(
        None, None), ValueError),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_unported_options_refuse(what):
    with pytest.raises(NotPortedError):
        REFUSALS[what](_binary_tensors())


@pytest.mark.parametrize("what", sorted(LIFTED))
def test_lifted_refusals_run(what):
    eng = LIFTED[what](_binary_tensors())
    if isinstance(eng, ShardedMaxSum):
        values, _, _ = eng.run(cycles=3)
    else:
        values = eng.run(cycles=3)
    assert values.shape == (eng.base.n_vars,)
    assert (eng.packs is None) == (what in GENERIC)
    if eng.packs is not None:
        assert eng.packs.mixed == what.startswith("mixed")
    if what.startswith(("overlap", "exchange", "ls_overlap")):
        assert eng.comm.compact


@pytest.mark.parametrize("what", sorted(JAX_ERRORS))
def test_packed_editing_raises_jax_errors(what):
    call, err = JAX_ERRORS[what]
    with pytest.raises(err):
        call(_binary_tensors())


def test_unported_solve_paths_refuse():
    d = load_dcop_from_file([os.path.join(INST, "graph_coloring_tuto.yaml")])
    dist = _full_distribution(d, 3, Distribution)
    # strategy names are computed and validated since the placement
    # strategies came (oneagent, adhoc); the others still refuse
    with pytest.raises(NotPortedError, match="heur_comhost"):
        solve_result(d, "maxsum", distribution="heur_comhost", device="cpu")
    res = solve_result(d, "amaxsum", distribution=dist, device="cpu")
    assert res.status == "FINISHED" and res.config["algo"] == "amaxsum"
    for algo in ("dpop", "mgm"):
        with pytest.raises(ValueError, match="maxsum/amaxsum"):
            solve_result(d, algo, distribution=dist, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        solve_result(d, "maxsum", n_shards=2, device="cpu")
    big_d = tensors_from_numpy(numpy_fields(jax_compile_binary(
        np.array([0]), np.array([1]), np.zeros((1, 9, 9), np.float32), 2)),
        device="cpu")
    # D = 9 is out of the packers' scope: the generic engine runs it
    eng = ShardedMaxSum(big_d, _cpu(2))
    assert eng.packs is None and eng.st is not None
    assert eng.run(cycles=3)[0].shape == (2,)
    with pytest.raises(ValueError, match="unknown shard overlap"):
        ShardedMaxSum(_binary_tensors(), _cpu(2), overlap="sideways")


def test_mesh_defaults(monkeypatch):
    assert build_mesh(device="cpu") == [torch.device("cpu")]
    assert build_mesh(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _binary_tensors()
    for call in (lambda: build_mesh(), lambda: ShardedMaxSum(t),
                 lambda: ShardedLocalSearch(t)):
        with pytest.raises(DeviceUnavailableError):
            call()
