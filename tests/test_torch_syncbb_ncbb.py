"""SyncBB and NCBB's host loops in the port against the JAX package's.

The same DCOP goes through both packages — the six ``tests/instances``
YAMLs, and the seeded integer chain/hub/dense instances of
``tests/unit/test_search.py`` (n = 7–9, D = 3), built with each
package's own classes from the same numpy draws — in min and max mode.
The cost, the assignment, the message counts and the ordered chain must
be equal bit for bit (both loops are numpy float64 code on the host).
It also pins the engine routing, the parameter set, the CLI and the
device rule (``device="cuda"`` without a GPU raises)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import ncbb as jax_ncbb
from pydcop_tpu.algorithms import syncbb as jax_syncbb
from pydcop_tpu.graph import ordered_graph as jax_og
from pydcop_tpu_torch.algorithms import AlgorithmDef, ncbb, syncbb
from pydcop_tpu_torch.errors import DeviceUnavailableError
from pydcop_tpu_torch.graph import ordered_graph
from pydcop_tpu_torch.search.solver import FrontierSearchSolver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
ALGOS = {"syncbb": (syncbb, jax_syncbb), "ncbb": (ncbb, jax_ncbb)}


def _path(name):
    return os.path.join(ROOT, "tests", "instances", name + ".yaml")


def _edges(shape, n):
    if shape == "chain":
        return [(i, i + 1) for i in range(n - 1)]
    if shape == "hub":
        return [(0, i) for i in range(1, n)]
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def make_dcop(ns, shape, seed, n=8, D=3, objective="min"):
    """``tests/unit/test_search.py::make_dcop`` with the classes of the
    package ``ns``: every cost an exact float32 integer."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP(f"{shape}-{seed}", objective=objective)
    dom = ns.Domain("d", "v", list(range(D)))
    vs = [ns.Variable(f"v{i:02d}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(_edges(shape, n)):
        m = rng.integers(0, 97, (D, D)).astype(float)
        dcop.add_constraint(ns.NAryMatrixRelation([vs[i], vs[j]], m,
                                                  name=f"c{k}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


def _same(got, ref):
    assert got.assignment == ref.assignment
    assert got.cost == ref.cost and got.violation == ref.violation
    assert got.status == ref.status and got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("name", NAMES)
def test_host_loop_equals_jax_on_the_instances(name, algo):
    mod, jmod = ALGOS[algo]
    ref = jmod.build_solver(jdc.load_dcop_from_file(_path(name))).run()
    got = mod.build_solver(tdc.load_dcop_from_file(_path(name)),
                           device="cpu").run()
    _same(got, ref)
    assert set(got.metrics()) == set(ref.metrics())


@pytest.mark.parametrize("objective", ["min", "max"])
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("shape", ["chain", "hub", "dense"])
@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_host_loop_equals_jax_on_seeded_instances(algo, shape, seed,
                                                  objective):
    mod, jmod = ALGOS[algo]
    n = 7 if shape == "dense" else 9
    ref = jmod.build_solver(make_dcop(jdc, shape, seed, n, 3,
                                      objective)).run()
    got = mod.build_solver(make_dcop(tdc, shape, seed, n, 3, objective),
                           device="cpu").run()
    _same(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_ordered_graph_equals_jax(name):
    ref = jax_og.build_computation_graph(jdc.load_dcop_from_file(_path(name)))
    got = ordered_graph.build_computation_graph(
        tdc.load_dcop_from_file(_path(name)))
    assert got.order == ref.order
    for g, r in zip(got.nodes, ref.nodes):
        assert (g.name, g.position, g.next_node, g.previous_node) == \
            (r.name, r.position, r.next_node, r.previous_node)
        assert [c.name for c in g.constraints] == \
            [c.name for c in r.constraints]


def test_params_and_engine_routing_equal_jax():
    for algo, (mod, jmod) in ALGOS.items():
        assert [(p.name, p.type, p.values, p.default_value)
                for p in mod.algo_params] == \
            [(p.name, p.type, p.values, p.default_value)
             for p in jmod.algo_params]
        assert mod.GRAPH_TYPE == jmod.GRAPH_TYPE
    assert syncbb.AUTO_FRONTIER_MIN_VARS == \
        jax_syncbb.AUTO_FRONTIER_MIN_VARS == 16
    for n, want in ((9, "host"), (16, "frontier")):
        dcop = make_dcop(tdc, "chain", 0, n=n)
        jdcop = make_dcop(jdc, "chain", 0, n=n)
        for engine in ("host", "frontier", "auto"):
            adef = AlgorithmDef.build_with_default_params(
                "syncbb", {"engine": engine})
            jdef = JaxAlgorithmDef.build_with_default_params(
                "syncbb", {"engine": engine})
            got = syncbb._resolve_engine(dcop, adef)
            assert got == jax_syncbb._resolve_engine(jdcop, jdef)
            assert got == (want if engine == "auto" else engine)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_build_solver_routes_the_engine(algo):
    mod = ALGOS[algo][0]
    dcop = make_dcop(tdc, "chain", 5, n=6)
    host = mod.build_solver(dcop, None, AlgorithmDef.
                            build_with_default_params(algo, {}),
                            device="cpu")
    assert not isinstance(host, FrontierSearchSolver)
    front = mod.build_solver(dcop, None, AlgorithmDef.
                             build_with_default_params(
                                 algo, {"engine": "frontier"}),
                             device="cpu")
    assert isinstance(front, FrontierSearchSolver)
    assert front.algo_name == algo
    big = make_dcop(tdc, "chain", 5, n=16)
    auto = mod.build_solver(big, None, AlgorithmDef.
                            build_with_default_params(
                                algo, {"engine": "auto"}),
                            device="cpu")
    assert isinstance(auto, FrontierSearchSolver)
    res = front.run()
    assert res.search["optimal"] and res.config["algo"] == algo
    assert res.cost == host.run().cost


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dcop = make_dcop(tdc, "chain", 1, n=5)
    for mod in (syncbb, ncbb):
        with pytest.raises(DeviceUnavailableError):
            mod.build_solver(dcop)


@pytest.mark.parametrize("argv", [
    ["-a", "syncbb"], ["-a", "ncbb"], ["--anytime-exact"],
    ["--anytime-exact", "-a", "ncbb", "--i-bound", "1"],
    ["-a", "syncbb", "-p", "engine:frontier", "--frontier-width", "16"],
], ids=["syncbb", "ncbb", "anytime", "anytime_ncbb_ib1",
        "syncbb_frontier"])
def test_cli_on_cpu_equals_jax(argv):
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", *argv,
         "--device", "cpu", _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    algo = argv[argv.index("-a") + 1] if "-a" in argv else "syncbb"
    ref = ALGOS[algo][1].build_solver(
        jdc.load_dcop_from_file(_path("graph_coloring_tuto"))).run()
    assert res["status"] == "FINISHED"
    assert res["cost"] == ref.cost == 12
    assert res["assignment"] == ref.assignment
    frontier = "--anytime-exact" in argv or "engine:frontier" in argv
    assert ("search" in res) == frontier
    if frontier:
        assert res["search"]["optimal"]
        assert res["config"]["engine"] == "frontier"
    if "--frontier-width" in argv:
        assert res["search"]["frontier_width"] == 16
    if "--i-bound" in argv:
        assert res["search"]["i_bound"] == 1


@pytest.mark.parametrize("argv, error", [
    (["--anytime-exact", "-a", "maxsum"], "exact-search family"),
    (["-a", "maxsum", "--frontier-width", "8"], "--frontier-width"),
    (["--cycles", "3"], "one of -a/--algo or --anytime-exact"),
    (["-a", "mgm", "--i-bound", "1"], "only apply to -a dpop"),
], ids=["anytime_maxsum", "width_maxsum", "no_algo", "ibound_mgm"])
def test_cli_refusals(argv, error):
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", *argv,
         "--device", "cpu", _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 1
    res = json.loads(out.stdout)
    assert res["status"] == "ERROR" and error in res["error"]
