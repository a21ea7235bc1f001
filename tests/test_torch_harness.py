"""The chunked harness of the port (``pydcop_tpu_torch/algorithms/base.py``
and ``capture.py``) on the CPU, held to the JAX package's harness
(``pydcop_tpu/algorithms/base.py``), after the JAX package's own
``tests/unit/test_harness_pipeline.py``.

* ``default_chunk`` equals JAX's over a grid of its five arguments;
* the fixed-shape runner: a tail chunk freezes its surplus cycles
  (``masked_tail_cycles``) and equals the same cycles run plainly, one
  runner is built per ``(chunk, collect)`` whatever the remainders and
  deadlines (``trace_count``), the LRU of runners counts its evictions;
* pipelined runs reach the same assignment, at most one chunk late;
* ``collect_cycles``: maxsum's per-cycle history equals JAX's on the six
  test instances, engine for engine (the generic engine on both sides:
  the JAX package's CPU default; the port's packed engine, its CPU
  default on the all-binary instances, beside JAX's generic one where
  the end-to-end parity already holds them equal), and so do the stop
  cycles of open-ended runs at chunks 5 and 7 and 1-3 stable chunks;
  mgm's history equals JAX's from the same initial values; a run with
  ``collect`` equals one without it at the same explicit chunk for
  every harness algorithm, and its last history cost is the cost;
* the event bus: the ``harness.run.done``, ``search.*``,
  ``dpop.minibucket.bounds`` and ``shard.comm.selected`` payloads have
  the JAX package's keys.
"""
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.algorithms.base import LruCache as JaxLruCache
from pydcop_tpu.algorithms.base import default_chunk as jax_default_chunk
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.algorithms.base import LruCache, default_chunk
from pydcop_tpu_torch.algorithms.capture import flatten
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
BINARY = {"coloring_csp", "coloring_intention", "graph_coloring_tuto",
          "meeting_scheduling"}
#: every algorithm the harness runs
HARNESS_ALGOS = ["maxsum", "amaxsum", "maxsum_dynamic", "mgm", "mgm2",
                 "dsa", "dsatuto", "mixeddsa", "adsa", "dba", "gdba"]


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _port(algo, name, params=None, seed=0, **kw):
    dcop = load_dcop_from_file(_path(name))
    algo_def = AlgorithmDef.build_with_default_params(
        algo, params or {}, mode=dcop.objective)
    return load_algorithm_module(algo).build_solver(
        dcop, None, algo_def, seed=seed, device="cpu", **kw)


def _jax(algo, name, params=None, seed=0):
    dcop = jax_load_dcop(_path(name))
    algo_def = JaxAlgorithmDef.build_with_default_params(
        algo, params or {}, mode=dcop.objective)
    return jax_algo_module(algo).build_solver(dcop, None, algo_def,
                                              seed=seed)


def _values(solver):
    return solver.values_of(solver._last_state).cpu().numpy()


# ---------------------------------------------------------------------------
# the chunk policy and the runner cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collect,caller_chunk,timeout", list(
    itertools.product([False, True], [False, True], [None, 2.5])))
def test_default_chunk_equals_jax(collect, caller_chunk, timeout):
    for target, limit in itertools.product([None, 1, 6, 50, 150, 2000],
                                           [1, 3, 7, 100, 2000]):
        assert default_chunk(target, collect, caller_chunk, timeout,
                             limit) == jax_default_chunk(
            target, collect, caller_chunk, timeout, limit)


def test_lru_evictions_counted_as_jax():
    got, ref = LruCache(capacity=2), JaxLruCache(capacity=2)
    for c in (got, ref):
        c["a"], c["b"] = 1, 2
        _ = c["a"]  # refresh a
        c["c"] = 3  # evicts b
    assert len(got) == len(ref) == 2
    assert got.evictions == ref.evictions == 1
    assert "b" not in got and "a" in got and "c" in got
    got.clear()
    assert len(got) == 0


def test_solver_runner_cache_is_bounded():
    solver = _port("dba", "coloring_csp")
    solver._runners.capacity = 2
    for n in (3, 4, 5, 6):
        solver.run(cycles=n, chunk=n)
    assert len(solver._runners) <= 2
    assert solver._runners.evictions >= 2
    res = solver.run(cycles=3, chunk=3)
    assert res.harness["compile_cache_evictions"] >= 3
    assert solver.trace_count() == 5  # 3 rebuilt after its eviction


# ---------------------------------------------------------------------------
# the fixed-shape runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo,kw", [
    ("dsa", {"use_packed": False}), ("mgm", {"use_packed": False}),
    ("adsa", {"use_packed": False}), ("dba", {}), ("gdba", {}),
    ("amaxsum", {}), ("maxsum", {"use_packed": False})])
def test_masked_tail_equals_plain_cycles(algo, kw):
    """run(cycles=10, chunk=7): chunks of 7 and 3 live cycles, the tail's
    4 frozen; the state equals the same cycles run plainly, chunk by
    chunk with the same coin draws."""
    solver = _port(algo, "graph_coloring_tuto", seed=3, **kw)
    res = solver.run(cycles=10, chunk=7)
    assert res.cycle == 10
    assert res.harness["masked_tail_cycles"] == 4
    assert res.harness["chunks_dispatched"] == 2
    assert res.harness["host_sync_count"] == 0
    assert res.harness["donated_chunks"] == 0  # no CUDA graph on the CPU
    plain = _port(algo, "graph_coloring_tuto", seed=3, **kw)
    plain._restart_streams(False)
    state = plain.run_cycles(plain.initial_state(), 7)
    state = plain.run_cycles(state, 3)
    got, want = flatten(solver._last_state), flatten(state)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_one_runner_despite_remainders_and_deadlines():
    solver = _port("dsa", "coloring_csp", use_packed=False)
    res = solver.run(cycles=23, chunk=7)  # chunks 7, 7, 7, tail 2
    assert res.cycle == 23
    assert solver.trace_count() == 1
    assert len(solver._runners) == 1
    assert res.harness["chunks_dispatched"] == 4
    assert res.harness["masked_tail_cycles"] == 5
    # fixed-cycle runs never block on convergence reads
    assert res.harness["host_sync_count"] == 0
    solver.run(cycles=9, chunk=7)
    solver.run(cycles=40, chunk=7, timeout=30.0)
    assert solver.trace_count() == 1


def test_resume_continues_state_and_coins():
    a = _port("dsa", "coloring_csp", seed=2, use_packed=False)
    a.run(cycles=14, chunk=7)
    b = _port("dsa", "coloring_csp", seed=2, use_packed=False)
    b.run(cycles=7, chunk=7)
    b.run(cycles=7, chunk=7, resume=True)
    assert np.array_equal(_values(a), _values(b))
    # a fresh run replays the coins from the seed
    c = _port("dsa", "coloring_csp", seed=2, use_packed=False)
    c.run(cycles=7, chunk=7)
    c.run(cycles=14, chunk=7)
    assert np.array_equal(_values(a), _values(c))


# ---------------------------------------------------------------------------
# pipelined dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo,kw", [
    ("maxsum", {"use_packed": False}), ("amaxsum", {}),
    ("mgm", {"use_packed": False}), ("dsa", {"use_packed": False}),
    ("adsa", {"use_packed": False}), ("gdba", {}), ("dba", {})])
@pytest.mark.parametrize("name", ["coloring_intention", "ising_grid"])
def test_pipelined_overshoots_at_most_one_chunk(algo, kw, name):
    ref = _port(algo, name, **kw).run(max_cycles=300)
    res = _port(algo, name, **kw).run(max_cycles=300, pipeline=True)
    assert res.assignment == ref.assignment
    assert ref.cycle <= res.cycle <= ref.cycle + 7
    assert res.harness["overshoot_cycles"] == res.cycle - ref.cycle
    assert res.harness["host_sync_count"] <= res.harness["chunks_dispatched"]


def test_pipeline_is_jax_semantics_for_maxsum():
    """The JAX package's pipelined maxsum (generic engine on the CPU) and
    the port's generic engine stop at the same cycle with the same
    overshoot."""
    for name in ("graph_coloring_tuto", "ising_grid"):
        ref = _jax("maxsum", name, {"noise": 0}).run(max_cycles=300,
                                                      pipeline=True)
        got = _port("maxsum", name, {"noise": 0}, use_packed=False).run(
            max_cycles=300, pipeline=True)
        assert got.assignment == ref.assignment
        assert got.cycle == ref.cycle
        assert got.harness["overshoot_cycles"] == \
            ref.harness["overshoot_cycles"]


# ---------------------------------------------------------------------------
# per-cycle metrics against the JAX package
# ---------------------------------------------------------------------------


def _same_history(got, ref):
    assert [h["cycle"] for h in got.history] == \
        [h["cycle"] for h in ref.history]
    np.testing.assert_allclose([h["cost"] for h in got.history],
                               [h["cost"] for h in ref.history], atol=1e-4)
    assert set(got.history[0]) == set(ref.history[0]) == {
        "cycle", "cost", "time"}


@pytest.mark.parametrize("name", NAMES)
def test_maxsum_history_equals_jax_generic(name):
    """generic (port, use_packed=False) against generic (JAX, its CPU
    default): fixed cycles and open-ended."""
    params = {"noise": 0}
    for kw in ({"cycles": 12}, {}):
        ref = _jax("maxsum", name, params).run(collect_cycles=True, **kw)
        got = _port("maxsum", name, params, use_packed=False).run(
            collect_cycles=True, **kw)
        _same_history(got, ref)
        assert got.cycle == ref.cycle and got.assignment == ref.assignment


@pytest.mark.parametrize("name", sorted(BINARY))
def test_maxsum_packed_history_equals_jax(name):
    """The port's packed engine (its CPU default on all-binary graphs, one
    ``packed_cycles`` call a cycle under ``collect``) against the JAX
    package's CPU default, the generic engine: equal cycle by cycle on the
    all-binary instances, as their end results are
    (``test_torch_solve.py``)."""
    params = {"noise": 0}
    ref = _jax("maxsum", name, params).run(collect_cycles=True)
    solver = _port("maxsum", name, params)
    assert solver.packed is not None
    got = solver.run(collect_cycles=True)
    _same_history(got, ref)
    assert got.cycle == ref.cycle


@pytest.mark.parametrize("name", NAMES)
def test_open_ended_stop_cycles_equal_jax(name):
    params = {"noise": 0}
    for chunk, stable in itertools.product((5, 7), (1, 2, 3)):
        ref = _jax("maxsum", name, params).run(chunk=chunk,
                                               stable_chunks=stable)
        got = _port("maxsum", name, params, use_packed=False).run(
            chunk=chunk, stable_chunks=stable)
        assert got.cycle == ref.cycle, (chunk, stable)
        assert got.assignment == ref.assignment, (chunk, stable)


def _initial_x(dcop, seed):
    rng = np.random.default_rng(seed)
    sizes = [len(dcop.variables[n].domain) for n in sorted(dcop.variables)]
    return (rng.uniform(0, 1, len(sizes)) * np.array(sizes)).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_mgm_history_equals_jax_from_shared_start(name):
    """Both start from one numpy-made assignment (as
    ``test_torch_solve_local_search.py`` does); the port's CPU default
    (K2's plain version on the all-binary instances, the generic tables
    on the others) against the JAX package's CPU default."""
    jsolver, solver = _jax("mgm", name), _port("mgm", name)
    x0 = _initial_x(solver.dcop, 0)
    jsolver.initial_state = lambda: (jnp.asarray(x0),)
    solver.initial_state = lambda: (torch.as_tensor(x0),)
    for kw in ({"cycles": 15}, {}):
        ref = jsolver.run(collect_cycles=True, **kw)
        got = solver.run(collect_cycles=True, **kw)
        _same_history(got, ref)
        assert got.cycle == ref.cycle and got.assignment == ref.assignment


@pytest.mark.parametrize("algo", HARNESS_ALGOS)
@pytest.mark.parametrize("name", ["graph_coloring_tuto", "coloring_csp",
                                  "secp_small"])
def test_collect_equals_no_collect_at_the_same_chunk(algo, name):
    params = {"noise": 0} if "maxsum" in algo else None
    for kw in ({"cycles": 20, "chunk": 7}, {"chunk": 5}):
        plain = _port(algo, name, params, seed=1).run(**kw)
        coll = _port(algo, name, params, seed=1).run(collect_cycles=True,
                                                     **kw)
        assert coll.assignment == plain.assignment
        assert coll.cost == plain.cost and coll.cycle == plain.cycle
        assert [h["cycle"] for h in coll.history] == list(
            range(1, coll.cycle + 1))
        # the history's cost is a float32 sum on the device (within 1e-6
        # of it), the result's the host's float64 one; the history counts
        # a violated hard constraint at its table value (10000 here), the
        # result leaves it out of the cost and counts the violation — both
        # packages alike
        assert coll.history[-1]["cost"] == pytest.approx(
            coll.cost + 10000 * coll.violation, rel=1e-6, abs=1e-4)
        assert plain.history is None


@pytest.mark.parametrize("algo", ["mgm", "dsa", "mgm2"])
def test_collect_on_the_packed_layout_runs_k2(algo):
    """With ``collect`` the packed engine's cycle is the generic cycle on
    K2's tables (its plain version here): no K4/K5/K6 call, the same run
    as the packed kernels' at the same chunk."""
    from pydcop_tpu_torch.ops import packed_local_search as P

    calls = []
    real = P.ls_tables_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    solver = _port(algo, "meeting_scheduling", seed=4)
    assert solver.packed is not None
    P.ls_tables_plain = spy
    try:
        coll = solver.run(cycles=21, chunk=7, collect_cycles=True)
    finally:
        P.ls_tables_plain = real
    assert len(calls) == 21
    plain = _port(algo, "meeting_scheduling", seed=4).run(cycles=21, chunk=7)
    assert coll.assignment == plain.assignment


def test_solve_result_passes_the_harness_options():
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    res = solve_result(dcop, "mgm", collect_cycles=True, chunk=5,
                       device="cpu")
    assert res.config["chunk"] == 5
    assert [h["cycle"] for h in res.history] == list(range(1, res.cycle + 1))
    res = solve_result(dcop, "dba", pipeline=True, device="cpu")
    assert res.status == "FINISHED"
    for algo in ("dpop", "syncbb", "ncbb"):
        res = solve_result(dcop, algo, collect_cycles=True, chunk=5,
                           pipeline=True, device="cpu")
        assert res.cost == 12
    res = solve_result(dcop, "syncbb", collect_cycles=True,
                       algo_params={"engine": "frontier"}, device="cpu")
    assert res.history and res.history[-1]["cost"] == 12


# ---------------------------------------------------------------------------
# the event bus
# ---------------------------------------------------------------------------


class _Capture:
    """Every event of one package's bus while the block runs."""

    def __init__(self, module):
        self.bus = module.event_bus
        self.got = []

    def __enter__(self):
        self._cb = lambda topic, evt: self.got.append((topic, evt))
        self.bus.subscribe("*", self._cb)
        self._was, self.bus.enabled = self.bus.enabled, True
        return self.got

    def __exit__(self, *exc):
        self.bus.enabled = self._was
        self.bus.unsubscribe(self._cb)


def _both_events(run_port, run_jax):
    import pydcop_tpu.runtime.events as jev
    import pydcop_tpu_torch.runtime.events as tev

    with _Capture(tev) as got:
        run_port()
    with _Capture(jev) as ref:
        run_jax()
    return got, ref


def _same_keys(got, ref, prefix):
    got = [(t, set(e)) for t, e in got if t.startswith(prefix)]
    ref = [(t, set(e)) for t, e in ref if t.startswith(prefix)]
    assert got and got == ref


def test_bus_is_off_by_default_and_matches_wildcards():
    from pydcop_tpu_torch.runtime.events import EventDispatcher, event_bus

    assert not event_bus.enabled
    bus = EventDispatcher(enabled=True)
    seen = []
    bus.subscribe("search.*", lambda t, e: seen.append(t))
    bus.subscribe("harness.run.done", lambda t, e: seen.append("exact"))
    bus.send("search.bounds", {})
    bus.send("harness.run.done", {})
    bus.send("dpop.minibucket.bounds", {})
    assert seen == ["search.bounds", "exact"]


def test_harness_run_done_payload_keys_equal_jax():
    got, ref = _both_events(
        lambda: _port("mgm", "graph_coloring_tuto").run(max_cycles=50),
        lambda: _jax("mgm", "graph_coloring_tuto").run(max_cycles=50))
    _same_keys(got, ref, "harness.")
    assert got[-1][1]["algo"] == "mgm"


def test_search_payloads_equal_jax():
    """A frontier run that spills (the JAX tests' dense seed-7 case on a
    4-row slab): the same topics in the same order, the same keys and
    values, but the time-free ones only."""
    from test_torch_search import both

    from pydcop_tpu.search.solver import FrontierSearchSolver as Jax
    from pydcop_tpu_torch.search.solver import FrontierSearchSolver

    jd, td = both("dense", 7, n=8, D=3)
    kw = dict(frontier_width=4, ring=8, steps=3, i_bound=1)
    got, ref = _both_events(
        lambda: FrontierSearchSolver(td, device="cpu", **kw).run(),
        lambda: Jax(jd, **kw).run())
    _same_keys(got, ref, "search.")
    topics = {t for t, _ in got}
    assert {"search.bounds", "search.spill.drain", "search.done"} <= topics
    assert [e for t, e in got if t.startswith("search.")] == \
        [e for t, e in ref if t.startswith("search.")]


def test_dpop_minibucket_payload_equals_jax():
    params = {"engine": "minibucket", "i_bound": 1}

    def port():
        solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                     "dpop", algo_params=params, device="cpu")

    def jax_run():
        from pydcop_tpu.runtime import solve_result as jax_solve_result

        jax_solve_result(jax_load_dcop(_path("graph_coloring_tuto")), "dpop",
                         algo_params=params)

    got, ref = _both_events(port, jax_run)
    _same_keys(got, ref, "dpop.")
    assert [e for t, e in got if t.startswith("dpop.")] == \
        [e for t, e in ref if t.startswith("dpop.")]


def test_shard_comm_selected_payload_equals_jax():
    from pydcop_tpu.ops.compile import compile_constraint_graph as jax_cg
    from pydcop_tpu.ops.compile import compile_factor_graph as jax_fg
    from pydcop_tpu.parallel.mesh import ShardedLocalSearch as JaxLocal
    from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
    from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
    from pydcop_tpu_torch.parallel import (
        ShardedLocalSearch,
        ShardedMaxSum,
        build_mesh,
    )

    jd = jax_load_dcop(_path("graph_coloring_tuto"))
    jf, jc = jax_fg(jd), jax_cg(jd)
    tf = tensors_from_numpy(numpy_fields(jf), device="cpu")
    tc = tensors_from_numpy(numpy_fields(jc), device="cpu")

    def port():
        ShardedMaxSum(tf, build_mesh(4, "cpu"), overlap="off")
        ShardedLocalSearch(tc, build_mesh(4, "cpu"), rule="mgm",
                           overlap="off")

    def jax_run():
        JaxMaxSum(jf, jax_build_mesh(4), use_packed=True, overlap="off")
        JaxLocal(jc, jax_build_mesh(4), rule="mgm", use_packed=True,
                 overlap="off")

    got, ref = _both_events(port, jax_run)
    _same_keys(got, ref, "shard.")
    assert [e["engine"] for t, e in got] == ["maxsum", "local_search:mgm"]


# ---------------------------------------------------------------------------
# the entry points' default device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", HARNESS_ALGOS + [
    "dpop", "syncbb", "ncbb"])
def test_entry_points_default_to_cuda(algo):
    """Every algorithm's solve runs on ``cuda`` unless the caller passes
    the CPU: without a visible GPU it raises, never a silent CPU run."""
    from pydcop_tpu_torch.errors import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    with pytest.raises(DeviceUnavailableError):
        solve_result(dcop, algo, collect_cycles=True)
    with pytest.raises(DeviceUnavailableError):
        load_algorithm_module(algo).build_solver(dcop)


def test_launch_counters_name_every_counter():
    """Every ``*launches`` counter of every kernel wrapper is in
    ``ops.launch_counters()``, which the capture's replay bookkeeping
    and the launch checks read."""
    import inspect

    from pydcop_tpu_torch import ops
    from pydcop_tpu_torch.ops import packed_dpop, packed_local_search, \
        packed_maxsum, packed_mgm2, packed_sharded, permute

    named = {(id(fn), attr) for fn, attr in ops.launch_counters().values()}
    found = set()
    for mod in (packed_dpop, packed_local_search, packed_maxsum,
                packed_mgm2, packed_sharded, permute):
        for _, fn in inspect.getmembers(mod, inspect.isfunction):
            for attr in vars(fn):
                if attr.endswith("launches"):
                    found.add((id(fn), attr))
    assert found and found <= named
    ops.packed_local_search.ls_tables.launches = 3
    assert ops.read_launch_counters()["ls_tables"] == 3
    ops.reset_launch_counters()
    assert not any(ops.read_launch_counters().values())
