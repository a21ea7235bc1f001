"""The batched solve engine of the port (``pydcop_tpu_torch/batch/``) on
the CPU, held to the JAX package's (``pydcop_tpu/batch/``) and to the
port's own sequential solves, after the JAX package's
``tests/unit/test_batch_engine.py``:

* the bucketing policy: the same plans (buckets, targets, signatures,
  waste) as JAX's, on the JAX tests' synthetic shapes and on the six
  test instances compiled by each package; ``pad_instance`` returns the
  JAX package's arrays;
* bit-identity with the port's sequential solves: every result of
  ``BatchEngine.solve`` equals ``solve_result(..., device="cpu")`` of its
  instance (maxsum also its generic engine, ``use_packed=False``, the
  engine the batch runs) in assignment, cost, stop cycle and message
  counts, for JAX's seven algorithm cases with fixed cycles, with at
  least 2 buckets formed; the same to convergence for all five batched
  algorithms (stop cycles included); an instance alone equals itself
  inside a padded bucket;
* direct JAX parity: maxsum at noise 0 equals the JAX package's
  ``BatchEngine`` (values exact, costs within ``atol=1e-4``);
* the runner cache (one runner per (bucket, algo) pair, a repeat sweep
  all hits, the params in the key, a deeper bucket regrows the rank
  tables), the ``batch.*`` events and counters, ``on_lane_release``,
  the counted fallback, the refused persistent cache, the rank table's
  ordered sum.
"""
import os

import numpy as np
import pytest
import torch

from pydcop_tpu.batch import BatchEngine as JaxBatchEngine
from pydcop_tpu.batch import BatchItem as JaxBatchItem
from pydcop_tpu.batch import InstanceDims as JaxDims
from pydcop_tpu.batch import dims_of as jax_dims_of
from pydcop_tpu.batch import plan_buckets as jax_plan_buckets
from pydcop_tpu.batch.cache import CompileCache as JaxCompileCache
from pydcop_tpu.batch.engine import pad_instance as jax_pad_instance
from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.ops import compile as jax_compile
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.batch import (
    BatchEngine,
    BatchItem,
    CompileCache,
    InstanceDims,
    dims_of,
    plan_buckets,
)
from pydcop_tpu_torch.batch import bucketing
from pydcop_tpu_torch.batch.engine import RankTable, pad_instance
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops import compile as port_compile
from pydcop_tpu_torch.ops.segments import SegmentPlan
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.events import event_bus

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]
#: the JAX package's engine test's instances and algorithm cases
FILES = NAMES[:4]
ALGO_CASES = [
    ("maxsum", None),
    ("mgm", None),
    ("dsa", None),
    ("dsa", {"variant": "C", "probability": 0.8}),
    ("adsa", None),
    ("gdba", None),
    ("gdba", {"modifier": "M", "violation": "NM", "increase_mode": "R"}),
]
CASE_IDS = [f"{a}-{i}" for i, (a, _p) in enumerate(ALGO_CASES)]


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


@pytest.fixture(scope="module")
def dcops():
    return {n: load_dcop_from_file(_path(n)) for n in NAMES}


def _sequential(item, algo, params, cycles, use_packed=None):
    """The port's sequential solve of ``item`` on the CPU: through
    ``solve_result``, or the solver built with ``use_packed``."""
    if use_packed is None:
        return solve_result(item.dcop, algo, cycles=cycles,
                            algo_params=params, seed=item.seed,
                            device="cpu")
    solver = load_algorithm_module(algo).build_solver(
        item.dcop, None, item.algo_def(), seed=item.seed, device="cpu",
        use_packed=use_packed)
    return solver.run(cycles=cycles)


def _same(res, seq):
    return (res.assignment, res.cost, res.cycle, res.msg_count,
            res.msg_size) == (seq.assignment, seq.cost, seq.cycle,
                              seq.msg_count, seq.msg_size)


# ---------------------------------------------------------------------------
# bucketing and padding, against the JAX package
# ---------------------------------------------------------------------------


def _plans(plans):
    return [(p.indices, p.target.graph_type, p.target.D, p.target.arities,
             p.target.V, p.target.F, p.target.M, p.waste, p.signature())
            for p in plans]


SYNTHETIC = {
    "identical": [dict()] * 5,
    "arity_sets": [dict(arities=(2,), F=(20,)),
                   dict(arities=(1, 2), F=(5, 20))],
    "families": [dict(), dict(graph="factor_graph", M=0)],
    "waste_split": [dict(V=100, F=(300,), M=600), dict(V=4, F=(4,), M=8)],
    "dummy_slot": [dict(V=10, F=(20,), M=40), dict(V=10, F=(18,), M=36)],
    "size_sorted": [dict(V=v, F=(v * 2,), M=v * 4) for v in (4, 50, 4, 50)],
    "domains": [dict(D=3), dict(D=5, V=8), dict(D=2, V=12, F=(30,))],
}


def _dims(cls, graph="constraints_hypergraph", D=3, arities=(2,), V=10,
          F=(20,), M=40):
    return cls(graph_type=graph, D=D, arities=arities, V=V, F=F, M=M)


@pytest.mark.parametrize("waste", [0.0, 0.25, 0.9])
@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_plan_buckets_equals_jax_on_synthetic_shapes(case, waste):
    mine = [_dims(InstanceDims, **k) for k in SYNTHETIC[case]]
    theirs = [_dims(JaxDims, **k) for k in SYNTHETIC[case]]
    assert [d.cells for d in mine] == [d.cells for d in theirs]
    assert _plans(plan_buckets(mine, waste)) == \
        _plans(jax_plan_buckets(theirs, waste))


def _compiled(name, graph_type):
    """(port tensors, JAX tensors) of one instance, on the CPU."""
    if graph_type == "factor_graph":
        return (port_compile.compile_factor_graph(
                    load_dcop_from_file(_path(name)), device="cpu"),
                jax_compile.compile_factor_graph(jax_load(_path(name))))
    return (port_compile.compile_constraint_graph(
                load_dcop_from_file(_path(name)), device="cpu"),
            jax_compile.compile_constraint_graph(jax_load(_path(name))))


@pytest.fixture(scope="module")
def compiled():
    return {(n, g): _compiled(n, g) for n in NAMES
            for g in ("factor_graph", "constraints_hypergraph")}


@pytest.mark.parametrize("waste", [0.0, 0.25, 0.9, 1.0])
@pytest.mark.parametrize("graph_type", ["factor_graph",
                                        "constraints_hypergraph"])
def test_plans_and_padding_equal_jax_on_the_instances(compiled, graph_type,
                                                      waste):
    """The six instances compiled by each package: the same shape
    signatures and plans, and every member padded to its bucket's
    target gives the JAX package's arrays."""
    pairs = [compiled[n, graph_type] for n in NAMES]
    mine = [dims_of(p, graph_type) for p, _ in pairs]
    theirs = [jax_dims_of(j, graph_type) for _, j in pairs]
    assert [dataclass_tuple(d) for d in mine] == \
        [dataclass_tuple(d) for d in theirs]
    plans = plan_buckets(mine, waste)
    assert _plans(plans) == _plans(jax_plan_buckets(theirs, waste))
    jplans = jax_plan_buckets(theirs, waste)
    for plan, jplan in zip(plans, jplans):
        for i in plan.indices:
            got = pad_instance(pairs[i][0], plan.target)
            want = jax_pad_instance(pairs[i][1], jplan.target)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=f"{NAMES[i]} {k}")


def dataclass_tuple(d):
    return (d.graph_type, d.D, d.arities, d.V, d.F, d.M, d.cells)


def test_structured_buckets_refused_with_the_jax_message():
    class Structured:
        sbuckets = [object()]

    with pytest.raises(bucketing.StructuredBatchingUnsupported,
                       match="dedicated lane"):
        dims_of(Structured(), "factor_graph")
    assert issubclass(bucketing.StructuredBatchingUnsupported,
                      NotImplementedError)


# ---------------------------------------------------------------------------
# bit-identity with the port's sequential solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo,params", ALGO_CASES, ids=CASE_IDS)
def test_fixed_cycles_equal_the_sequential_solves(dcops, algo, params):
    """waste 0.9 forces mixed-shape instances into shared padded buckets
    — the padding-inertness contract under test."""
    items = [BatchItem(dcops[n], algo, algo_params=params, seed=s,
                       label=f"{n}:{s}") for n in NAMES for s in (0, 1)]
    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    results = engine.solve(items, cycles=21)
    assert engine.counters.counts["buckets_formed"] >= 2
    assert engine.counters.counts["fallback_sequential"] == 0
    for item, res in zip(items, results):
        assert res.status == "FINISHED"
        assert _same(res, _sequential(item, algo, params, 21)), item.label
        if algo == "maxsum":
            # the engine the bucket runs, named (C-w2)
            assert _same(res, _sequential(item, algo, params, 21,
                                          use_packed=False)), item.label


@pytest.mark.parametrize("algo,params", [ALGO_CASES[i]
                                         for i in (0, 1, 2, 4, 5)],
                         ids=["maxsum", "mgm", "dsa", "adsa", "gdba"])
def test_convergence_mode_equals_the_sequential_solves(dcops, algo, params):
    """cycles=None: per-lane convergence and freeze reproduce the
    sequential harness's stop states AND stop cycles."""
    items = [BatchItem(dcops[n], algo, algo_params=params, seed=s,
                       label=f"{n}:{s}") for n in NAMES for s in (0, 1)]
    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    results = engine.solve(items)
    converged = 0
    for item, res in zip(items, results):
        seq = _sequential(item, algo, params, None,
                          use_packed=None if algo == "gdba" else False)
        assert _same(res, seq), item.label
        converged += res.cycle < 2000
    assert engine.counters.counts["instances_converged"] == converged > 0


def test_mgm_convergence_equals_solve_result(dcops):
    items = [BatchItem(dcops[n], "mgm", seed=s, label=f"{n}:{s}")
             for n in FILES[:3] for s in (0, 1)]
    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    results = engine.solve(items)
    assert engine.counters.counts["instances_converged"] == len(items)
    for item, res in zip(items, results):
        seq = solve_result(item.dcop, "mgm", seed=item.seed, device="cpu")
        assert res.assignment == seq.assignment, item.label
        assert res.cycle == seq.cycle, item.label


@pytest.mark.parametrize("algo", ["mgm", "dsa", "maxsum"])
def test_padded_instance_equals_itself_alone(dcops, algo):
    alone = BatchEngine(cache=CompileCache(), device="cpu").solve(
        [BatchItem(dcops["coloring_csp"], algo, seed=3)], cycles=15)[0]
    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    mixed = engine.solve([BatchItem(dcops["graph_coloring_tuto"], algo,
                                    seed=3),
                          BatchItem(dcops["coloring_csp"], algo, seed=3)],
                         cycles=15)
    assert engine.counters.counts["buckets_formed"] == 1
    assert engine.metrics()["padding_waste"] > 0.0
    assert (mixed[1].assignment, mixed[1].cost) == \
        (alone.assignment, alone.cost)


def test_timeout_marks_unfinished_lanes(dcops):
    engine = BatchEngine(cache=CompileCache(), device="cpu")
    (res,) = engine.solve([BatchItem(dcops["ising_grid"], "dsa", seed=0)],
                          timeout=0.0)
    assert res.status == "TIMEOUT"
    assert res.cycle == 7  # one chunk at the deadline policy's 7


# ---------------------------------------------------------------------------
# direct JAX parity: maxsum at noise 0
# ---------------------------------------------------------------------------


def test_maxsum_noise0_equals_the_jax_batch_engine():
    params = {"noise": 0}
    items = [BatchItem(load_dcop_from_file(_path(n)), "maxsum",
                       algo_params=params, label=n) for n in FILES]
    jitems = [JaxBatchItem(jax_load(_path(n)), "maxsum",
                           algo_params=params, label=n) for n in FILES]
    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    got = engine.solve(items, cycles=21)
    jengine = JaxBatchEngine(cache=JaxCompileCache(), max_padding_waste=0.9)
    want = jengine.solve(jitems, cycles=21)
    assert engine.counters.as_dict() == jengine.counters.as_dict()
    for g, w, n in zip(got, want, FILES):
        assert g.assignment == w.assignment, n
        assert g.cost == pytest.approx(w.cost, abs=1e-4), n
        assert (g.cycle, g.msg_count, g.msg_size, g.status) == \
            (w.cycle, w.msg_count, w.msg_size, w.status), n


# ---------------------------------------------------------------------------
# the runner cache, events, hooks, fallback
# ---------------------------------------------------------------------------


def test_one_runner_per_bucket_algo_pair_and_repeat_all_hits(dcops):
    items = [BatchItem(dcops[n], "mgm", seed=s, label=f"{n}:{s}")
             for n in FILES for s in (0, 1)]
    cache = CompileCache()
    engine = BatchEngine(cache=cache, device="cpu")
    first = engine.solve(items, cycles=20)
    n_buckets = engine.counters.counts["buckets_formed"]
    assert n_buckets >= 2
    assert (cache.misses, cache.hits) == (n_buckets, 0)
    assert engine.counters.counts["compile_misses"] == n_buckets
    engine2 = BatchEngine(cache=cache, device="cpu")
    second = engine2.solve(items, cycles=20)
    assert (cache.misses, cache.hits) == (n_buckets, n_buckets)
    assert engine2.counters.counts["compile_hits"] == n_buckets
    assert cache.stats() == {"hits": n_buckets, "misses": n_buckets,
                             "entries": n_buckets}
    for a, b in zip(first, second):
        assert (a.assignment, a.cost) == (b.assignment, b.cost)


def test_cache_key_covers_params(dcops):
    cache = CompileCache()
    engine = BatchEngine(cache=cache, device="cpu")
    engine.solve([BatchItem(dcops["coloring_csp"], "dsa", seed=0)],
                 cycles=10)
    engine.solve([BatchItem(dcops["coloring_csp"], "dsa",
                            algo_params={"variant": "C"}, seed=0)],
                 cycles=10)
    assert cache.misses == 2


def _graph_dcop(edges, seed):
    """A 3-colouring of 4 variables on ``edges`` (uniform [0, 1) tables
    from ``seed``), built with the port's DCOP objects."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i}", d) for i in range(4)]
    dcop = DCOP("g")
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(edges):
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], rng.uniform(0, 1, (3, 3)).astype(np.float32),
            name=f"c{k}"))
    return dcop


@pytest.mark.parametrize("algo", ["mgm", "maxsum", "gdba"])
def test_a_cached_runner_takes_new_instances_of_its_shape(algo):
    """Buckets of one signature (4 variables, 3 edges, D = 3): the second
    and third are cache hits that copy their arrays into the runner's
    buffers; the star is deeper than the chain (a variable in three
    factors), so its bucket regrows the rank tables.  Every result
    equals its sequential solve."""
    chain, star = [(0, 1), (1, 2), (2, 3)], [(0, 1), (0, 2), (0, 3)]
    cache = CompileCache()
    engine = BatchEngine(cache=cache, device="cpu")
    for k, edges in enumerate((chain, chain, star, chain)):
        items = [BatchItem(_graph_dcop(edges, 10 * k + i), algo, seed=i)
                 for i in range(2)]
        for item, res in zip(items, engine.solve(items, cycles=12)):
            assert _same(res, _sequential(
                item, algo, None, 12,
                use_packed=None if algo == "gdba" else False))
    assert (cache.misses, cache.hits) == (1, 3)
    assert engine.metrics()["runners"]["regrows"] == 1


def test_persistent_cache_is_refused():
    with pytest.raises(NotPortedError, match="persistent compile cache"):
        BatchEngine(persistent_cache_dir="/nonexistent/cache", device="cpu")


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    from pydcop_tpu_torch.errors import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError):
        BatchEngine()


def _listen(topic):
    seen = []

    def cb(t, evt):
        seen.append((t, evt))

    event_bus.enabled = True
    event_bus.subscribe(topic, cb)
    return seen, cb


def _stop(cb):
    event_bus.unsubscribe(cb)
    event_bus.enabled = False


def test_batch_events_and_counters(dcops):
    seen, cb = _listen("batch.*")
    try:
        engine = BatchEngine(cache=CompileCache(), device="cpu")
        engine.solve([BatchItem(dcops[n], "mgm", seed=0)
                      for n in FILES[:2]], cycles=10)
        engine.solve([BatchItem(dcops[n], "mgm", seed=0)
                      for n in FILES[:2]], cycles=10)
    finally:
        _stop(cb)
    topics = [t for t, _ in seen]
    for t in ("batch.bucket.formed", "batch.compile.miss",
              "batch.compile.hit", "batch.run.done"):
        assert t in topics, t
    formed = next(e for t, e in seen if t == "batch.bucket.formed")
    assert set(formed) == {"algo", "signature", "size", "waste"}
    done = next(e for t, e in seen if t == "batch.run.done")
    assert set(done) == {"instances", "buckets", "wall", "cache"}
    m = engine.metrics()
    assert m["instances_enqueued"] == m["instances_solved"] == 4
    assert set(m) >= {"padding_waste", "cache", "runners", "seconds",
                      "compile_hits", "compile_misses", "lanes_nonfinite"}
    assert set(m["seconds"]) == {"specs_s", "load_s", "loop_s", "score_s"}


def test_converged_event_and_counter(dcops):
    seen, cb = _listen("batch.instance.converged")
    try:
        engine = BatchEngine(cache=CompileCache(), device="cpu")
        engine.solve([BatchItem(dcops["graph_coloring_tuto"], "mgm",
                                seed=0, label="tuto")])
    finally:
        _stop(cb)
    assert engine.counters.counts["instances_converged"] == 1
    assert seen and seen[0][1]["label"] == "tuto"
    assert engine.metrics()["cache"]["misses"] >= 1


def test_on_lane_release_hook(dcops):
    released = []

    def hook(lane, stop_cycle, final_state):
        released.append((lane, stop_cycle, final_state))

    engine = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                         device="cpu")
    items = [BatchItem(dcops[n], "mgm", seed=0) for n in FILES[:2]]
    results = engine.solve(items, on_lane_release=hook)
    assert sorted(lane for lane, _c, _s in released) == [0, 1]
    assert sorted(c for _l, c, _s in released) == \
        sorted(r.cycle for r in results)
    for _lane, _c, state in released:
        (x,) = state
        assert x.ndim == 1 and x.dtype == torch.int32


def test_nonfinite_lane_is_frozen_error(dcops, monkeypatch):
    """A lane whose float state goes NaN is frozen ERROR at the chunk
    boundary (``lanes_nonfinite``, ``batch.lane.nonfinite``, the hook);
    its bucket-mates run on and equal their sequential solves."""
    from pydcop_tpu_torch.batch import engine as E

    make = E._MaxSumAdapter.initial_leaves

    def poisoned(self, spec, target):
        leaves = make(self, spec, target)
        if spec.item.label == "bad":
            leaves[0][:] = np.nan
            leaves[1][:] = np.nan
        return leaves

    monkeypatch.setattr(E._MaxSumAdapter, "initial_leaves", poisoned)
    seen, cb = _listen("batch.lane.nonfinite")
    released = []
    try:
        engine = BatchEngine(cache=CompileCache(), max_padding_waste=1.0,
                             device="cpu")
        items = [BatchItem(dcops["coloring_csp"], "maxsum", label="bad"),
                 BatchItem(dcops["coloring_intention"], "maxsum",
                           label="good")]
        results = engine.solve(items, on_lane_release=lambda *a:
                               released.append(a[0]))
    finally:
        _stop(cb)
    assert engine.counters.counts["buckets_formed"] == 1
    assert engine.counters.counts["lanes_nonfinite"] == 1
    assert results[0].status == "ERROR" and results[0].cycle == 7
    assert seen[0][1]["label"] == "bad"
    assert results[1].status == "FINISHED"
    assert _same(results[1], _sequential(items[1], "maxsum", None, None,
                                         use_packed=False))
    assert len(released) == 2


def test_fallback_sequential_counted(dcops):
    engine = BatchEngine(cache=CompileCache(), device="cpu")
    res = engine.solve([BatchItem(dcops["graph_coloring_tuto"], "dpop"),
                        BatchItem(dcops["graph_coloring_tuto"], "mgm2",
                                  seed=1)], cycles=30)
    assert res[0].cost == 12
    seq = solve_result(dcops["graph_coloring_tuto"], "mgm2", cycles=30,
                       seed=1, device="cpu")
    assert _same(res[1], seq)
    assert engine.counters.counts["fallback_sequential"] == 2
    assert engine.counters.counts["buckets_formed"] == 0


def test_results_align_with_items_across_groups(dcops):
    items = [BatchItem(dcops["coloring_csp"], "dsa", seed=4),
             BatchItem(dcops["graph_coloring_tuto"], "mgm", seed=5),
             BatchItem(dcops["coloring_csp"], AlgorithmDef
                       .build_with_default_params("gdba", {}), seed=6)]
    engine = BatchEngine(cache=CompileCache(), device="cpu")
    res = engine.solve(items, cycles=9)
    for item, r, algo in zip(items, res, ("dsa", "mgm", "gdba")):
        assert _same(r, _sequential(item, algo, None, 9))


# ---------------------------------------------------------------------------
# the rank table: the ordered sum at a fixed shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_rank_table_equals_the_segment_plan(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 37, 400)
    ids[:50] = 3  # a hub
    data = torch.as_tensor(rng.normal(size=(400, 5)).astype(np.float32))
    want = SegmentPlan(torch.as_tensor(ids), 40).sum(data)
    rt = RankTable(ids, 40, torch.device("cpu"))
    assert rt.depth == int(np.bincount(ids).max())
    assert torch.equal(rt.sum(data), want)
    # a deeper table (a bucket of the same shape with fewer ranks) adds
    # zeros: the same bits
    rt.table = torch.as_tensor(rt.host_table(ids, rt.depth + 3))
    assert torch.equal(rt.sum(data), want)
