"""The serve hooks of the port's batch engine on the CPU: the per-lane
bucket runner, ``chunk_coins_per_lane``, lane-level loading into a
runner's buffers, the rank tables' regrow under running lanes, and the
runner cache's exclusive pool.

* **the per-lane runner**: one call of a bucket with per-lane cycle
  counts ``[chunk, 3, 0, chunk - 1]`` leaves each lane's state equal
  (``torch.equal``) to its standalone solver's after that many cycles
  from its initial state; the idle lane's state and generator are
  unchanged;
* **lane loading**: a union written lane by lane (``load_lane``) holds
  the same buffers as one built from the whole bucket (``load``), rank
  tables included; a deeper lane regrows the tables while the lanes
  already running continue bit for bit;
* **the pool**: a runner checked out is nobody else's until it is
  checked in; a prewarm fills the pool and counts a prewarmed miss.

* **spread padding**: a serve lane's padded factor positions and pairs
  go round-robin over its padded variables, so a small instance folded
  into a large bucket leaves the rank tables as shallow as its real
  degree; the batch path's padding (every position on the dummy) is
  unchanged.

The batch path itself (``tests/test_torch_batch.py``) is unchanged and
still passes: a call with ``[n] * B`` is the old call with one ``n``.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.batch.engine import (
    BatchItem,
    BucketMeta,
    RankTable,
    adapter_for,
    build_bucket_runner,
    rank_block,
)
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.serve.scheduler import (
    dummy_bucket_inputs,
    lane_depths,
    serve_target,
    warm_bucket_runner,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
CPU = torch.device("cpu")
CHUNK = 7
ALGOS = ["mgm", "dsa", "adsa", "maxsum", "gdba"]


def _dcops():
    return [C.coloring_dcop(12, 30, seed=3), load_dcop_from_file(TUTO),
            C.coloring_dcop(10, 18, seed=4), C.coloring_dcop(12, 24, seed=5)]


def _specs(algo, dcops):
    adapter = adapter_for(algo)
    return adapter, [adapter.build_spec(BatchItem(d, algo, seed=s))
                     for s, d in enumerate(dcops)]


def _runner(adapter, target, B, chunk=CHUNK):
    return build_bucket_runner(adapter, BucketMeta.of(target), B, {}, chunk,
                               CPU)


def _seat(runner, adapter, specs, target):
    """Every spec loaded lane by lane into an idle runner, its initial
    state written and its stream restarted; returns the state."""
    state = runner.load_idle(target)
    for i, spec in enumerate(specs):
        runner.load_lane(i, adapter.lane_arrays(spec, target, spread=True))
        runner.write_lane(state, i, adapter.initial_leaves(spec, target))
        spec.solver._restart_streams(False)
    done = torch.ones(runner.B, dtype=torch.bool)
    done[:len(specs)] = False
    return state[0], done


def _standalone_leaves(adapter, spec, target, n):
    """Lane leaves of the spec's own solver after ``n`` cycles from its
    initial state (a fresh stream), padded as a lane holds them."""
    solver = adapter.build_spec(spec.item).solver
    solver._restart_streams(False)
    state = solver.initial_state()
    if n:
        state = solver.run_cycles(state, n)
    return state


def _values(adapter, runner, state, lane, spec):
    leaf = state[0][adapter.values_leaf]
    return runner.layout.lane("var", leaf, lane)[:spec.dims.V]


@pytest.mark.parametrize("algo", ALGOS)
def test_per_lane_counts_equal_each_lanes_standalone_cycles(algo):
    adapter, specs = _specs(algo, _dcops())
    target = serve_target([s.dims for s in specs])
    runner = _runner(adapter, target, len(specs))
    state = _seat(runner, adapter, specs, target)
    ns = [CHUNK, 3, 0, CHUNK - 1]
    gens_before = [tuple(g.get_state().clone()
                         for g in adapter.lane_generators(s)) for s in specs]
    coins = adapter.chunk_coins_per_lane(specs, ns, target, CHUNK)
    for c in coins:
        assert tuple(c.shape) == (CHUNK, len(specs) * target.V)
    idle_before = runner.read_lane(state, 2)
    state, _, flags = runner(state, coins, ns)
    assert tuple(flags.shape) == (2, len(specs))
    for i, (spec, n) in enumerate(zip(specs, ns)):
        want = _standalone_leaves(adapter, spec, target, n)
        got = _values(adapter, runner, state, i, spec)
        assert torch.equal(got.to(torch.int64),
                           spec.solver.values_of(want).to(torch.int64)), \
            (algo, i, n)
    for a, b in zip(idle_before, runner.read_lane(state, 2)):
        assert torch.equal(a, b)
    # the idle lane drew nothing: its generator did not advance
    for g, before in zip(adapter.lane_generators(specs[2]), gens_before[2]):
        assert torch.equal(g.get_state(), before)
    # a lane that drew advanced by exactly its own count
    for i in (0, 1, 3):
        for g, before in zip(adapter.lane_generators(specs[i]),
                             gens_before[i]):
            fresh = torch.Generator().set_state(before)
            torch.rand((ns[i], specs[i].dims.V), generator=fresh)
            if algo == "adsa":
                torch.rand((ns[i], specs[i].dims.V), generator=fresh)
            assert torch.equal(g.get_state(), fresh.get_state())


@pytest.mark.parametrize("algo", ["dsa", "adsa"])
def test_idle_lanes_give_all_ones_coins_and_draw_nothing(algo):
    adapter, specs = _specs(algo, _dcops()[:2])
    target = serve_target([s.dims for s in specs])
    for s in specs:
        s.solver._restart_streams(False)
    before = specs[1].solver.coins.get_state().clone()
    coins = adapter.chunk_coins_per_lane([specs[0], None], [3, 0], target,
                                         CHUNK)
    Vp = target.V
    for c in coins:
        assert torch.equal(c[:, Vp:], torch.ones(CHUNK, Vp))
        assert torch.equal(c[3:, :Vp], torch.ones(CHUNK - 3, Vp))
        assert torch.equal(c[:3, specs[0].dims.V:Vp],
                           torch.ones(3, Vp - specs[0].dims.V))
    assert torch.equal(specs[1].solver.coins.get_state(), before)
    assert adapter_for("mgm").chunk_coins_per_lane(
        [specs[0]], [3], target, CHUNK) == ()


@pytest.mark.parametrize("algo", ["mgm", "maxsum", "gdba"])
def test_lane_loading_equals_the_whole_bucket_load(algo):
    """A union written lane by lane holds the same field buffers and rank
    tables as one built from the whole bucket at once."""
    adapter, specs = _specs(algo, _dcops())
    target = serve_target([s.dims for s in specs])
    whole = _runner(adapter, target, len(specs))
    whole.load(specs, target)
    lanes = _runner(adapter, target, len(specs))
    state = lanes.load_idle(target, whole.union.depths())
    lanes(state, (), [0] * len(specs))  # builds the idle buffers
    for i, spec in enumerate(specs):
        assert not lanes.load_lane(i, adapter.lane_arrays(spec, target))
    a, b = whole.union, lanes.union
    assert torch.equal(a.t.domain_mask, b.t.domain_mask)
    assert torch.equal(a.t.unary_costs, b.t.unary_costs)
    assert torch.equal(a.t.edge_var, b.t.edge_var)
    for ba, bb, ia, ib in zip(a.t.buckets, b.t.buckets, a.index, b.index):
        assert torch.equal(ba.tensors, bb.tensors)
        assert torch.equal(ia[0], ib[0])
        for ca, cb in zip(ia[1], ib[1]):
            assert torch.equal(ca, cb)
    for (ra, _, _), (rb, _, _) in zip(a.tables, b.tables):
        assert torch.equal(ra.table, rb.table)
    for k in a.extra:
        assert torch.equal(a.extra[k], b.extra[k])


@pytest.mark.parametrize("algo", ["mgm", "maxsum", "dsa"])
def test_a_deeper_lane_regrows_while_running_lanes_continue(algo):
    """Two chain lanes run a chunk; a star (one variable in every
    factor) then joins lane 2 and regrows the tables: the running lanes
    finish bit for bit as their standalone solves."""
    chain = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
    star = [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5)]
    dcops = [C_graph(chain, 1), C_graph(chain, 2), C_graph(star, 3)]
    adapter, specs = _specs(algo, dcops)
    target = serve_target([s.dims for s in specs])
    runner = _runner(adapter, target, 3)
    state = _seat(runner, adapter, specs[:2], target)
    done = torch.tensor([False, False, True])
    ns = [CHUNK, CHUNK, 0]
    coins = adapter.chunk_coins_per_lane(specs[:2] + [None], ns, target,
                                         CHUNK)
    state, _, _ = runner((state[0], done), coins, ns)
    assert runner.regrows == 0
    assert runner.load_lane(2, adapter.lane_arrays(specs[2], target,
                                                   spread=True))
    assert runner.regrows == 1
    runner.write_lane(state, 2, adapter.initial_leaves(specs[2], target))
    specs[2].solver._restart_streams(False)
    ns = [CHUNK - 2, CHUNK, CHUNK]
    coins = adapter.chunk_coins_per_lane(specs, ns, target, CHUNK)
    state, _, _ = runner((state[0], torch.zeros(3, dtype=torch.bool)),
                         coins, ns)
    # each lane's chunks, as its standalone solver draws them
    chunks = {0: (CHUNK, CHUNK - 2), 1: (CHUNK, CHUNK), 2: (CHUNK,)}
    for i, ms in chunks.items():
        solver = adapter.build_spec(specs[i].item).solver
        solver._restart_streams(False)
        st = solver.initial_state()
        for m in ms:
            st = solver.run_cycles(st, m)
        assert torch.equal(
            _values(adapter, runner, state, i, specs[i]).to(torch.int64),
            solver.values_of(st).to(torch.int64)), (algo, i)


def C_graph(edges, seed):
    """A 3-colouring of six variables on ``edges``."""
    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )

    rng = np.random.default_rng(seed)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i}", d) for i in range(6)]
    dcop = DCOP("g")
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(edges):
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], rng.uniform(0, 1, (3, 3)).astype(np.float32),
            name=f"c{k}"))
    return dcop


@pytest.mark.parametrize("algo", ["mgm", "maxsum"])
def test_spread_padding_keeps_a_folded_lane_shallow(algo):
    """A small instance in a large bucket: spread, its padded positions
    sit on padded variables only, at most ceil(padding / padded
    variables) a column, and its real variables' rows are the batch
    padding's; unspread, every padded position is on the dummy."""
    small = C.coloring_dcop(10, 18, seed=4)
    large = C.coloring_dcop(40, 120, seed=5)
    adapter, specs = _specs(algo, [small, large])
    target = serve_target([s.dims for s in specs])
    V, Vp = specs[0].dims.V, target.V
    flat = adapter.lane_arrays(specs[0], target)
    spread = adapter.lane_arrays(specs[0], target, spread=True)
    for k in flat:
        if not (k.startswith("bv") or k in ("edge_var", "nsrc", "ndst")):
            assert np.array_equal(flat[k], spread[k]), k
    if algo == "maxsum":
        cols = [("edge_var", flat["edge_var"], spread["edge_var"])]
    else:
        bv_f, bv_s = flat["bv0"], spread["bv0"]
        cols = [(f"bv0[{p}]", bv_f[:, p], bv_s[:, p])
                for p in range(bv_f.shape[1])]
        cols += [(k, flat[k], spread[k]) for k in ("nsrc", "ndst")]
    for name, f, s in cols:
        real = f < V
        assert np.array_equal(f[real], s[real]), name
        assert (f[~real] == Vp - 1).all(), name
        assert (s[~real] >= V).all(), name
        pad = int((~real).sum())
        counts = np.bincount(s[~real], minlength=Vp)[V:]
        assert counts.max(initial=0) <= -(-pad // (Vp - V)), name
    d_flat = lane_depths(flat, target.graph_type, Vp)
    d_spread = lane_depths(spread, target.graph_type, Vp)
    assert max(d_spread.values()) < max(d_flat.values())


def test_rank_block_is_the_rank_tables_host_table():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, 40)
    rt = RankTable(ids, 9, CPU)
    assert np.array_equal(rt.host_table(ids), rank_block(
        ids, np.arange(40), 9, 40))
    # a lane's block: its rows mapped to union rows, sentinel kept
    block = rank_block(ids[:10], np.arange(100, 110), 9, 999, depth=5)
    assert block.shape == (5, 9)
    assert set(block[block != 999].tolist()) == set(range(100, 110))
    assert RankTable(ids, 9, CPU, depth=20).depth == 20


def test_lane_depths_and_dummy_inputs():
    adapter, specs = _specs("mgm", _dcops()[:2])
    target = serve_target([s.dims for s in specs])
    arrays, leaves, coins = dummy_bucket_inputs("dsa", target, 3, CHUNK)
    assert len(arrays) == 3 and len(leaves) == 1
    assert leaves[0].shape == (3 * target.V,)
    assert len(coins) == 1 and torch.equal(coins[0],
                                           torch.ones(CHUNK, 3 * target.V))
    d = lane_depths(adapter.lane_arrays(specs[0], target),
                    target.graph_type, target.V)
    assert set(d) == {("bv0", 0), ("bv0", 1)} and min(d.values()) >= 1


def test_warm_runner_sizes_its_tables_for_the_traffic():
    adapter, specs = _specs("mgm", _dcops())
    target = serve_target([s.dims for s in specs])
    like = [adapter.lane_arrays(s, target, spread=True) for s in specs]
    runner = warm_bucket_runner(adapter, target, {}, 4, CHUNK, device="cpu",
                                like=like)
    state = runner.load_idle(target)
    for i, arrays in enumerate(like):
        assert not runner.load_lane(i, arrays)  # no regrow
    assert runner.regrows == 0
    with pytest.raises(Exception, match="not ported"):
        warm_bucket_runner(adapter, target, {}, 4, CHUNK, aot=True,
                           device="cpu")
    assert state[1].all()


def test_the_pool_hands_a_runner_to_one_worker_at_a_time():
    cache = CompileCache()
    built = []

    def build():
        built.append(object())
        return built[-1]

    a, warm_a = cache.checkout(("k",), build)
    b, warm_b = cache.checkout(("k",), build)
    assert a is not b and not warm_a and not warm_b
    cache.checkin(("k",), a)
    c, warm_c = cache.checkout(("k",), build)
    assert c is a and warm_c
    assert cache.prewarm([(("k",), build), (("j",), build)]) == 2
    assert cache.prewarm([(("k",), build)]) == 0  # a free one: a hit
    st = {**cache.stats(), **cache.pool_stats()}
    assert st["prewarmed"] == 2 and st["pooled"] == 2
    assert (st["hits"], st["misses"]) == (2, 4)
    # the batch engine's shared runners stay apart from the pool
    shared, hit = cache.get_or_build(("k",), build)
    assert not hit and shared is built[-1]
