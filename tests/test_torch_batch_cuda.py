"""The batched engine and K10's instance axis on the card, held to the
port's own CPU runs and plain versions.

``cuda``-marked; each test skips where no GPU is visible (a CUDA graph
and the K10 kernel have no CPU mode).  No JAX here: the port is held to
the JAX package on the CPU (``tests/test_torch_batch.py``,
``tests/test_torch_dpop_batched.py``).  Run on a machine with a card
with ``python -m pytest tests/test_torch_batch_cuda.py -m cuda``."""
import os

import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.batch import BatchEngine, BatchItem, CompileCache
from pydcop_tpu_torch.batch.engine import WARMUP_CALLS
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import packed_dpop as PD
from pydcop_tpu_torch.ops import dpop_sweep as DS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("algo,params", [
    ("maxsum", None), ("mgm", None), ("dsa", {"variant": "C"}),
    ("adsa", None), ("gdba", {"modifier": "M", "violation": "MX"})])
@pytest.mark.parametrize("cycles", [21, None])
def test_captured_bucket_runner_equals_its_cpu_run(algo, params, cycles):
    """The same sweep solved WARMUP_CALLS + 2 times on the card: eager,
    then captured and replayed (every replay under the sync check), each
    result equal to the CPU engine's."""
    _need_gpu()
    items = [BatchItem(load_dcop_from_file(os.path.join(
        INSTANCES, n + ".yaml")), algo, algo_params=params, seed=s)
        for n in NAMES for s in (0, 1)]
    want = BatchEngine(cache=CompileCache(), max_padding_waste=0.9,
                       device="cpu").solve(items, cycles=cycles)
    cache = CompileCache()
    engine = BatchEngine(cache=cache, max_padding_waste=0.9, device="cuda")
    for turn in range(WARMUP_CALLS + 2):
        got = engine.solve(items, cycles=cycles)
        for g, w in zip(got, want):
            assert (g.assignment, g.cost, g.cycle, g.status) == \
                (w.assignment, w.cost, w.cycle, w.status), turn
        if turn == 0:
            for runner in cache._fns.values():
                runner.chunk_runner.solver.check_chunk_syncs = True
    calls = engine.metrics()["runners"]
    assert calls["captures"] == cache.misses
    assert calls["replays"] >= cache.misses


TREES = {
    "bench": lambda: C.bench_tree_dcop(2000),
    "forest": lambda: C.tree_dcop(300, seed=3, forest=True),
    "ragged": lambda: C.tree_dcop(300, D=5, seed=4, ragged=True),
    "max": lambda: C.tree_dcop(300, seed=5, objective="max"),
}


def _batch(plan, B=7, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pert = torch.rand((B,) + tuple(plan.local.shape), generator=g) * 5
    return (plan.local[None] + pert.to(plan.device)).contiguous()


@pytest.mark.parametrize("tree", sorted(TREES))
def test_batched_k10_equals_its_plain_version(tree):
    """One launch for B instances, torch.equal to the plain version
    (assign, msg, cs) at the wrapper's grid and at 1 and 3 blocks; the
    batched function's assignments equal the level scan's."""
    _need_gpu()
    _, plan, ps = C.dpop_pack(TREES[tree](), "cuda")
    local_b = _batch(plan)
    tables = PD.pack_tables(ps, local_b)
    want = PD.whole_sweep_plain(ps, tables)
    for blocks in (None, 1, 3):
        before = PD.whole_sweep.launches
        got = PD.whole_sweep_batched(ps, tables, blocks=blocks)
        assert PD.whole_sweep.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (tree, blocks)
    fn, args = DS.make_batched_sweep_fn(plan, batch=local_b.shape[0])
    before = PD.whole_sweep.launches
    assign = fn(local_b, *args)
    assert PD.whole_sweep.launches == before + 1
    scan = DS._run_sweep_batched(plan, local_b)
    assert torch.equal(assign, scan)


def test_failed_batched_launch_raises_nothing_falls_back(monkeypatch):
    _need_gpu()
    _, plan, ps = C.dpop_pack(TREES["bench"](), "cuda")
    tables = PD.pack_tables(ps, _batch(plan, B=2))
    before = PD.whole_sweep.launches

    def never(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(PD, "whole_sweep_plain", never)
    capacity, _ = PD._capacity(ps.D, ps.mode)
    with pytest.raises(ValueError, match="capacity"):
        PD.whole_sweep_batched(ps, tables, blocks=capacity + 1)
    monkeypatch.setattr(PD, "_batched_kernel",
                        lambda: (lambda *args: 719))
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        PD.whole_sweep_batched(ps, tables)
    assert PD.whole_sweep.launches == before
