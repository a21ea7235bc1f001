"""K10, the whole-sweep DPOP kernel of ``csrc/dpop_sweep.cu`` (ONE
cooperative launch a sweep that walks every UTIL and VALUE level, a grid
barrier between consecutive levels), and its wrapper.

Here, on the CPU: the device copy of ``level_start`` against the host
one; and the wrapper's CUDA branch run on CPU tensors with a stand-in C
entry (the grid it asks for and its refusal of a forced grid out of
range, a capacity of 0, a refused launch, each call's own zeroed barrier
word, one launch counted a sweep, the operands in the entry's order, the
tensors the result comes from); the plain version on the CPU at any
``blocks``, counting nothing.

On the card (``cuda``-marked, skipped here): the kernel against
``whole_sweep_plain`` under ``torch.equal`` (assign, msg, cs), and its
assign against the level scan's, at the wrapper's grid and at forced
grids of 1 and 3 blocks, one launch a sweep.  This file imports no JAX:
the port's DPOP is held to the JAX package in ``test_torch_dpop.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.ops import packed_dpop as PD
from pydcop_tpu_torch.ops.dpop_sweep import run_sweep

torch.set_num_threads(1)

#: the trees of the checks: the bench's random tree (D = 10), a forest
#: (every 17th node a root), ragged domains (D - 2 values on every second
#: node, a deep chain-like tree) and a max-mode tree
TREES = {
    "bench": lambda: C.bench_tree_dcop(2000),
    "forest": lambda: C.tree_dcop(300, seed=3, forest=True),
    "ragged": lambda: C.tree_dcop(300, D=5, seed=4, ragged=True),
    "max": lambda: C.tree_dcop(300, seed=5, objective="max"),
}


def packed(tree, device="cpu"):
    """(sweep plan, packed sweep) of ``tree`` on ``device``."""
    _, plan, ps = C.dpop_pack(TREES[tree](), device)
    assert ps is not None
    return plan, ps


@pytest.mark.parametrize("tree", sorted(TREES))
def test_device_level_start_equals_the_host_one(tree):
    _, ps = packed(tree)
    dev = ps.level_start_dev
    assert dev.dtype == torch.int32 and dev.device == ps.device
    assert dev.is_contiguous()
    assert np.array_equal(dev.numpy(), ps.level_start)
    assert ps.level_start[-1] == ps.n_nodes
    assert np.all(np.diff(ps.level_start) > 0)


# ---------------------------------------------------------------------------
# the wrapper's CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``dpop_whole_sweep``: records each
    call's arguments, its barrier word as it finds it and the host level
    starts it reads, leaves the word dirty, writes 3 into assign and 0
    into msg and cs, and returns ``rc``."""

    def __init__(self, ps, rc=0):
        self.ps, self.rc, self.calls, self.bars, self.levels = ps, rc, [], \
            [], []

    def __call__(self, *args):
        self.calls.append(args)
        word = ctypes.c_uint32.from_address(args[-2])
        self.bars.append(word.value)
        word.value = 7
        ps = self.ps
        self.levels.append(list((ctypes.c_int32 * (ps.L + 1)).from_address(
            args[5])))
        nd = ps.n_nodes * ps.D
        (ctypes.c_int32 * ps.n_nodes).from_address(args[11])[:] = \
            [3] * ps.n_nodes
        for ptr in args[9:11]:
            (ctypes.c_float * nd).from_address(ptr)[:] = [0.0] * nd
        return self.rc


def cuda_branch(monkeypatch, entry, capacity=(1056, 250), cap=32):
    """Run the CUDA branch of ``whole_sweep`` on CPU tensors with
    ``entry`` as its kernel, on a counter of its own (zero, restored after
    the test) and the grid cap ``cap``; the plain version must not run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    monkeypatch.setattr(PD, "_kernel", lambda: entry)
    monkeypatch.setattr(PD, "_capacity", lambda D, mode: capacity)
    monkeypatch.setattr(PD, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(PD, "whole_sweep_plain", never)
    monkeypatch.setattr(PD, "SWEEP_GRID_CAP", cap)
    monkeypatch.setattr(PD.whole_sweep, "launches", 0)


def widest_tiles(ps, threads):
    return -(-int(np.diff(ps.level_start).max()) // (threads // ps.D))


@pytest.mark.parametrize("capacity,cap", [((1056, 250), 32),
                                          ((1056, 250), 10 ** 6),
                                          ((2, 250), 32), ((1, 250), 32),
                                          ((1056, 250), 1)])
@pytest.mark.parametrize("tree", ["bench", "ragged"])
def test_launch_grid_and_forced_grids(monkeypatch, tree, capacity, cap):
    """The grid: the UTIL tiles of the widest level, at most the capacity
    and the cap, at least 1; a forced grid goes to the entry as it is,
    from 1 to the capacity, and one out of that range is refused before
    any launch."""
    _, ps = packed(tree)
    entry = StandInEntry(ps)
    cuda_branch(monkeypatch, entry, capacity, cap)
    blocks, threads = capacity
    PD._launch_sweep(ps, None)
    want = max(1, min(blocks, widest_tiles(ps, threads), cap))
    assert entry.calls[0][-3] == want == PD.sweep_blocks(ps, *capacity)
    for forced in (1, blocks):
        PD._launch_sweep(ps, forced)
        assert entry.calls[-1][-3] == forced
    for forced in (0, blocks + 1):
        with pytest.raises(ValueError, match="capacity"):
            PD._launch_sweep(ps, forced)
    assert len(entry.calls) == 3
    assert PD.whole_sweep.launches == 3


def test_no_resident_block_raises_without_launching(monkeypatch):
    _, ps = packed("bench")
    entry = StandInEntry(ps)
    cuda_branch(monkeypatch, entry, capacity=(0, 250))
    with pytest.raises(RuntimeError, match="no resident block"):
        PD._launch_sweep(ps, None)
    assert entry.calls == []
    assert PD.whole_sweep.launches == 0


@pytest.mark.parametrize("rc", [1, 720])
def test_failed_launch_raises_and_counts_nothing(monkeypatch, rc):
    _, ps = packed("forest")
    entry = StandInEntry(ps, rc)
    cuda_branch(monkeypatch, entry)
    with pytest.raises(RuntimeError, match=f"dpop_whole_sweep launch "
                       f"failed: CUDA error {rc}"):
        PD._launch_sweep(ps, None)
    assert len(entry.calls) == 1
    assert PD.whole_sweep.launches == 0


@pytest.mark.parametrize("tree", sorted(TREES))
def test_each_sweep_one_launch_own_barrier_word(monkeypatch, tree):
    """Each sweep: one launch, counted once, with a barrier word of its
    own, zero although the sweep before left its word dirty; the operands
    in the entry's order (the table, the CSR children, the parents, the
    device and host level starts, L, D, the mode, msg, cs, assign, the
    grid); the result is the tensors the entry wrote."""
    _, ps = packed(tree)
    entry = StandInEntry(ps)
    cuda_branch(monkeypatch, entry)
    for k in range(3):
        assign, msg, cs = PD._launch_sweep(ps, None)
        args = entry.calls[-1]
        assert args[:6] == (
            ps.table.data_ptr(), ps.child_ptr.data_ptr(),
            ps.child_idx.data_ptr(), ps.parent.data_ptr(),
            ps.level_start_dev.data_ptr(), ps.level_start.ctypes.data)
        assert args[6:9] == (ps.L, ps.D, int(ps.mode == "max"))
        assert args[9:12] == (msg.data_ptr(), cs.data_ptr(),
                              assign.data_ptr())
        assert args[12] == PD.sweep_blocks(ps, 1056, 250)
        assert entry.levels[-1] == ps.level_start.tolist()
        assert entry.bars[-1] == 0
        assert PD.whole_sweep.launches == k + 1
        assert torch.equal(assign, torch.full_like(assign, 3))
        assert assign.dtype == torch.int32
        assert tuple(msg.shape) == tuple(cs.shape) == (ps.n_nodes, ps.D)


def test_cpu_runs_the_plain_version_and_counts_nothing():
    """On the CPU whole_sweep is the plain version at any ``blocks`` (it
    has no use there), and no launch is counted."""
    plan, ps = packed("forest")
    before = PD.whole_sweep.launches
    want = PD.whole_sweep_plain(ps)
    for blocks in (None, 1, 3):
        got = PD.whole_sweep(ps, blocks=blocks)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(want[0].numpy(), run_sweep(plan)[0])
    assert PD.whole_sweep.launches == before


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(TREES))
def test_kernel_matches_plain_on_gpu(tree):
    """torch.equal with the plain version (assign, msg, cs) and assign
    equal to the level scan's, at the wrapper's grid and at 1 and 3
    blocks, one launch a sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    plan, ps = packed(tree, "cuda")
    want = PD.whole_sweep_plain(ps)
    scan = run_sweep(plan)[0]
    for blocks in (None, 1, 3):
        before = PD.whole_sweep.launches
        got = PD.whole_sweep(ps, blocks=blocks)
        assert PD.whole_sweep.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), (tree, blocks)
        assert np.array_equal(got[0].cpu().numpy(), scan)
    torch.cuda.synchronize()
