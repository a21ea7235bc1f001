"""K1's binary branch, the MaxSum kernel of ``csrc/packed_maxsum.cu`` (ONE
cooperative launch a ``packed_cycles`` call: each degree class cut into
tiles of neighbouring columns, a block's tile r' of every (rank, column),
then the columns' beliefs, then q', a grid barrier between cycles), and
its wrapper.

Here, on the CPU: the tile table (every column in one tile, every slot in
one (rank, column) unit, on a colouring, the degree-2,500 star, unequal
domains, a hard colouring and a graph with degree-0 columns); a numpy
walk of the tiles in the kernel's order, which must give the plain
version's numbers bit for bit; and the wrapper's CUDA branch run on CPU
tensors with a stand-in C entry (the grid it asks for and its refusal of
a forced grid out of range, a capacity of 0, a refused launch, each
call's own zeroed barrier word, one launch counted a call, the operands
in the entry's order, the buffer the result comes from).

On the card (``cuda``-marked, skipped here): the kernel against
``packed_cycles_plain`` under ``torch.equal`` (q, r, beliefs, values) at
damping 0.5 and 0, at the wrapper's grid and at forced grids of 1 and 3
blocks, after 1, 2, 3 and 20 cycles and over two consecutive calls.  This
file imports no JAX: the port's packed MaxSum is held to the JAX package
in ``test_torch_packed_maxsum.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.ops import packed_maxsum as PM
from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

torch.set_num_threads(1)


def colouring(V, E, device, seed=2):
    """A soft 3-colouring of uniform [0, 1) costs (E < V leaves columns
    without slots)."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, E)
    ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
    return compile_binary_from_arrays(
        ei, ej, rng.uniform(0, 1, (E, 3, 3)).astype(np.float32), V,
        device=device)


def bench_colouring(V, E, device):
    """The bench's colouring (``chip_smoke.coloring_arrays``)."""
    ei, ej, mats, un = C.coloring_arrays(V, E)
    return compile_binary_from_arrays(ei, ej, mats, V, unary=un,
                                      device=device)


#: the binary graphs of the checks: the bench colouring, the star with a
#: hub of degree 2,500, odd variables on 2 of 4 values, integer costs
#: with ties, and 150 edges on 400 variables (columns without slots)
GRAPHS = {
    "coloring": lambda dev: bench_colouring(1000, 3000, dev),
    "star": lambda dev: C.star_tensors(2500, dev),
    "unequal": lambda dev: C.unequal_domains_tensors(500, 1500, 4, dev),
    "hard": lambda dev: C.hard_coloring_tensors(400, 1200, dev),
    "sparse": lambda dev: colouring(400, 150, dev),
}


def packed(graph, device="cpu"):
    pg = PM.pack_for_gpu(GRAPHS[graph](device))
    assert pg is not None and pg.mixed is None
    return pg


def start(pg, seed=0):
    """A random (q, r) state, float32 and contiguous."""
    gen = torch.Generator().manual_seed(seed)
    q, r = (torch.rand((pg.D, pg.N), generator=gen) for _ in range(2))
    return q.to(pg.device), r.to(pg.device)


# ---------------------------------------------------------------------------
# the tile table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols", [1, 7, 64, 1024])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_table_covers_every_unit_once(graph, cols):
    """Every column lies in one tile of at most ``cols`` columns of its
    degree; the tile's (rank k, column w) unit is the column's rank-k
    slot, and every slot is one unit of one tile."""
    pg = packed(graph)
    tiles = PM.tile_table(pg, cols)
    assert tiles.dtype == np.int32 and tiles.shape[1] == 5
    deg = pg.col_deg.numpy()
    slot0, stride = pg.col_slot0.numpy(), pg.col_stride.numpy()
    cols_seen = np.zeros(pg.Vp, dtype=np.int64)
    slots_seen = np.zeros(pg.N, dtype=np.int64)
    for c0, width, d, s0, step in tiles:
        assert 1 <= width <= cols
        col = c0 + np.arange(width)
        cols_seen[col] += 1
        assert np.all(deg[col] == d)
        for k in range(d):
            s = s0 + k * step + np.arange(width)
            assert np.array_equal(s, slot0[col] + k * stride[col])
            slots_seen[s] += 1
    assert np.all(cols_seen == 1)
    assert np.all(slots_seen == 1)
    if graph == "sparse":
        assert int((pg.col_deg == 0).sum()) > 0
        assert (tiles[:, 2] == 0).any()
    if graph == "star":
        # the hub is a tile of its own
        assert [2500, 1] in tiles[:, [2, 1]].tolist()


def test_tile_table_is_built_once_per_width():
    pg = packed("coloring")
    a = PM._tiles(pg, 64)
    assert PM._tiles(pg, 64) is a
    assert torch.equal(a, torch.as_tensor(PM.tile_table(pg, 64)))
    assert PM._tiles(pg, 32) is not a and set(pg.tile_tables) == {32, 64}


def tile_walk(pg, q0, r0, n_cycles, damping, cols):
    """The kernel's arithmetic in numpy float32, tile by tile in its
    order: per unit r' (fminf from j = 0, the mask, damping), per column
    the belief sum from 0 in rank order plus the unary cost, per unit q'
    (the mean over the valid values); q double-buffered by cycle parity,
    r in place after cycle 0.  Returns (q', r', beliefs)."""
    f32 = np.float32
    D, N = pg.D, pg.N
    cost, unary = pg.cost_rows.numpy(), pg.unary_p.numpy()
    vmask, inv = pg.vmask.numpy(), pg.inv_dcount.numpy()
    mate = pg.mate.numpy()
    bufs = [np.empty((D, N), f32), np.empty((D, N), f32)]
    r = np.empty((D, N), f32)
    beliefs = np.empty((D, pg.Vp), f32)
    for cyc in range(n_cycles):
        q_in = q0 if cyc == 0 else bufs[(cyc - 1) % 2]
        q_out = bufs[cyc % 2]
        r_in = r0 if cyc == 0 else r
        for c0, width, deg, s0, step in PM.tile_table(pg, cols):
            k, w = np.divmod(np.arange(deg * width), width)
            s = s0 + k * step + w
            qm = q_in[:, mate[s]]
            best = cost[0:D, s] + qm[0]
            for j in range(1, D):
                best = np.fmin(best, cost[j * D:(j + 1) * D, s] + qm[j])
            rn = best * vmask[:, s]
            if damping:
                rn = f32(damping) * r_in[:, s] + f32(1.0 - damping) * rn
            r[:, s] = rn
            acc = np.zeros((D, width), f32)
            for kk in range(deg):
                acc = acc + r[:, s0 + kk * step + np.arange(width)]
            bel = unary[:, c0:c0 + width] + acc
            beliefs[:, c0:c0 + width] = bel
            qv = bel[:, w] - r[:, s]
            total = np.zeros(s.shape, f32)
            for i in range(D):
                total = total + qv[i] * vmask[i, s]
            q_out[:, s] = (qv - total * inv[s]) * vmask[:, s]
    return bufs[(n_cycles - 1) % 2], r, beliefs


@pytest.mark.parametrize("damping", [0.5, 0.0])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_walk_gives_the_plain_numbers(graph, damping):
    """Walking the tiles in the kernel's order gives q, r and beliefs
    equal to the plain version's after 1, 2, 3 and 20 cycles, at tile
    widths 1 and 64: the split into tiles changes no number."""
    pg = packed(graph)
    q, r = start(pg)
    for n in (1, 2, 3, 20):
        pq, pr, pb, _ = PM.packed_cycles_plain(pg, q, r, n, damping)
        for cols in (1, 64):
            out = tile_walk(pg, q.numpy(), r.numpy(), n, damping, cols)
            for a, b in zip(out, (pq, pr, pb)):
                assert torch.equal(torch.as_tensor(a), b), (n, cols)


# ---------------------------------------------------------------------------
# the wrapper's CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``packed_maxsum_coop``: records each
    call's arguments and its barrier word as it finds it, leaves the word
    dirty, writes 1 into every entry of q_a and 2 into q_b (the buffers of
    even and odd cycles) and 0 into the beliefs, and returns ``rc``."""

    def __init__(self, pg, rc=0):
        self.pg, self.rc, self.calls, self.bars = pg, rc, [], []

    def __call__(self, *args):
        self.calls.append(args)
        word = ctypes.c_uint32.from_address(args[-2])
        self.bars.append(word.value)
        word.value = 7
        pg = self.pg
        for ptr, value, size in ((args[1], 1.0, pg.D * pg.N),
                                 (args[2], 2.0, pg.D * pg.N),
                                 (args[5], 0.0, pg.D * pg.Vp)):
            (ctypes.c_float * size).from_address(ptr)[:] = [value] * size
        return self.rc


def cuda_branch(monkeypatch, entry, capacity=2112, cap=264):
    """Run the CUDA branch of ``packed_cycles`` on CPU tensors with
    ``entry`` as its kernel, on counters of its own (zero, restored after
    the test) and the grid cap ``cap``; the plain version must not run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    asked = []

    def kernel(mixed):
        asked.append(mixed)
        return entry

    monkeypatch.setattr(PM, "_kernel", kernel)
    monkeypatch.setattr(PM, "_binary_capacity",
                        lambda D, threads, cols: capacity)
    monkeypatch.setattr(PM, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(PM, "packed_cycles_plain", never)
    monkeypatch.setattr(PM, "_plain_cycle", never)
    monkeypatch.setattr(PM, "BINARY_GRID_CAP", cap)
    monkeypatch.setattr(PM.packed_cycles, "launches", 0)
    monkeypatch.setattr(PM.packed_cycles, "mixed_launches", 0)
    return asked


def launch(pg, q, r, n=3, damping=0.5, blocks=None):
    return PM._launch_cycles(pg, q, r, n, damping, blocks)


@pytest.mark.parametrize("capacity,cap", [(2112, 264), (2112, 10 ** 6),
                                          (2, 264), (1, 264), (2112, 1)])
@pytest.mark.parametrize("graph", ["coloring", "star"])
def test_launch_grid_and_forced_grids(monkeypatch, graph, capacity, cap):
    """The grid: one block a tile, at most the capacity and the cap, at
    least 1; a forced grid goes to the entry as it is, from 1 to the
    capacity, and one out of that range is refused before any launch."""
    pg = packed(graph)
    entry = StandInEntry(pg)
    cuda_branch(monkeypatch, entry, capacity, cap)
    q, r = start(pg)
    launch(pg, q, r)
    n_tiles = PM.tile_table(pg, PM.TILE_COLS).shape[0]
    want = max(1, min(capacity, n_tiles, cap))
    assert entry.calls[0][-7] == want == PM.binary_blocks(n_tiles, capacity)
    for blocks in (1, capacity):
        launch(pg, q, r, blocks=blocks)
        assert entry.calls[-1][-7] == blocks
    for blocks in (0, capacity + 1):
        with pytest.raises(ValueError, match="capacity"):
            launch(pg, q, r, blocks=blocks)
    assert len(entry.calls) == 3
    assert PM.packed_cycles.launches == 3


def test_no_resident_block_raises_without_launching(monkeypatch):
    pg = packed("coloring")
    entry = StandInEntry(pg)
    cuda_branch(monkeypatch, entry, capacity=0)
    with pytest.raises(RuntimeError, match="no resident block"):
        launch(pg, *start(pg))
    assert entry.calls == []
    assert PM.packed_cycles.launches == 0


@pytest.mark.parametrize("rc", [1, 720])
def test_failed_launch_raises_and_counts_nothing(monkeypatch, rc):
    pg = packed("coloring")
    entry = StandInEntry(pg, rc)
    cuda_branch(monkeypatch, entry)
    with pytest.raises(RuntimeError, match=f"packed_maxsum_coop launch "
                       f"failed: CUDA error {rc}"):
        launch(pg, *start(pg))
    assert len(entry.calls) == 1
    assert PM.packed_cycles.launches == 0
    assert PM.packed_cycles.mixed_launches == 0


@pytest.mark.parametrize("damping", [0.5, 0.0])
@pytest.mark.parametrize("graph", ["coloring", "sparse"])
def test_each_call_one_launch_own_barrier_word(monkeypatch, graph,
                                                damping):
    """Each call: one launch of the binary entry, counted once whatever n,
    with a barrier word of its own, zero although the call before left
    its word dirty; q and r unchanged; the operands in the entry's order
    (q, the two q buffers, r, r_out, beliefs, the layout, the tile table,
    its rows and width, D, N, Vp, n, the grid, the threads, damping,
    1 - damping and its flag)."""
    pg = packed(graph)
    entry = StandInEntry(pg)
    asked = cuda_branch(monkeypatch, entry)
    for k, n in enumerate((1, 2, 3, 100)):
        q, r = start(pg, seed=k)
        keep = q.clone(), r.clone()
        out_q, out_r, bel, _ = launch(pg, q, r, n, damping)
        assert torch.equal(q, keep[0]) and torch.equal(r, keep[1])
        args = entry.calls[-1]
        assert args[0] == q.data_ptr() and args[3] == r.data_ptr()
        assert out_q.data_ptr() in args[1:3]
        assert out_r.data_ptr() == args[4] and bel.data_ptr() == args[5]
        assert len(set(args[:6])) == 6  # six distinct buffers
        tiles = pg.tile_tables[PM.TILE_COLS]
        assert args[6:12] == (
            pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
            pg.vmask.data_ptr(), pg.inv_dcount.data_ptr(),
            pg.mate.data_ptr(), tiles.data_ptr())
        assert args[12:17] == (tiles.shape[0], PM.TILE_COLS, pg.D, pg.N,
                               pg.Vp)
        assert args[17:20] == (n, PM.binary_blocks(tiles.shape[0], 2112),
                               PM.BINARY_THREADS)
        assert args[20:23] == (damping, 1.0 - damping, int(damping != 0))
        assert entry.bars[-1] == 0
        assert PM.packed_cycles.launches == k + 1
        assert PM.packed_cycles.mixed_launches == 0
    assert set(asked) == {False}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_result_comes_from_the_last_cycles_buffer(monkeypatch, n):
    """Cycle i writes q_a for even i and q_b for odd i: the result of n
    cycles is q_a for odd n and q_b for even n."""
    pg = packed("coloring")
    entry = StandInEntry(pg)
    cuda_branch(monkeypatch, entry)
    out_q = launch(pg, *start(pg), n)[0]
    args = entry.calls[-1]
    assert out_q.data_ptr() == args[1 if n % 2 else 2]
    assert torch.equal(out_q, torch.full_like(out_q, 1.0 if n % 2 else 2.0))


def test_mixed_layout_refuses_a_forced_grid(monkeypatch):
    """``blocks`` forces the binary kernel's grid only: the mixed kernel
    sizes its own, and a forced grid there is refused before any
    launch."""
    mixed = PM.pack_mixed_for_gpu(C.star_tensors(50, "cpu"),
                                  all_binary=True)
    entry = StandInEntry(mixed)
    cuda_branch(monkeypatch, entry)
    with pytest.raises(ValueError, match="binary kernel's grid"):
        launch(mixed, *start(mixed), blocks=3)
    assert entry.calls == []


def test_cpu_runs_the_plain_version_and_counts_nothing():
    """On CPU tensors packed_cycles is the plain version at any
    ``blocks`` (it has no use there), and no launch is counted."""
    pg = packed("unequal")
    q, r = start(pg)
    before = PM.packed_cycles.launches, PM.packed_cycles.mixed_launches
    want = PM.packed_cycles_plain(pg, q, r, 5, 0.5)
    for blocks in (None, 1, 3):
        got = PM.packed_cycles(pg, q, r, 5, 0.5, blocks=blocks)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (PM.packed_cycles.launches,
            PM.packed_cycles.mixed_launches) == before


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_kernel_matches_plain_on_gpu(graph):
    """torch.equal with the plain version on q, r, beliefs and values at
    damping 0.5 and 0, at the wrapper's grid and at 1 and 3 blocks, after
    1, 2, 3 and 20 cycles in one call (one launch) and in two."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pg = packed(graph, "cuda")
    for seed in range(2):
        q, r = start(pg, seed)
        for damping in (0.5, 0.0):
            for n in (1, 2, 3, 20):
                want = PM.packed_cycles_plain(pg, q, r, n, damping)
                for blocks in (None, 1, 3):
                    before = PM.packed_cycles.launches
                    got = PM.packed_cycles(pg, q, r, n, damping,
                                           blocks=blocks)
                    assert PM.packed_cycles.launches == before + 1
                    for a, b in zip(got, want):
                        assert torch.equal(a, b), (graph, damping, n,
                                                   blocks)
                    if n < 2:
                        continue
                    hq, hr, _, _ = PM.packed_cycles(pg, q, r, n // 2,
                                                    damping, blocks=blocks)
                    two = PM.packed_cycles(pg, hq, hr, n - n // 2, damping,
                                           blocks=blocks)
                    for a, b in zip(two, want):
                        assert torch.equal(a, b), (graph, damping, n,
                                                   blocks, "two calls")
    torch.cuda.synchronize()
