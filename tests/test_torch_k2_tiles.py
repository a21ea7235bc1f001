"""K2, the local-tables kernel of ``csrc/local_search.cu``
(``ls_tables_kernel``: ONE launch a ``packed_local_tables`` call, blocks
taking tiles of neighbouring columns grid-stride, a tile's (rank, column)
units staged in shared memory, then one thread a column summing its ranks
in order; x ``[V]`` and the tables ``[V, D]`` in variable order).

Here, on the CPU: the tile table on the mixed layout (every column in one
tile, every slot in one (rank, column) unit); the variable-order plain
version against the column-order one; a walk of the tiles in the kernel's
order (slabs of ranks, the rank-order sum from 0, the variable-order
store, no absent sibling read) that must give the plain version's numbers
bit for bit, at several tile widths and slab sizes; and the wrapper's CUDA
branch run on CPU tensors with stand-in C entries (the operands in the
entry's order, the tile width from the device's wave, the grid and a
forced one, a refused launch, one launch counted a call, no gather or copy
around the launch).

On the card (``cuda``-marked, skipped here): both branches against their
plain versions under ``torch.equal``, at the wrapper's grid and at forced
grids of 1 and 3 blocks, on the degree-2,500 star, on graphs with
degree-0 columns, and replayed from a captured CUDA graph.  This file imports no JAX: the plain versions are
held to the JAX package in ``test_torch_local_search.py`` and
``test_torch_local_search_mixed.py``.
"""
import ctypes
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops import packed_maxsum as PM
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    compile_binary_from_arrays,
    compile_constraint_graph,
    local_cost_tables,
)

torch.set_num_threads(1)

#: shared-memory units of the kernel's slab (csrc/local_search.cu
#: kSlabUnits)
SLAB_UNITS = 1024
#: a wave of 1,056 tiles: 8 resident blocks on each of 132 SMs
WAVE = 1056


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


def mixed(V, counts, device, seed=12, **kw):
    """Arity 1-4 at D = 4 (``chip_smoke.mixed_dcop``)."""
    return compile_constraint_graph(
        C.mixed_dcop(V, 4, counts, seed=seed, **kw), device=device)


#: the graphs of the checks: binary (the bench colouring, the star with a
#: hub of degree 2,500, unequal domains, columns without slots) and mixed
#: (ragged domains, a hub of 150 factors, columns without slots)
GRAPHS = {
    "coloring": lambda dev: bench_colouring(1000, 3000, dev),
    "star": lambda dev: C.star_tensors(2500, dev),
    "unequal": lambda dev: C.unequal_domains_tensors(500, 1500, 4, dev),
    "sparse": lambda dev: colouring(400, 150, dev),
    "mixed_ragged": lambda dev: mixed(
        300, {1: 60, 2: 300, 3: 120, 4: 30}, dev, ragged=True),
    "mixed_hub": lambda dev: mixed(200, {1: 20, 2: 100, 3: 50}, dev,
                                   hub=True),
    "mixed_sparse": lambda dev: mixed(400, {1: 10, 2: 40, 3: 20, 4: 5},
                                      dev),
}
MIXED = sorted(g for g in GRAPHS if g.startswith("mixed"))


def packed(graph, device="cpu"):
    pls = P.pack_local_search(GRAPHS[graph](device))
    assert pls is not None
    assert (pls.pg.mixed is not None) == graph.startswith("mixed")
    return pls


def start(pls, seed=1):
    """A random valid x, in column order and in variable order."""
    x_col = C.random_x_col(pls, seed)
    return x_col, P.unpack_x(pls, x_col)


# ---------------------------------------------------------------------------
# the tile table on the mixed layout, and the two plain forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cols", [1, 32, 64, 128])
@pytest.mark.parametrize("graph", MIXED)
def test_tile_table_covers_every_mixed_slot_once(graph, cols):
    """On the mixed layout too every column lies in one tile of at most
    ``cols`` columns of its degree, and every slot is the (rank, column)
    unit of one tile: the column's slot of that rank."""
    pls = packed(graph)
    pg = pls.pg
    tiles = PM.tile_table(pg, cols)
    deg = pg.col_deg.numpy()
    slot0, stride = pg.col_slot0.numpy(), pg.col_stride.numpy()
    slot_col = pg.slot_col.numpy()
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
            assert np.array_equal(slot_col[s], col)
            slots_seen[s] += 1
    assert np.all(cols_seen == 1)
    assert np.all(slots_seen == 1)
    if graph == "mixed_sparse":
        assert (tiles[:, 2] == 0).any()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_variable_order_plain_is_the_column_order_plain_permuted(graph):
    t = GRAPHS[graph]("cpu")
    pls = P.pack_local_search(t)
    x_col, x = start(pls)
    got = P.packed_local_tables_plain(pls, x)
    col = P.ls_tables_plain(pls, x_col)[0]
    assert got.shape == (pls.Vp, pls.D) and got.is_contiguous()
    assert torch.equal(got, col[:, pls.pg.var_order].T)
    assert torch.equal(got[pls.col_var.long()], col.T)
    # the wrapper runs the plain version here, from any integer dtype
    assert torch.equal(P.packed_local_tables(pls, x.long()), got)
    assert torch.equal(P.packed_local_tables(pls, x.numpy()), got)
    # and the generic engine's tables, another order of the adds
    gen = local_cost_tables(t, x)
    assert torch.allclose(got, gen, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel's schedule, walked on the CPU
# ---------------------------------------------------------------------------


def slot_costs(pls, x, s):
    """[D, len(s)] cost floats of slots ``s`` at x ([V], variable order),
    as a unit loads them: the siblings read at their variables, and only
    where the slot's arity has that sibling."""
    pg = pls.pg
    D = pg.D
    d = torch.arange(D)[:, None]
    sibs = [idx for _, idx in pls.siblings()]
    xl = x.long()
    if pg.mixed is None:
        xm = xl[sibs[0].long()[s]]
        return pg.cost_rows[xm[None, :] * D + d, s[None, :]]
    m = pg.mixed
    a = m.arity.long()[s]
    row = torch.zeros_like(s)
    for r in range(3):
        has = a >= r + 2
        # an absent sibling holds NO_INDEX: indexing x with it would
        # fail, so it must never be read
        sib = sibs[r].long()[s[has]]
        assert bool((sib >= 0).all()) and bool((sib < pls.Vp).all())
        row[has] = row[has] * D + xl[sib]
    ci = m.cost_idx.long()[s]
    out = torch.empty((D, len(s)), dtype=torch.float32)
    for ar, cost in enumerate(m.costs, 1):
        on = a == ar
        if bool(on.any()):
            out[:, on] = cost[row[on][None, :] * D + d, ci[on][None, :]]
    return out


def tile_walk(pls, x, cols, slab_units=SLAB_UNITS):
    """The kernel's arithmetic, tile by tile in its order: slabs of
    slab_units // width ranks staged, each column's running sum from 0
    over its ranks in order (float32), then unary + sum under the mask or
    PAD_COST, stored at the column's variable's row."""
    pg = pls.pg
    D, Vp = pg.D, pg.Vp
    out = torch.full((Vp, D), float("nan"))
    for c0, width, deg, s0, step in PM.tile_table(pg, cols).tolist():
        c = torch.arange(c0, c0 + width)
        acc = torch.zeros((D, width), dtype=torch.float32)
        ranks = slab_units // width
        for k0 in range(0, deg, ranks):
            nk = min(ranks, deg - k0)
            u = torch.arange(nk * width)
            s = s0 + (k0 + u // width) * step + u % width
            sh = slot_costs(pls, x, s).reshape(D, nk, width)
            for k in range(nk):
                acc = acc + sh[:, k, :]
        t = torch.where(pg.mask_p[:, c] > 0, pg.unary_p[:, c] + acc,
                        torch.tensor(PAD_COST, dtype=torch.float32))
        out[pls.col_var.long()[c]] = t.T
    return out


@pytest.mark.parametrize("cols,slab", [(1, SLAB_UNITS), (7, SLAB_UNITS),
                                       (64, SLAB_UNITS), (128, SLAB_UNITS),
                                       (64, 128), (5, 16)])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_walk_gives_the_plain_numbers(graph, cols, slab):
    """Bit for bit, at several tile widths and slab sizes (a slab of 16
    units runs the star's hub, and every tile of degree above 16 //
    width, in slabs), from two assignments."""
    pls = packed(graph)
    for seed in (1, 2):
        _, x = start(pls, seed)
        assert torch.equal(tile_walk(pls, x, cols, slab),
                           P.packed_local_tables_plain(pls, x))


# ---------------------------------------------------------------------------
# the wrappers' CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``ls_tables(_mixed)``: records each
    call's arguments, writes ``tables`` where the call's pointer says,
    and returns ``rc``."""

    def __init__(self, tables=None, rc=0):
        self.tables, self.rc, self.calls = tables, rc, []

    def __call__(self, *args):
        self.calls.append(args)
        if self.tables is not None:
            ctypes.memmove(args[1], self.tables.data_ptr(),
                           self.tables.numel() * self.tables.element_size())
        return self.rc


def cuda_branch(monkeypatch, entry, on_cuda=False, wave=WAVE):
    """Route K2's launches to ``entry`` on CPU tensors, on counters of
    its own (zero, restored after the test), its capacity query to a
    stand-in reporting ``wave`` blocks (each query's arguments go to the
    returned list ``asked``); ``on_cuda`` also makes the public wrapper
    take its CUDA branch.  Neither plain version nor pack_x may run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    names, asked = [], []

    def capacity(*args):
        asked.append(args)
        return wave

    def kernel(name):
        if name == "tables_capacity":
            return capacity
        names.append(name)
        return entry

    monkeypatch.setattr(P, "_kernel", kernel)
    monkeypatch.setattr(P, "_waves", {})
    monkeypatch.setattr(P, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(P, "ls_tables_plain", never)
    monkeypatch.setattr(P, "packed_local_tables_plain", never)
    monkeypatch.setattr(P, "pack_x", never)
    monkeypatch.setattr(P.packed_local_tables, "launches", 0)
    monkeypatch.setattr(P.packed_local_tables, "mixed_launches", 0)
    if on_cuda:
        # the operand checks still run; their "on the CPU" answer is
        # taken as "on the card"
        real = P._on
        monkeypatch.setattr(P, "_on", lambda *a: real(*a) or True)
    return names, asked


def expected_args(pls, x, tables, blocks, wave=WAVE):
    """The operands the wrapper must pass, in the entry's order."""
    pg = pls.pg
    cols = P.tables_tile_cols(pg, wave)
    tiles = pg.tile_tables[cols]
    sibs = [idx.data_ptr() for _, idx in pls.siblings()]
    head = (x.data_ptr(), tables.data_ptr())
    tail = (pls.col_var.data_ptr(), tiles.data_ptr(), tiles.shape[0],
            cols, pg.D, pg.N, pg.Vp)
    flags = (blocks, P.TABLES_THREADS)
    if pg.mixed is None:
        return (*head, pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
                pg.mask_p.data_ptr(), *sibs, *tail, *flags)
    m = pg.mixed
    return (*head, *(c.data_ptr() for c in m.costs), m.arity.data_ptr(),
            m.cost_idx.data_ptr(), *sibs, pg.unary_p.data_ptr(),
            pg.mask_p.data_ptr(), *tail,
            *(int(sl.numel()) for sl in m.slots), *flags)


@pytest.mark.parametrize("graph", ["coloring", "mixed_ragged"])
def test_solve_path_form_is_one_launch_and_nothing_around_it(monkeypatch,
                                                            graph):
    """``packed_local_tables`` on the card: one launch of the layout's
    entry, x passed as it is (no pack_x, no gather, no transpose: the
    result is the entry's own output), the tiles at the width the wave
    gives, one block a tile, counted once."""
    pls = packed(graph)
    x_col, x = start(pls)
    want = P.packed_local_tables_plain(pls, x)
    entry = StandInEntry(tables=want)
    names, _ = cuda_branch(monkeypatch, entry, on_cuda=True)
    got = P.packed_local_tables(pls, x)
    assert torch.equal(got, want)
    assert len(entry.calls) == 1
    mixed = pls.pg.mixed is not None
    assert names == ["ls_tables_mixed" if mixed else "ls_tables"]
    args = entry.calls[0]
    assert args[0] == x.data_ptr() and args[1] == got.data_ptr()
    n_tiles = PM.tile_table(pls.pg, P.tables_tile_cols(pls.pg, WAVE)
                            ).shape[0]
    assert args[:-1] == expected_args(pls, x, got, n_tiles)
    assert (P.packed_local_tables.launches,
            P.packed_local_tables.mixed_launches) == \
        ((0, 1) if mixed else (1, 0))


@pytest.mark.parametrize("graph", ["sparse", "mixed_sparse"])
def test_tile_width_follows_the_devices_wave(monkeypatch, graph):
    """The wave is the kernel's resident blocks as the device reports
    them for the layout's branch, D and threads, asked once per device
    and shape; the tile width is the narrowest whose tiles fit it; a
    device that reports none is refused before any launch."""
    pls = packed(graph)
    _, x = start(pls)
    mixed = pls.pg.mixed is not None
    n = {c: PM.tile_table(pls.pg, c).shape[0] for c in P.TABLES_TILE_WIDTHS}
    wave = n[P.TABLES_TILE_WIDTHS[0]] - 1  # the narrowest does not fit
    entry = StandInEntry()
    _, asked = cuda_branch(monkeypatch, entry, wave=wave)
    out = torch.empty((pls.Vp, pls.D))
    for _ in range(2):
        P._launch_tables(pls, x, out)
    assert asked == [(pls.D, int(mixed), P.TABLES_THREADS)]
    cols = P.tables_tile_cols(pls.pg, wave)
    assert cols > P.TABLES_TILE_WIDTHS[0]
    assert entry.calls[-1][:-1] == expected_args(pls, x, out, n[cols], wave)
    monkeypatch.setattr(P, "TABLES_THREADS", 64)
    P._launch_tables(pls, x, out)
    assert asked[-1] == (pls.D, int(mixed), 64)
    _, asked = cuda_branch(monkeypatch, entry, wave=0)
    with pytest.raises(RuntimeError, match="no resident block"):
        P._launch_tables(pls, x, out)
    assert len(entry.calls) == 3
    assert P.packed_local_tables.launches == \
        P.packed_local_tables.mixed_launches == 0


@pytest.mark.parametrize("graph", ["coloring", "mixed_hub"])
def test_grid_tiles_and_forced_grids(monkeypatch, graph):
    """One block a tile by default; a forced grid goes to the entry as it
    is; a grid below 1 is refused before any launch; the tile table is
    built once per width and follows the widths and threads set."""
    pls = packed(graph)
    x_col, x = start(pls)
    entry = StandInEntry()
    cuda_branch(monkeypatch, entry)
    out = torch.empty((pls.Vp, pls.D))
    P._launch_tables(pls, x, out)
    n_tiles = PM.tile_table(pls.pg, P.tables_tile_cols(pls.pg, WAVE)
                            ).shape[0]
    assert entry.calls[0][:-1] == expected_args(pls, x, out, n_tiles)
    for blocks in (1, 3, 10_000):
        P._launch_tables(pls, x, out, blocks=blocks)
        assert entry.calls[-1][-3] == blocks
    with pytest.raises(ValueError, match="at least 1"):
        P._launch_tables(pls, x, out, blocks=0)
    assert len(entry.calls) == 4
    tiles = pls.pg.tile_tables[P.tables_tile_cols(pls.pg, WAVE)]
    monkeypatch.setattr(P, "TABLES_TILE_WIDTHS", (7,))
    monkeypatch.setattr(P, "TABLES_THREADS", 64)
    P._launch_tables(pls, x, out)
    assert pls.pg.tile_tables[7] is not tiles
    assert entry.calls[-1][-2] == 64
    assert entry.calls[-1][-11 if pls.pg.mixed is not None else -7] == 7
    assert P._tiles(pls.pg, 32) is tiles


@pytest.mark.parametrize("graph", ["coloring", "mixed_ragged", "star"])
def test_tile_width_is_the_narrowest_that_fits_one_wave(graph):
    """tables_tile_cols: the narrowest width whose tiles fit one wave,
    else the widest; at a wave of WAVE tiles every graph here takes the
    narrowest."""
    pg = packed(graph).pg
    widths = P.TABLES_TILE_WIDTHS
    n = {c: PM.tile_table(pg, c).shape[0] for c in widths}
    assert P.tables_tile_cols(pg, WAVE) == widths[0] and \
        n[widths[0]] <= WAVE
    for wave in sorted(set(n.values())):
        cols = P.tables_tile_cols(pg, wave)
        assert n[cols] <= wave
        assert all(n[c] > wave for c in widths if c < cols)
    assert P.tables_tile_cols(pg, min(n.values()) - 1) == widths[-1]


@pytest.mark.parametrize("rc", [1, 720])
@pytest.mark.parametrize("graph", ["coloring", "mixed_ragged"])
def test_failed_launch_raises_and_counts_nothing(monkeypatch, graph, rc):
    pls = packed(graph)
    x_col, x = start(pls)
    cuda_branch(monkeypatch, StandInEntry(rc=rc))
    name = "ls_tables_mixed" if pls.pg.mixed is not None else "ls_tables"
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                       f"error {rc}"):
        P._launch_tables(pls, x, torch.empty((pls.Vp, pls.D)))
    assert P.packed_local_tables.launches == \
        P.packed_local_tables.mixed_launches == 0


def test_cpu_runs_the_plain_versions_and_counts_nothing():
    pls = packed("mixed_ragged")
    x_col, x = start(pls)
    P.reset_launches()
    want = P.packed_local_tables_plain(pls, x)
    for blocks in (None, 1):
        assert torch.equal(P.packed_local_tables(pls, x, blocks=blocks),
                           want)
    assert P.packed_local_tables.launches == \
        P.packed_local_tables.mixed_launches == 0
    with pytest.raises(ValueError, match="shape"):
        P.packed_local_tables(pls, x[:-1])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_kernel_matches_plain_on_gpu(graph):
    """At the wrapper's grid and at forced grids of 1 and 3 blocks, equal
    to the plain version (torch.equal), from two assignments; the device
    reports a wave."""
    _need_gpu()
    pls = packed(graph, "cuda")
    assert P.tables_wave(pls.device, pls.D, pls.pg.mixed is not None,
                         P.TABLES_THREADS) > 0
    for seed in (1, 2):
        _, x = start(pls, seed)
        want = P.packed_local_tables_plain(pls, x)
        for blocks in (None, 1, 3):
            assert torch.equal(P.packed_local_tables(pls, x, blocks=blocks),
                               want)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["coloring", "mixed_ragged"])
def test_kernel_replays_from_a_captured_graph(graph):
    """The solve path's form captured in a CUDA graph: each replay at a
    new x (copied into the captured input) equals the plain version, and
    the graph holds one launch."""
    _need_gpu()
    pls = packed(graph, "cuda")
    _, x = start(pls)
    x_in = x.clone()
    P.packed_local_tables(pls, x_in)  # builds the tile table
    torch.cuda.synchronize()
    before = sum((P.packed_local_tables.launches,
                  P.packed_local_tables.mixed_launches))
    graph_ = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_):
        out = P.packed_local_tables(pls, x_in)
    assert sum((P.packed_local_tables.launches,
                P.packed_local_tables.mixed_launches)) == before + 1
    for seed in (2, 3):
        x_in.copy_(start(pls, seed)[1])
        graph_.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, P.packed_local_tables_plain(pls, x_in))
