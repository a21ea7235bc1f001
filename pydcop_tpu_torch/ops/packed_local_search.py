"""Packed local-search engine on the GPU layouts (all-binary and mixed
arity 1-4).

The counterpart of the JAX package's ``ops/pallas_local_search.py``
(``pack_local_search``/``move_extras``, ``packed_mgm_cycles``,
``packed_dsa_cycles``) and of ``ops/pallas_maxsum.py::packed_local_tables``,
on the var-grouped slot layouts of
:func:`~pydcop_tpu_torch.ops.packed_maxsum.pack_for_gpu` (an all-binary
constraints hypergraph IS an all-binary factor graph: a slot's factor
mate is the neighbour on the other end; a mixed graph's slot has up to
three siblings).

On top of that layout local search needs, per slot, the column of each
sibling (``mate_col``, and on the mixed layout ``mate2_col``/``mate3_col``,
-1 where the slot's factor has no such sibling — a unary slot has none),
so a thread reads a neighbour's value or gain with one indexed load, and
each sibling's original variable index (``mate_idx``/``mate2_idx``/
``mate3_idx``, MGM's static lexic tie-break, ``NO_INDEX`` where absent),
and per column its original variable (``col_var``).  The assignment is
int32 ``[Vp]`` in column order (:func:`pack_x` / :func:`unpack_x`); coins
are ``[n, Vp]`` float32 in column order (:func:`pack_uniforms`).

Three hand-written CUDA kernels (``csrc/local_search.cu``, each with a
binary and a mixed branch), each behind a wrapper with a launch counter
per branch and a plain PyTorch version doing the same arithmetic in the
same order:

* :func:`packed_local_tables` — K2, local cost tables, one launch a call
  of a kernel that takes the tiles of
  :func:`~pydcop_tpu_torch.ops.packed_maxsum.tile_table`, in the JAX
  function's form (x ``[V]`` and the tables ``[V, D]`` in variable
  order);
* :func:`packed_mgm_cycles` — n MGM cycles: ONE cooperative launch a
  call, each cycle's tables and neighbourhood arbitration two phases of
  the grid split by a grid barrier (MGM reads its neighbours' gains of
  the same cycle);
* :func:`packed_dsa_cycles` — n DSA-family cycles: ONE cooperative
  launch a call, each cycle one phase of the grid (DSA reads other
  columns only through the previous cycle's x), a grid barrier between
  consecutive cycles.

A wrapper runs its plain version only for CPU tensors; on CUDA tensors it
launches the kernel or raises — nothing falls back.  The assignment is
double-buffered across cycles.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.ops.packed_maxsum import (
    ARITIES,
    MAX_D,
    PackedMaxSumGraph,
    _tiles,
    pack_for_gpu,
)

#: hard-constraint threshold (algorithms/_local_search.HARD_THRESHOLD)
HARD = 10000.0
#: the prefer-change nudge and the gain/tie epsilon of the JAX package
NUDGE = 1e-6
EPS = 1e-9
#: tie-break sentinel of a column with no neighbour at the max
NO_INDEX = torch.iinfo(torch.int32).max
VARIANTS = {"A": 0, "B": 1, "C": 2}
#: K2's launch shape, chosen from a sweep on an H100 (PERF.md, K2):
#: threads a block, and the tile widths a layout's tiles take (at most
#: the threads; :func:`tables_tile_cols` picks one for the kernel's wave,
#: :func:`tables_wave`)
TABLES_THREADS = 128
TABLES_TILE_WIDTHS = (32, 64, 128)


@dataclass
class PackedLocalSearch:
    """The packed layout plus the per-slot arrays local search needs."""

    pg: PackedMaxSumGraph
    #: [N] int32 column of each slot's (first) sibling; -1 on unary slots
    mate_col: torch.Tensor
    mate_idx: torch.Tensor  # [N] int32 original variable of that column
    col_var: torch.Tensor  # [Vp] int32 original variable of each column
    #: mixed layout only: the second and third siblings' columns (-1
    #: where absent) and original variables (NO_INDEX where absent)
    mate2_col: Optional[torch.Tensor] = None
    mate3_col: Optional[torch.Tensor] = None
    mate2_idx: Optional[torch.Tensor] = None
    mate3_idx: Optional[torch.Tensor] = None

    @property
    def D(self) -> int:
        return self.pg.D

    @property
    def Vp(self) -> int:
        return self.pg.Vp

    @property
    def N(self) -> int:
        return self.pg.N

    @property
    def device(self) -> torch.device:
        return self.pg.device

    def siblings(self):
        """[(column [N], variable [N])] of each sibling rank the layout
        has: one on the binary layout, three on the mixed one."""
        out = [(self.mate_col, self.mate_idx)]
        if self.mate2_col is not None:
            out += [(self.mate2_col, self.mate2_idx),
                    (self.mate3_col, self.mate3_idx)]
        return out


def pack_from_pg(pg: Optional[PackedMaxSumGraph]
                 ) -> Optional[PackedLocalSearch]:
    if pg is None:
        return None
    col_var = torch.empty_like(pg.var_order)
    col_var[pg.var_order] = torch.arange(pg.Vp, device=pg.device)

    def sibling(mate):
        """(column, variable) of the slots ``mate`` (-1 = none)."""
        m = mate.long()
        col = torch.where(m >= 0, pg.slot_col[m.clamp_min(0)], -1)
        idx = torch.where(col >= 0, col_var[col.clamp_min(0)], NO_INDEX)
        return col.int().contiguous(), idx.int().contiguous()

    mate_col, mate_idx = sibling(pg.mate)
    extra = {}
    if pg.mixed is not None:
        extra["mate2_col"], extra["mate2_idx"] = sibling(pg.mixed.mate2)
        extra["mate3_col"], extra["mate3_idx"] = sibling(pg.mixed.mate3)
    return PackedLocalSearch(pg=pg, mate_col=mate_col, mate_idx=mate_idx,
                             col_var=col_var.int().contiguous(), **extra)


def pack_local_search(t: FactorGraphTensors
                      ) -> Optional[PackedLocalSearch]:
    """The packed local-search layout of ``t`` on ``t``'s device, or None
    when the graph does not pack (see :func:`pack_for_gpu`)."""
    return pack_from_pg(pack_for_gpu(t))


def pack_x(pls: PackedLocalSearch, x) -> torch.Tensor:
    """[V] value indices in variable order (a tensor or a numpy array) →
    int32 [Vp] column order, on the layout's device."""
    x = torch.as_tensor(x, device=pls.device)
    return x.to(torch.int32)[pls.col_var.long()].contiguous()


def unpack_x(pls: PackedLocalSearch, x_col: torch.Tensor) -> torch.Tensor:
    """int32 [Vp] column order → int32 [V] variable order."""
    return x_col[pls.pg.var_order]


def pack_uniforms(pls: PackedLocalSearch, u) -> torch.Tensor:
    """[n, V] coins in variable order (a tensor or a numpy array) →
    float32 [n, Vp] column order, on the layout's device."""
    u = torch.as_tensor(u, device=pls.device)
    return u.to(torch.float32)[:, pls.col_var.long()].contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, in their order)
# ---------------------------------------------------------------------------


def _per_column(pls, slot_vals, combine, fill):
    """Combine each column's slot values in slot order, rank by rank,
    from ``fill`` (which degree-0 columns keep)."""
    lead = tuple(slot_vals.shape[:-1])
    out = torch.full(lead + (pls.Vp,), fill, dtype=slot_vals.dtype,
                     device=slot_vals.device)
    for deg, nvp, voff, soff in pls.pg.buckets:
        block = slot_vals[..., soff: soff + deg * nvp]
        block = block.reshape(lead + (deg, nvp))
        part = torch.full_like(block[..., 0, :], fill)
        for k in range(deg):
            part = combine(part, block[..., k, :])
        out[..., voff: voff + nvp] = part
    return out


def _slot_costs(pls: PackedLocalSearch, xl: torch.Tensor) -> torch.Tensor:
    """[D, N] each slot's cost row at its siblings' current values."""
    pg = pls.pg
    D = pg.D
    d = torch.arange(D, device=xl.device)[:, None]
    if pg.mixed is None:
        xm = xl[pls.mate_col.long()]  # the mate's value at each slot
        return pg.cost_rows.gather(0, xm[None, :] * D + d)
    out = torch.empty((D, pg.N), dtype=torch.float32, device=xl.device)
    sib_cols = [c.long() for c, _ in pls.siblings()]
    for a, sl, cost in zip(ARITIES, pg.mixed.slots, pg.mixed.costs):
        if sl.numel() == 0:
            continue
        # row of the siblings' values: x1, (x1*D + x2), ((x1*D+x2)*D+x3)
        row = torch.zeros_like(sl)
        for col in sib_cols[:a - 1]:
            row = row * D + xl[col[sl]]
        out[:, sl] = cost.gather(0, row[None, :] * D + d)
    return out


def ls_tables_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                    prefer_change: bool = False):
    """(tables [D, Vp] with PAD_COST at invalid values, cur [Vp], best
    [Vp] int32, gain [Vp]) at assignment ``x_col``."""
    pg = pls.pg
    xl = x_col.long()
    acc = _per_column(pls, _slot_costs(pls, xl), torch.add, 0.0)
    tables = torch.where(pg.mask_p > 0, pg.unary_p + acc, PAD_COST)
    cur = tables.gather(0, xl[None]).squeeze(0)
    pick = tables
    if prefer_change:
        nudge = torch.zeros_like(tables).scatter_(0, xl[None], NUDGE)
        pick = tables + nudge
    best = torch.argmin(pick, dim=0)  # first index of the minimum
    gain = torch.clamp_min(cur - tables.gather(0, best[None]).squeeze(0),
                           0.0)
    return tables, cur, best.to(torch.int32), gain


def packed_local_tables_plain(pls: PackedLocalSearch,
                              x: torch.Tensor) -> torch.Tensor:
    """[V, D] tables in variable order at the variable-order assignment
    ``x``: :func:`pack_x`, :func:`ls_tables_plain`, then the columns
    gathered back into variable order."""
    tables = ls_tables_plain(pls, pack_x(pls, x))[0]
    return tables[:, pls.pg.var_order].T.contiguous()


def mgm_move_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                   best: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """MGM's move: a column moves to ``best`` iff its gain is the strict
    maximum of its neighbourhood (every sibling of every slot), ties to
    the smallest original index."""
    eps = gain.new_tensor(EPS)
    sibs = [(c.long(), i) for c, i in pls.siblings()]
    # a sibling that does not exist routes gain 0 and index NO_INDEX
    g = [torch.where(c >= 0, gain[c.clamp_min(0)], 0.0) for c, _ in sibs]
    g_max = g[0]
    for gs in g[1:]:
        g_max = torch.maximum(g_max, gs)
    nm = _per_column(pls, g_max, torch.maximum, 0.0)
    thr = (nm - eps)[pls.pg.slot_col]
    cand = None
    for gs, (_, idx) in zip(g, sibs):
        cs = torch.where(gs >= thr, idx, torch.full_like(idx, NO_INDEX))
        cand = cs if cand is None else torch.minimum(cand, cs)
    idx = _per_column(pls, cand, torch.minimum, NO_INDEX)
    move = (gain > 0) & ((gain > nm + eps) | (
        ((gain - nm).abs() <= eps) & (pls.col_var < idx)))
    return torch.where(move, best, x_col)


def dsa_cycle_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                    u: torch.Tensor, probability: float, variant: str,
                    probability_hard: Optional[float] = None,
                    awake_u: Optional[torch.Tensor] = None,
                    activation: Optional[float] = None) -> torch.Tensor:
    """One DSA-family cycle (``pallas_local_search.py:617-636``)."""
    _, cur, best, gain = ls_tables_plain(pls, x_col, variant != "A")
    f32 = gain.new_tensor
    eps = f32(EPS)
    conflict = cur >= f32(HARD)
    improving = gain > eps
    lateral = (gain <= eps) & (best != x_col)
    if variant == "A":
        want = improving
    elif variant == "B":
        want = improving | (lateral & conflict)
    else:
        want = improving | lateral
    p = f32(probability)
    if probability_hard is not None:
        p = torch.where(conflict, f32(probability_hard), p)
    move = want & (u < p)
    if awake_u is not None:
        move = move & (awake_u < f32(activation))
    return torch.where(move, best, x_col)


def packed_mgm_cycles_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                            n_cycles: int) -> torch.Tensor:
    for _ in range(n_cycles):
        _, _, best, gain = ls_tables_plain(pls, x_col)
        x_col = mgm_move_plain(pls, x_col, best, gain)
    return x_col


def packed_dsa_cycles_plain(pls, x_col, uniforms, probability,
                            variant="B", probability_hard=None,
                            awake_uniforms=None, activation=None):
    for i in range(uniforms.shape[0]):
        x_col = dsa_cycle_plain(
            pls, x_col, uniforms[i], probability, variant,
            probability_hard,
            None if awake_uniforms is None else awake_uniforms[i],
            activation)
    return x_col


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_fns = {}


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/local_search.cu``, bound once."""
    if name not in _fns:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        argtypes = {
            "ls_tables": [P] * 8 + [I] * 7 + [P],
            "mgm_cycles": [P] * 12 + [I] * 3 + [P] * 2 + [I, I, P, P],
            "dsa_cycles": [P] * 12 + [I] * 4 + [F, F, I, F]
            + [I, I, P, P],
            "ls_tables_mixed": [P] * 15 + [I] * 11 + [P],
            "tables_capacity": [I] * 3,
            "mgm_cycles_mixed": [P] * 19 + [I] * 7 + [P] * 4
            + [I, I, P, P],
            "dsa_cycles_mixed": [P] * 19 + [I] * 8 + [F, F, I, F]
            + [I, I, P, P],
        }[name]
        fn = getattr(load("local_search"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return _fns[name]


def _on(pls: PackedLocalSearch, name: str, x: torch.Tensor, dtype,
        shape) -> bool:
    """Check an operand; True when it lies on CUDA (launch the kernel),
    False on the CPU (run the plain version)."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != pls.device:
        raise ValueError(f"{name} is on {x.device} but the packed graph "
                         f"is on {pls.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the local-search kernels run on cuda or cpu, "
                         f"not {x.device}")
    if not 1 <= pls.D <= MAX_D:
        raise ValueError(f"the local-search kernels take D in [1, {MAX_D}]")
    return True


def _check_rule(variant, awake, activation) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown DSA variant {variant!r}")
    if (awake is None) != (activation is None):
        raise ValueError("awake uniforms and activation go together")


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _tables_layout(pls: PackedLocalSearch):
    """The layout operands of ``mgm_cycles`` and ``dsa_cycles`` (binary)
    or of their ``_mixed`` entries, after the state operands."""
    pg = pls.pg
    cols = (pg.col_deg.data_ptr(), pg.col_slot0.data_ptr(),
            pg.col_stride.data_ptr())
    if pg.mixed is None:
        return (pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
                pg.mask_p.data_ptr(), pls.mate_col.data_ptr(), *cols,
                pg.D, pg.N, pg.Vp)
    m = pg.mixed
    return (*(c.data_ptr() for c in m.costs), m.arity.data_ptr(),
            m.cost_idx.data_ptr(), pls.mate_col.data_ptr(),
            pls.mate2_col.data_ptr(), pls.mate3_col.data_ptr(),
            pg.unary_p.data_ptr(), pg.mask_p.data_ptr(), *cols,
            pg.D, pg.N, pg.Vp, *(int(sl.numel()) for sl in m.slots))


def _count(fn, pls: PackedLocalSearch) -> None:
    """One launch of ``fn``'s binary or mixed kernel."""
    if pls.pg.mixed is None:
        fn.launches += 1
    else:
        fn.mixed_launches += 1


_waves = {}


def tables_wave(device: torch.device, D: int, mixed: bool,
                threads: int) -> int:
    """Tiles of one wave of K2's kernel of one branch at domain size
    ``D`` on CUDA ``device``: the blocks of ``threads`` threads it holds
    resident at once, as the C entry ``tables_capacity`` reports them
    (its occupancy times the SMs); asked once per device and shape.  A
    device that reports none raises RuntimeError."""
    key = (device.index, D, mixed, threads)
    if key not in _waves:
        with torch.cuda.device(device):
            wave = _kernel("tables_capacity")(D, int(mixed), threads)
        if wave <= 0:
            raise RuntimeError("ls_tables: the device reports no resident "
                               "block")
        _waves[key] = wave
    return _waves[key]


def tables_tile_cols(pg: PackedMaxSumGraph, wave: int) -> int:
    """K2's tile width on layout ``pg``: the narrowest of
    :data:`TABLES_TILE_WIDTHS` whose tile table fits one ``wave`` of
    tiles (:func:`tables_wave`), else the widest.  Narrow tiles put more
    blocks on the SMs, but past one wave a block's chain of dependent
    loads is paid again (PERF.md, the K2 sweep).  Each width's table is
    built once per layout (:func:`~pydcop_tpu_torch.ops.packed_maxsum.
    tile_table`)."""
    for cols in TABLES_TILE_WIDTHS:
        if _tiles(pg, cols).shape[0] <= wave:
            return cols
    return TABLES_TILE_WIDTHS[-1]


def tables_shape(pls: PackedLocalSearch, device: torch.device):
    """(threads a block, tile width, tile table) of K2's launch on layout
    ``pls`` on CUDA ``device``."""
    threads = TABLES_THREADS
    wave = tables_wave(device, pls.D, pls.pg.mixed is not None, threads)
    cols = tables_tile_cols(pls.pg, wave)
    return threads, cols, _tiles(pls.pg, cols)


def _launch_tables(pls: PackedLocalSearch, x: torch.Tensor,
                   tables: torch.Tensor,
                   blocks: Optional[int] = None) -> None:
    """K2's one launch on checked CUDA ``x`` ([V] in variable order, the
    siblings read at their variables), into ``tables`` ([V, D] in
    variable order).  The tiles are :func:`~pydcop_tpu_torch.ops.
    packed_maxsum.tile_table`'s at :func:`tables_shape`'s width, cached
    on the layout.  The grid is one block a tile; ``blocks`` forces
    another (at least 1: blocks take tiles grid-stride, so any grid gives
    the same tables).  A refused launch raises RuntimeError."""
    pg = pls.pg
    if blocks is not None and blocks < 1:
        raise ValueError(f"ls_tables: {blocks} blocks, at least 1 needed")
    threads, cols, tiles = tables_shape(pls, x.device)
    if blocks is None:
        blocks = tiles.shape[0]
    sibs = [idx.data_ptr() for _, idx in pls.siblings()]
    ptrs = (x.data_ptr(), tables.data_ptr())
    tail = (pls.col_var.data_ptr(), tiles.data_ptr(), tiles.shape[0], cols,
            pg.D, pg.N, pg.Vp)
    flags = (blocks, threads, _stream(x))
    if pg.mixed is None:
        name = "ls_tables"
        err = _kernel(name)(
            *ptrs, pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
            pg.mask_p.data_ptr(), *sibs, *tail, *flags)
    else:
        name = "ls_tables_mixed"
        m = pg.mixed
        err = _kernel(name)(
            *ptrs, *(c.data_ptr() for c in m.costs), m.arity.data_ptr(),
            m.cost_idx.data_ptr(), *sibs, pg.unary_p.data_ptr(),
            pg.mask_p.data_ptr(), *tail,
            *(int(sl.numel()) for sl in m.slots), *flags)
    _raise_on(err, name)
    _count(packed_local_tables, pls)


def coop_capacity(lib: str, entry: str, D: int,
                  mixed: bool) -> Tuple[int, int]:
    """(resident blocks, threads a block) of a cooperative kernel of
    library ``lib`` at domain size ``D`` on the current CUDA device, as
    its C entry ``entry`` reports them (0 blocks when the device cannot be
    asked); asked anew at every call."""
    from pydcop_tpu_torch.ops.cuda_build import load

    fn = getattr(load(lib), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    threads = ctypes.c_int(0)
    return int(fn(D, int(mixed), ctypes.byref(threads))), int(threads.value)


def grid_blocks(Vp: int, capacity: int, threads: int) -> int:
    """Blocks of one cooperative launch: one thread a column, at most
    ``capacity`` (every phase is a grid-stride loop over the columns), at
    least 1."""
    return max(1, min(capacity, -(-Vp // threads)))


def _capacity(D: int, mixed: bool) -> Tuple[int, int]:
    """(resident blocks, threads a block) of the MGM kernel of one
    branch."""
    return coop_capacity("local_search", "mgm_capacity", D, mixed)


def _dsa_capacity(D: int, mixed: bool) -> Tuple[int, int]:
    """(resident blocks, threads a block) of the DSA kernel of one
    branch."""
    return coop_capacity("local_search", "dsa_capacity", D, mixed)


def _grid(name: str, Vp: int, capacity: int, threads: int,
          blocks: Optional[int]) -> int:
    """The grid of entry ``name``'s cooperative launch: ``blocks`` when
    given (1 up to the capacity), else :func:`grid_blocks`; a capacity of
    0 raises RuntimeError, a forced grid out of range ValueError."""
    if capacity <= 0:
        raise RuntimeError(f"{name}: the device reports no resident block "
                           f"for the cooperative launch")
    if blocks is None:
        return grid_blocks(Vp, capacity, threads)
    if not 1 <= blocks <= capacity:
        raise ValueError(f"{name}: {blocks} blocks, the capacity is "
                         f"{capacity}")
    return blocks


def _launch_mgm(pls: PackedLocalSearch, x_col: torch.Tensor,
                n_cycles: int, blocks: Optional[int] = None
                ) -> torch.Tensor:
    """:func:`packed_mgm_cycles` on a checked CUDA ``x_col``: the MGM
    kernel's one launch, or RuntimeError.  ``blocks`` forces the grid (1
    up to the capacity); by default it is :func:`grid_blocks`.  The grid
    barrier's word and the scratch are allocated by this call and shared
    with no other."""
    pg = pls.pg
    mixed = pg.mixed is not None
    name = "mgm_cycles_mixed" if mixed else "mgm_cycles"
    blocks = _grid(name, pg.Vp, *_capacity(pg.D, mixed), blocks)
    dev = x_col.device
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    best = torch.empty(pg.Vp, dtype=torch.int32, device=dev)
    gain = torch.empty(pg.Vp, dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    ties = [idx.data_ptr() for _, idx in pls.siblings()]
    err = _kernel(name)(
        x_col.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        best.data_ptr(), gain.data_ptr(), *_tables_layout(pls), *ties,
        pls.col_var.data_ptr(), n_cycles, blocks, bar.data_ptr(),
        _stream(x_col))
    _raise_on(err, name)
    _count(packed_mgm_cycles, pls)
    return bufs[(n_cycles - 1) % 2]


def _launch_dsa(pls: PackedLocalSearch, x_col: torch.Tensor,
                uniforms: torch.Tensor, probability: float, variant: str,
                probability_hard: Optional[float],
                awake_uniforms: Optional[torch.Tensor],
                activation: Optional[float],
                blocks: Optional[int] = None) -> torch.Tensor:
    """:func:`packed_dsa_cycles` on checked CUDA operands: the DSA
    kernel's one launch, or RuntimeError.  ``blocks`` forces the grid (1
    up to the capacity); by default it is :func:`grid_blocks`.  The grid
    barrier's word is allocated by this call and shared with no other."""
    pg = pls.pg
    mixed = pg.mixed is not None
    name = "dsa_cycles_mixed" if mixed else "dsa_cycles"
    blocks = _grid(name, pg.Vp, *_dsa_capacity(pg.D, mixed), blocks)
    n_cycles = uniforms.shape[0]
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    bar = torch.zeros(1, dtype=torch.int32, device=x_col.device)
    err = _kernel(name)(
        x_col.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        uniforms.data_ptr(),
        None if awake_uniforms is None else awake_uniforms.data_ptr(),
        *_tables_layout(pls), VARIANTS[variant], float(probability),
        float(probability if probability_hard is None
              else probability_hard),
        int(probability_hard is not None),
        float(0.0 if activation is None else activation), n_cycles, blocks,
        bar.data_ptr(), _stream(x_col))
    _raise_on(err, name)
    _count(packed_dsa_cycles, pls)
    return bufs[(n_cycles - 1) % 2]


def reset_launches() -> None:
    """Zero the launch counters of the three kernels' wrappers
    (``launches``: the binary kernels; ``mixed_launches``: the mixed
    ones)."""
    for fn in (packed_local_tables, packed_mgm_cycles, packed_dsa_cycles):
        fn.launches = fn.mixed_launches = 0


# ---------------------------------------------------------------------------
# the three Pallas entry points, ported
# ---------------------------------------------------------------------------


def packed_local_tables(pls: PackedLocalSearch, x,
                        blocks: Optional[int] = None) -> torch.Tensor:
    """Local cost tables ``[V, D]`` (variable order, PAD_COST at invalid
    values) at the assignment ``x`` ([V] value indices in variable order,
    a tensor or a numpy array): the port of
    ``pallas_maxsum.py::packed_local_tables``.

    On the card ONE launch of the ``ls_tables`` kernel (K2), which reads
    ``x`` as it is (int32 on the layout's device; another dtype is
    converted first) and writes the tables in variable order
    (``packed_local_tables.launches`` counts the binary branch's,
    ``packed_local_tables.mixed_launches`` the mixed branch's);
    ``blocks`` forces its grid.  On the CPU
    :func:`packed_local_tables_plain`."""
    x = torch.as_tensor(x, device=pls.device)
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    x = x.contiguous()
    if not _on(pls, "x", x, torch.int32, (pls.Vp,)):
        return packed_local_tables_plain(pls, x)
    tables = torch.empty((pls.Vp, pls.D), dtype=torch.float32,
                         device=x.device)
    _launch_tables(pls, x, tables, blocks)
    return tables


def packed_mgm_cycles(pls: PackedLocalSearch, x_col: torch.Tensor,
                      n_cycles: int,
                      blocks: Optional[int] = None) -> torch.Tensor:
    """``n_cycles`` MGM cycles from the column-order assignment ``x_col``
    (left unchanged).

    On CUDA tensors this makes one cooperative launch of the MGM kernel
    on the current stream that runs all the cycles, and adds one to
    ``packed_mgm_cycles.launches`` on the binary layout or to
    ``packed_mgm_cycles.mixed_launches`` on the mixed one; ``blocks``
    forces its grid (1 up to the kernel's capacity; the checks on the
    card run the grid-stride loops so).  On CPU tensors it runs the plain
    version, and ``blocks`` has no use."""
    if n_cycles < 1:
        raise ValueError(f"n_cycles must be >= 1, got {n_cycles}")
    if not _on(pls, "x", x_col, torch.int32, (pls.Vp,)):
        return packed_mgm_cycles_plain(pls, x_col, n_cycles)
    return _launch_mgm(pls, x_col, n_cycles, blocks)


def packed_dsa_cycles(pls: PackedLocalSearch, x_col: torch.Tensor,
                      uniforms: torch.Tensor, probability: float,
                      variant: str = "B",
                      probability_hard: Optional[float] = None,
                      awake_uniforms: Optional[torch.Tensor] = None,
                      activation: Optional[float] = None,
                      blocks: Optional[int] = None) -> torch.Tensor:
    """``n`` DSA-family cycles, one per row of ``uniforms`` ([n, Vp]
    column-order coins; ``awake_uniforms`` likewise for adsa), from
    ``x_col`` (left unchanged).

    The coins must be contiguous float32 on ``x_col``'s device.  On CUDA
    tensors this makes one cooperative launch of the DSA kernel on the
    current stream that runs all the cycles, and adds one to
    ``packed_dsa_cycles.launches`` on the binary layout or to
    ``packed_dsa_cycles.mixed_launches`` on the mixed one; ``blocks``
    forces its grid (1 up to the kernel's capacity).  On CPU tensors it
    runs the plain version, and ``blocks`` has no use."""
    _check_rule(variant, awake_uniforms, activation)
    if uniforms.dim() != 2 or uniforms.shape[0] < 1:
        raise ValueError("uniforms must be [n >= 1, Vp]")
    on_cuda = _on(pls, "x", x_col, torch.int32, (pls.Vp,))
    _on(pls, "uniforms", uniforms, torch.float32,
        (uniforms.shape[0], pls.Vp))
    if awake_uniforms is not None:
        _on(pls, "awake_uniforms", awake_uniforms, torch.float32,
            tuple(uniforms.shape))
    if not on_cuda:
        return packed_dsa_cycles_plain(
            pls, x_col, uniforms, probability, variant, probability_hard,
            awake_uniforms, activation)
    return _launch_dsa(pls, x_col, uniforms, probability, variant,
                       probability_hard, awake_uniforms, activation, blocks)


reset_launches()
