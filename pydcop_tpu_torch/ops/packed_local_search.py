"""Packed local-search engine for all-binary constraint graphs (GPU layout).

The counterpart of the JAX package's ``ops/pallas_local_search.py``
(``pack_local_search``, ``packed_mgm_cycles``, ``packed_dsa_cycles``) and
of ``ops/pallas_maxsum.py::packed_local_tables``, on the var-grouped slot
layout of :func:`~pydcop_tpu_torch.ops.packed_maxsum.pack_for_gpu` (an
all-binary constraints hypergraph IS an all-binary factor graph: a
slot's factor mate is the neighbour on the other end).

On top of that layout local search needs, per slot, the column of its
mate (``mate_col = slot_col[mate]``, so a thread reads a neighbour's
value or gain with one indexed load) and the mate's original variable
index (``mate_idx``, MGM's static lexic tie-break), and per column its
original variable (``col_var``).  The assignment is int32 ``[Vp]`` in
column order (:func:`pack_x` / :func:`unpack_x`); coins are ``[n, Vp]``
float32 in column order (:func:`pack_uniforms`).

Three hand-written CUDA kernels (``csrc/local_search.cu``), each behind a
wrapper with a launch counter and a plain PyTorch version doing the same
arithmetic in the same order:

* :func:`ls_tables` — local cost tables, current cost, best value, gain;
* :func:`mgm_move` — MGM's neighbourhood arbitration and move;
* :func:`dsa_cycle` — one whole DSA-family cycle.

A wrapper runs its plain version only for CPU tensors; on CUDA tensors it
launches the kernel or raises — nothing falls back.  One MGM cycle is
``ls_tables`` + ``mgm_move`` (MGM reads its neighbours' gains of the same
cycle, which needs a grid-wide barrier); one DSA cycle is one
``dsa_cycle``.  The assignment is double-buffered across launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.ops.packed_maxsum import (
    MAX_D,
    PackedMaxSumGraph,
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


@dataclass
class PackedLocalSearch:
    """The packed layout plus the per-slot arrays local search needs."""

    pg: PackedMaxSumGraph
    mate_col: torch.Tensor  # [N] int32 column of each slot's mate
    mate_idx: torch.Tensor  # [N] int32 original variable of that column
    col_var: torch.Tensor  # [Vp] int32 original variable of each column

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


def pack_from_pg(pg: Optional[PackedMaxSumGraph]
                 ) -> Optional[PackedLocalSearch]:
    if pg is None:
        return None
    mate_col = pg.slot_col[pg.mate.long()]
    col_var = torch.empty_like(pg.var_order)
    col_var[pg.var_order] = torch.arange(pg.Vp, device=pg.device)
    return PackedLocalSearch(
        pg=pg,
        mate_col=mate_col.int().contiguous(),
        mate_idx=col_var[mate_col].int().contiguous(),
        col_var=col_var.int().contiguous(),
    )


def pack_local_search(t: FactorGraphTensors
                      ) -> Optional[PackedLocalSearch]:
    """The packed local-search layout of ``t`` on ``t``'s device, or None
    when the graph does not pack (see :func:`pack_for_gpu`)."""
    return pack_from_pg(pack_for_gpu(t))


def pack_x(pls: PackedLocalSearch, x: torch.Tensor) -> torch.Tensor:
    """[V] value indices in variable order → int32 [Vp] column order."""
    return x.to(torch.int32)[pls.col_var.long()].contiguous()


def unpack_x(pls: PackedLocalSearch, x_col: torch.Tensor) -> torch.Tensor:
    """int32 [Vp] column order → int32 [V] variable order."""
    return x_col[pls.pg.var_order]


def pack_uniforms(pls: PackedLocalSearch, u: torch.Tensor) -> torch.Tensor:
    """[n, V] coins in variable order → float32 [n, Vp] column order."""
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


def ls_tables_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                    prefer_change: bool = False):
    """(tables [D, Vp] with PAD_COST at invalid values, cur [Vp], best
    [Vp] int32, gain [Vp]) at assignment ``x_col``."""
    pg = pls.pg
    D = pg.D
    xl = x_col.long()
    xm = xl[pls.mate_col.long()]  # the mate's value at each slot
    rows = xm[None, :] * D + torch.arange(D, device=xl.device)[:, None]
    contrib = pg.cost_rows.gather(0, rows)  # [D, N]
    acc = _per_column(pls, contrib, torch.add, 0.0)
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


def mgm_move_plain(pls: PackedLocalSearch, x_col: torch.Tensor,
                   best: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """MGM's move: a column moves to ``best`` iff its gain is the strict
    maximum of its neighbourhood, ties to the smallest original index."""
    eps = gain.new_tensor(EPS)
    g_mate = gain[pls.mate_col.long()]
    nm = _per_column(pls, g_mate, torch.maximum, 0.0)
    thr = (nm - eps)[pls.pg.slot_col]
    cand = torch.where(g_mate >= thr, pls.mate_idx,
                       torch.full_like(pls.mate_idx, NO_INDEX))
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
            "ls_tables": [P] * 12 + [I] * 4 + [P],
            "mgm_move": [P] * 10 + [I, P],
            "dsa_cycle": [P] * 11 + [I] * 4 + [F, F, I, F, P],
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


def ls_tables(pls: PackedLocalSearch, x_col: torch.Tensor,
              prefer_change: bool = False,
              out: Optional[Tuple[torch.Tensor, ...]] = None):
    """(tables [D, Vp], cur [Vp], best [Vp] int32, gain [Vp]) at the
    column-order assignment ``x_col``: one launch of the ``ls_tables``
    kernel on CUDA (``ls_tables.launches`` counts them), the plain
    version on the CPU.  ``out`` reuses four output tensors."""
    if not _on(pls, "x", x_col, torch.int32, (pls.Vp,)):
        return ls_tables_plain(pls, x_col, prefer_change)
    pg = pls.pg
    if out is None:
        f = dict(dtype=torch.float32, device=x_col.device)
        out = (torch.empty((pg.D, pg.Vp), **f), torch.empty(pg.Vp, **f),
               torch.empty(pg.Vp, dtype=torch.int32, device=x_col.device),
               torch.empty(pg.Vp, **f))
    tables, cur, best, gain = out
    err = _kernel("ls_tables")(
        x_col.data_ptr(), tables.data_ptr(), cur.data_ptr(),
        best.data_ptr(), gain.data_ptr(), pg.cost_rows.data_ptr(),
        pg.unary_p.data_ptr(), pg.mask_p.data_ptr(),
        pls.mate_col.data_ptr(), pg.col_deg.data_ptr(),
        pg.col_slot0.data_ptr(), pg.col_stride.data_ptr(),
        pg.D, pg.N, pg.Vp, int(prefer_change), _stream(x_col))
    _raise_on(err, "ls_tables")
    ls_tables.launches += 1
    return out


def mgm_move(pls: PackedLocalSearch, x_col: torch.Tensor,
             best: torch.Tensor, gain: torch.Tensor,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MGM's arbitration and move from this cycle's (best, gain): one
    launch of the ``mgm_move`` kernel on CUDA (``mgm_move.launches``),
    the plain version on the CPU.  ``out`` must not alias ``x_col``."""
    on_cuda = _on(pls, "x", x_col, torch.int32, (pls.Vp,))
    _on(pls, "best", best, torch.int32, (pls.Vp,))
    _on(pls, "gain", gain, torch.float32, (pls.Vp,))
    if not on_cuda:
        return mgm_move_plain(pls, x_col, best, gain)
    pg = pls.pg
    out = torch.empty_like(x_col) if out is None else out
    err = _kernel("mgm_move")(
        x_col.data_ptr(), out.data_ptr(), best.data_ptr(), gain.data_ptr(),
        pls.mate_col.data_ptr(), pls.mate_idx.data_ptr(),
        pls.col_var.data_ptr(), pg.col_deg.data_ptr(),
        pg.col_slot0.data_ptr(), pg.col_stride.data_ptr(), pg.Vp,
        _stream(x_col))
    _raise_on(err, "mgm_move")
    mgm_move.launches += 1
    return out


def dsa_cycle(pls: PackedLocalSearch, x_col: torch.Tensor, u: torch.Tensor,
              probability: float, variant: str = "B",
              probability_hard: Optional[float] = None,
              awake_u: Optional[torch.Tensor] = None,
              activation: Optional[float] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DSA-family cycle: one launch of the ``dsa_cycle`` kernel on
    CUDA (``dsa_cycle.launches``), the plain version on the CPU.  ``u``
    (and ``awake_u``) are this cycle's [Vp] coins in column order."""
    _check_rule(variant, awake_u, activation)
    on_cuda = _on(pls, "x", x_col, torch.int32, (pls.Vp,))
    _on(pls, "u", u, torch.float32, (pls.Vp,))
    if awake_u is not None:
        _on(pls, "awake_u", awake_u, torch.float32, (pls.Vp,))
    if not on_cuda:
        return dsa_cycle_plain(pls, x_col, u, probability, variant,
                               probability_hard, awake_u, activation)
    pg = pls.pg
    out = torch.empty_like(x_col) if out is None else out
    err = _kernel("dsa_cycle")(
        x_col.data_ptr(), out.data_ptr(), u.data_ptr(),
        None if awake_u is None else awake_u.data_ptr(),
        pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
        pg.mask_p.data_ptr(), pls.mate_col.data_ptr(),
        pg.col_deg.data_ptr(), pg.col_slot0.data_ptr(),
        pg.col_stride.data_ptr(), pg.D, pg.N, pg.Vp, VARIANTS[variant],
        float(probability),
        float(probability if probability_hard is None
              else probability_hard),
        int(probability_hard is not None),
        float(0.0 if activation is None else activation), _stream(x_col))
    _raise_on(err, "dsa_cycle")
    dsa_cycle.launches += 1
    return out


ls_tables.launches = 0
mgm_move.launches = 0
dsa_cycle.launches = 0


def reset_launches() -> None:
    ls_tables.launches = mgm_move.launches = dsa_cycle.launches = 0


# ---------------------------------------------------------------------------
# the three Pallas entry points, ported
# ---------------------------------------------------------------------------


def packed_local_tables(pls: PackedLocalSearch,
                        x: torch.Tensor) -> torch.Tensor:
    """Local cost tables ``[V, D]`` (variable order, PAD_COST at invalid
    values) at the assignment ``x`` ([V] value indices): the port of
    ``pallas_maxsum.py::packed_local_tables``, one ``ls_tables``
    launch."""
    tables = ls_tables(pls, pack_x(pls, x))[0]
    return tables[:, pls.pg.var_order].T.contiguous()


def packed_mgm_cycles(pls: PackedLocalSearch, x_col: torch.Tensor,
                      n_cycles: int) -> torch.Tensor:
    """``n_cycles`` MGM cycles from the column-order assignment ``x_col``
    (left unchanged); two launches per cycle on CUDA."""
    if n_cycles < 1:
        raise ValueError(f"n_cycles must be >= 1, got {n_cycles}")
    if not _on(pls, "x", x_col, torch.int32, (pls.Vp,)):
        return packed_mgm_cycles_plain(pls, x_col, n_cycles)
    scratch = None
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    for i in range(n_cycles):
        scratch = ls_tables(pls, x_col, out=scratch)
        x_col = mgm_move(pls, x_col, scratch[2], scratch[3],
                         out=bufs[i % 2])
    return x_col


def packed_dsa_cycles(pls: PackedLocalSearch, x_col: torch.Tensor,
                      uniforms: torch.Tensor, probability: float,
                      variant: str = "B",
                      probability_hard: Optional[float] = None,
                      awake_uniforms: Optional[torch.Tensor] = None,
                      activation: Optional[float] = None) -> torch.Tensor:
    """``n`` DSA-family cycles, one per row of ``uniforms`` ([n, Vp]
    column-order coins; ``awake_uniforms`` likewise for adsa), from
    ``x_col`` (left unchanged); one launch per cycle on CUDA."""
    _check_rule(variant, awake_uniforms, activation)
    if uniforms.dim() != 2 or uniforms.shape[0] < 1:
        raise ValueError("uniforms must be [n >= 1, Vp]")
    if awake_uniforms is not None \
            and awake_uniforms.shape != uniforms.shape:
        raise ValueError("awake_uniforms must have the shape of uniforms")
    if not _on(pls, "x", x_col, torch.int32, (pls.Vp,)):
        return packed_dsa_cycles_plain(
            pls, x_col, uniforms, probability, variant, probability_hard,
            awake_uniforms, activation)
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    for i in range(uniforms.shape[0]):
        x_col = dsa_cycle(
            pls, x_col, uniforms[i], probability, variant,
            probability_hard,
            None if awake_uniforms is None else awake_uniforms[i],
            activation, out=bufs[i % 2])
    return x_col
