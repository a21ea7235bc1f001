"""Per-shard kernels of the sharded engines (all-binary and mixed-arity
branches, and MaxSum's activation branch).

The counterpart of the JAX package's ``ops/pallas_sharded.py``.  Each
kernel computes ONE shard's part of a cycle on that shard's layout
(:class:`~pydcop_tpu_torch.parallel.packed_mesh.ShardLayout`) and device;
the engines (``parallel/mesh.py``) combine the shards' partials with the
ordered collectives of ``parallel/collectives.py``:

* :func:`shard_fused_ba` (K7, ``packed_shard_fused_ba``) — one sharded
  MaxSum cycle, rotated: the previous cycle's variable side (expand the
  combined beliefs to the slots, subtract r, centre on the valid values'
  mean) then this cycle's factor side (min over the cost rows plus the
  siblings' q — the arity-masked update on a mixed layout — vmask,
  damping) and the per-column partial beliefs.  With an activation row
  (amaxsum) the commit selects of the previous cycle run between the
  two sides: ``q1 = active ? q : q_m`` at every slot, ``r1 = active ?
  r_u : r_m``, damping against ``r1``, and the launch also returns q1
  and r1, the next masked carry;
* :func:`shard_route_gains` (K8, ``packed_shard_route_gains``) — the
  shard's half of MGM's arbitration: each slot's siblings' gains (one on
  a binary layout; three rows, masked by arity, on a mixed one) and the
  per-column maximum over the shard's slots;
* :func:`shard_tables` (K9, ``packed_shard_tables``) — the shard's partial
  local cost tables at the current assignment, without unary costs.

Each wrapper launches its hand-written CUDA kernel (``csrc/sharded.cu``)
on CUDA tensors and counts the launch, per branch: ``.launches`` (the
binary kernel), ``.mixed_launches`` (the mixed one), and for K7
``.act_launches`` / ``.mixed_act_launches`` (with activation).  On CPU
tensors it runs the plain PyTorch version beside it, the same arithmetic
in the same order.  A build or launch failure on CUDA raises; nothing
falls back.

The rest of a cycle — the variable side after the combine, MGM's
tie-break partial and decision (``_cur_best_gain``,
``_tiebreak_idx_partial``, ``_mgm_decision`` of the JAX package's
``ops/pallas_local_search.py``, XLA code there) — is plain PyTorch:
:func:`cur_best_gain`, :func:`tiebreak_idx_partial`, :func:`mgm_decision`.
Their constants are the JAX package's: indices float-encoded with
:data:`BIG_IDX` for "no neighbour", ties within :data:`EPS` in float32.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from pydcop_tpu_torch.ops.packed_maxsum import ARITIES, MAX_D, \
    MAX_D_NARY, _mixed_r_new
from pydcop_tpu_torch.ops.segments import ordered_sum

if TYPE_CHECKING:  # the layout module imports nothing of this one
    from pydcop_tpu_torch.parallel.packed_mesh import ShardLayout

#: float-encoded "no neighbour at the maximum" (``_BIG_IDX``)
BIG_IDX = 1e9
#: the gain/tie epsilon and the prefer-change nudge of the JAX package
EPS = 1e-9
NUDGE = 1e-6
#: hard-constraint threshold (conflicts), the reference's infinity
HARD = 10000.0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def reduce_columns(sh: ShardLayout, slot_vals: torch.Tensor, how: str,
                   fill: float) -> torch.Tensor:
    """[R, N] per-slot rows → [R, Vp] per-column rows: each column's
    slots combined (``how``: "sum", "amax" or "amin"), starting from
    ``fill`` (which columns the shard does not touch keep).  The sum runs
    the kernels' loop, block by block and rank by rank, so it rounds as
    they do; a maximum or minimum is exact in any order and takes one
    ``scatter_reduce``."""
    R = slot_vals.shape[0]
    out = torch.full((R, sh.Vp), fill, dtype=slot_vals.dtype,
                     device=slot_vals.device)
    if how != "sum":
        idx = sh.slot_col.long().expand(R, -1)
        return out.scatter_reduce_(1, idx, slot_vals, how)
    tcol = sh.tcol.long()
    for deg, nvp, toff, soff in sh.buckets:
        block = slot_vals[:, soff: soff + deg * nvp].reshape(R, deg, nvp)
        part = torch.full_like(block[:, 0], fill)
        for k in range(deg):
            part = part + block[:, k]
        out[:, tcol[toff: toff + nvp]] = part
    return out


def _at(row: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``row`` [Vp] read at the columns ``cols`` [N] (-1 = none: reads
    column 0, which the callers mask)."""
    return row[cols.long().clamp_min(0)]


def shard_fused_ba_plain(sh: ShardLayout, bel_g: torch.Tensor,
                         r_u: torch.Tensor, damping: float,
                         q_m: Optional[torch.Tensor] = None,
                         r_m: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None):
    """K7's arithmetic: (r_new [D, N], partial beliefs [D, Vp]), and with
    ``active`` also the committed (q1, r1) [D, N]."""
    D = sh.D
    # pending variable side of the previous cycle (a no-op on zero state)
    q = bel_g[:, sh.slot_col.long()] - r_u
    mean = ordered_sum(q * sh.vmask, axis=0) * sh.inv_dcount
    q = (q - mean) * sh.vmask
    r1 = r_u
    if active is not None:  # the previous cycle's commit (amaxsum)
        on = active > 0
        q = torch.where(on, q, q_m)
        r1 = torch.where(on, r_u, r_m)
    # this cycle's factor side
    if sh.mixed is not None:
        r_new = _mixed_r_new(sh, q)
    else:
        qm = q[:, sh.mate.long()]  # the mate's q, min over its value
        cost = sh.cost_rows
        r_new = cost[0:D] + qm[0:1]
        for j in range(1, D):
            r_new = torch.minimum(r_new,
                                  cost[j * D:(j + 1) * D] + qm[j:j + 1])
    r_new = r_new * sh.vmask
    if damping:
        r_new = damping * r1 + (1.0 - damping) * r_new
    partial = reduce_columns(sh, r_new, "sum", 0.0)
    if active is None:
        return r_new, partial
    return r_new, partial, q, r1


def shard_route_gains_plain(sh: ShardLayout, gain: torch.Tensor):
    """K8's arithmetic: (nm_part [Vp], gn [N]), and on a mixed layout
    (nm_part, gn, gn2, gn3), each sibling's gain masked by arity."""
    gn = _at(gain, sh.mate_col) * sh.gmask1
    if sh.mixed is None:
        return reduce_columns(sh, gn[None], "amax", 0.0)[0], gn
    m = sh.mixed
    gn2 = _at(gain, m.mate2_col) * m.gmask2
    gn3 = _at(gain, m.mate3_col) * m.gmask3
    g = torch.maximum(torch.maximum(gn, gn2), gn3)
    return reduce_columns(sh, g[None], "amax", 0.0)[0], gn, gn2, gn3


def _slot_costs(sh: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """[D, N] each slot's cost row at its siblings' values ``x``: the
    binary rows at the mate's value, or per arity the row of
    (x1, (x1*D + x2), ((x1*D + x2)*D + x3)); a unary slot's cost."""
    D = sh.D
    d = torch.arange(D, device=x.device)[:, None]
    if sh.mixed is None:
        xm = x[sh.mate_col.long()].long()
        return sh.cost_rows.gather(0, xm[None, :] * D + d)
    m = sh.mixed
    out = torch.empty((D, sh.N), dtype=torch.float32, device=x.device)
    cols = (sh.mate_col, m.mate2_col, m.mate3_col)
    for a, sl, cost in zip(ARITIES, m.slots, m.costs):
        if sl.numel() == 0:
            continue
        row = torch.zeros_like(sl)
        for col in cols[:a - 1]:
            row = row * D + x[col.long()[sl]].long()
        out[:, sl] = cost.gather(0, row[None, :] * D + d)
    return out


def shard_tables_plain(sh: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """Partial local cost tables [D, Vp] at ``x`` ([Vp] int32 values in
    column order): K9's arithmetic."""
    return reduce_columns(sh, _slot_costs(sh, x), "sum", 0.0)


def cur_best_gain(tables: torch.Tensor, x: torch.Tensor,
                  prefer_change: bool):
    """(cur [Vp], best [Vp] int32, gain [Vp]) from masked tables [D, Vp]
    at ``x``: ``_cur_best_gain``.  ``prefer_change`` adds the nudge to
    the current value before the argmin (first index of the minimum)."""
    xl = x.long()[None]
    cur = tables.gather(0, xl)[0]
    pick = tables
    if prefer_change:
        pick = tables + torch.zeros_like(tables).scatter_(0, xl, NUDGE)
    best = torch.argmin(pick, dim=0)
    gain = torch.clamp_min(cur - pick.gather(0, best[None])[0], 0.0)
    return cur, best.to(torch.int32), gain


def tiebreak_idx_partial(sh: ShardLayout, neigh_max: torch.Tensor,
                         gn: torch.Tensor,
                         gn2: Optional[torch.Tensor] = None,
                         gn3: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """[Vp] smallest neighbour index at the (combined) neighbourhood max
    over the shard's slots — every sibling of a mixed slot, through its
    routed gain ``gn2``/``gn3`` — BIG_IDX where none:
    ``_tiebreak_idx_partial``."""
    thr = neigh_max[sh.slot_col.long()] - EPS
    big = torch.full_like(sh.mate_idx, BIG_IDX)
    cand = torch.where(gn >= thr, sh.mate_idx, big)
    if gn2 is not None:
        m = sh.mixed
        cand = torch.minimum(cand, torch.where(gn2 >= thr, m.mate2_idx, big))
        cand = torch.minimum(cand, torch.where(gn3 >= thr, m.mate3_idx, big))
    return reduce_columns(sh, cand[None], "amin", BIG_IDX)[0]


def mgm_decision(gain, idx_row, neigh_max, idx_at_max) -> torch.Tensor:
    """Move iff the own gain is the strict neighbourhood max, ties to the
    smaller variable index: ``_mgm_decision``."""
    return (gain > 0) & (
        (gain > neigh_max + EPS)
        | (((gain - neigh_max).abs() <= EPS) & (idx_row < idx_at_max)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_fns = {}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "shard_fused_ba": [P] * 18 + [I] * 3 + [F, F, I, P],
    "shard_fused_ba_mixed": [P] * 27 + [I] * 7 + [F, F, I, P],
    "shard_route_gains": [P] * 9 + [I] * 2 + [P],
    "shard_route_gains_mixed": [P] * 15 + [I] * 2 + [P],
    "shard_tables": [P] * 8 + [I] * 3 + [P],
    "shard_tables_mixed": [P] * 15 + [I] * 6 + [P],
}


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/sharded.cu``, bound once."""
    if name not in _fns:
        from pydcop_tpu_torch.ops.cuda_build import load

        fn = getattr(load("sharded"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return _fns[name]


def _check(sh: ShardLayout, name: str, x: torch.Tensor, shape,
           dtype=torch.float32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != sh.device:
        raise ValueError(
            f"{name} is on {x.device} but shard {sh.index} is on "
            f"{sh.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_ready(sh: ShardLayout, what: str) -> bool:
    """True when the wrapper must launch the kernel (a CUDA shard); False
    for the plain version (a CPU shard)."""
    if sh.device.type == "cpu":
        return False
    if sh.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {sh.device}")
    if not 1 <= sh.D <= MAX_D:
        raise ValueError(f"{what} takes D in [1, {MAX_D}]")
    if sh.mixed is not None and sh.D > MAX_D_NARY and any(
            sl.numel() for sl in sh.mixed.slots[2:]):
        raise ValueError(f"{what} takes ternary and quaternary slots at "
                         f"D <= {MAX_D_NARY}")
    return True


def _walk(sh: ShardLayout) -> tuple:
    return (sh.tcol.data_ptr(), sh.t_deg.data_ptr(), sh.t_slot0.data_ptr(),
            sh.t_stride.data_ptr())


def _mixed_args(sh: ShardLayout) -> tuple:
    """The per-arity cost arrays, arity, cost index and sibling columns of
    a mixed layout, as ``struct Mixed`` of ``csrc/sharded.cu`` opens."""
    m = sh.mixed
    return (*(c.data_ptr() for c in m.costs), m.arity.data_ptr(),
            m.cost_idx.data_ptr(), sh.mate_col.data_ptr(),
            m.mate2_col.data_ptr(), m.mate3_col.data_ptr())


def _widths(sh: ShardLayout) -> tuple:
    return tuple(int(sl.numel()) for sl in sh.mixed.slots)


def _fused_ba_args(sh: ShardLayout) -> tuple:
    """K7's layout operands, which follow its state operands."""
    if sh.mixed is None:
        return (sh.cost_rows.data_ptr(), sh.vmask.data_ptr(),
                sh.inv_dcount.data_ptr(), sh.mate.data_ptr(),
                sh.mate_col.data_ptr(), *_walk(sh), sh.D, sh.N, sh.Vp)
    m = sh.mixed
    return (*_mixed_args(sh), sh.mate.data_ptr(), m.mate2.data_ptr(),
            m.mate3.data_ptr(), sh.vmask.data_ptr(), sh.inv_dcount.data_ptr(),
            *_walk(sh), sh.D, sh.N, sh.Vp, *_widths(sh))


def _route_gains_args(sh: ShardLayout) -> tuple:
    """K8's layout operands, which follow its state operands."""
    if sh.mixed is None:
        return (sh.gmask1.data_ptr(), sh.mate_col.data_ptr(), *_walk(sh),
                sh.N, sh.Vp)
    m = sh.mixed
    return (sh.gmask1.data_ptr(), m.gmask2.data_ptr(), m.gmask3.data_ptr(),
            sh.mate_col.data_ptr(), m.mate2_col.data_ptr(),
            m.mate3_col.data_ptr(), *_walk(sh), sh.N, sh.Vp)


def _tables_args(sh: ShardLayout) -> tuple:
    """K9's layout operands, which follow its state operands."""
    if sh.mixed is None:
        return (sh.cost_rows.data_ptr(), sh.mate_col.data_ptr(), *_walk(sh),
                sh.D, sh.N, sh.Vp)
    return (*_mixed_args(sh), *_walk(sh), sh.D, sh.Vp, *_widths(sh))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _count(wrapper: str, counter: str) -> None:
    """Add one launch to a wrapper's counter.  The counters live on the
    wrapper functions as defined here (``_WRAPPERS``), so they count
    even while a caller has rebound the module's names (a harness that
    checks each launch against its plain version)."""
    fn = _WRAPPERS[wrapper]
    setattr(fn, counter, getattr(fn, counter) + 1)


def shard_fused_ba(sh: ShardLayout, bel_g: torch.Tensor, r_u: torch.Tensor,
                   damping: float = 0.0,
                   q_m: Optional[torch.Tensor] = None,
                   r_m: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None):
    """One shard's rotated MaxSum cycle: from the combined beliefs of the
    previous cycle ``bel_g`` [D, Vp] (unary included) and the shard's
    unmasked messages ``r_u`` [D, N], return (r_new [D, N], partial
    beliefs [D, Vp] without unary).  On a zero state the pending variable
    side is a no-op.

    With ``active`` ([N] float32, 1 where the previous cycle's messages
    commit) and the masked carry ``q_m``, ``r_m`` [D, N] (amaxsum), the
    launch commits before the factor side and returns (r_new, partial,
    q1, r1).  The inputs are not modified."""
    _check(sh, "bel_g", bel_g, (sh.D, sh.Vp))
    _check(sh, "r_u", r_u, (sh.D, sh.N))
    act = active is not None
    if act:
        _check(sh, "q_m", q_m, (sh.D, sh.N))
        _check(sh, "r_m", r_m, (sh.D, sh.N))
        _check(sh, "active", active, (sh.N,))
    elif q_m is not None or r_m is not None:
        raise ValueError("q_m and r_m go with an activation row")
    if not _launch_ready(sh, "shard_fused_ba"):
        return shard_fused_ba_plain(sh, bel_g, r_u, damping, q_m, r_m,
                                    active)
    r_out = torch.empty_like(r_u)
    partial = torch.empty_like(bel_g)
    q1 = r1 = None
    act_ptrs = (None,) * 5
    if act:
        q1, r1 = torch.empty_like(r_u), torch.empty_like(r_u)
        act_ptrs = (q_m.data_ptr(), r_m.data_ptr(), active.data_ptr(),
                    q1.data_ptr(), r1.data_ptr())
    name = "shard_fused_ba" + ("_mixed" if sh.mixed is not None else "")
    err = _kernel(name)(
        bel_g.data_ptr(), r_u.data_ptr(), *act_ptrs[:3], r_out.data_ptr(),
        partial.data_ptr(), *act_ptrs[3:], *_fused_ba_args(sh),
        float(damping), float(1.0 - damping), 1 if damping else 0,
        _stream(bel_g))
    _raise_on(err, "shard_fused_ba")
    _count("shard_fused_ba", ("mixed_" if sh.mixed is not None else "")
           + ("act_" if act else "") + "launches")
    if act:
        return r_out, partial, q1, r1
    return r_out, partial


def shard_route_gains(sh: ShardLayout, gain: torch.Tensor):
    """The shard's half of MGM's arbitration from the combined gains
    ``gain`` [Vp]: (nm_part [Vp], the per-column max of the siblings'
    gains over the shard's slots, 0 where it has none; gn [N], each
    slot's mate's gain times ``gmask1``), and on a mixed layout also gn2
    and gn3, the second and third siblings' gains times ``gmask2`` /
    ``gmask3``."""
    _check(sh, "gain", gain, (sh.Vp,))
    if not _launch_ready(sh, "shard_route_gains"):
        return shard_route_gains_plain(sh, gain)
    nm_part = torch.empty_like(gain)
    gns = [torch.empty((sh.N,), dtype=torch.float32, device=gain.device)
           for _ in range(1 if sh.mixed is None else 3)]
    name = "shard_route_gains" + ("_mixed" if sh.mixed is not None else "")
    err = _kernel(name)(gain.data_ptr(), nm_part.data_ptr(),
                        *(g.data_ptr() for g in gns),
                        *_route_gains_args(sh), _stream(gain))
    _raise_on(err, "shard_route_gains")
    _count("shard_route_gains",
           "mixed_launches" if sh.mixed is not None else "launches")
    return (nm_part, *gns)


def shard_tables(sh: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """The shard's partial local cost tables [D, Vp] (no unary) at the
    assignment ``x`` ([Vp] int32 value indices in column order)."""
    _check(sh, "x", x, (sh.Vp,), torch.int32)
    if not _launch_ready(sh, "shard_tables"):
        return shard_tables_plain(sh, x)
    partial = torch.empty((sh.D, sh.Vp), dtype=torch.float32,
                          device=x.device)
    name = "shard_tables" + ("_mixed" if sh.mixed is not None else "")
    err = _kernel(name)(x.data_ptr(), partial.data_ptr(),
                        *_tables_args(sh), _stream(x))
    _raise_on(err, "shard_tables")
    _count("shard_tables",
           "mixed_launches" if sh.mixed is not None else "launches")
    return partial


_WRAPPERS = {fn.__name__: fn for fn in (shard_fused_ba, shard_route_gains,
                                        shard_tables)}


def reset_launches() -> None:
    """Zero the launch counters of the three wrappers, every branch."""
    for fn in _WRAPPERS.values():
        fn.launches = fn.mixed_launches = 0
    fn = _WRAPPERS["shard_fused_ba"]
    fn.act_launches = fn.mixed_act_launches = 0


reset_launches()
