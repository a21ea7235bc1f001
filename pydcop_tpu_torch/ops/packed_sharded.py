"""Kernels of the sharded engines (all-binary and mixed-arity branches,
and MaxSum's activation branch).

The counterpart of the JAX package's ``ops/pallas_sharded.py``.  There
each kernel computes one shard's part of a cycle, one shard per device,
and ``psum`` / ``pmax`` / ``pmin`` combine them.  Here K7, K8 and K9
launch once per DEVICE per cycle, over the group of shards the device
holds (:class:`~pydcop_tpu_torch.parallel.packed_mesh.ShardGroup`), with
the shard-order combine inside the launch:

* :func:`device_fused_ba` (K7, ``packed_shard_fused_ba``) — one sharded
  MaxSum cycle of every shard of the group, rotated: the previous cycle's
  variable side (expand the combined beliefs to the slots, subtract r,
  centre on the valid values' mean) then this cycle's factor side (min
  over the cost rows plus the siblings' q — the arity-masked update on a
  mixed layout — vmask, damping), and the beliefs: unary + the shards'
  partials added in shard order (a whole group), or the partials.  With
  an activation row (amaxsum) the commit selects of the previous cycle
  run between the two sides: ``q1 = active ? q : q_m`` at every slot,
  ``r1 = active ? r_u : r_m``, damping against ``r1``, and the launch
  also returns q1 and r1, the next masked carry;
* :func:`device_tables` (K9, ``packed_shard_tables``) — the local cost
  tables at the current assignment: ``where(mask > 0, unary + the
  shards' partials in shard order, PAD_COST)``, or the partials;
* :func:`device_mgm_move` (K8, ``packed_shard_route_gains`` and the
  arbitration after it) — MGM's move mask from the combined gains: each
  slot's siblings' routed gains (one on a binary layout; three rows,
  masked by arity, on a mixed one), the neighbourhood max, the smallest
  sibling index at that max and the decision, all per column; on a group
  that holds only some shards, the partial max or the partial tie-break
  index instead (``mode``).

The group's slot operands are slabs: one allocation per operand, shard
k's ``[R, N_k]`` piece contiguous at ``R * soff[k]`` (the shards'
``ShardLayout`` fields are views of them).  The state K7 takes and
returns is laid out the same way: ``r_u``, ``q_m``, ``r_m``, ``r_new``,
``q1``, ``r1`` are ``[D * n_slots]`` slabs and ``active`` an
``[n_slots]`` one (:meth:`ShardGroup.views` cuts them per shard).

Each wrapper launches its hand-written CUDA kernel (``csrc/sharded.cu``)
on CUDA tensors and counts the launch, per branch: ``.launches`` (the
binary kernel), ``.mixed_launches`` (the mixed one), and for K7
``.act_launches`` / ``.mixed_act_launches`` (with activation).  On CPU
tensors it runs the plain PyTorch version beside it: the per-shard plain
versions (:func:`shard_fused_ba_plain`, :func:`shard_tables_plain`,
:func:`shard_route_gains_plain` with :func:`tiebreak_idx_partial` and
:func:`mgm_decision`, the arithmetic of one shard, what the tests hold
against the JAX package's per-shard Pallas kernels and XLA helpers)
followed by the same ordered combine.  A build or launch failure on CUDA
raises; nothing falls back.

The rest of a cycle — the variable side after the combine
(``_cur_best_gain`` of the JAX package's ``ops/pallas_local_search.py``,
XLA code there) — is plain PyTorch: :func:`cur_best_gain`.  The
constants are the JAX package's: indices float-encoded with
:data:`BIG_IDX` for "no neighbour", ties within :data:`EPS` in float32.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Optional

import torch

from pydcop_tpu_torch.ops.compile import PAD_COST
from pydcop_tpu_torch.ops.packed_maxsum import ARITIES, MAX_D, \
    MAX_D_NARY, _mixed_r_new
from pydcop_tpu_torch.ops.segments import ordered_sum

if TYPE_CHECKING:  # the layout module imports nothing of this one
    from pydcop_tpu_torch.parallel.packed_mesh import ShardGroup, \
        ShardLayout

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
# plain versions of the device-level launches
# ---------------------------------------------------------------------------


def _combined(group: ShardGroup, parts, fill=None) -> torch.Tensor:
    """The group's per-shard [R, Vp] partials, as the device-level kernel
    writes them: ``unary + ((p_0 + p_1) + ...)`` in shard order for a
    whole group (``fill``: where(mask > 0, that, fill)), else stacked
    [S, R, Vp]."""
    if not group.whole:
        return torch.stack(parts)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    out = group.unary_p + total
    if fill is None:
        return out
    return torch.where(group.mask_p > 0, out, fill)


def device_fused_ba_plain(group: ShardGroup, bel_g: torch.Tensor,
                          r_u: torch.Tensor, damping: float,
                          q_m: Optional[torch.Tensor] = None,
                          r_m: Optional[torch.Tensor] = None,
                          active: Optional[torch.Tensor] = None):
    """K7 over a device's group of shards: :func:`shard_fused_ba_plain` on
    each shard's views of the slabs, then the shards' partials combined
    in shard order (:func:`_combined`).  Returns (r_new slab, result)
    and with ``active`` also the (q1, r1) slabs."""
    D = group.D
    rs = group.views(r_u, D)
    acts = ([None] * 3 if active is None else
            [group.views(q_m, D), group.views(r_m, D),
             group.views(active, None)])
    outs = []
    for k, sh in enumerate(group.shards):
        extra = [] if active is None else [a[k] for a in acts]
        if sh.N == 0:  # launches nothing, adds +0
            zero = torch.zeros((D, group.Vp), dtype=torch.float32,
                               device=bel_g.device)
            outs.append((rs[k], zero, *extra[:2]))
            continue
        outs.append(shard_fused_ba_plain(sh, bel_g, rs[k], damping, *extra))
    r_new = group.slab_of([o[0] for o in outs])
    result = _combined(group, [o[1] for o in outs])
    if active is None:
        return r_new, result
    return (r_new, result, group.slab_of([o[2] for o in outs]),
            group.slab_of([o[3] for o in outs]))


def device_tables_plain(group: ShardGroup, x: torch.Tensor) -> torch.Tensor:
    """K9 over a device's group of shards: :func:`shard_tables_plain` per
    shard, then ``where(mask > 0, unary + ordered sum, PAD_COST)`` for a
    whole group, else the stacked partials."""
    parts = [shard_tables_plain(sh, x) if sh.N else torch.zeros(
        (group.D, group.Vp), dtype=torch.float32, device=x.device)
        for sh in group.shards]
    return _combined(group, parts, PAD_COST)


#: K8's modes: the move mask (a whole group), the group's partial
#: neighbourhood max, the group's partial tie-break index
MGM_MODES = ("move", "max", "min")


def device_mgm_move_plain(group: ShardGroup, gain: torch.Tensor,
                          idx_row: Optional[torch.Tensor] = None,
                          mode: str = "move",
                          neigh_max: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """K8 over a device's group of shards: :func:`shard_route_gains_plain`
    per shard, the ordered ``all_max`` of their partials over the group
    (``mode`` "max" stops here), clamped at 0; :func:`tiebreak_idx_partial`
    per shard at that ``neigh_max`` (given, in ``mode`` "min"), the ordered
    ``all_min`` ("min" stops here); :func:`mgm_decision`.  A shard that
    holds no factor passes the identity (0, BIG_IDX)."""
    # imported here: the parallel package imports this module
    from pydcop_tpu_torch.parallel.collectives import all_max, all_min

    devs = [group.device] * len(group.shards)
    routed = [shard_route_gains_plain(sh, gain) if sh.N else None
              for sh in group.shards]
    if mode != "min":
        zero = torch.zeros_like(gain)
        nm = all_max([zero if r is None else r[0] for r in routed],
                     devs)[0]
        if mode == "max":
            return nm
        neigh_max = torch.clamp_min(nm, 0.0)
    big = torch.full_like(gain, BIG_IDX)
    idx = all_min([big if r is None else
                   tiebreak_idx_partial(sh, neigh_max, *r[1:])
                   for sh, r in zip(group.shards, routed)], devs)[0]
    if mode == "min":
        return idx
    return mgm_decision(gain, idx_row, neigh_max, idx)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_fns = {}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "device_fused_ba": [P] * 32 + [I] * 4 + [F, F, I, I, P, P],
    "device_tables": [P] * 11 + [I] * 3 + [F, P],
    "device_tables_mixed": [P] * 18 + [I] * 4 + [F, P],
    "device_mgm_move": [P] * 11 + [I] * 2 + [P],
    "device_mgm_move_mixed": [P] * 17 + [I] * 2 + [P],
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


def _check(where, name: str, x: torch.Tensor, shape,
           dtype=torch.float32) -> None:
    """``x`` must have the dtype, shape and device of the shard or group
    ``where`` and be contiguous."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != where.device:
        raise ValueError(f"{name} is on {x.device} but the kernel's "
                         f"operands are on {where.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _nary(where) -> bool:
    """The shard or group has a ternary or quaternary slot."""
    if hasattr(where, "aseg"):  # a ShardGroup: its slots in arity order
        return where.aseg[4] > where.aseg[2]
    return where.mixed is not None and any(
        sl.numel() for sl in where.mixed.slots[2:])


def _launch_ready(where, what: str) -> bool:
    """True when the wrapper must launch the kernel (a CUDA shard or
    group); False for the plain version (the CPU)."""
    if where.device.type == "cpu":
        return False
    if where.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {where.device}")
    if not 1 <= where.D <= MAX_D:
        raise ValueError(f"{what} takes D in [1, {MAX_D}]")
    if where.D > MAX_D_NARY and _nary(where):
        raise ValueError(f"{what} takes ternary and quaternary slots at "
                         f"D <= {MAX_D_NARY}")
    return True


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


def _ptrs(*ts) -> tuple:
    return tuple(t.data_ptr() for t in ts)


def _group_args(g: ShardGroup, kernel: str, aseg) -> tuple:
    """The layout operands of a device-level kernel, in the order of its
    C entry (after the state operands); ``aseg`` is the host array K7
    reads the arity offsets from."""
    sl = g.slabs
    walk = _ptrs(g.desc, g.corder, g.cptr, g.centry, g.cshard)
    dims = (g.D, g.Vp)
    if kernel == "device_fused_ba":
        if g.mixed:  # cost1..cost4, cost_idx, slot_col, mate..mate3_col
            layout = _ptrs(*(sl[f"cost{a}"] for a in ARITIES),
                           *(sl[f] for f in ("cost_idx", "slot_col", "mate",
                                             "mate2", "mate3", "mate_col",
                                             "mate2_col", "mate3_col")))
        else:  # the cost rows as the arity-2 piece; no other arity
            layout = (None, sl["cost_rows"].data_ptr(), None, None, None,
                      *_ptrs(sl["slot_col"], sl["mate"]), None, None,
                      sl["mate_col"].data_ptr(), None, None)
        return (g.unary_p.data_ptr(), *layout,
                *_ptrs(sl["vmask"], sl["inv_dcount"], g.items,
                       g.item_shard),
                ctypes.cast(aseg, ctypes.c_void_p).value, *walk, *dims,
                int(g.mixed), int(_nary(g)))
    if kernel == "device_tables":
        return (g.unary_p.data_ptr(), g.mask_p.data_ptr(),
                *_ptrs(sl["cost_rows"], sl["mate_col"]), *walk, *dims)
    return (g.unary_p.data_ptr(), g.mask_p.data_ptr(),
            *_ptrs(*(sl[f"cost{a}"] for a in ARITIES), sl["arity"],
                   sl["cost_idx"], sl["mate_col"], sl["mate2_col"],
                   sl["mate3_col"]), *walk, *dims, int(_nary(g)))


def _result(g: ShardGroup, rows: int, like: torch.Tensor) -> torch.Tensor:
    """The device-level kernels' result: [rows, Vp] for a whole group,
    else the [S, rows, Vp] partials, zeroed (the kernels write a shard's
    partial of a column only where it has slots there)."""
    if g.whole:
        return torch.empty((rows, g.Vp), dtype=torch.float32,
                           device=like.device)
    return torch.zeros((len(g.shards), rows, g.Vp), dtype=torch.float32,
                       device=like.device)


def device_fused_ba(group: ShardGroup, bel_g: torch.Tensor,
                    r_u: torch.Tensor, damping: float = 0.0,
                    q_m: Optional[torch.Tensor] = None,
                    r_m: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None):
    """One rotated MaxSum cycle of every shard a device holds, in one
    launch: from the combined beliefs of the previous cycle ``bel_g``
    [D, Vp] (unary included) and the shards' unmasked messages ``r_u``
    (a [D * n_slots] slab, shard k's [D, N_k] piece at D * soff[k]),
    return (r_new slab, result): for a whole group the combined beliefs
    [D, Vp], unary + the shards' partials added in shard order; else the
    partials [S, D, Vp].  On a zero state the pending variable side is a
    no-op.

    With ``active`` (an [n_slots] slab, 1 where the previous cycle's
    messages commit) and the masked carry ``q_m``, ``r_m`` (slabs as
    ``r_u``; amaxsum), the launch commits before the factor side and
    returns (r_new, result, q1, r1).  The inputs are not modified."""
    D, N = group.D, group.n_slots
    _check(group, "bel_g", bel_g, (D, group.Vp))
    _check(group, "r_u", r_u, (D * N,))
    act = active is not None
    if act:
        _check(group, "q_m", q_m, (D * N,))
        _check(group, "r_m", r_m, (D * N,))
        _check(group, "active", active, (N,))
    elif q_m is not None or r_m is not None:
        raise ValueError("q_m and r_m go with an activation row")
    if not _launch_ready(group, "device_fused_ba"):
        return device_fused_ba_plain(group, bel_g, r_u, damping, q_m, r_m,
                                     active)
    r_out = torch.empty_like(r_u)
    result = _result(group, D, bel_g)
    q1 = r1 = None
    act_ptrs = (None,) * 5
    if act:
        q1, r1 = torch.empty_like(r_u), torch.empty_like(r_u)
        act_ptrs = (q_m.data_ptr(), r_m.data_ptr(), active.data_ptr(),
                    q1.data_ptr(), r1.data_ptr())
    aseg = (ctypes.c_longlong * 5)(*group.aseg)
    err = _kernel("device_fused_ba")(
        bel_g.data_ptr(), r_u.data_ptr(), *act_ptrs[:3], r_out.data_ptr(),
        *act_ptrs[3:], result.data_ptr(),
        *_group_args(group, "device_fused_ba", aseg), float(damping),
        float(1.0 - damping), 1 if damping else 0, 1 if group.whole else 0,
        group.barrier.data_ptr(), _stream(bel_g))
    _raise_on(err, "device_fused_ba")
    _count("device_fused_ba", ("mixed_" if group.mixed else "")
           + ("act_" if act else "") + "launches")
    if act:
        return r_out, result, q1, r1
    return r_out, result


def device_tables(group: ShardGroup, x: torch.Tensor) -> torch.Tensor:
    """The local cost tables of every shard a device holds, in one launch,
    at the assignment ``x`` ([Vp] int32 value indices in column order):
    for a whole group ``where(mask > 0, unary + the shards' partials in
    shard order, PAD_COST)`` [D, Vp], else the partials (no unary)
    [S, D, Vp]."""
    _check(group, "x", x, (group.Vp,), torch.int32)
    if not _launch_ready(group, "device_tables"):
        return device_tables_plain(group, x)
    result = _result(group, group.D, x)
    name = "device_tables" + ("_mixed" if group.mixed else "")
    err = _kernel(name)(x.data_ptr(), result.data_ptr(),
                        *_group_args(group, name, None),
                        1 if group.whole else 0,
                        float(PAD_COST), _stream(x))
    _raise_on(err, "device_tables")
    _count("device_tables",
           "mixed_launches" if group.mixed else "launches")
    return result


def device_mgm_move(group: ShardGroup, gain: torch.Tensor,
                    idx_row: Optional[torch.Tensor] = None,
                    mode: str = "move",
                    neigh_max: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """MGM's neighbourhood arbitration over every shard a device holds, in
    one launch, from the combined gains ``gain`` [Vp].  ``mode``:

    * "move" (a group that holds every shard): the move mask [Vp] bool of
      ``mgm_decision`` — move iff the own gain is positive and the strict
      neighbourhood max, ties within EPS to the smaller variable index
      (``idx_row`` [Vp] float32, each column's variable index);
    * "max": the group's partial neighbourhood max [Vp] (each column's
      siblings' routed gains over the group's slots, from 0);
    * "min": the group's partial tie-break index [Vp] at the combined,
      clamped ``neigh_max`` [Vp] (BIG_IDX where no sibling is at it).

    Across devices the engine runs "max", the ordered max, "min", the
    ordered min and :func:`mgm_decision`."""
    if mode not in MGM_MODES:
        raise ValueError(f"mode must be one of {MGM_MODES}, got {mode!r}")
    _check(group, "gain", gain, (group.Vp,))
    if mode == "move":
        if not group.whole:
            raise ValueError("mode 'move' takes a group that holds every "
                             "shard; run 'max' and 'min' across devices")
        if idx_row is None:
            raise ValueError("mode 'move' takes idx_row")
        _check(group, "idx_row", idx_row, (group.Vp,))
    elif idx_row is not None:
        raise ValueError("idx_row goes with mode 'move'")
    if mode == "min":
        if neigh_max is None:
            raise ValueError("mode 'min' takes neigh_max")
        _check(group, "neigh_max", neigh_max, (group.Vp,))
    elif neigh_max is not None:
        raise ValueError("neigh_max goes with mode 'min'")
    if not _launch_ready(group, "device_mgm_move"):
        return device_mgm_move_plain(group, gain, idx_row, mode, neigh_max)
    out = torch.empty((group.Vp,), device=gain.device,
                      dtype=torch.bool if mode == "move" else torch.float32)
    sl = group.slabs
    if group.mixed:
        name = "device_mgm_move_mixed"
        sibs = _ptrs(*(sl[f] for f in ("gmask1", "gmask2", "gmask3",
                                       "mate_col", "mate2_col", "mate3_col",
                                       "mate_idx", "mate2_idx",
                                       "mate3_idx")))
    else:
        name = "device_mgm_move"
        sibs = _ptrs(sl["gmask1"], sl["mate_col"], sl["mate_idx"])
    move = out.data_ptr() if mode == "move" else None
    err = _kernel(name)(
        gain.data_ptr(), None if idx_row is None else idx_row.data_ptr(),
        None if neigh_max is None else neigh_max.data_ptr(),
        None if mode == "move" else out.data_ptr(), move, *sibs,
        *_ptrs(group.corder, group.cptr, group.centry), group.Vp,
        MGM_MODES.index(mode), _stream(gain))
    _raise_on(err, "device_mgm_move")
    _count("device_mgm_move",
           "mixed_launches" if group.mixed else "launches")
    return out


_WRAPPERS = {fn.__name__: fn for fn in (device_fused_ba, device_tables,
                                        device_mgm_move)}


def reset_launches() -> None:
    """Zero the launch counters of the three wrappers, every branch."""
    for fn in _WRAPPERS.values():
        fn.launches = fn.mixed_launches = 0
    fn = _WRAPPERS["device_fused_ba"]
    fn.act_launches = fn.mixed_act_launches = 0


reset_launches()
