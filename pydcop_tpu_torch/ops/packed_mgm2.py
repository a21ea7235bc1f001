"""Packed MGM-2 engine on the GPU layouts (all-binary and mixed arity
1-4).

The counterpart of the JAX package's ``ops/pallas_mgm2.py``
(``PackedMgm2``, ``pack_mgm2_from_pls``, ``packed_mgm2_cycles``, both
branches) on the port's packed local-search layouts
(:mod:`pydcop_tpu_torch.ops.packed_local_search`).

On top of that layout MGM-2 needs two int32 slot arrays:

* ``pick_rank [N]``: each binary slot's index in its variable's
  incidence order — pair edges (binary factors) by id, side 0 before
  side 1, the order in which the offer pick ``floor(u_pick * max(deg,
  1))`` counts.  It is NOT the slot rank of the layout (``pack_for_gpu``
  ranks a variable's slots by endpoint id ``p*F + f``, all side-0
  endpoints first, and on the mixed layout after the unary slots);
* ``edge_id [N]``: the pair-edge id ``f``, the same on both endpoints
  (the receiver's lowest-edge-id tie-break);

both ``NO_INDEX`` on the mixed layout's unary, ternary and quaternary
slots (pairing stays binary-only), and ``deg_col [Vp]``, the pair degree
of each column: its number of binary slots (the JAX packer's
``counter``), which on an all-binary graph is its degree (``col_deg``).
Index compares are int32 throughout, where the Pallas kernel compares
float32 indices with a 1e9 sentinel.

On the mixed layout the tables cover every arity, the joint gains and
the pair moves read the binary cost array only, and the gain and go
arbitration runs over every sibling of every slot
(``pallas_mgm2.py:329-360``).

:func:`packed_mgm2_cycles` launches the hand-written CUDA kernel of
``csrc/mgm2.cu`` on CUDA tensors: ONE cooperative launch a call runs all
its cycles, the six rounds of each a phase of the grid, split by grid
barriers (the mixed layout has an entry of its own).  It runs
:func:`packed_mgm2_cycles_plain`, the same arithmetic in torch ops, only
on CPU tensors.  A build or launch failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.packed_local_search import (
    EPS,
    NO_INDEX,
    PackedLocalSearch,
    _on,
    _per_column,
    _raise_on,
    _stream,
    coop_capacity,
    grid_blocks,
    ls_tables_plain,
)

#: favor modes of the response round, as the kernel numbers them
FAVORS = {"unilateral": 0, "no": 1, "coordinated": 2}


@dataclass
class PackedMgm2:
    """Static pairing arrays on top of the packed local-search layout."""

    pls: PackedLocalSearch
    pick_rank: torch.Tensor  # [N] int32 slot's index in inc[v] order
    edge_id: torch.Tensor  # [N] int32 pair-edge id of each slot
    deg_col: torch.Tensor  # [Vp] int32 pair degree of each column


def pack_mgm2_from_pls(pls: Optional[PackedLocalSearch]
                       ) -> Optional[PackedMgm2]:
    """The MGM-2 statics of ``pls`` on its device (either layout), or
    None when there is no packed layout or the graph has no binary factor
    (no pair edge: MGM-2 then runs its generic engine, as in the JAX
    package)."""
    if pls is None:
        return None
    pg = pls.pg
    soe = pg.slot_of_edge if pg.mixed is None else pg.mixed.slot_of.get(2)
    if soe is None or len(soe) == 0:
        return None
    soe = np.asarray(soe, dtype=np.int64)  # e = p*F + f
    F = len(soe) // 2
    col_var = pls.col_var.cpu().numpy().astype(np.int64)
    edge_col = pg.slot_col.cpu().numpy()[soe]
    edge_var = col_var[edge_col]  # [2F]
    # endpoints in inc[v] order: (f, side) lexicographic, then each
    # endpoint's rank among its variable's, counted in that order
    inc = np.stack([np.arange(F), np.arange(F, 2 * F)], axis=1).reshape(-1)
    ev = edge_var[inc]
    by_var = np.argsort(ev, kind="stable")
    start = np.concatenate(
        [[0], np.cumsum(np.bincount(ev, minlength=pg.Vp))[:-1]])
    rank_inc = np.empty(2 * F, dtype=np.int64)
    rank_inc[by_var] = np.arange(2 * F) - start[ev[by_var]]
    pick_rank = np.full(pg.N, NO_INDEX, dtype=np.int32)
    pick_rank[soe[inc]] = rank_inc
    edge_id = np.full(pg.N, NO_INDEX, dtype=np.int32)
    edge_id[soe] = np.tile(np.arange(F, dtype=np.int32), 2)
    deg_col = np.bincount(edge_col, minlength=pg.Vp).astype(np.int32)
    put = functools.partial(torch.as_tensor, device=pg.device)
    return PackedMgm2(pls=pls, pick_rank=put(pick_rank),
                      edge_id=put(edge_id), deg_col=put(deg_col))


# ---------------------------------------------------------------------------
# the plain PyTorch version (the kernels' arithmetic, in their order)
# ---------------------------------------------------------------------------


def _pair_slots(pg):
    """(slots [n2] int64, their binary cost rows [D*D, n2], the position
    in ``slots`` of each slot's mate [n2]): every slot on the all-binary
    layout, the binary ones (in cost-array order) on the mixed one."""
    if pg.mixed is None:
        return (torch.arange(pg.N, device=pg.device), pg.cost_rows,
                pg.mate.long())
    sl = pg.mixed.slots[1]
    return sl, pg.mixed.costs[1], pg.mixed.cost_idx.long()[pg.mate.long()[sl]]


def _gather(a: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``a[idx]`` where ``idx >= 0``, ``fill`` where it is -1 (no
    sibling): a gather at -1 would read the last entry."""
    return torch.where(idx >= 0, a[idx.clamp_min(0)], fill)


def mgm2_cycle_plain(pm: PackedMgm2, x_col: torch.Tensor,
                     u_off: torch.Tensor, u_pick: torch.Tensor,
                     u_fav: torch.Tensor, threshold: float,
                     favor: str, stats: Optional[dict] = None
                     ) -> torch.Tensor:
    """One MGM-2 cycle (``pallas_mgm2.py::_mgm2_cycle``) from the
    column-order assignment ``x_col`` and this cycle's [Vp] coins.
    ``stats`` (a dict) gets this cycle's ``offers``, ``accepted`` pairs
    and ``pair_moves`` (columns that move as half of a pair) added."""
    pls = pm.pls
    pg = pls.pg
    D = pg.D
    f32 = u_off.new_tensor
    eps = f32(EPS)
    xl = x_col.long()
    mc, mate, sc = pls.mate_col.long(), pg.mate.long(), pg.slot_col
    tables, cur, best, own_gain = ls_tables_plain(pls, x_col)

    # ---- offer round: offerers pick one binary slot by pick_rank
    offerer = u_off < f32(threshold)
    pick = torch.floor(u_pick * torch.clamp_min(pm.deg_col.float(), 1.0))
    sel = offerer[sc] & (pm.pick_rank == pick.to(torch.int32)[sc])
    offered = sel & ~_gather(offerer, mc, True)

    # ---- joint gain at each binary slot: A = own table minus this
    # edge's contribution, Am the mate's A read at the mate's slot
    bs, cost, mpos = _pair_slots(pg)
    bc, bm = sc[bs], mc[bs]
    rows = xl[bm][None, :] * D + torch.arange(D, device=xl.device)[:, None]
    contrib = cost.gather(0, rows)  # [D, n2] cost(x_mate, d)
    A = tables[:, bc] - contrib
    Am = A[:, mpos]
    cc = contrib.gather(0, xl[bc][None]).squeeze(0)
    cur_joint = (cur[bc] + cur[bm]) - cc
    rowmin = []  # M(du, dw) = cost[dw*D + du]
    for du in range(D):
        rm = Am[0] + cost[du]
        for dw in range(1, D):
            rm = torch.minimum(rm, Am[dw] + cost[dw * D + du])
        rowmin.append(A[du] + rm)
    rowmin = torch.stack(rowmin)
    du_b = torch.argmin(rowmin, dim=0)  # first index of the minimum
    best_joint = rowmin.gather(0, du_b[None]).squeeze(0)
    Adu = A.gather(0, du_b[None]).squeeze(0)
    cands = torch.stack([
        (Adu + Am[dw]) + cost.gather(0, (dw * D + du_b)[None]).squeeze(0)
        for dw in range(D)])
    dw_b = torch.argmin(cands, dim=0)
    jg_b = torch.clamp_min(cur_joint - best_joint, 0.0)
    # scattered back to every slot: 0 off the offered binary slots
    jg = torch.zeros(pg.N, dtype=torch.float32, device=xl.device)
    jg[bs] = torch.where(offered[bs], jg_b, f32(0.0))
    du_star = torch.zeros(pg.N, dtype=torch.int32, device=xl.device)
    du_star[bs] = du_b.to(torch.int32)
    dw_star = torch.zeros_like(du_star)
    dw_star[bs] = dw_b.to(torch.int32)

    # ---- response round, per receiver column
    jg_in = _gather(jg, mate, f32(0.0))
    pos = jg_in > eps
    rec_max = _per_column(pls, torch.where(pos, jg_in, f32(-1.0)),
                          torch.maximum, -1.0)
    at_best = pos & (jg_in >= (rec_max - eps)[sc])
    first_e = _per_column(
        pls, torch.where(at_best, pm.edge_id,
                         torch.full_like(pm.edge_id, NO_INDEX)),
        torch.minimum, NO_INDEX)
    beats = rec_max > own_gain + eps
    ties = (rec_max - own_gain).abs() <= eps
    if favor == "coordinated":
        commits = beats | ties
    elif favor == "no":
        commits = beats | (ties & (u_fav > f32(0.5)))
    else:
        commits = beats
    accepted = at_best & (pm.edge_id == first_e[sc]) & commits[sc]

    # ---- committed pairs, both sides
    acc_back = _gather(accepted, mate, False)  # my offer came back accepted
    mine = accepted | acc_back
    committed = _per_column(pls, mine.to(torch.int32), torch.maximum, 0) > 0
    no_slot = torch.full_like(x_col[sc], -1)
    tgt_slot = torch.where(accepted, _gather(dw_star, mate, -1),
                           torch.where(acc_back, du_star, no_slot))
    pair_target = _per_column(pls, tgt_slot, torch.maximum, -1)
    gain_slot = torch.where(accepted, jg_in,
                            torch.where(acc_back, jg, f32(0.0)))
    pair_gain = _per_column(pls, gain_slot, torch.maximum, 0.0)
    partner = _per_column(
        pls, torch.where(mine, pls.mate_idx,
                         torch.full_like(pls.mate_idx, NO_INDEX)),
        torch.minimum, NO_INDEX)

    # ---- gain and go rounds over every sibling of every slot, partners
    # sharing the tie-break id; a missing sibling routes gain 0 and id
    # NO_INDEX
    gain = torch.where(committed, pair_gain, own_gain)
    pid = torch.where(committed, torch.minimum(pls.col_var, partner),
                      pls.col_var)
    sibs = [c.long() for c, _ in pls.siblings()]
    gns = [_gather(gain, c, f32(0.0)) for c in sibs]
    pns = [_gather(pid, c, NO_INDEX) for c in sibs]
    g_max = gns[0]
    for g in gns[1:]:
        g_max = torch.maximum(g_max, g)
    nm = torch.clamp_min(_per_column(pls, g_max, torch.maximum, 0.0), 0.0)
    thr = (nm - eps)[sc]
    cand = None
    for gn, pn in zip(gns, pns):
        cs = torch.where(gn >= thr, pn, torch.full_like(pn, NO_INDEX))
        cand = cs if cand is None else torch.minimum(cand, cs)
    idx_at_max = _per_column(pls, cand, torch.minimum, NO_INDEX)
    winner = (gain > eps) & ((gain > nm + eps) | (
        ((gain - nm).abs() <= eps) & (pid <= idx_at_max)))
    # partners read each other's verdict through the committed binary
    # slot only
    win_m = torch.where(mine, _gather(winner, mc, True).to(torch.int32),
                        torch.ones_like(pls.mate_idx))
    partner_win = _per_column(pls, win_m, torch.minimum, 1) > 0
    pair_go = committed & winner & partner_win
    if stats is not None:
        for key, flags in (("offers", offered), ("accepted", accepted),
                           ("pair_moves", pair_go & (pair_target != x_col))):
            stats[key] = stats.get(key, 0) + int(flags.sum())
    x2 = torch.where(pair_go, pair_target, x_col)
    return torch.where(~committed & winner, best, x2)


def packed_mgm2_cycles_plain(pm: PackedMgm2, x_col: torch.Tensor,
                             u_off: torch.Tensor, u_pick: torch.Tensor,
                             u_fav: torch.Tensor, threshold: float,
                             favor: str = "unilateral") -> torch.Tensor:
    for i in range(u_off.shape[0]):
        x_col = mgm2_cycle_plain(pm, x_col, u_off[i], u_pick[i], u_fav[i],
                                 threshold, favor)
    return x_col


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_fns = {}


def _kernel(mixed: bool):
    """The C entry ``mgm2_cycles`` (or ``mgm2_cycles_mixed``) of
    ``csrc/mgm2.cu``, bound once."""
    if mixed not in _fns:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I = ctypes.c_void_p, ctypes.c_int
        lib = load("mgm2")
        fn = lib.mgm2_cycles_mixed if mixed else lib.mgm2_cycles
        fn.restype = ctypes.c_int
        n_ptr, n_int = (28, 8) if mixed else (20, 4)
        fn.argtypes = ([P] * n_ptr + [I] * n_int
                       + [ctypes.c_float, I, I, P, P])
        _fns[mixed] = fn
    return _fns[mixed]


def _capacity(D: int, mixed: bool) -> Tuple[int, int]:
    """(resident blocks, threads a block) of the kernel of one branch."""
    return coop_capacity("mgm2", "mgm2_capacity", D, mixed)


#: blocks of one launch (one thread a column, at most the capacity)
mgm2_blocks = grid_blocks


def _layout_args(pm: PackedMgm2):
    """The layout operands of the binary or the mixed C entry, between
    the coins and the scratch."""
    pls = pm.pls
    pg = pls.pg
    cols = (pls.col_var.data_ptr(), pg.col_deg.data_ptr(),
            pg.col_slot0.data_ptr(), pg.col_stride.data_ptr(),
            pm.pick_rank.data_ptr(), pm.edge_id.data_ptr())
    if pg.mixed is None:
        return (pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
                pg.mask_p.data_ptr(), pg.mate.data_ptr(),
                pls.mate_col.data_ptr(), pls.mate_idx.data_ptr(), *cols)
    m = pg.mixed
    return (*(c.data_ptr() for c in m.costs), m.arity.data_ptr(),
            m.cost_idx.data_ptr(), pg.unary_p.data_ptr(),
            pg.mask_p.data_ptr(), pg.mate.data_ptr(),
            pls.mate_col.data_ptr(), pls.mate2_col.data_ptr(),
            pls.mate3_col.data_ptr(), pls.mate_idx.data_ptr(), *cols,
            pm.deg_col.data_ptr())


def packed_mgm2_cycles(pm: PackedMgm2, x_col: torch.Tensor,
                       u_off: torch.Tensor, u_pick: torch.Tensor,
                       u_fav: torch.Tensor, threshold: float = 0.5,
                       favor: str = "unilateral") -> torch.Tensor:
    """``n`` MGM-2 cycles, one per row of the ``[n, Vp]`` column-order
    coins (offer, pick, favor), from ``x_col`` (left unchanged).

    On CUDA tensors this makes one cooperative launch of the kernel on
    the current stream that runs all ``n`` cycles, and adds one to
    ``packed_mgm2_cycles.launches`` on the binary layout or to
    ``packed_mgm2_cycles.mixed_launches`` on the mixed one.  On CPU
    tensors it runs the plain version."""
    if favor not in FAVORS:
        raise ValueError(f"unknown favor mode {favor!r}")
    if u_off.dim() != 2 or u_off.shape[0] < 1:
        raise ValueError("u_off must be [n >= 1, Vp]")
    pls = pm.pls
    on_cuda = _on(pls, "x", x_col, torch.int32, (pls.Vp,))
    for name, u in (("u_off", u_off), ("u_pick", u_pick), ("u_fav", u_fav)):
        _on(pls, name, u, torch.float32, tuple(u_off.shape))
    if not on_cuda:
        return packed_mgm2_cycles_plain(pm, x_col, u_off, u_pick, u_fav,
                                        threshold, favor)
    return _launch_cycles(pm, x_col, u_off, u_pick, u_fav, threshold, favor)


def _launch_cycles(pm: PackedMgm2, x_col: torch.Tensor, u_off: torch.Tensor,
                   u_pick: torch.Tensor, u_fav: torch.Tensor,
                   threshold: float, favor: str,
                   blocks: Optional[int] = None) -> torch.Tensor:
    """:func:`packed_mgm2_cycles` on checked CUDA operands: the kernel's
    one launch, or RuntimeError.  ``blocks`` forces the grid (1 up to the
    capacity; the checks on the card run the grid-stride loops so); by
    default it is :func:`mgm2_blocks`.  The grid barrier takes one word
    that this call allocates zeroed and no other call shares."""
    pg = pm.pls.pg
    mixed = pg.mixed is not None
    name = "mgm2_cycles_mixed" if mixed else "mgm2_cycles"
    capacity, threads = _capacity(pg.D, mixed)
    if capacity <= 0:
        raise RuntimeError(f"{name}: the device reports no resident block "
                           f"for the cooperative launch")
    if blocks is None:
        blocks = mgm2_blocks(pg.Vp, capacity, threads)
    elif not 1 <= blocks <= capacity:
        raise ValueError(f"{name}: {blocks} blocks, the capacity is "
                         f"{capacity}")
    n = int(u_off.shape[0])
    dev = x_col.device
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    fwork = torch.empty((pg.D + 4) * pg.Vp, dtype=torch.float32, device=dev)
    iwork = torch.empty(9 * pg.Vp, dtype=torch.int32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    widths = (tuple(int(sl.numel()) for sl in pg.mixed.slots) if mixed
              else ())
    err = _kernel(mixed)(
        x_col.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        u_off.data_ptr(), u_pick.data_ptr(), u_fav.data_ptr(),
        *_layout_args(pm), fwork.data_ptr(), iwork.data_ptr(),
        pg.D, pg.N, pg.Vp, *widths, n, float(threshold), FAVORS[favor],
        blocks, bar.data_ptr(), _stream(x_col))
    _raise_on(err, name)
    if mixed:
        packed_mgm2_cycles.mixed_launches += 1
    else:
        packed_mgm2_cycles.launches += 1
    return bufs[(n - 1) % 2]


def reset_launches() -> None:
    """Zero the launch counters (``launches``: the binary branch's;
    ``mixed_launches``: the mixed one's)."""
    packed_mgm2_cycles.launches = packed_mgm2_cycles.mixed_launches = 0


reset_launches()
