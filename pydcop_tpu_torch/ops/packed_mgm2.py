"""Packed MGM-2 engine for all-binary constraint graphs (GPU layout).

The counterpart of the JAX package's ``ops/pallas_mgm2.py``
(``PackedMgm2``, ``pack_mgm2_from_pls``, ``packed_mgm2_cycles``, its
all-binary branch) on the port's packed local-search layout
(:mod:`pydcop_tpu_torch.ops.packed_local_search`).

On top of that layout MGM-2 needs two int32 slot arrays:

* ``pick_rank [N]``: each slot's index in its variable's incidence order
  — pair edges by id, side 0 before side 1, the order in which the offer
  pick ``floor(u_pick * max(deg, 1))`` counts.  It is NOT the slot rank
  of the layout (``pack_for_gpu`` ranks a variable's slots by endpoint id
  ``p*F + f``, all side-0 endpoints first);
* ``edge_id [N]``: the pair-edge id ``f``, the same on both endpoints
  (the receiver's lowest-edge-id tie-break);

and the pair degree of each column, which on an all-binary graph is its
degree (``col_deg``).  Index compares are int32 throughout, where the
Pallas kernel compares float32 indices with a 1e9 sentinel.

:func:`packed_mgm2_cycles` launches the hand-written CUDA kernels of
``csrc/mgm2.cu`` (six dependent launches a cycle, all cycles of a chunk
from one host call) on CUDA tensors and runs
:func:`packed_mgm2_cycles_plain`, the same arithmetic in torch ops, only
on CPU tensors.  A build or launch failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

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
    ls_tables_plain,
)

#: favor modes of the response round, as the kernel numbers them
FAVORS = {"unilateral": 0, "no": 1, "coordinated": 2}
#: kernel launches of one cycle (tables, offer, response, commit, winner,
#: go)
LAUNCHES_PER_CYCLE = 6


@dataclass
class PackedMgm2:
    """Static pairing arrays on top of the packed local-search layout."""

    pls: PackedLocalSearch
    pick_rank: torch.Tensor  # [N] int32 slot's index in inc[v] order
    edge_id: torch.Tensor  # [N] int32 pair-edge id of each slot

    @property
    def deg_col(self) -> torch.Tensor:
        """[Vp] int32 pair degree of each column (its degree: every
        constraint of an all-binary graph is a pair edge)."""
        return self.pls.pg.col_deg


def pack_mgm2_from_pls(pls: Optional[PackedLocalSearch]
                       ) -> Optional[PackedMgm2]:
    """The MGM-2 statics of ``pls`` on its device, or None when there is
    no packed layout, no pair edge, or the layout is the mixed-arity one
    (the mixed branch of the JAX kernel, ``pallas_mgm2.py:329-354``, is
    not ported yet: MGM-2 keeps its generic engine on mixed graphs)."""
    if pls is None or pls.pg.mixed is not None:
        return None
    pg = pls.pg
    soe = np.asarray(pg.slot_of_edge, dtype=np.int64)  # e = p*F + f
    F = len(soe) // 2
    if F == 0:
        return None
    col_var = pls.col_var.cpu().numpy().astype(np.int64)
    edge_var = col_var[pg.slot_col.cpu().numpy()[soe]]  # [2F]
    # endpoints in inc[v] order: (f, side) lexicographic, then each
    # endpoint's rank among its variable's, counted in that order
    inc = np.stack([np.arange(F), np.arange(F, 2 * F)], axis=1).reshape(-1)
    ev = edge_var[inc]
    by_var = np.argsort(ev, kind="stable")
    start = np.concatenate(
        [[0], np.cumsum(np.bincount(ev, minlength=pg.Vp))[:-1]])
    rank_inc = np.empty(2 * F, dtype=np.int64)
    rank_inc[by_var] = np.arange(2 * F) - start[ev[by_var]]
    pick_rank = np.empty(pg.N, dtype=np.int32)
    pick_rank[soe[inc]] = rank_inc
    edge_id = np.empty(pg.N, dtype=np.int32)
    edge_id[soe] = np.tile(np.arange(F, dtype=np.int32), 2)
    return PackedMgm2(
        pls=pls,
        pick_rank=torch.as_tensor(pick_rank, device=pg.device),
        edge_id=torch.as_tensor(edge_id, device=pg.device),
    )


# ---------------------------------------------------------------------------
# the plain PyTorch version (the kernels' arithmetic, in their order)
# ---------------------------------------------------------------------------


def mgm2_cycle_plain(pm: PackedMgm2, x_col: torch.Tensor,
                     u_off: torch.Tensor, u_pick: torch.Tensor,
                     u_fav: torch.Tensor, threshold: float,
                     favor: str) -> torch.Tensor:
    """One MGM-2 cycle (``pallas_mgm2.py::_mgm2_cycle``, all-binary) from
    the column-order assignment ``x_col`` and this cycle's [Vp] coins."""
    pls = pm.pls
    pg = pls.pg
    D = pg.D
    f32 = u_off.new_tensor
    eps = f32(EPS)
    xl = x_col.long()
    mc, mate, sc = pls.mate_col.long(), pg.mate.long(), pg.slot_col
    tables, cur, best, own_gain = ls_tables_plain(pls, x_col)

    # ---- offer round: offerers pick one slot by pick_rank
    offerer = u_off < f32(threshold)
    pick = torch.floor(u_pick * torch.clamp_min(pm.deg_col.float(), 1.0))
    sel = offerer[sc] & (pm.pick_rank == pick.to(torch.int32)[sc])
    offered = sel & ~offerer[mc]

    # ---- joint gain at each slot: A = own table minus this edge's
    # contribution, Am the mate's A read at the mate's slot
    rows = xl[mc][None, :] * D + torch.arange(D, device=xl.device)[:, None]
    contrib = pg.cost_rows.gather(0, rows)  # [D, N] cost(x_mate, d)
    A = tables[:, sc] - contrib
    Am = A[:, mate]
    cc = contrib.gather(0, xl[sc][None]).squeeze(0)
    cur_joint = (cur[sc] + cur[mc]) - cc
    cost = pg.cost_rows  # M(du, dw) = cost[dw*D + du]
    rowmin = []
    for du in range(D):
        rm = Am[0] + cost[du]
        for dw in range(1, D):
            rm = torch.minimum(rm, Am[dw] + cost[dw * D + du])
        rowmin.append(A[du] + rm)
    rowmin = torch.stack(rowmin)
    du_star = torch.argmin(rowmin, dim=0)  # first index of the minimum
    best_joint = rowmin.gather(0, du_star[None]).squeeze(0)
    Adu = A.gather(0, du_star[None]).squeeze(0)
    cands = torch.stack([
        (Adu + Am[dw]) + cost.gather(0, (dw * D + du_star)[None]).squeeze(0)
        for dw in range(D)])
    dw_star = torch.argmin(cands, dim=0)
    jg = torch.clamp_min(cur_joint - best_joint, 0.0)
    jg = torch.where(offered, jg, f32(0.0))

    # ---- response round, per receiver column
    jg_in = jg[mate]
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
    acc_back = accepted[mate]  # my offer came back accepted
    mine = accepted | acc_back
    committed = _per_column(pls, mine.to(torch.int32), torch.maximum, 0) > 0
    no_slot = torch.full_like(x_col[sc], -1)
    tgt_slot = torch.where(accepted, dw_star[mate].to(torch.int32),
                           torch.where(acc_back, du_star.to(torch.int32),
                                       no_slot))
    pair_target = _per_column(pls, tgt_slot, torch.maximum, -1)
    gain_slot = torch.where(accepted, jg_in,
                            torch.where(acc_back, jg, f32(0.0)))
    pair_gain = _per_column(pls, gain_slot, torch.maximum, 0.0)
    partner = _per_column(
        pls, torch.where(mine, pls.mate_idx,
                         torch.full_like(pls.mate_idx, NO_INDEX)),
        torch.minimum, NO_INDEX)

    # ---- gain and go rounds, partners sharing the tie-break id
    gain = torch.where(committed, pair_gain, own_gain)
    pid = torch.where(committed, torch.minimum(pls.col_var, partner),
                      pls.col_var)
    gn, pn = gain[mc], pid[mc]
    nm = torch.clamp_min(_per_column(pls, gn, torch.maximum, 0.0), 0.0)
    cand = torch.where(gn >= (nm - eps)[sc], pn,
                       torch.full_like(pn, NO_INDEX))
    idx_at_max = _per_column(pls, cand, torch.minimum, NO_INDEX)
    winner = (gain > eps) & ((gain > nm + eps) | (
        ((gain - nm).abs() <= eps) & (pid <= idx_at_max)))
    win_m = torch.where(mine, winner[mc].to(torch.int32),
                        torch.ones_like(pls.mate_idx))
    partner_win = _per_column(pls, win_m, torch.minimum, 1) > 0
    x2 = torch.where(committed & winner & partner_win, pair_target, x_col)
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

_fn = []


def _kernel():
    """The C entry of ``csrc/mgm2.cu``, bound once."""
    if not _fn:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I = ctypes.c_void_p, ctypes.c_int
        fn = load("mgm2").mgm2_cycles
        fn.restype = ctypes.c_int
        fn.argtypes = ([P] * 20 + [I] * 4 + [ctypes.c_float, I, P,
                                             ctypes.POINTER(I)])
        _fn.append(fn)
    return _fn[0]


def packed_mgm2_cycles(pm: PackedMgm2, x_col: torch.Tensor,
                       u_off: torch.Tensor, u_pick: torch.Tensor,
                       u_fav: torch.Tensor, threshold: float = 0.5,
                       favor: str = "unilateral") -> torch.Tensor:
    """``n`` MGM-2 cycles, one per row of the ``[n, Vp]`` column-order
    coins (offer, pick, favor), from ``x_col`` (left unchanged).

    On CUDA tensors this makes one host call that launches the six
    kernels of each cycle on the current stream
    (``packed_mgm2_cycles.launches`` adds the launches that call reports
    having made); on CPU tensors it runs the plain version."""
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
    pg = pls.pg
    n = int(u_off.shape[0])
    bufs = [torch.empty_like(x_col), torch.empty_like(x_col)]
    fwork = torch.empty((pg.D + 4) * pg.Vp, dtype=torch.float32,
                        device=x_col.device)
    iwork = torch.empty(9 * pg.Vp, dtype=torch.int32, device=x_col.device)
    launched = ctypes.c_int(0)
    err = _kernel()(
        x_col.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        u_off.data_ptr(), u_pick.data_ptr(), u_fav.data_ptr(),
        pg.cost_rows.data_ptr(), pg.unary_p.data_ptr(),
        pg.mask_p.data_ptr(), pg.mate.data_ptr(), pls.mate_col.data_ptr(),
        pls.mate_idx.data_ptr(), pls.col_var.data_ptr(),
        pg.col_deg.data_ptr(), pg.col_slot0.data_ptr(),
        pg.col_stride.data_ptr(), pm.pick_rank.data_ptr(),
        pm.edge_id.data_ptr(), fwork.data_ptr(), iwork.data_ptr(),
        pg.D, pg.N, pg.Vp, n, float(threshold), FAVORS[favor],
        _stream(x_col), ctypes.byref(launched))
    packed_mgm2_cycles.launches += launched.value
    _raise_on(err, "mgm2_cycles")
    return bufs[(n - 1) % 2]


packed_mgm2_cycles.launches = 0


def reset_launches() -> None:
    packed_mgm2_cycles.launches = 0
