"""Per-shard kernels of the sharded engines (all-binary branch).

The counterpart of the JAX package's ``ops/pallas_sharded.py``.  Each
kernel computes ONE shard's part of a cycle on that shard's layout
(:class:`~pydcop_tpu_torch.parallel.packed_mesh.ShardLayout`) and device;
the engines (``parallel/mesh.py``) combine the shards' partials with the
ordered collectives of ``parallel/collectives.py``:

* :func:`shard_fused_ba` (K7, ``packed_shard_fused_ba``) — one sharded
  MaxSum cycle, rotated: the previous cycle's variable side (expand the
  combined beliefs to the slots, subtract r, centre on the valid values'
  mean) then this cycle's factor side (min over the cost rows plus the
  mate's q, vmask, damping) and the per-column partial beliefs;
* :func:`shard_route_gains` (K8, ``packed_shard_route_gains``) — the
  shard's half of MGM's arbitration: each slot's mate's gain, and the
  per-column maximum over the shard's slots;
* :func:`shard_tables` (K9, ``packed_shard_tables``) — the shard's partial
  local cost tables at the current assignment, without unary costs.

Each wrapper launches its hand-written CUDA kernel (``csrc/sharded.cu``)
on CUDA tensors and counts the launch (``.launches``); on CPU tensors it
runs the plain PyTorch version beside it, the same arithmetic in the same
order.  A build or launch failure on CUDA raises; nothing falls back.

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
from typing import TYPE_CHECKING, Tuple

import torch

from pydcop_tpu_torch.ops.packed_maxsum import MAX_D
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


def shard_fused_ba_plain(sh: ShardLayout, bel_g: torch.Tensor,
                         r_u: torch.Tensor, damping: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_new [D, N], partial beliefs [D, Vp]): K7's arithmetic."""
    D = sh.D
    # pending variable side of the previous cycle (a no-op on zero state)
    q = bel_g[:, sh.slot_col.long()] - r_u
    mean = ordered_sum(q * sh.vmask, axis=0) * sh.inv_dcount
    q = (q - mean) * sh.vmask
    # this cycle's factor side: the mate's q, min over the other value
    qm = q[:, sh.mate.long()]
    cost = sh.cost_rows
    r_new = cost[0:D] + qm[0:1]
    for j in range(1, D):
        r_new = torch.minimum(r_new, cost[j * D:(j + 1) * D] + qm[j:j + 1])
    r_new = r_new * sh.vmask
    if damping:
        r_new = damping * r_u + (1.0 - damping) * r_new
    return r_new, reduce_columns(sh, r_new, "sum", 0.0)


def shard_route_gains_plain(sh: ShardLayout, gain: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nm_part [Vp], gn [N]): K8's arithmetic."""
    gn = gain[sh.mate_col.long()] * sh.gmask1
    return reduce_columns(sh, gn[None], "amax", 0.0)[0], gn


def shard_tables_plain(sh: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """Partial local cost tables [D, Vp] at ``x`` ([Vp] int32 values in
    column order): K9's arithmetic."""
    D = sh.D
    xm = x[sh.mate_col.long()].long()
    d = torch.arange(D, device=x.device)[:, None]
    contrib = sh.cost_rows.gather(0, xm[None, :] * D + d)
    return reduce_columns(sh, contrib, "sum", 0.0)


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
                         gn: torch.Tensor) -> torch.Tensor:
    """[Vp] smallest neighbour index at the (combined) neighbourhood max
    over the shard's slots, BIG_IDX where none: ``_tiebreak_idx_partial``."""
    nm_exp = neigh_max[sh.slot_col.long()]
    cand = torch.where(gn >= nm_exp - EPS, sh.mate_idx,
                       torch.full_like(sh.mate_idx, BIG_IDX))
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


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/sharded.cu``, bound once."""
    if name not in _fns:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        argtypes = {
            "shard_fused_ba": [P] * 13 + [I] * 3 + [F, F, I, P],
            "shard_route_gains": [P] * 9 + [I] * 2 + [P],
            "shard_tables": [P] * 8 + [I] * 3 + [P],
        }[name]
        fn = getattr(load("sharded"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
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
    return True


def _layout_ptrs(sh: ShardLayout):
    return (sh.tcol.data_ptr(), sh.t_deg.data_ptr(), sh.t_slot0.data_ptr(),
            sh.t_stride.data_ptr())


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def shard_fused_ba(sh: ShardLayout, bel_g: torch.Tensor, r_u: torch.Tensor,
                   damping: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's rotated MaxSum cycle: from the combined beliefs of the
    previous cycle ``bel_g`` [D, Vp] (unary included) and the shard's
    unmasked messages ``r_u`` [D, N], return (r_new [D, N], partial
    beliefs [D, Vp] without unary).  On a zero state the pending variable
    side is a no-op.  The inputs are not modified."""
    _check(sh, "bel_g", bel_g, (sh.D, sh.Vp))
    _check(sh, "r_u", r_u, (sh.D, sh.N))
    if not _launch_ready(sh, "shard_fused_ba"):
        return shard_fused_ba_plain(sh, bel_g, r_u, damping)
    r_out = torch.empty_like(r_u)
    partial = torch.empty_like(bel_g)
    err = _kernel("shard_fused_ba")(
        bel_g.data_ptr(), r_u.data_ptr(), r_out.data_ptr(),
        partial.data_ptr(), sh.cost_rows.data_ptr(), sh.vmask.data_ptr(),
        sh.inv_dcount.data_ptr(), sh.mate.data_ptr(), sh.mate_col.data_ptr(),
        *_layout_ptrs(sh), sh.D, sh.N, sh.Vp, float(damping),
        float(1.0 - damping), 1 if damping else 0, _stream(bel_g))
    _raise_on(err, "shard_fused_ba")
    shard_fused_ba.launches += 1
    return r_out, partial


def shard_route_gains(sh: ShardLayout, gain: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard's half of MGM's arbitration from the combined gains
    ``gain`` [Vp]: (nm_part [Vp], the per-column max of the mates' gains
    over the shard's slots, 0 where it has none; gn [N], each slot's
    mate's gain times ``gmask1``)."""
    _check(sh, "gain", gain, (sh.Vp,))
    if not _launch_ready(sh, "shard_route_gains"):
        return shard_route_gains_plain(sh, gain)
    nm_part = torch.empty_like(gain)
    gn = torch.empty((sh.N,), dtype=torch.float32, device=gain.device)
    err = _kernel("shard_route_gains")(
        gain.data_ptr(), sh.gmask1.data_ptr(), nm_part.data_ptr(),
        gn.data_ptr(), sh.mate_col.data_ptr(), *_layout_ptrs(sh), sh.N,
        sh.Vp, _stream(gain))
    _raise_on(err, "shard_route_gains")
    shard_route_gains.launches += 1
    return nm_part, gn


def shard_tables(sh: ShardLayout, x: torch.Tensor) -> torch.Tensor:
    """The shard's partial local cost tables [D, Vp] (no unary) at the
    assignment ``x`` ([Vp] int32 value indices in column order)."""
    _check(sh, "x", x, (sh.Vp,), torch.int32)
    if not _launch_ready(sh, "shard_tables"):
        return shard_tables_plain(sh, x)
    partial = torch.empty((sh.D, sh.Vp), dtype=torch.float32,
                          device=x.device)
    err = _kernel("shard_tables")(
        x.data_ptr(), partial.data_ptr(), sh.cost_rows.data_ptr(),
        sh.mate_col.data_ptr(), *_layout_ptrs(sh), sh.D, sh.N, sh.Vp,
        _stream(x))
    _raise_on(err, "shard_tables")
    shard_tables.launches += 1
    return partial


def reset_launches() -> None:
    """Zero the launch counters of the three wrappers."""
    for fn in (shard_fused_ba, shard_route_gains, shard_tables):
        fn.launches = 0


reset_launches()
