"""Ordered collectives across the shards of one process.

The counterpart of ``jax.lax.psum`` / ``pmax`` / ``pmin`` inside the JAX
package's ``shard_map`` cycles (``parallel/mesh.py``): every shard holds
a partial of the same shape; each function combines them and hands the
result back to every shard's device.

The sum runs in shard order, 0, 1, ..., S-1, with one explicit add per
shard, so a run on the card adds the same float32 values in the same
order as a run on the CPU and the two agree bit for bit
(``torch.sum`` over a stacked ``[S, ...]`` tensor promises no order on
CUDA).  Max and min are exact in any order; they take the same loop.

Shards may share a device (all on one H100, or on the CPU): the result
is placed once per distinct device, and shards on one device share one
tensor.  Where one device holds every shard, the launches of K7, K8 and
K9 combine the shards themselves (``ops/packed_sharded.py``) and nothing
comes here; across devices every combine does, one partial per device
(K8) or per shard (K7, K9).  A shard that holds no factor passes the
operation's identity (zeros for the sums and the gain maxima, the "no
index" sentinel for the tie-break minima) — it launches nothing.

The compact modes of the engines (``overlap="exact"|"stale"``,
``exchange=True``; the counterpart of the JAX package's
``_combine_boundary``) combine at the boundary columns only:
:func:`boundary_reduce` reduces the entries' slabs at the boundary index
in entry order and :func:`put_boundary` writes the total back over an
entry, whose other columns keep its own partial (the total of an
interior column: its owner holds every factor of it);
:func:`exchange` runs a neighbour-exchange plan's rounds of pairwise
index sends instead, each sender sending its own partial and each
receiver combining what it gets under the plan's valid bits with the
operation's neutral (:data:`NEG_BIG`, :data:`POS_BIG`, :data:`INT_BIG`)
at padding positions.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

#: the neighbour exchange's neutrals at padding positions: float max,
#: float min, and int max / min (``_NEG_BIG``, ``_POS_BIG``, ``_INT_BIG``)
NEG_BIG = -3.0e38
POS_BIG = 3.0e38
INT_BIG = int(np.iinfo(np.int32).max)

_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _all_reduce(parts: Sequence[torch.Tensor],
                devices: Sequence[torch.device],
                combine: Callable) -> List[torch.Tensor]:
    if len(parts) != len(devices) or not parts:
        raise ValueError(
            f"one partial per entry of devices: got {len(parts)} partials "
            f"for {len(devices)} devices")
    acc = parts[0]
    for p in parts[1:]:
        acc = combine(acc, p.to(acc.device))
    placed = {}
    out = []
    for dev in devices:
        dev = torch.device(dev)
        if dev not in placed:
            placed[dev] = acc.to(dev)
        out.append(placed[dev])
    return out


def all_sum(parts: Sequence[torch.Tensor],
            devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The shards' partials added in shard order, on each shard's
    device."""
    return _all_reduce(parts, devices, torch.add)


def all_max(parts: Sequence[torch.Tensor],
            devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise maximum of the shards' partials, on each shard's
    device."""
    return _all_reduce(parts, devices, torch.maximum)


def all_min(parts: Sequence[torch.Tensor],
            devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise minimum of the shards' partials, on each shard's
    device."""
    return _all_reduce(parts, devices, torch.minimum)


def boundary_reduce(parts: Sequence[torch.Tensor],
                    devices: Sequence[torch.device],
                    bnd: Sequence[torch.Tensor], axis: int,
                    op: str = "sum") -> List[torch.Tensor]:
    """The entries' slabs at the boundary index combined in entry order
    (``op``: "sum", "max" or "min"), on each entry's device.  ``bnd[k]``
    is the index on entry k's device; only the slabs cross devices."""
    slabs = [p.index_select(axis, b) for p, b in zip(parts, bnd)]
    return _all_reduce(slabs, devices, _COMBINE[op])


def put_boundary(part: torch.Tensor, bnd: torch.Tensor, total: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """``part`` with its boundary columns (rows for ``axis`` 0) replaced
    by ``total``; a padding position of ``bnd`` repeats a column and
    carries the same value."""
    return part.index_copy(axis, bnd, total)


#: one send of an exchange round: (sender, receiver, the sender's column
#: index on its device, the receiver's column index and valid bits on
#: its device)
ExchangeStep = Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor]


def _neutral(t: torch.Tensor, op: str):
    if op == "sum":
        return 0
    if t.dtype.is_floating_point:
        return NEG_BIG if op == "max" else POS_BIG
    return -INT_BIG if op == "max" else INT_BIG


def exchange(parts: Sequence[torch.Tensor],
             rounds: Sequence[Sequence[ExchangeStep]], axis: int,
             op: str = "sum") -> List[torch.Tensor]:
    """A neighbour exchange: each receiver combines (``op``) the segment
    each round brings into its columns, the plan's padding positions
    adding the neutral.  Every send reads the sender's partial as it was
    before the exchange, so a pairwise column takes its partner's own
    partial once, whatever rounds the plan put the pair's two directions
    in (on an odd ring of shards they cannot share one).  Returns new
    tensors; ``parts`` are not modified."""
    orig = list(parts)
    parts = list(parts)
    for steps in rounds:
        got = [(dst, orig[src].index_select(axis, send), recv, valid)
               for src, dst, send, recv, valid in steps]
        for dst, seg, recv, valid in got:
            tgt = parts[dst]
            seg = seg.to(tgt.device)
            shape = [1] * tgt.dim()
            shape[axis] = -1
            upd = torch.where(valid.view(shape) > 0, seg,
                              torch.full_like(seg, _neutral(tgt, op)))
            if op == "sum":
                parts[dst] = tgt.index_add(axis, recv, upd)
                continue
            idx = recv.view(shape).expand_as(upd)
            parts[dst] = tgt.scatter_reduce(
                axis, idx, upd, "amax" if op == "max" else "amin",
                include_self=True)
    return parts
