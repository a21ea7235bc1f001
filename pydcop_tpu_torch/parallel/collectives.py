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
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch


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
