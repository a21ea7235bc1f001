"""Segment reductions over graph neighborhoods.

A "round of messages" is one segment reduction over a static edge list:
``segment_sum`` is ``index_add_`` into a zeroed ``[num_segments, ...]``
tensor.  ``masked_argmin`` keeps ``jnp.argmin``'s rule of returning the
FIRST index among equal minima (``torch.argmin`` does the same).
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def ordered_sum(x: torch.Tensor, axis: int = -1,
                keepdims: bool = True) -> torch.Tensor:
    """Sum over a short axis (a domain axis) strictly left to right.

    ``torch.sum`` may split a row into several partial sums (on the CPU
    it does for 5, 6, 7 or 9 elements), while the JAX package's XLA CPU
    reductions and the CUDA kernels add the values in order; on near-tie
    beliefs the last bit decides the argmin, so the order is pinned."""
    parts = torch.unbind(x, dim=axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out.unsqueeze(axis) if keepdims else out


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = -1,
                keepdims: bool = True) -> torch.Tensor:
    """Mean of x over entries where mask==1 (mask is 0/1 float)."""
    s = ordered_sum(x * mask, axis=axis, keepdims=keepdims)
    n = torch.clamp(ordered_sum(mask, axis=axis, keepdims=keepdims),
                    min=1.0)
    return s / n


def masked_argmin(x: torch.Tensor, mask: torch.Tensor,
                  axis: int = -1) -> torch.Tensor:
    """Argmin over valid entries (mask 1 = valid), first index on ties."""
    big = torch.finfo(x.dtype).max
    return torch.argmin(torch.where(mask > 0, x, big), dim=axis)
