"""Segment reductions over graph neighborhoods.

A "round of messages" is one segment reduction over a static edge list.

* :func:`segment_sum` adds each segment's rows in ascending row order,
  starting from 0 — what CPU ``index_add_`` and the JAX package's XLA CPU
  ``segment_sum`` do.  On CUDA, ``index_add_`` adds in atomic order, which
  changes from run to run and flips near-tie argmins; so the sum runs
  rank by rank from a plan built once per edge list (:class:`SegmentPlan`):
  rank k adds, for every segment that has a k-th row, that row.  An index
  appears at most once per rank, so each step is a collision-free indexed
  add, deterministic on every device.  A segment of degree d costs d
  steps: a hub of degree 2,500 means 2,500 small launches per sum.  The
  compiled graph keeps the plans of its static edge lists
  (``compile.edge_plan`` / ``compile.bucket_plans``).
* :func:`segment_max` / :func:`segment_min` are exact in any order; empty
  segments keep the JAX package's identities (``-inf``/``+inf`` for
  floats, the dtype's smallest/largest value for integers).
* :func:`masked_argmin` keeps ``jnp.argmin``'s rule of returning the
  FIRST index among equal minima (``torch.argmin`` does the same).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


class SegmentPlan:
    """The by-rank plan of one edge list: ``steps[k]`` = (segments that
    have a k-th row, the id of that row), both int64 on the ids' device."""

    def __init__(self, segment_ids: torch.Tensor, num_segments: int):
        ids = segment_ids.detach().cpu().numpy().astype(np.int64)
        self.num_segments = int(num_segments)
        self.n_rows = int(ids.shape[0])
        order = np.argsort(ids, kind="stable")  # rows by segment, in order
        counts = np.bincount(ids, minlength=self.num_segments)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.empty(self.n_rows, dtype=np.int64)
        rank[order] = np.arange(self.n_rows) - start[ids[order]]
        dev = segment_ids.device
        self.steps: List[Tuple[torch.Tensor, torch.Tensor]] = []
        by_rank = np.argsort(rank, kind="stable")  # rank-major, rows ascending
        bounds = np.cumsum(np.bincount(rank))
        lo = 0
        for hi in bounds:
            rows = by_rank[lo:hi]
            self.steps.append((
                torch.as_tensor(ids[rows], device=dev),
                torch.as_tensor(rows, device=dev),
            ))
            lo = hi

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] != self.n_rows:
            raise ValueError(
                f"data has {data.shape[0]} rows, the plan {self.n_rows}")
        out = data.new_zeros((self.num_segments,) + tuple(data.shape[1:]))
        for segs, rows in self.steps:
            out.index_add_(0, segs, data.index_select(0, rows))
        return out


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ data[i]`` over rows i with ``segment_ids[i] == s``,
    added in ascending i from 0, on every device.  Builds the plan on
    the host each call: a loop over a static edge list keeps a
    :class:`SegmentPlan` instead."""
    return SegmentPlan(segment_ids, num_segments).sum(data)


def _reduce(data, segment_ids, num_segments, op, identity):
    out = torch.full((num_segments,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long()
    if data.dim() > 1:
        idx = idx.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce=op, include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty segments hold -inf (floats) or the dtype's
    smallest value (integers), as ``jax.ops.segment_max``."""
    lo = (-float("inf") if data.dtype.is_floating_point
          else torch.iinfo(data.dtype).min)
    return _reduce(data, segment_ids, num_segments, "amax", lo)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment min; empty segments hold +inf (floats) or the dtype's
    largest value (integers), as ``jax.ops.segment_min``."""
    hi = (float("inf") if data.dtype.is_floating_point
          else torch.iinfo(data.dtype).max)
    return _reduce(data, segment_ids, num_segments, "amin", hi)


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
