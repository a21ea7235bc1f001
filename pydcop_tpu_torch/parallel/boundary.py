"""Boundary analysis of a factor→shard partition.

The counterpart of the first half of the JAX package's
``parallel/boundary.py`` (``BoundaryInfo``, ``analyze_boundary``,
``_info_from_counts``): every variable is **interior** (all its factors
on one shard: its column of the per-cycle combine never needs another
shard) or **boundary** (touched by 2+ shards), and has an **owner**
shard (its one toucher, the lowest toucher of a boundary variable, shard
0 for a variable no factor touches).  ``partition_stats`` and the
sharded engines' ``comm_stats()`` report these numbers.

The other half of the JAX module — the patch, the neighbour-exchange
plan and the padded boundary index — serves the compact collective modes
(``overlap="exact"|"stale"``, ``exchange=True``), which are not ported:
this package combines the whole space every cycle (dense mode).

Pure numpy, run on the host when an engine is built.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class BoundaryInfo:
    """Cut structure of one factor→shard assignment.  ``owner`` covers
    every variable exactly once."""

    n_vars: int
    n_shards: int
    owner: np.ndarray          # [V] int32 owning shard per variable
    boundary_mask: np.ndarray  # [V] bool — touched by 2+ shards
    touch_count: np.ndarray    # [V] int32 — number of shards touching
    n_boundary: int
    n_touched: int             # variables incident to >= 1 factor
    cut_fraction: float        # n_boundary / n_touched (0 if untouched)
    boundary_fraction: float   # n_boundary / n_vars

    @property
    def boundary_vars(self) -> np.ndarray:
        return np.flatnonzero(self.boundary_mask)

    @property
    def pairwise(self) -> bool:
        """True when every boundary variable is shared by EXACTLY two
        shards."""
        return bool(
            self.n_boundary > 0
            and int(self.touch_count[self.boundary_mask].max()) <= 2
        )


def analyze_boundary(
    var_idx_per_bucket: List[np.ndarray],
    assign_per_bucket: List[np.ndarray],
    n_vars: int,
    n_shards: int,
) -> BoundaryInfo:
    """Classify variables as interior/boundary under an assignment (the
    per-bucket, original-order arrays ``partition_factors`` produces)."""
    counts = np.zeros((max(1, n_shards), n_vars), dtype=np.int32)
    for var_idx, assign in zip(var_idx_per_bucket, assign_per_bucket):
        vi = np.asarray(var_idx)
        asg = np.asarray(assign)
        if vi.shape[0] == 0:
            continue
        for p in range(vi.shape[1]):
            np.add.at(counts, (asg, vi[:, p]), 1)
    return _info_from_counts(counts, n_vars, n_shards)


def _info_from_counts(counts: np.ndarray, n_vars: int,
                      n_shards: int) -> BoundaryInfo:
    touch = counts > 0
    touch_count = touch.sum(axis=0).astype(np.int32)
    boundary = touch_count > 1
    # owner: first touching shard (argmax of the boolean column), 0 for
    # untouched unary-only variables — argmax of an all-False column is 0
    owner = np.argmax(touch, axis=0).astype(np.int32)
    n_touched = int((touch_count > 0).sum())
    n_boundary = int(boundary.sum())
    return BoundaryInfo(
        n_vars=n_vars,
        n_shards=n_shards,
        owner=owner,
        boundary_mask=boundary,
        touch_count=touch_count,
        n_boundary=n_boundary,
        n_touched=n_touched,
        cut_fraction=(n_boundary / n_touched) if n_touched else 0.0,
        boundary_fraction=(n_boundary / n_vars) if n_vars else 0.0,
    )
