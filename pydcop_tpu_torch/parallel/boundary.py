"""Boundary analysis of a factor→shard partition, and the compact
collectives' static operands.

The counterpart of the JAX package's ``parallel/boundary.py``:

* :func:`analyze_boundary` classifies every variable as **interior** (all
  its factors on one shard: its column of the per-cycle combine never
  needs another shard) or **boundary** (touched by 2+ shards), and gives
  it an **owner** shard (its one toucher, the lowest toucher of a
  boundary variable, shard 0 for a variable no factor touches), so that
  per-shard views can be reconciled with one owner-masked pass per run.
  ``keep_touch=True`` keeps the per-(shard, variable) endpoint counts that
  :func:`patch_boundary` updates factor by factor.
* :func:`build_exchange_plan` compiles a *pairwise* cut (every boundary
  variable shared by exactly two shards) into neighbour-exchange rounds:
  the shard-pair cut graph, properly edge-coloured (:func:`_edge_color`,
  a copy of the JAX package's ``ops/clos_routing.edge_color``), each
  round a set of pairwise sends of only the columns a pair shares.
  :func:`patch_exchange_plan` rewrites a plan after a patch when the pair
  structure is unchanged.  Neither patch has a caller in the package
  yet: the elastic re-partition that moves factors between shards
  (ROADMAP A8b) is their user.
* :func:`padded_boundary_idx` is the static index vector of the compact
  collective.

``partition_stats`` and the sharded engines' ``comm_stats()`` report
these numbers; the compact modes (``overlap="exact"|"stale"``,
``exchange=True``) of ``parallel/mesh.py`` run on them.

Pure numpy, run on the host when an engine is built.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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
    #: [S, V] per-(shard, variable) factor-endpoint counts, kept only
    #: under ``analyze_boundary(..., keep_touch=True)``: what
    #: :func:`patch_boundary` updates
    touch: Optional[np.ndarray] = None

    @property
    def boundary_vars(self) -> np.ndarray:
        return np.flatnonzero(self.boundary_mask)

    @property
    def pairwise(self) -> bool:
        """True when every boundary variable is shared by EXACTLY two
        shards — the cut shape a neighbour exchange can serve."""
        return bool(
            self.n_boundary > 0
            and int(self.touch_count[self.boundary_mask].max()) <= 2
        )


def analyze_boundary(
    var_idx_per_bucket: List[np.ndarray],
    assign_per_bucket: List[np.ndarray],
    n_vars: int,
    n_shards: int,
    keep_touch: bool = False,
) -> BoundaryInfo:
    """Classify variables as interior/boundary under an assignment (the
    per-bucket, original-order arrays ``partition_factors`` produces).
    ``keep_touch`` keeps the endpoint count matrix for
    :func:`patch_boundary`."""
    counts = np.zeros((max(1, n_shards), n_vars), dtype=np.int32)
    for var_idx, assign in zip(var_idx_per_bucket, assign_per_bucket):
        vi = np.asarray(var_idx)
        asg = np.asarray(assign)
        if vi.shape[0] == 0:
            continue
        for p in range(vi.shape[1]):
            np.add.at(counts, (asg, vi[:, p]), 1)
    return _info_from_counts(counts, n_vars, n_shards,
                             keep_touch=keep_touch)


def _info_from_counts(counts: np.ndarray, n_vars: int, n_shards: int,
                      keep_touch: bool = False) -> BoundaryInfo:
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
        touch=counts if keep_touch else None,
    )


def patch_boundary(
    info: BoundaryInfo,
    removed: List[Tuple[np.ndarray, int]] = (),
    added: List[Tuple[np.ndarray, int]] = (),
) -> BoundaryInfo:
    """Update a ``keep_touch=True`` analysis for single-factor mutations,
    each ``(var_idx_row, shard)``: only the mutated factors' variables
    are classified again, and the result equals a fresh
    :func:`analyze_boundary` of the mutated assignment.  ``info`` is not
    modified."""
    if info.touch is None:
        raise ValueError(
            "patch_boundary needs an analysis built with keep_touch=True")
    counts = info.touch.copy()
    dirty: List[int] = []
    for row, shard in removed:
        for v in np.asarray(row).reshape(-1):
            counts[int(shard), int(v)] -= 1
            dirty.append(int(v))
    for row, shard in added:
        for v in np.asarray(row).reshape(-1):
            counts[int(shard), int(v)] += 1
            dirty.append(int(v))
    if np.min(counts, initial=0) < 0:
        raise ValueError(
            "patch_boundary: removed a factor endpoint that was never "
            "counted — stale BoundaryInfo?")
    if not dirty:
        return dataclasses.replace(info, touch=counts)
    dv = np.unique(np.asarray(dirty, dtype=np.int64))
    touch_d = counts[:, dv] > 0
    tc_d = touch_d.sum(axis=0).astype(np.int32)
    owner = info.owner.copy()
    boundary = info.boundary_mask.copy()
    touch_count = info.touch_count.copy()
    # the totals move by the dirtied columns only
    was_b = int(boundary[dv].sum())
    was_t = int((touch_count[dv] > 0).sum())
    owner[dv] = np.argmax(touch_d, axis=0).astype(np.int32)
    boundary[dv] = tc_d > 1
    touch_count[dv] = tc_d
    n_boundary = info.n_boundary - was_b + int((tc_d > 1).sum())
    n_touched = info.n_touched - was_t + int((tc_d > 0).sum())
    return dataclasses.replace(
        info,
        owner=owner,
        boundary_mask=boundary,
        touch_count=touch_count,
        n_boundary=n_boundary,
        n_touched=n_touched,
        cut_fraction=(n_boundary / n_touched) if n_touched else 0.0,
        boundary_fraction=(
            n_boundary / info.n_vars) if info.n_vars else 0.0,
        touch=counts,
    )


@dataclasses.dataclass
class ExchangePlan:
    """Neighbour-exchange schedule of a pairwise cut.

    In round r, shard s sends ``values[..., send_idx[s, r]]`` to its
    partner of that round, and combines the segment it receives into
    ``recv_idx[s, r]`` where ``recv_valid[s, r]`` is 1 (0 on padding).
    Both sides of a pair list the shared columns in ascending order, so
    segment position k names the same column to sender and receiver."""

    n_shards: int
    n_rounds: int
    bpair: int                  # padded per-round segment width
    rounds: List[List[Tuple[int, int]]]   # (src, dst) pairs per round
    send_idx: np.ndarray        # [S, R, Bpair] int32 (variable ids)
    recv_idx: np.ndarray        # [S, R, Bpair] int32 (variable ids)
    recv_valid: np.ndarray      # [S, R, Bpair] float32 0/1

    @property
    def lanes_moved(self) -> int:
        """Columns a shard sends per cycle (the all-reduce pays
        ``n_boundary``)."""
        return self.n_rounds * self.bpair


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _euler_split(src: np.ndarray, dst: np.ndarray, n_left: int,
                 n_right: int) -> np.ndarray:
    """Split a bipartite multigraph with all-even degrees into two halves
    (0/1 per edge), every vertex with half its edges in each: a
    Hierholzer walk alternating the halves."""
    E = len(src)
    half = np.empty(E, dtype=np.int8)
    left_adj = [[] for _ in range(n_left)]
    right_adj = [[] for _ in range(n_right)]
    for e in range(E):
        left_adj[src[e]].append(e)
        right_adj[dst[e]].append(e)
    used = np.zeros(E, dtype=bool)
    for e0 in range(E):
        if used[e0]:
            continue
        e, color, on_left = e0, 0, True
        while True:
            used[e] = True
            half[e] = color
            color ^= 1
            vert_adj = right_adj[dst[e]] if on_left else left_adj[src[e]]
            nxt = None
            while vert_adj:
                cand = vert_adj.pop()
                if not used[cand]:
                    nxt = cand
                    break
            if nxt is None:
                break  # the circuit closed (all degrees even)
            e = nxt
            on_left = not on_left
    return half


def _edge_color(src: np.ndarray, dst: np.ndarray, n_left: int,
                n_right: int, degree: int) -> np.ndarray:
    """Proper edge colouring of a ``degree``-regular bipartite multigraph
    with exactly ``degree`` colours (a power of two): recursive Euler
    splitting."""
    if degree & (degree - 1):
        raise ValueError(f"degree {degree} is not a power of two")
    colors = np.zeros(len(src), dtype=np.int32)
    stack = [(np.arange(len(src)), 0, degree)]
    while stack:
        ids, base, deg = stack.pop()
        if deg == 1:
            colors[ids] = base
            continue
        half = _euler_split(src[ids], dst[ids], n_left, n_right)
        stack.append((ids[half == 0], base, deg // 2))
        stack.append((ids[half == 1], base + deg // 2, deg // 2))
    return colors


def build_exchange_plan(
    info: BoundaryInfo,
    var_idx_per_bucket: List[np.ndarray],
    assign_per_bucket: List[np.ndarray],
) -> Optional[ExchangePlan]:
    """The pairwise cut as edge-coloured exchange rounds, or None when
    the cut is not pairwise (a boundary variable is shared by 3+ shards)
    or there is no boundary."""
    if not info.pairwise:
        return None
    S, V = info.n_shards, info.n_vars
    touch = np.zeros((S, V), dtype=bool)
    for var_idx, assign in zip(var_idx_per_bucket, assign_per_bucket):
        vi = np.asarray(var_idx)
        asg = np.asarray(assign)
        if vi.shape[0] == 0:
            continue
        for p in range(vi.shape[1]):
            touch[asg, vi[:, p]] = True
    return _plan_from_pairs(info, _pairs_from_touch(info, touch))


def _pairs_from_touch(
    info: BoundaryInfo, touch: np.ndarray
) -> Dict[Tuple[int, int], List[int]]:
    """(lo, hi) shard pair → its shared boundary columns, sorted, from a
    boolean touch matrix."""
    S = info.n_shards
    bvars = info.boundary_vars
    lo = np.argmax(touch[:, bvars], axis=0)
    hi = S - 1 - np.argmax(touch[::-1, bvars], axis=0)
    pair_cols: Dict[Tuple[int, int], List[int]] = {}
    for v, a, b in zip(bvars.tolist(), lo.tolist(), hi.tolist()):
        pair_cols.setdefault((int(a), int(b)), []).append(int(v))
    for cols in pair_cols.values():
        cols.sort()
    return pair_cols


def _plan_from_pairs(
    info: BoundaryInfo, pair_cols: Dict[Tuple[int, int], List[int]]
) -> ExchangePlan:
    S = info.n_shards
    # the directed exchange multigraph: both directions of every pair,
    # then self-loops padding every shard to a power-of-two regular
    # degree (what the Euler splitting needs)
    deg = np.zeros(S, dtype=np.int64)
    src, dst = [], []
    for (a, b) in pair_cols:
        src.extend([a, b])
        dst.extend([b, a])
        deg[a] += 1
        deg[b] += 1
    d = _next_pow2(int(deg.max(initial=1)))
    for s in range(S):
        for _ in range(d - int(deg[s])):
            src.append(s)
            dst.append(s)
    src_a = np.asarray(src, dtype=np.int64)
    dst_a = np.asarray(dst, dtype=np.int64)
    colors = _edge_color(src_a, dst_a, S, S, d)

    bpair = max(len(c) for c in pair_cols.values())
    rounds: List[List[Tuple[int, int]]] = [[] for _ in range(d)]
    send_idx = np.zeros((S, d, bpair), dtype=np.int32)
    recv_idx = np.zeros((S, d, bpair), dtype=np.int32)
    recv_valid = np.zeros((S, d, bpair), dtype=np.float32)
    for e in range(len(src)):
        a, b, r = int(src_a[e]), int(dst_a[e]), int(colors[e])
        if a == b:
            continue  # a padding self-loop: the shard idles this round
        rounds[r].append((a, b))
        cols = pair_cols[(a, b) if (a, b) in pair_cols else (b, a)]
        k = len(cols)
        send_idx[a, r, :k] = cols
        send_idx[a, r, k:] = cols[0]
        recv_idx[b, r, :k] = cols
        recv_idx[b, r, k:] = cols[0]
        recv_valid[b, r, :k] = 1.0
    return ExchangePlan(
        n_shards=S, n_rounds=d, bpair=bpair, rounds=rounds,
        send_idx=send_idx, recv_idx=recv_idx, recv_valid=recv_valid,
    )


def patch_exchange_plan(
    plan: Optional[ExchangePlan],
    info: BoundaryInfo,
) -> Tuple[Optional[ExchangePlan], bool]:
    """An exchange plan after a :func:`patch_boundary`: when the shard
    pairs are unchanged and their widths still fit the padded segment,
    only the pairs' send/recv rows are rewritten and the round schedule
    is kept.  Returns ``(plan, patched)``; ``patched=False`` means the
    cut changed shape (a new pair, a wider one, no longer pairwise) and
    the plan was built afresh from ``info``, which must carry the
    ``keep_touch=True`` counts."""
    if info.touch is None:
        raise ValueError(
            "patch_exchange_plan needs an analysis with keep_touch=True")
    if not info.pairwise:
        return None, False
    pair_cols = _pairs_from_touch(info, info.touch > 0)
    if plan is None:
        return _plan_from_pairs(info, pair_cols), False
    width = max(len(c) for c in pair_cols.values())
    old_pairs = set()
    for r in plan.rounds:
        for (a, b) in r:
            old_pairs.add((min(a, b), max(a, b)))
    if set(pair_cols) != old_pairs or width > plan.bpair:
        return _plan_from_pairs(info, pair_cols), False
    send_idx = plan.send_idx.copy()
    recv_idx = plan.recv_idx.copy()
    recv_valid = plan.recv_valid.copy()
    for r, perms in enumerate(plan.rounds):
        for (a, b) in perms:
            cols = pair_cols[(a, b) if (a, b) in pair_cols else (b, a)]
            k = len(cols)
            send_idx[a, r, :k] = cols
            send_idx[a, r, k:] = cols[0]
            recv_idx[b, r, :k] = cols
            recv_idx[b, r, k:] = cols[0]
            recv_valid[b, r, :k] = 1.0
            recv_valid[b, r, k:] = 0.0
    return dataclasses.replace(
        plan, send_idx=send_idx, recv_idx=recv_idx, recv_valid=recv_valid,
    ), True


def padded_boundary_idx(info: BoundaryInfo, quantum: int = 8) -> np.ndarray:
    """Boundary variable ids padded (with repeats of the first id) to a
    ``quantum`` multiple: the compact collective's gather/scatter index.
    A padding position carries the same combined value as the column it
    repeats.  Empty when the partition has no boundary (the cycle then
    needs no collective)."""
    b = info.boundary_vars.astype(np.int32)
    if b.size == 0:
        return b
    pad = (-b.size) % quantum
    if pad:
        b = np.concatenate([b, np.full(pad, b[0], dtype=np.int32)])
    return b
