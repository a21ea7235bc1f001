"""Graph partitioning: assign factors (and their edges) to shards.

The counterpart of the JAX package's ``parallel/partition.py``: balanced
load and few variables shared across shards decide which shard owns each
factor.  Variables are replicated; each shared variable adds a column to
the combine of partial beliefs or tables every cycle.

The JAX package's preferred path is a C++ BFS-region-growing vertex
partitioner (``native/partition.cc::partition_bfs_growing``), with a
greedy order as its fallback when the library does not load.  Here both
are plain Python/numpy and both are named paths: ``use_native=True`` runs
:func:`bfs_growing` (the same parts as the C++ code, vertex for vertex)
and ``use_native=False`` the greedy order.  Nothing is built, and the
port never moves from one path to the other because something failed.
As in the JAX package, a graph without any variable-to-variable edge
(one shard, or unary factors only) is split by the greedy order on both
paths: region growing has nothing to grow along.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np


def bfs_growing(edge_u: np.ndarray, edge_v: np.ndarray, n_vertices: int,
                n_parts: int) -> np.ndarray:
    """Part of each vertex: repeatedly seed the unassigned vertex of
    highest degree (ties to the lower id) and grow its region breadth
    first to ``ceil(n_vertices / n_parts)`` vertices; what is left (a
    disconnected remainder) goes one by one to the smallest part.

    A line-by-line port of ``native/partition.cc::partition_bfs_growing``:
    the adjacency lists keep the C++ fill order (edge by edge, ``u``'s
    entry then ``v``'s), so the parts are the same."""
    u = np.asarray(edge_u, dtype=np.int64)
    v = np.asarray(edge_v, dtype=np.int64)
    if n_parts <= 0 or n_vertices <= 0:
        raise ValueError(
            f"bfs_growing needs n_parts > 0 and n_vertices > 0, got "
            f"{n_parts} and {n_vertices}")
    if u.size and max(int(u.max()), int(v.max())) >= n_vertices:
        raise ValueError("an edge names a vertex id >= n_vertices")
    deg = (np.bincount(u, minlength=n_vertices)
           + np.bincount(v, minlength=n_vertices))
    offset = np.concatenate([[0], np.cumsum(deg)])
    src = np.stack([u, v], axis=1).ravel()
    dst = np.stack([v, u], axis=1).ravel()
    adj = dst[np.argsort(src, kind="stable")].tolist()
    offset = offset.tolist()
    by_deg = np.argsort(-deg, kind="stable").tolist()

    target = -(-n_vertices // n_parts)
    part = [-1] * n_vertices
    cursor = 0
    for p in range(n_parts):
        while cursor < n_vertices and part[by_deg[cursor]] != -1:
            cursor += 1
        if cursor >= n_vertices:
            break
        seed = by_deg[cursor]
        queue = deque([seed])
        part[seed] = p
        grown = 1
        while queue and grown < target:
            x = queue.popleft()
            for i in range(offset[x], offset[x + 1]):
                w = adj[i]
                if part[w] == -1:
                    part[w] = p
                    queue.append(w)
                    grown += 1
                    if grown >= target:
                        break
    out = np.asarray(part, dtype=np.int32)
    sizes = np.bincount(out[out >= 0], minlength=n_parts)
    for x in np.flatnonzero(out == -1):
        best = int(np.argmin(sizes))  # first smallest part
        out[x] = best
        sizes[best] += 1
    return out


def _greedy(var_idx_per_bucket: List[np.ndarray],
            n_shards: int) -> List[np.ndarray]:
    """Factors ordered by their lowest variable index (a cheap locality
    proxy), cut into ceil(F / n_shards) runs."""
    out = []
    for var_idx in var_idx_per_bucket:
        F = var_idx.shape[0]
        if F == 0:
            out.append(np.zeros(0, dtype=np.int32))
            continue
        order = np.argsort(var_idx.min(axis=1), kind="stable")
        per_shard = -(-F // n_shards)  # ceil
        assign = np.zeros(F, dtype=np.int32)
        assign[order] = np.minimum(np.arange(F) // per_shard, n_shards - 1)
        out.append(assign)
    return out


def _bfs_partition(var_idx_per_bucket: List[np.ndarray], n_vars: int,
                   n_shards: int) -> Optional[List[np.ndarray]]:
    """Factor assignment from the BFS vertex partition, or None when the
    variable graph has no edge."""
    # variable graph: consecutive scope pairs cover each factor's clique
    # connectivity at O(arity) edges
    eu, ev = [], []
    for var_idx in var_idx_per_bucket:
        for p in range(var_idx.shape[1] - 1):
            eu.append(var_idx[:, p])
            ev.append(var_idx[:, p + 1])
    if not eu:
        return None
    vpart = bfs_growing(np.concatenate(eu), np.concatenate(ev), n_vars,
                        n_shards)

    out = []
    total_f = sum(v.shape[0] for v in var_idx_per_bucket)
    cap = -(-total_f // n_shards)  # global ceil target per shard
    loads = np.zeros(n_shards, dtype=np.int64)
    for var_idx in var_idx_per_bucket:
        F = var_idx.shape[0]
        if F == 0:
            out.append(np.zeros(0, dtype=np.int32))
            continue
        assign = vpart[var_idx[:, 0]].astype(np.int32)
        out.append(assign)
        np.add.at(loads, assign, 1)
    # rebalance: move factors from overloaded shards to the lightest, in
    # factor order.  A shard that is not overloaded never becomes so (a
    # move only fills a shard up to cap), so only the factors of shards
    # overloaded when a bucket's pass starts can move.
    for assign in out:
        for f in np.flatnonzero(loads[assign] > cap):
            s = assign[f]
            if loads[s] > cap:
                tgt = int(np.argmin(loads))
                if loads[tgt] < cap:
                    assign[f] = tgt
                    loads[s] -= 1
                    loads[tgt] += 1
    return out


def partition_factors(
    var_idx_per_bucket: List[np.ndarray],
    n_vars: int,
    n_shards: int,
    use_native: bool = True,
) -> List[np.ndarray]:
    """Locality partition of factors onto shards; per bucket, the
    factor→shard assignment.

    ``use_native=True`` (the JAX package's name for its C++ path): the
    BFS region-growing partition of the variable graph
    (:func:`bfs_growing`), each factor on its first variable's part, then
    shard loads rebalanced to the ceil-average.  ``use_native=False``: the
    greedy variable-major order.  With one shard, or no variable edge,
    both give the greedy order, as in the JAX package."""
    var_idx_per_bucket = [np.asarray(v) for v in var_idx_per_bucket]
    if use_native and n_shards > 1:
        parts = _bfs_partition(var_idx_per_bucket, n_vars, n_shards)
        if parts is not None:
            return parts
    return _greedy(var_idx_per_bucket, n_shards)


def partition_stats(
    var_idx_per_bucket: List[np.ndarray],
    assign_per_bucket: List[np.ndarray],
    n_shards: int,
) -> Dict[str, float]:
    """Cut quality of an assignment, from the same boundary analysis the
    sharded engines report in ``comm_stats()``
    (:func:`~pydcop_tpu_torch.parallel.boundary.analyze_boundary`).
    ``cut_fraction`` is the fraction of factor-touched variables shared
    by 2+ shards (the boundary columns)."""
    from pydcop_tpu_torch.parallel.boundary import analyze_boundary

    n_vars = 0
    for var_idx in var_idx_per_bucket:
        if var_idx.shape[0]:
            n_vars = max(n_vars, int(np.asarray(var_idx).max()) + 1)
    info = analyze_boundary(
        var_idx_per_bucket, assign_per_bucket, n_vars, n_shards
    )
    if info.n_touched == 0:
        return {"cut_fraction": 0.0, "replicated_vars": 0}
    return {
        "cut_fraction": info.cut_fraction,
        "replicated_vars": info.n_boundary,
        "boundary_fraction": info.boundary_fraction,
        "n_boundary": info.n_boundary,
        "n_touched": info.n_touched,
        "pairwise_cut": info.pairwise,
    }


def assigns_from_distribution(
    distribution, tensors, n_shards: int
) -> List[np.ndarray]:
    """Factor→shard assignments driven by an explicit placement.

    The reference runs computations on the agents a distribution names
    (pydcop/commands/solve.py:483-507); here agents are folded (sorted,
    round-robin) onto ``n_shards`` shards and every factor computation
    lands on its host agent's shard.  Raises
    :class:`ImpossibleDistributionException` if the placement does not
    cover the graph."""
    from pydcop_tpu_torch.distribution.objects import (
        ImpossibleDistributionException,
    )

    agents = sorted(distribution.agents)
    if not agents:
        raise ImpossibleDistributionException(
            "distribution names no agents"
        )
    shard_of_agent = {a: i % n_shards for i, a in enumerate(agents)}
    host = {
        c: a
        for a in agents
        for c in distribution.computations_hosted(a)
    }
    out = []
    for b in tensors.buckets:
        assign = np.zeros(b.n_factors, dtype=np.int32)
        for f in range(b.n_factors):
            name = tensors.factor_names[int(b.factor_ids[f])]
            if name not in host:
                raise ImpossibleDistributionException(
                    f"distribution does not place computation {name!r}"
                )
            assign[f] = shard_of_agent[host[name]]
        out.append(assign)
    return out
