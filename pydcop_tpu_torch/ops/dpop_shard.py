"""DPOP's memory planner and bounded fallback, on one device.

The single-device half of the JAX package's ``ops/dpop_shard.py``:

* :exc:`UtilTableTooLarge` is the typed refusal for util tables beyond
  every budget: it carries the planner's byte estimate and a suggested
  ``--i-bound`` / shard count so the caller can act on it;
* :func:`estimate_sweep_bytes` / :func:`suggest_i_bound` are the cheap
  shape pass the solver routes on, from the pseudo-tree's separators
  before any table is built;
* :func:`minibucket_solve` degrades gracefully instead of refusing:
  buckets wider than a user-set ``i_bound`` are split mini-bucket style
  (each part projected separately), yielding a relaxation bound, a
  greedy assignment and therefore a bound *sandwich*
  ``lower ≤ optimum ≤ upper``.

The separator-tiling planner (``plan_tiled_sweep``) and the
cross-edge-consistency pruning it uses belong to the multi-GPU sharded
sweep, which is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.ops.dpop_sweep import MAX_TABLE_ENTRIES_PER_NODE


class UtilTableTooLarge(MemoryError):
    """A DPOP UTIL table exceeds every engine's memory budget.

    Carries the planner's byte estimate plus actionable suggestions —
    how many shards would fit a sharded sweep, and an ``i_bound`` under
    which the mini-bucket fallback fits — so callers (and error
    messages) can route instead of just refusing.
    """

    def __init__(self, estimated_bytes: int,
                 budget_bytes: Optional[int] = None,
                 n_shards: int = 1,
                 suggested_shards: int = 0,
                 suggested_i_bound: int = 0,
                 detail: str = ""):
        self.estimated_bytes = int(estimated_bytes)
        self.budget_bytes = budget_bytes
        self.n_shards = n_shards
        self.suggested_shards = int(suggested_shards)
        self.suggested_i_bound = int(suggested_i_bound)
        budget = (
            f"{budget_bytes / 2**20:.1f} MiB/device budget"
            if budget_bytes else "the engine caps"
        )
        hints = []
        if suggested_shards > n_shards:
            hints.append(f"~{suggested_shards} shards would fit the "
                         f"tiled sweep")
        if suggested_i_bound:
            hints.append(f"--i-bound {suggested_i_bound} fits the "
                         f"mini-bucket fallback (bounds, not exact)")
        hint = ("; ".join(hints)) or "use a local-search algorithm"
        super().__init__(
            f"DPOP util tables need ~{estimated_bytes / 2**20:.1f} MiB "
            f"against {budget} on {n_shards} shard(s){': ' + detail if detail else ''} — {hint}"
        )


# ---------------------------------------------------------------------------
# byte estimation (planner-driven: from separators only, no tables built)
# ---------------------------------------------------------------------------


def _level_shapes(tree) -> Tuple[List[int], List[int], int, int]:
    """(B_l, W_l, Dmax, max_true_entries) per level from the tree's
    separator sets — the cheap shape pass every routing decision uses
    before any table is materialized."""
    levels = tree.nodes_by_depth()
    if not levels or not levels[0]:
        return [], [], 1, 0
    nodes_flat = [n for lv in levels for n in lv]
    Dmax = max(len(n.variable.domain) for n in nodes_flat)
    sep = tree.separators()
    by_name = {n.name: n for n in nodes_flat}
    W_l = [
        max(max((len(sep[n.name]) for n in lv), default=0), 1)
        for lv in levels
    ]
    B_l = [len(lv) for lv in levels]
    max_true = 0
    for name, s in sep.items():
        e = len(by_name[name].variable.domain)
        for m in s:
            e *= len(by_name[m].variable.domain)
        max_true = max(max_true, e)
    return B_l, W_l, Dmax, max_true


def estimate_sweep_bytes(tree) -> Dict[str, int]:
    """Planner-driven single-device byte estimate of the per-level
    sweep: stored padded tables + the align/aligned intermediates, f32.
    ``max_node_entries`` is the TRUE (unpadded) largest joint table."""
    B_l, W_l, Dmax, max_true = _level_shapes(tree)
    S_l = [Dmax ** (w + 1) for w in W_l]
    entries = sum(b * s for b, s in zip(B_l, S_l))
    entries += sum(B_l[i] * S_l[i - 1] for i in range(1, len(B_l)))
    return {
        "bytes": entries * 4,
        "entries": entries,
        "max_node_entries": max_true,
        "max_level_table_entries": max(S_l, default=0),
        "Dmax": Dmax,
    }


def suggest_i_bound(Dmax: int, budget_bytes: Optional[int]) -> int:
    """Largest ``i`` such that one mini-bucket table
    (``Dmax^(i+1)`` f32 entries) fits the budget (or the single-device
    engine cap when unbudgeted); at least 1."""
    cap_entries = (
        budget_bytes // 4 if budget_bytes else MAX_TABLE_ENTRIES_PER_NODE
    )
    i = 1
    d = max(2, Dmax)
    while d ** (i + 2) <= max(cap_entries, d * d):
        i += 1
    return i


# ---------------------------------------------------------------------------
# mini-bucket fallback (bounded approximation; host-driven)
# ---------------------------------------------------------------------------


def minibucket_solve(tree, dcop, mode: str = "min", i_bound: int = 2,
                     device="cpu"):
    """Mini-bucket elimination over the pseudo-tree (Dechter & Rish):
    each node's items (unary + own constraints + child messages) are
    partitioned into mini-buckets whose separator scope has at most
    ``i_bound`` variables; each mini-bucket is joined and projected
    SEPARATELY, so no table ever exceeds ``D^(i_bound+1)`` entries.
    Joins of tables past ``DEVICE_THRESHOLD`` entries run on ``device``.

    Returns ``(assignment_idx, relax_bound, info)``:

    * ``relax_bound`` — the relaxation value (a LOWER bound of the
      optimum for min mode, an UPPER bound for max);
    * ``assignment_idx`` — the greedy top-down decoding (any concrete
      assignment's true cost bounds the optimum from the other side);
    * ``info`` — bucket/message accounting (splits, widest kept scope,
      message counts) for ``metrics()["dpop"]``.

    A single constraint or child message wider than ``i_bound`` forms
    its own mini-bucket (a table that already exists cannot be split) —
    the bound degrades gracefully rather than failing.
    """
    from pydcop_tpu_torch.ops.dpop_kernels import (
        join_t,
        slice_t,
        table_size,
        to_numpy,
    )

    i_bound = max(1, int(i_bound))
    levels = tree.nodes_by_depth()
    ext = {ev.name: ev.value for ev in dcop.external_variables.values()}

    incoming: Dict[str, List[tuple]] = {}   # node -> [(table, dims)]
    buckets_of: Dict[str, List[tuple]] = {}  # node -> joined (t, dims)
    relax = 0.0
    n_splits = 0
    n_msgs = 0
    msg_entries = 0
    widest = 0

    for lv in reversed(levels):
        for node in lv:
            v = node.variable
            items: List[tuple] = [(
                np.asarray(v.cost_vector(), dtype=np.float32),
                [(v.name, len(v.domain))],
            )]
            for c in node.constraints:
                if any(nm in ext for nm in c.scope_names):
                    c = c.slice(ext)
                items.append((
                    np.asarray(c.to_tensor(), dtype=np.float32),
                    [(d.name, len(d.domain)) for d in c.dimensions],
                ))
            passthrough: List[tuple] = []
            for t, dims in incoming.pop(node.name, []):
                if any(nm == v.name for nm, _ in dims):
                    items.append((t, dims))
                else:  # scope is strictly above this node: hoist it
                    passthrough.append((t, dims))

            # greedy first-fit-decreasing on separator scope
            items.sort(
                key=lambda it: -len([d for d in it[1]
                                     if d[0] != v.name])
            )
            buckets: List[Tuple[set, List[tuple]]] = []
            for t, dims in items:
                sep_scope = {nm for nm, _ in dims if nm != v.name}
                placed = False
                for scope, members in buckets:
                    if len(scope | sep_scope) <= i_bound:
                        scope |= sep_scope
                        members.append((t, dims))
                        placed = True
                        break
                if not placed:
                    buckets.append((set(sep_scope), [(t, dims)]))
            n_splits += max(0, len(buckets) - 1)

            joined: List[tuple] = []
            for scope, members in buckets:
                t, dims = members[0]
                for t2, dims2 in members[1:]:
                    t, dims = join_t(t, dims, t2, dims2, device=device)
                widest = max(widest, len(dims))
                joined.append((to_numpy(t), dims))
            buckets_of[node.name] = joined

            out: List[tuple] = list(passthrough)
            for t, dims in joined:
                axis = [nm for nm, _ in dims].index(v.name)
                proj = (np.min if mode == "min" else np.max)(t, axis=axis)
                pdims = [d for d in dims if d[0] != v.name]
                out.append((proj, pdims))
            if node.parent is None:
                for t, dims in out:
                    # at a root every remaining scope has eliminated
                    # out: accumulate the relaxation value
                    relax += float(np.asarray(t).reshape(-1).sum()
                                   if table_size(dims) == 1
                                   else (np.min if mode == "min"
                                         else np.max)(t))
            else:
                dest = incoming.setdefault(node.parent, [])
                for t, dims in out:
                    dest.append((t, dims))
                    n_msgs += 1
                    msg_entries += table_size(dims)

    # ---- greedy top-down decoding
    assignment_idx: Dict[str, int] = {}
    for lv in levels:
        for node in lv:
            v = node.variable
            cand = np.zeros(len(v.domain), dtype=np.float64)
            for t, dims in buckets_of[node.name]:
                fixed = {nm: assignment_idx[nm] for nm, _ in dims
                         if nm in assignment_idx}
                st, sdims = slice_t(np.asarray(t), dims, fixed)
                if len(sdims) != 1 or sdims[0][0] != v.name:
                    raise ValueError(
                        f"mini-bucket of {v.name} left dims {sdims}")
                cand += np.asarray(st, dtype=np.float64)
            assignment_idx[v.name] = int(
                np.argmin(cand) if mode == "min" else np.argmax(cand)
            )

    info = {
        "engine": "minibucket",
        "i_bound": i_bound,
        "bucket_splits": n_splits,
        "widest_scope": widest,
        "msg_count": n_msgs,
        "msg_entries": msg_entries,
        "exact": n_splits == 0,
    }
    return assignment_idx, float(relax), info
