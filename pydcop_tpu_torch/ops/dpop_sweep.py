"""Batched level-synchronous DPOP sweep engine.

Replaces the per-node host loop over ``join_t``/``project_t`` with one
batched step per tree level for the UTIL phase and one for the VALUE
phase — all nodes of a level compute their tables together.

Equivalent capability to the reference's UTIL/VALUE sweeps
(pydcop/algorithms/dpop.py:239-425) whose hot path is the per-assignment
python loops of join/projection (pydcop/dcop/relations.py:1622-1706).

Formulation (the JAX package's, with its plans field for field)
-----------------------------------------------------------------
* Every node's UTIL table is laid out canonically as a dense
  ``[Dmax] * (W+1)`` tensor — axis 0 is the node's own variable, axes
  ``1..W`` its separator variables sorted by (tree depth, name), padded
  with broadcast (constant) axes up to the tree-wide maximum separator
  width ``W``.
* A child's UTIL message is its table min/max-reduced over axis 0 —
  shape ``[Dmax] * W`` flattened to ``Sm = Dmax**W``.  How the child's
  separator digits map into the parent's digit layout is a host-side
  index computation: ``align_idx[b, s]`` says which message entry feeds
  slot ``s`` of the parent table.  On the device the alignment is one
  ``gather`` and the per-parent combine one order-exact
  :func:`~pydcop_tpu_torch.ops.segments.segment_sum` (children in
  ascending slot order, from 0 — the JAX package's XLA ``segment_sum``).
* UTIL = a Python loop bottom-up over levels (``lax.scan`` in the JAX
  package); VALUE = a loop top-down, each step fixing separator digits
  from already-assigned ancestors and arg-reducing the own-variable axis
  (first index on ties, as ``jnp.argmin``).

Ragged domains are padded to ``Dmax`` with a BIG sentinel on the unary
cost so invalid values never win a reduction.  Plans are compiled on the
host in numpy (:func:`compile_sweep` builds exactly the JAX package's
arrays) and moved to a device by :func:`plan_from_numpy`, which also
carries a JAX-compiled plan into this package for the parity tests.

The engine refuses (returns None) when the padded arrays would not pay
off — very wide separators or extreme level-width skew.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.ops.segments import SegmentPlan

BIG = 1e9  # +inf stand-in: survives (C+1)-way f32 sums without overflow

#: refuse plans whose padded arrays exceed this many total f32 entries
#: (local + align_idx + saved tables ≈ 3x this in bytes x4)
MAX_PLAN_ENTRIES = 64_000_000
#: refuse per-node padded tables beyond this (width blowup)
MAX_TABLE_ENTRIES_PER_NODE = 1 << 20

#: the scalar and host fields of a global plan, and its array fields
_PLAN_SCALARS = ("L", "Bmax", "Dmax", "W", "S", "Sm", "n_nodes", "mode",
                 "gid_to_name", "sep_size")
_PLAN_ARRAYS = {"local": torch.float32, "align_idx": torch.int32,
                "parent_slot": torch.int32, "sep_ids": torch.int32,
                "node_ids": torch.int32, "dom_sizes": torch.int32}
_LEVEL_SCALARS = ("B", "W", "S")
_LEVEL_ARRAYS = {"local": torch.float32, "align_idx": torch.int32,
                 "parent_slot": torch.int32, "sep_ids": torch.int32,
                 "node_ids": torch.int32}


@dataclass
class DpopSweepPlan:
    """Static schedule for the batched UTIL/VALUE sweeps, on one
    device."""

    L: int          # number of tree levels
    Bmax: int       # max nodes per level (batch dim)
    Dmax: int       # max domain size (digit radix)
    W: int          # max separator width (separator axes per table)
    S: int          # Dmax ** (W + 1), flat table size
    Sm: int         # Dmax ** W, flat message size
    n_nodes: int
    mode: str       # "min" | "max"
    # stacked per-level arrays, top-down level order (index 0 = roots)
    local: torch.Tensor        # [L, Bmax, S]  f32 — own constraints + unary
    align_idx: torch.Tensor    # [L, Bmax, S]  i32 — msg→parent-table mapping
    parent_slot: torch.Tensor  # [L, Bmax]     i32 — parent's slot in level-1
    sep_ids: torch.Tensor      # [L, Bmax, W]  i32 — separator gids (pad: N)
    node_ids: torch.Tensor     # [L, Bmax]     i32 — global node id (pad: N+1)
    dom_sizes: torch.Tensor    # [n_nodes]     i32
    gid_to_name: List[str]
    sep_size: Dict[str, int]  # true (unpadded) separator entries per node
    level_sizes: List[int]    # real nodes per level (slots 0..B-1)

    @property
    def total_entries(self) -> int:
        return self.L * self.Bmax * self.S

    @property
    def device(self) -> torch.device:
        return self.local.device


@dataclass
class DpopLevelPlan:
    """One level's static arrays (batch axis = nodes of the level)."""

    B: int           # real nodes at this level
    W: int           # this level's max separator width
    S: int           # Dmax ** (W + 1) — table entries per node
    local: torch.Tensor        # [B, S] f32
    align_idx: torch.Tensor    # [B, S_parent] i32 (roots: [B, 1] zeros)
    parent_slot: torch.Tensor  # [B] i32 (parent's slot one level up)
    sep_ids: torch.Tensor      # [B, W] i32 (pad: n_nodes)
    node_ids: torch.Tensor     # [B] i32


@dataclass
class DpopPerLevelPlan:
    levels: List[DpopLevelPlan]  # top-down (index 0 = roots)
    Dmax: int
    n_nodes: int
    mode: str
    gid_to_name: List[str]
    sep_size: Dict[str, int]

    @property
    def total_entries(self) -> int:
        return sum(lv.B * lv.S for lv in self.levels)

    @property
    def device(self) -> torch.device:
        return self.levels[0].local.device


# ---------------------------------------------------------------------------
# host compile (numpy; the JAX package's arrays, entry for entry)
# ---------------------------------------------------------------------------


def _canonical_seps(sep: set, depth: Dict[str, int]) -> List[str]:
    return sorted(sep, key=lambda n: (depth[n], n))


def _global_ids(levels):
    """(gid map, gid->name list, per-level slot map) in level order."""
    gid = {}
    gid_to_name = []
    for lv in levels:
        for n in lv:
            gid[n.name] = len(gid_to_name)
            gid_to_name.append(n.name)
    slot = {n.name: i for lv in levels for i, n in enumerate(lv)}
    return gid, gid_to_name, slot


def _true_sep_sizes(sep, by_name):
    """Product of true (unpadded) separator domain sizes per node — the
    UTIL message size reported in metrics (DpopMessage.size parity)."""
    return {
        name: int(np.prod(
            [len(by_name[m].variable.domain) for m in s], dtype=np.int64
        )) if s else 1
        for name, s in sep.items()
    }


def _compute_separators(tree, levels):
    """Separator sets + node map (the set computation itself lives on
    the pseudo-tree — graph/pseudotree.separators — so the sweep
    compilers and the byte estimators share one definition)."""
    by_name = {n.name: n for lv in levels for n in lv}
    return tree.separators(), by_name


def _digits_table(S: int, W: int, Dmax: int) -> np.ndarray:
    """digits[s, k] of table slot s: k=0 own var, k>=1 separator axes."""
    s_range = np.arange(S, dtype=np.int64)
    digits = np.empty((S, W + 1), dtype=np.int64)
    for k in range(W + 1):
        digits[:, k] = (s_range // (Dmax ** (W - k))) % Dmax
    return digits


def _build_local_table(node, cseps: List[str], W: int, Dmax: int,
                       sign: float, ext: Dict) -> np.ndarray:
    """Flat [Dmax**(W+1)] local table: padded unary + own constraints in
    the canonical [own, sep...] layout."""
    v = node.variable
    D = len(v.domain)
    axis_of = {node.name: 0}
    for k, sn in enumerate(cseps):
        axis_of[sn] = k + 1
    tbl = np.zeros((Dmax,) * (W + 1), dtype=np.float32)
    unary = np.full(Dmax, sign * BIG, dtype=np.float32)
    unary[:D] = np.asarray(v.cost_vector(), dtype=np.float32)
    tbl += unary.reshape((Dmax,) + (1,) * W)
    for c in node.constraints:
        if any(n in ext for n in c.scope_names):
            c = c.slice(ext)
        c_names = [d.name for d in c.dimensions]
        ct = np.asarray(c.to_tensor(), dtype=np.float32)
        if any(sz < Dmax for sz in ct.shape):
            ct = np.pad(
                ct, [(0, Dmax - sz) for sz in ct.shape],
                constant_values=0.0,
            )
        tgt = [axis_of[n] for n in c_names]
        ct = np.transpose(ct, np.argsort(tgt))
        shape = [1] * (W + 1)
        for a in sorted(tgt):
            shape[a] = Dmax
        tbl += ct.reshape(shape)
    return tbl.reshape(-1)


def _child_align_index(cseps_child: List[str], parent_name: str,
                       p_cseps: List[str], digits_parent: np.ndarray,
                       W_child: int, Dmax: int) -> np.ndarray:
    """For each parent-table slot, the child-message entry feeding it
    (child message layout: canonical seps with strides
    Dmax**(W_child-1-k))."""
    p_axis_of = {parent_name: 0}
    for k, sn in enumerate(p_cseps):
        p_axis_of[sn] = k + 1
    idx = np.zeros(digits_parent.shape[0], dtype=np.int64)
    for k, sn in enumerate(cseps_child):
        idx += digits_parent[:, p_axis_of[sn]] * (
            Dmax ** (W_child - 1 - k)
        )
    return idx.astype(np.int32)


def compile_sweep_numpy(tree, dcop, mode: str = "min"
                        ) -> Optional[Dict[str, Any]]:
    """The global plan's fields as numpy arrays (the JAX package's
    ``compile_sweep``, field for field), or None when the padded
    formulation would blow up.  Pure host; cost O(total padded
    entries)."""
    levels = tree.nodes_by_depth()
    if not levels or not levels[0]:
        return None
    L = len(levels)
    Bmax = max(len(lv) for lv in levels)
    nodes_flat = [n for lv in levels for n in lv]
    N = len(nodes_flat)
    depth = {n.name: tree.depth(n.name) for n in nodes_flat}

    Dmax = max(len(n.variable.domain) for n in nodes_flat)
    sep, by_name = _compute_separators(tree, levels)
    sep_size = _true_sep_sizes(sep, by_name)
    # W >= 1 keeps the message/stride arrays non-degenerate (W would be 0
    # only when every node is an isolated root)
    W = max(max((len(s) for s in sep.values()), default=0), 1)
    S = Dmax ** (W + 1)
    Sm = Dmax ** W
    if S > MAX_TABLE_ENTRIES_PER_NODE:
        return None
    if L * Bmax * S > MAX_PLAN_ENTRIES:
        return None

    # global ids in level order; gid N = padding sentinel
    gid, gid_to_name, slot = _global_ids(levels)

    ext = {ev.name: ev.value for ev in dcop.external_variables.values()}

    local = np.zeros((L, Bmax, S), dtype=np.float32)
    align_idx = np.zeros((L, Bmax, S), dtype=np.int32)
    parent_slot = np.full((L, Bmax), Bmax, dtype=np.int32)
    # sep pad -> N (the permanent zero row of the assign vector);
    # node-id pad -> N+1 (out of bounds)
    sep_ids = np.full((L, Bmax, W), N, dtype=np.int32)
    node_ids = np.full((L, Bmax), N + 1, dtype=np.int32)
    dom_sizes = np.zeros(N, dtype=np.int32)

    # per-table-slot digits (k=0 own var, k>=1 separator axis k-1)
    digits = _digits_table(S, W, Dmax)
    sign = 1.0 if mode == "min" else -1.0

    for li, lv in enumerate(levels):
        for bi, node in enumerate(lv):
            name = node.name
            node_ids[li, bi] = gid[name]
            dom_sizes[gid[name]] = len(node.variable.domain)
            cseps = _canonical_seps(sep[name], depth)
            for k, sn in enumerate(cseps):
                sep_ids[li, bi, k] = gid[sn]
            local[li, bi] = _build_local_table(
                node, cseps, W, Dmax, sign, ext
            )
            # ---- alignment of this node's UTIL message into its parent
            if node.parent is not None:
                parent_slot[li, bi] = slot[node.parent]
                p_cseps = _canonical_seps(sep[node.parent], depth)
                align_idx[li, bi] = _child_align_index(
                    cseps, node.parent, p_cseps, digits, W, Dmax
                )

    return dict(
        L=L, Bmax=Bmax, Dmax=Dmax, W=W, S=S, Sm=Sm, n_nodes=N, mode=mode,
        local=local, align_idx=align_idx, parent_slot=parent_slot,
        sep_ids=sep_ids, node_ids=node_ids, dom_sizes=dom_sizes,
        gid_to_name=gid_to_name, sep_size=sep_size,
    )


def compile_sweep_perlevel_numpy(
    tree, dcop, mode: str = "min",
    max_table_entries: Optional[int] = None,
    max_plan_entries: Optional[int] = None,
) -> Optional[Dict[str, Any]]:
    """The per-level plan's fields as numpy arrays (the JAX package's
    ``compile_sweep_perlevel``), or None when even the per-level form
    blows the budgets."""
    if max_table_entries is None:
        max_table_entries = MAX_TABLE_ENTRIES_PER_NODE
    if max_plan_entries is None:
        max_plan_entries = MAX_PLAN_ENTRIES
    levels = tree.nodes_by_depth()
    if not levels or not levels[0]:
        return None
    nodes_flat = [n for lv in levels for n in lv]
    N = len(nodes_flat)
    depth = {n.name: tree.depth(n.name) for n in nodes_flat}
    Dmax = max(len(n.variable.domain) for n in nodes_flat)
    sep, by_name = _compute_separators(tree, levels)
    sep_size = _true_sep_sizes(sep, by_name)

    W_l = [
        max(max((len(sep[n.name]) for n in lv), default=0), 1)
        for lv in levels
    ]
    S_l = [Dmax ** (w + 1) for w in W_l]
    if any(s > max_table_entries for s in S_l):
        return None
    # budget covers local tables AND the align_idx / aligned
    # intermediates, which are [B_child, S_parent]-shaped — in the
    # wide-hub case those dominate (many narrow children x a huge
    # parent table)
    entries = sum(len(lv) * s for lv, s in zip(levels, S_l))
    entries += sum(
        len(levels[li]) * S_l[li - 1] for li in range(1, len(levels))
    )
    if entries > max_plan_entries:
        return None

    gid, gid_to_name, slot = _global_ids(levels)
    ext = {ev.name: ev.value for ev in dcop.external_variables.values()}
    sign = 1.0 if mode == "min" else -1.0
    digits_l = [_digits_table(s, w, Dmax) for s, w in zip(S_l, W_l)]

    plans: List[Dict[str, Any]] = []
    for li, lv in enumerate(levels):
        B, W, S = len(lv), W_l[li], S_l[li]
        S_parent = S_l[li - 1] if li > 0 else 1
        local = np.zeros((B, S), dtype=np.float32)
        align_idx = np.zeros((B, S_parent), dtype=np.int32)
        parent_slot = np.full(
            (B,), len(levels[li - 1]) if li > 0 else 0, dtype=np.int32
        )
        sep_ids = np.full((B, W), N, dtype=np.int32)
        node_ids = np.empty((B,), dtype=np.int32)
        for bi, node in enumerate(lv):
            cseps = _canonical_seps(sep[node.name], depth)
            node_ids[bi] = gid[node.name]
            for k, sn in enumerate(cseps):
                sep_ids[bi, k] = gid[sn]
            local[bi] = _build_local_table(
                node, cseps, W, Dmax, sign, ext
            )
            if node.parent is not None:
                parent_slot[bi] = slot[node.parent]
                p_cseps = _canonical_seps(sep[node.parent], depth)
                align_idx[bi] = _child_align_index(
                    cseps, node.parent, p_cseps, digits_l[li - 1],
                    W, Dmax,
                )
        plans.append(dict(
            B=B, W=W, S=S, local=local,
            align_idx=align_idx, parent_slot=parent_slot,
            sep_ids=sep_ids, node_ids=node_ids,
        ))

    return dict(
        levels=plans, Dmax=Dmax, n_nodes=N, mode=mode,
        gid_to_name=gid_to_name, sep_size=sep_size,
    )


def _put(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(
        device=dev, dtype=dtype)


def plan_from_numpy(fields: Mapping[str, Any], device: DeviceLike = None):
    """A plan on ``device`` from its numpy fields: the output of
    :func:`compile_sweep_numpy` / :func:`compile_sweep_perlevel_numpy`,
    or the fields of a plan compiled by the JAX package (``local``,
    ``align_idx``, ``parent_slot``, ``sep_ids``, ``node_ids``,
    ``dom_sizes``, ``gid_to_name``, ``sep_size`` and the scalars; a
    per-level plan carries ``levels``, a list of mappings)."""
    dev = resolve_device(device)
    if "levels" in fields:
        levels = [
            DpopLevelPlan(
                **{k: int(lv[k]) for k in _LEVEL_SCALARS},
                **{k: _put(lv[k], dt, dev)
                   for k, dt in _LEVEL_ARRAYS.items()},
            )
            for lv in fields["levels"]
        ]
        return DpopPerLevelPlan(
            levels=levels, Dmax=int(fields["Dmax"]),
            n_nodes=int(fields["n_nodes"]), mode=str(fields["mode"]),
            gid_to_name=list(fields["gid_to_name"]),
            sep_size=dict(fields["sep_size"]),
        )
    node_ids = np.asarray(fields["node_ids"])
    return DpopSweepPlan(
        **{k: fields[k] for k in _PLAN_SCALARS},
        **{k: _put(fields[k], dt, dev) for k, dt in _PLAN_ARRAYS.items()},
        level_sizes=[int(b) for b in
                     (node_ids < int(fields["n_nodes"])).sum(axis=1)],
    )


def numpy_fields(plan) -> Dict[str, Any]:
    """The numpy fields of a plan of this package (the inverse of
    :func:`plan_from_numpy`, for comparing with the JAX package's)."""

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    if isinstance(plan, DpopPerLevelPlan):
        out = {k: getattr(plan, k) for k in
               ("Dmax", "n_nodes", "mode", "gid_to_name", "sep_size")}
        out["levels"] = [
            {k: host(getattr(lv, k))
             for k in (*_LEVEL_SCALARS, *_LEVEL_ARRAYS)}
            for lv in plan.levels
        ]
        return out
    return {k: host(getattr(plan, k))
            for k in (*_PLAN_SCALARS, *_PLAN_ARRAYS)}


def compile_sweep(tree, dcop, mode: str = "min",
                  device: DeviceLike = None) -> Optional[DpopSweepPlan]:
    """Compile a pseudo-tree + DCOP into a batched sweep plan on
    ``device`` (cuda unless the caller passes ``device="cpu"``), or None
    when the padded formulation would blow up."""
    dev = resolve_device(device)
    fields = compile_sweep_numpy(tree, dcop, mode)
    return None if fields is None else plan_from_numpy(fields, dev)


def compile_sweep_perlevel(
    tree, dcop, mode: str = "min",
    max_table_entries: Optional[int] = None,
    max_plan_entries: Optional[int] = None,
    device: DeviceLike = None,
) -> Optional[DpopPerLevelPlan]:
    """Compile with per-level width padding, on ``device``.  Returns
    None when even the per-level form blows the budgets."""
    dev = resolve_device(device)
    fields = compile_sweep_perlevel_numpy(
        tree, dcop, mode, max_table_entries, max_plan_entries)
    return None if fields is None else plan_from_numpy(fields, dev)


# ---------------------------------------------------------------------------
# device sweeps
# ---------------------------------------------------------------------------


def _reduce_own(table: torch.Tensor, mode: str) -> torch.Tensor:
    """min/max over axis 1 (the own-variable digit) of [B, Dmax, Sm]."""
    return (torch.amin(table, dim=1) if mode == "min"
            else torch.amax(table, dim=1))


def _argred(col: torch.Tensor, mode: str) -> torch.Tensor:
    """First index of the min/max along axis 1, as ``jnp.argmin``."""
    return (torch.argmin(col, dim=1) if mode == "min"
            else torch.argmax(col, dim=1))


def _msg_strides(Dmax: int, W: int, dev) -> torch.Tensor:
    return torch.tensor([Dmax ** (W - 1 - k) for k in range(W)],
                        dtype=torch.int64, device=dev)


def _combine(msg, align_idx, parent_slot, n_parents):
    """Children's messages aligned into their parents' table slots and
    summed per parent, children in ascending slot order from 0."""
    aligned = torch.gather(msg, 1, align_idx.long())
    return SegmentPlan(parent_slot, n_parents).sum(aligned)


def _value_step(assign, table, sep_ids, node_ids, Dmax, W, N, mode):
    """Fix each node of a level at its best value given its already
    assigned separator (``assign[N]`` is the permanent zero row that
    padded separator slots read)."""
    B = table.shape[0]
    sep_vals = assign[sep_ids.long().clamp(0, N)]
    sep_pos = (sep_vals * _msg_strides(Dmax, W, assign.device)).sum(1)
    t = table.reshape(B, Dmax, -1)
    col = torch.gather(t, 2, sep_pos.view(B, 1, 1).expand(B, Dmax, 1))
    assign[node_ids.long()] = _argred(col[:, :, 0], mode)


def run_sweep(plan: DpopSweepPlan):
    """Execute the batched UTIL+VALUE sweeps on the plan's device.
    Returns (assign_idx [N] numpy, tables computed); assign_idx maps
    gid -> chosen domain index."""
    Dmax, Sm, N, mode = plan.Dmax, plan.Sm, plan.n_nodes, plan.mode
    sizes = plan.level_sizes
    tables: List[torch.Tensor] = [None] * plan.L
    msg = None
    for li in range(plan.L - 1, -1, -1):
        B = sizes[li]
        table = plan.local[li, :B]
        if li + 1 < plan.L:
            Bc = sizes[li + 1]
            table = table + _combine(msg, plan.align_idx[li + 1, :Bc],
                                     plan.parent_slot[li + 1, :Bc], B)
        tables[li] = table
        msg = _reduce_own(table.reshape(B, Dmax, Sm), mode)

    assign = torch.zeros(N + 1, dtype=torch.int64, device=plan.device)
    for li in range(plan.L):
        B = sizes[li]
        _value_step(assign, tables[li], plan.sep_ids[li, :B],
                    plan.node_ids[li, :B], Dmax, plan.W, N, mode)
    return assign[:N].to(torch.int32).cpu().numpy(), N


def run_sweep_perlevel(plan: DpopPerLevelPlan):
    """Execute the per-level UTIL+VALUE sweeps: one batched step per
    level, each at its own separator width.  Returns (assign_idx [N]
    numpy, N)."""
    Dmax, N, mode = plan.Dmax, plan.n_nodes, plan.mode
    levels = plan.levels
    L = len(levels)

    # ---- UTIL: deepest level -> roots
    tables: List[torch.Tensor] = [None] * L
    msg = None
    for li in range(L - 1, -1, -1):
        lv = levels[li]
        table = lv.local
        if li < L - 1:
            child = levels[li + 1]
            table = table + _combine(msg, child.align_idx,
                                     child.parent_slot, lv.B)
        tables[li] = table
        msg = _reduce_own(table.reshape(lv.B, Dmax, lv.S // Dmax), mode)

    # ---- VALUE: roots -> deepest level
    assign = torch.zeros(N + 1, dtype=torch.int64, device=plan.device)
    for li in range(L):
        lv = levels[li]
        _value_step(assign, tables[li], lv.sep_ids, lv.node_ids, Dmax,
                    lv.W, N, mode)
    return assign[:N].to(torch.int32).cpu().numpy(), N
