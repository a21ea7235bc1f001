"""Seeded headroom layouts: mutate a compiled problem at a FIXED shape.

The port of the JAX package's ``ops/headroom.py``.  A dynamic-DCOP
mutation (a scenario event, an agent-churn repair, a dynamic factor swap,
a memo variant's factor diff) would otherwise be a cold rebuild: a new
compile, new plans, and on the card a new CUDA graph capture of the
chunk.  This module keeps the shape fixed so that a mutation is data:

* :func:`reserve_headroom` compiles a DCOP's tensor graph at
  **capacity**: the real variables/factors plus a seeded reserve of
  *inert* slots — free variable slots with a single valid value and
  zero cost, and free factor slots holding all-zero tables wired to a
  dedicated **parking variable** (a zero table attached to parking
  generates exactly zero messages/contributions, and parking's
  single-valued domain forces its outgoing messages to zero after
  mean-normalization).
* :class:`HeadroomLayout` is the claimed/free slot bookkeeping: a
  mutation *claims* a slot (add variable / add factor) or *releases*
  one (remove) — never changes a tensor shape.
* :func:`make_operands` gathers the MUTABLE device tensors (cost tables,
  scope indices, masks, unary costs, the edge→variable map, and this
  package's fixed-shape sum plans and neighbour pairs) into one dict that
  the warm solvers (``algorithms/warm.py``) carry in their state;
  :func:`operand_view` is a compiled graph over those very tensors, so
  every kernel of the generic engines runs on it unchanged.
* :func:`apply_mutation` turns every add/remove/edit into writes **in
  place** on those tensors (slice assignment and ``index_put_`` on the
  same storage, never a new tensor), in proportion to the rows it
  touches: a chunk captured as a CUDA graph reads the new data at its
  next replay, with no re-capture.

Shapes are static; only data moves.  When the reserve runs out the
caller repacks ONCE at a fresh capacity (see ``runtime/repair.py``).

What this package adds to the JAX layout, and why: the generic engines
sum a variable's incoming rows in ascending row order, from a plan built
once per edge list (``ops/segments.py``); a mutation rewires rows, so the
warm layout carries the plan as data too — :class:`RankPlan`, the
``[K, S]`` table of each segment's rows by rank, padded with a zero row.
``K`` (the *depth*) is the largest degree at compile time plus the same
seeded reserve as the slots (``max(min_free, ceil(K * headroom))``), and
a mutation that would raise a variable's degree past it raises
:class:`HeadroomExhausted` like a missing slot: one counted repack, where
the JAX layout (its sums are XLA scatters of any degree) would not
repack.  The parking variable takes no plan column: every row wired to it
is zero, so its sums are zero either way.

The structured (table-free) branch of the JAX module waits for the port
of ``ops/structured_kernels.py`` (ROADMAP A5): the port's loader refuses
``type: structured``, and a compiled graph with structured buckets is
refused here with :class:`~pydcop_tpu_torch.errors.NotPortedError`.
Int8 and bf16 table tiers are not ported either (``ops/compile.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    ConstraintGraphTensors,
    FactorBucket,
    FactorGraphTensors,
    numpy_fields,
)

#: host-side placeholder name of an unclaimed slot (never a real name:
#: YAML identifiers cannot start with ``__``)
FREE = None


class HeadroomExhausted(RuntimeError):
    """A mutation needed a slot kind (or a plan depth) the layout has no
    room for.  The repair controller catches this and performs ONE
    counted repack (``repair.repack`` event) — callers never see it
    mid-run."""


@dataclasses.dataclass
class HeadroomLayout:
    """Claimed/free slot maps of a capacity layout.

    ``var_names[i]`` is the DCOP variable claimed at slot ``i`` (or
    None when free); the last slot is the parking variable and is never
    claimable.  ``fac_names[b][k]`` likewise per arity bucket.  The
    maps are json-serializable (:meth:`to_meta`), the JAX package's
    checkpoint schema v3.  Beside them the layout keeps a name → slot
    index and min-heaps of the free slots, so a lookup is O(1) and a
    claim or release O(log n): a mutation's host work does not grow
    with the problem.  Change the maps only through the claim/release
    methods, which keep the indexes in step.
    """

    n_vars_cap: int
    parking: int
    headroom: float
    var_names: List[Optional[str]]
    arities: Tuple[int, ...]
    fac_names: List[List[Optional[str]]]
    _var_slots: Dict[str, int] = dataclasses.field(
        init=False, repr=False, compare=False)
    _fac_slots: Dict[str, Tuple[int, int]] = dataclasses.field(
        init=False, repr=False, compare=False)
    _free_vars: List[int] = dataclasses.field(
        init=False, repr=False, compare=False)
    _free_facs: List[List[int]] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        # the first slot of a name wins, as the list search's did
        self._var_slots = {}
        for i, n in enumerate(self.var_names):
            if n is not FREE:
                self._var_slots.setdefault(n, i)
        self._fac_slots = {}
        for b, names in enumerate(self.fac_names):
            for k, n in enumerate(names):
                if n is not FREE:
                    self._fac_slots.setdefault(n, (b, k))
        # ascending lists are valid heaps: the lowest free slot first
        self._free_vars = [
            i for i, n in enumerate(self.var_names)
            if n is FREE and i != self.parking
        ]
        self._free_facs = [
            [k for k, n in enumerate(names) if n is FREE]
            for names in self.fac_names
        ]

    # -- queries ------------------------------------------------------------

    @property
    def claimed_vars(self) -> List[str]:
        return [n for i, n in enumerate(self.var_names)
                if n is not FREE and i != self.parking]

    def free_var_slots(self) -> List[int]:
        return sorted(self._free_vars)

    def n_free_var_slots(self) -> int:
        return len(self._free_vars)

    def free_factor_slots(self, arity: int) -> List[int]:
        b = self.bucket_for_arity(arity)
        return [] if b is None else sorted(self._free_facs[b])

    def has_var(self, name: str) -> bool:
        return name in self._var_slots

    def var_slot(self, name: str) -> int:
        try:
            return self._var_slots[name]
        except KeyError:
            raise KeyError(f"unknown variable {name!r}") from None

    def factor_slot(self, name: str) -> Tuple[int, int]:
        try:
            return self._fac_slots[name]
        except KeyError:
            raise KeyError(f"unknown factor {name!r}") from None

    def has_factor(self, name: str) -> bool:
        return name in self._fac_slots

    def bucket_for_arity(self, arity: int) -> Optional[int]:
        for b, a in enumerate(self.arities):
            if a == arity:
                return b
        return None

    # -- claims -------------------------------------------------------------

    def claim_var(self, name: str) -> int:
        if not self._free_vars:
            raise HeadroomExhausted(
                f"no free variable slot for {name!r} "
                f"({self.n_vars_cap} capacity, all claimed)"
            )
        slot = heapq.heappop(self._free_vars)
        self.var_names[slot] = name
        self._var_slots[name] = slot
        return slot

    def release_var(self, name: str) -> int:
        slot = self.var_slot(name)
        self.var_names[slot] = FREE
        del self._var_slots[name]
        heapq.heappush(self._free_vars, slot)
        return slot

    def claim_factor(self, name: str, arity: int) -> Tuple[int, int]:
        b = self.bucket_for_arity(arity)
        if b is None:
            raise HeadroomExhausted(
                f"no arity-{arity} bucket in the capacity layout for "
                f"factor {name!r}"
            )
        if not self._free_facs[b]:
            raise HeadroomExhausted(
                f"no free arity-{arity} factor slot for {name!r}"
            )
        k = heapq.heappop(self._free_facs[b])
        self.fac_names[b][k] = name
        self._fac_slots[name] = (b, k)
        return b, k

    def release_factor(self, name: str) -> Tuple[int, int]:
        b, k = self.factor_slot(name)
        self.fac_names[b][k] = FREE
        del self._fac_slots[name]
        heapq.heappush(self._free_facs[b], k)
        return b, k

    # -- checkpoint schema v3 ------------------------------------------------

    def to_meta(self) -> Dict:
        """JSON-able claimed/free slot maps (checkpoint schema v3)."""
        return {
            "n_vars_cap": self.n_vars_cap,
            "parking": self.parking,
            "headroom": self.headroom,
            "var_names": list(self.var_names),
            "arities": list(self.arities),
            "fac_names": [list(ns) for ns in self.fac_names],
        }

    @classmethod
    def from_meta(cls, meta: Dict) -> "HeadroomLayout":
        return cls(
            n_vars_cap=int(meta["n_vars_cap"]),
            parking=int(meta["parking"]),
            headroom=float(meta["headroom"]),
            var_names=list(meta["var_names"]),
            arities=tuple(int(a) for a in meta["arities"]),
            fac_names=[list(ns) for ns in meta["fac_names"]],
        )


def _claimed_assignment(t, x: np.ndarray) -> Dict[str, object]:
    lay = t.layout
    return {
        n: t.domain_values[i][int(x[i])]
        for i, n in enumerate(t.var_names)
        if lay.var_names[i] is not FREE and i != lay.parking
    }


@dataclasses.dataclass
class HeadroomFactorTensors(FactorGraphTensors):
    """Capacity factor-graph tensors: free/parking slots are invisible
    to the host assignment (claimed variables only)."""

    layout: Optional[HeadroomLayout] = None
    #: depths of the operand plans (:class:`RankPlan`): ``edge`` (factor
    #: graphs) and ``pos`` (one a bucket, constraint graphs)
    plan_depths: Optional[Dict] = None

    def assignment_from_indices(self, x: np.ndarray) -> Dict[str, object]:
        return _claimed_assignment(self, x)


@dataclasses.dataclass
class HeadroomConstraintTensors(ConstraintGraphTensors):
    """Capacity constraints-hypergraph tensors (local-search family)."""

    layout: Optional[HeadroomLayout] = None
    #: depths of the operand plans (:class:`RankPlan`): ``edge`` (factor
    #: graphs) and ``pos`` (one a bucket, constraint graphs)
    plan_depths: Optional[Dict] = None

    def assignment_from_indices(self, x: np.ndarray) -> Dict[str, object]:
        return _claimed_assignment(self, x)


def _slots_for(n: int, headroom: float, min_free: int) -> int:
    return max(int(min_free), int(math.ceil(n * float(headroom))))


# ---------------------------------------------------------------------------
# fixed-shape ordered sums
# ---------------------------------------------------------------------------


class RankPlan:
    """The ordered segment sum of ``ops/segments.py`` at a fixed shape:
    ``idx[k, s]`` is the k-th row (ascending) of segment ``s``, or
    ``n_rows`` — a zero row appended to the data — when ``s`` has fewer
    than k + 1 rows.  :meth:`sum` adds rank by rank from 0, so a segment's
    rows are added in ascending order, as ``SegmentPlan.sum`` and the
    JAX package's XLA CPU ``segment_sum`` add them (adding the zero row
    leaves a partial sum unchanged).  ``idx`` is an operand: a mutation
    rewrites the columns of the segments it touches in place."""

    def __init__(self, idx: torch.Tensor, n_rows: int):
        self.idx = idx
        self.n_rows = int(n_rows)

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] != self.n_rows:
            raise ValueError(
                f"data has {data.shape[0]} rows, the plan {self.n_rows}")
        padded = torch.cat(
            [data, data.new_zeros((1,) + tuple(data.shape[1:]))])
        out = data.new_zeros((self.idx.shape[1],) + tuple(data.shape[1:]))
        for k in range(self.idx.shape[0]):
            out = out + padded[self.idx[k]]
        return out


def _rank_table(seg: np.ndarray, n_seg: int, depth: int,
                skip: int) -> np.ndarray:
    """The ``[depth, n_seg]`` host table of a :class:`RankPlan` over the
    row→segment map ``seg`` (segment ``skip`` — parking — left empty)."""
    n_rows = int(seg.shape[0])
    table = np.full((depth, n_seg), n_rows, dtype=np.int64)
    keep = np.flatnonzero(seg != skip)
    ids = seg[keep].astype(np.int64)
    order = np.argsort(ids, kind="stable")
    rows, ids = keep[order], ids[order]
    counts = np.bincount(ids, minlength=n_seg)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(rows.shape[0]) - start[ids]
    table[rank, ids] = rows
    return table


def _degrees(seg: np.ndarray, n_seg: int, skip: int) -> np.ndarray:
    counts = np.bincount(seg.astype(np.int64), minlength=n_seg)
    counts[skip] = 0
    return counts


def _depth(max_degree: int, headroom: float, min_free: int) -> int:
    return int(max_degree) + _slots_for(max_degree, headroom, min_free)


# ---------------------------------------------------------------------------
# capacity compile
# ---------------------------------------------------------------------------


def reserve_headroom(
    dcop,
    graph: str = "factor",
    headroom: float = 0.25,
    min_free: int = 4,
    ensure_arities: Sequence[int] = (2,),
    tensors=None,
    device: DeviceLike = None,
):
    """Compile ``dcop`` at capacity: real slots + seeded inert headroom.

    Returns ``(cap_tensors, layout)`` where ``cap_tensors`` is a
    :class:`HeadroomFactorTensors` / :class:`HeadroomConstraintTensors`
    on ``device`` (cuda unless the caller asks for the CPU; the device of
    ``tensors`` when it is given) whose free slots are inert (see the
    module docstring) and ``layout`` is the claim bookkeeping.
    ``tensors`` substitutes a pre-compiled base graph (array-built
    instances); otherwise the base is compiled from the DCOP exactly as
    the cold engines do.  ``ensure_arities`` guarantees a factor bucket
    exists for those arities even when the seed problem has none (so a
    mutation can add the first binary factor without a repack).
    """
    from pydcop_tpu_torch.ops.compile import (
        compile_constraint_graph,
        compile_factor_graph,
    )

    if tensors is None:
        dev = resolve_device(device)
        tensors = (
            compile_factor_graph(dcop, device=dev) if graph == "factor"
            else compile_constraint_graph(dcop, device=dev)
        )
    else:
        dev = tensors.device
    if getattr(tensors, "sbuckets", None):
        raise NotPortedError(
            "a warm layout of structured (table-free) buckets waits for "
            "the port of ops/structured_kernels.py (ROADMAP A5)")
    f = numpy_fields(tensors)
    V, D = tensors.n_vars, tensors.max_domain_size
    n_free_v = _slots_for(V, headroom, min_free)
    Vc = V + n_free_v + 1  # +1 parking
    parking = Vc - 1

    # -- variable-side arrays at capacity ----------------------------------
    mask = np.zeros((Vc, D), dtype=np.float32)
    unary = np.full((Vc, D), PAD_COST, dtype=np.float32)
    mask[:V] = f["domain_mask"]
    unary[:V] = f["unary_costs"]
    # inert slots: one valid value, zero cost
    mask[V:, 0] = 1.0
    unary[V:, 0] = 0.0
    domain_values = list(tensors.domain_values) + [(0,)] * (Vc - V)
    domain_sizes = np.concatenate(
        [np.asarray(tensors.domain_sizes, dtype=np.int32),
         np.ones(Vc - V, dtype=np.int32)]
    )
    var_names = list(tensors.var_names) + [
        f"__free_{i:04d}" for i in range(n_free_v)
    ] + ["__parking"]
    init = np.concatenate(
        [np.asarray(tensors.initial_values, dtype=np.int32),
         np.zeros(Vc - V, dtype=np.int32)]
    )
    has_init = np.concatenate(
        [np.asarray(tensors.has_initial, dtype=bool),
         # inert slots hold their single value: mark as pinned so the
         # local-search random init cannot wiggle them
         np.ones(Vc - V, dtype=bool)]
    )

    # -- factor buckets at capacity ----------------------------------------
    arities = sorted(
        {b.arity for b in tensors.buckets} | set(ensure_arities)
    )
    buckets: List[FactorBucket] = []
    fac_names: List[List[Optional[str]]] = []
    edge_var_parts: List[np.ndarray] = []
    offset = 0
    gid = 0
    factor_names_cap: List[str] = []
    by_arity = {b["arity"]: b for b in f["buckets"]}
    for a in arities:
        b = by_arity.get(a)
        F = int(np.asarray(b["var_idx"]).shape[0]) if b is not None else 0
        Fc = F + _slots_for(F, headroom, min_free)
        t_cap = np.zeros((Fc,) + (D,) * a, dtype=np.float32)
        vi_cap = np.full((Fc, a), parking, dtype=np.int32)
        names: List[Optional[str]] = [FREE] * Fc
        if b is not None:
            t_cap[:F] = b["tensors"]
            vi_cap[:F] = b["var_idx"]
            for k, fid in enumerate(np.asarray(b["factor_ids"])):
                names[k] = tensors.factor_names[int(fid)]
        buckets.append(
            FactorBucket(
                arity=a,
                tensors=torch.as_tensor(t_cap, device=dev),
                var_idx=vi_cap,
                factor_ids=np.arange(gid, gid + Fc, dtype=np.int32),
                edge_offset=offset,
            )
        )
        fac_names.append(names)
        factor_names_cap.extend(
            n if n is not FREE else f"__slot_{a}_{k:04d}"
            for k, n in enumerate(names)
        )
        edge_var_parts.append(vi_cap.reshape(-1))
        offset += Fc * a
        gid += Fc
    edge_var = (
        np.concatenate(edge_var_parts)
        if edge_var_parts else np.zeros(0, dtype=np.int32)
    )

    layout = HeadroomLayout(
        n_vars_cap=Vc,
        parking=parking,
        headroom=float(headroom),
        var_names=list(tensors.var_names) + [FREE] * n_free_v + ["__parking"],
        arities=tuple(arities),
        fac_names=fac_names,
    )
    # plan depths, seeded from the base degrees like the slot reserve
    plan_depths = {
        "edge": _depth(int(_degrees(edge_var, Vc, parking).max(initial=0)),
                       headroom, min_free),
        "pos": tuple(
            _depth(max((int(_degrees(b.var_idx[:, p], Vc, parking).max(
                initial=0)) for p in range(b.arity)), default=0),
                   headroom, min_free)
            for b in buckets),
    }
    common = dict(
        var_names=var_names,
        domain_values=domain_values,
        domain_sizes=domain_sizes,
        domain_mask=torch.as_tensor(mask, device=dev),
        unary_costs=torch.as_tensor(unary, device=dev),
        buckets=buckets,
        edge_var=torch.as_tensor(edge_var.astype(np.int64), device=dev),
        factor_names=factor_names_cap,
        sign=tensors.sign,
        initial_values=init,
        has_initial=has_init,
        layout=layout,
        plan_depths=plan_depths,
    )
    if graph == "factor":
        cap = HeadroomFactorTensors(**common)
    else:
        # neighbor pairs are DERIVED from the var_idx operands
        # (duplicates across factors are harmless to the segment-max
        # arbitration); the static arrays here only back host metrics
        src, dst = derived_pairs_host(buckets)
        cap = HeadroomConstraintTensors(
            **common,
            neighbor_src=torch.as_tensor(src.astype(np.int64), device=dev),
            neighbor_dst=torch.as_tensor(dst.astype(np.int64), device=dev),
        )
    return cap, layout


# ---------------------------------------------------------------------------
# mutable operands: the tensors warm solvers carry inside their state
# ---------------------------------------------------------------------------


def _is_constraint_graph(cap) -> bool:
    return isinstance(cap, ConstraintGraphTensors)


def make_operands(cap) -> Dict:
    """The mutable tensors of a capacity graph as one dict.

    Everything a mutation can touch rides here, on the graph's device:
    the JAX package's operands (``mask``, ``unary``, ``tensors``,
    ``var_idx`` as int64, ``edge_var``; no int8 or structured leaves) and
    this package's fixed-shape plans — ``edge_rows`` (the ``[K, V]``
    :class:`RankPlan` of the edge→variable sum, factor graphs) or
    ``pos_rows`` (one ``[arity, K, V]`` table a bucket, each scope
    position's sum, constraint graphs) and ``pairs`` (the directed
    neighbour pairs of :func:`derived_pairs`, constraint graphs).
    ``mask``, ``unary``, ``tensors`` and ``edge_var`` are the graph's own
    tensors, not copies.
    """
    dev = cap.device
    lay = cap.layout
    depths = cap.plan_depths
    constraint = _is_constraint_graph(cap)
    ops = {
        "mask": cap.domain_mask,
        "unary": cap.unary_costs,
        "tensors": tuple(b.tensors for b in cap.buckets),
        "var_idx": tuple(
            torch.as_tensor(np.asarray(b.var_idx, dtype=np.int64),
                            device=dev)
            for b in cap.buckets
        ),
        "edge_var": cap.edge_var,
        "edge_rows": None,
        "pos_rows": (),
        "pairs": None,
    }
    if constraint:
        ops["pos_rows"] = tuple(
            torch.as_tensor(np.stack([
                _rank_table(np.asarray(b.var_idx[:, p]), cap.n_vars, d,
                            lay.parking)
                for p in range(b.arity)]), device=dev)
            for b, d in zip(cap.buckets, depths["pos"]))
        src, dst = derived_pairs_host(cap.buckets)
        ops["pairs"] = (torch.as_tensor(src.astype(np.int64), device=dev),
                        torch.as_tensor(dst.astype(np.int64), device=dev))
    else:
        ev = np.concatenate([np.asarray(b.var_idx).reshape(-1)
                             for b in cap.buckets]) \
            if cap.buckets else np.zeros(0, dtype=np.int64)
        ops["edge_rows"] = torch.as_tensor(
            _rank_table(ev, cap.n_vars, depths["edge"], lay.parking),
            device=dev)
    return ops


def operand_leaves(ops: Dict) -> Tuple[torch.Tensor, ...]:
    """The tensors of an operand dict, in a fixed order (the tail of a
    warm solver's state)."""
    out: List[torch.Tensor] = [ops["mask"], ops["unary"]]
    out.extend(ops["tensors"])
    out.extend(ops["var_idx"])
    out.append(ops["edge_var"])
    if ops["edge_rows"] is not None:
        out.append(ops["edge_rows"])
    out.extend(ops["pos_rows"])
    if ops["pairs"] is not None:
        out.extend(ops["pairs"])
    return tuple(out)


def operand_view(cap, ops: Dict):
    """A compiled graph whose mutable tensors are the operand tensors —
    every existing kernel (``maxsum_cycle``, ``local_cost_tables``,
    ``total_cost``, the move rules) runs on it unchanged: the ordered
    sums read the operand plans (:class:`RankPlan`, seeded into the
    compile caches ``edge_plan`` / ``bucket_plans`` / ``bucket_index``
    read), the neighbour pairs are the operand pairs.  The view shares
    the graph's host metadata (names, domains, the host ``var_idx``
    mirror), so it follows every mutation."""
    dev = ops["mask"].device
    buckets = []
    for bi, (b, t, vi) in enumerate(zip(cap.buckets, ops["tensors"],
                                        ops["var_idx"])):
        nb = dataclasses.replace(b, tensors=t)
        nb.__dict__["_index"] = {
            dev: (vi, [vi[:, p] for p in range(b.arity)])}
        if ops["pos_rows"]:
            nb.__dict__["_plans"] = {dev: [
                RankPlan(ops["pos_rows"][bi][p], b.n_factors)
                for p in range(b.arity)]}
        buckets.append(nb)
    kw = dict(
        domain_mask=ops["mask"],
        unary_costs=ops["unary"],
        buckets=buckets,
        edge_var=ops["edge_var"],
    )
    if ops["pairs"] is not None:
        kw.update(neighbor_src=ops["pairs"][0], neighbor_dst=ops["pairs"][1])
    view = dataclasses.replace(cap, **kw)
    if ops["edge_rows"] is not None:
        view.__dict__["_edge_plan"] = RankPlan(ops["edge_rows"],
                                               view.n_edges)
    return view


def _pair_blocks(arity: int) -> List[Tuple[int, int]]:
    return [(p, q) for p in range(arity) for q in range(arity) if p != q]


def derived_pairs(var_idx_leaves, buckets) -> Tuple[np.ndarray, np.ndarray]:
    """Directed neighbor pairs derived from ``[F, arity]`` host scope
    arrays — one ordered pair per (factor slot, position pair), fixed
    shape, in the JAX package's order (bucket, then position pair, then
    slot).  :func:`make_operands` puts them on the device, and
    :func:`apply_mutation` rewrites a slot's pairs in place.

    Unlike compile_constraint_graph's deduplicated pair list this keeps
    duplicates (two factors over the same scope yield the pair twice)
    and parking self-pairs from free slots — both are no-ops to the
    segment-max/min arbitration of ``neighborhood_winner`` (max and min
    are idempotent; parking's gain is always 0).
    """
    src_parts, dst_parts = [], []
    for vi, b in zip(var_idx_leaves, buckets):
        vi = np.asarray(vi)
        for p, q in _pair_blocks(b.arity):
            src_parts.append(vi[:, p])
            dst_parts.append(vi[:, q])
    if not src_parts:
        z = np.zeros(0, dtype=np.int32)
        return z, z
    return (np.concatenate(src_parts).astype(np.int32),
            np.concatenate(dst_parts).astype(np.int32))


def derived_pairs_host(buckets) -> Tuple[np.ndarray, np.ndarray]:
    return derived_pairs([b.var_idx for b in buckets], buckets)


# ---------------------------------------------------------------------------
# mutations
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EditFactor:
    """Replace the cost function of an existing factor (same scope)."""

    constraint: Constraint


@dataclasses.dataclass
class AddFactor:
    """Claim a free slot of the constraint's arity and wire it in."""

    constraint: Constraint


@dataclasses.dataclass
class RemoveFactor:
    name: str


@dataclasses.dataclass
class AddVariable:
    """Claim a free variable slot.  ``variable`` is a dcop Variable;
    factors over it are added separately (AddFactor)."""

    variable: object
    unary_noise: Optional[np.ndarray] = None  # [D] noise row (maxsum)


@dataclasses.dataclass
class RemoveVariable:
    """Release a variable slot.  All its claimed factors must have been
    removed first (enforced)."""

    name: str


@dataclasses.dataclass
class Dirty:
    """What a mutation touched — drives the warm-start partial re-init
    (only the dirtied neighborhood's messages reset; everything else
    carries across the mutation)."""

    var_slots: List[int] = dataclasses.field(default_factory=list)
    edge_lo: int = 0
    edge_hi: int = 0  # [lo, hi) edge range of the touched factor slot


def _aligned_table(cap, constraint: Constraint, slot_names: List[str],
                   sign: float) -> np.ndarray:
    """The constraint's (sign-adjusted, PAD-padded) table with axes in
    ``slot_names`` order (the slot's existing scope order for edits)."""
    new_names = [d.name for d in constraint.dimensions]
    if set(new_names) != set(slot_names):
        raise ValueError(
            f"factor {constraint.name!r} covers {new_names}, slot "
            f"expects {slot_names} — mutations must keep the scope"
        )
    t = sign * constraint.to_tensor()
    if new_names != slot_names:
        t = np.transpose(t, [new_names.index(n) for n in slot_names])
    D = cap.max_domain_size
    padded = np.full((D,) * constraint.arity, PAD_COST, dtype=np.float32)
    padded[tuple(slice(0, s) for s in t.shape)] = t
    return padded


def _put(dst: torch.Tensor, index, value) -> None:
    """``dst[index] = value`` in place, ``value`` host data."""
    dst[index] = torch.as_tensor(np.asarray(value), dtype=dst.dtype,
                                 device=dst.device)


def _check_depth(cap, layout: HeadroomLayout, b: int,
                 row: Sequence[int]) -> None:
    """Raise :class:`HeadroomExhausted` when wiring ``row`` into a slot
    of bucket ``b`` would take a variable past a plan's depth."""
    depths = cap.plan_depths
    park = layout.parking
    if _is_constraint_graph(cap):
        vi = np.asarray(cap.buckets[b].var_idx)
        for p, v in enumerate(row):
            if v != park and np.count_nonzero(vi[:, p] == v) + 1 > \
                    depths["pos"][b]:
                raise HeadroomExhausted(
                    f"variable slot {v} would take more than "
                    f"{depths['pos'][b]} arity-{len(row)} factors at "
                    f"scope position {p} (the layout's plan depth)")
        return
    for v in set(int(v) for v in row):
        if v == park:
            continue
        deg = sum(int(np.count_nonzero(np.asarray(bk.var_idx) == v))
                  for bk in cap.buckets)
        if deg + list(row).count(v) > depths["edge"]:
            raise HeadroomExhausted(
                f"variable slot {v} would have degree "
                f"{deg + list(row).count(v)}, past the layout's plan "
                f"depth {depths['edge']}")


def _rewire_plans(cap, layout: HeadroomLayout, ops: Dict, b: int, k: int,
                  old_row: np.ndarray, new_row: np.ndarray) -> None:
    """After slot ``(b, k)`` changed its scope from ``old_row`` to
    ``new_row`` (host mirror already updated): rewrite, in place, the
    plan columns of the variables of both rows and the slot's pairs."""
    park = layout.parking
    touched = sorted({int(v) for v in np.concatenate([old_row, new_row])
                      if int(v) != park})
    bk = cap.buckets[b]
    a = bk.arity
    if ops["edge_rows"] is not None and touched:
        K = ops["edge_rows"].shape[0]
        E = cap.n_edges
        cols = np.full((K, len(touched)), E, dtype=np.int64)
        for j, v in enumerate(touched):
            rows = np.concatenate([
                ob.edge_offset + np.flatnonzero(
                    np.asarray(ob.var_idx).reshape(-1) == v)
                for ob in cap.buckets])
            cols[:rows.shape[0], j] = rows
        _put(ops["edge_rows"], (slice(None), torch.as_tensor(touched)),
             cols)
    if ops["pos_rows"]:
        vi = np.asarray(bk.var_idx)
        table = ops["pos_rows"][b]
        K, F = table.shape[1], vi.shape[0]
        for p in range(a):
            if not touched:
                break
            cols = np.full((K, len(touched)), F, dtype=np.int64)
            for j, v in enumerate(touched):
                rows = np.flatnonzero(vi[:, p] == v)
                cols[:rows.shape[0], j] = rows
            _put(table[p], (slice(None), torch.as_tensor(touched)), cols)
    if ops["pairs"] is not None:
        base = sum(ob.n_factors * ob.arity * (ob.arity - 1)
                   for ob in cap.buckets[:b])
        F = bk.n_factors
        blocks = _pair_blocks(a)
        pos = [base + j * F + k for j in range(len(blocks))]
        idx = torch.as_tensor(pos)
        _put(ops["pairs"][0], idx, [new_row[p] for p, _ in blocks])
        _put(ops["pairs"][1], idx, [new_row[q] for _, q in blocks])


def apply_mutation(cap, layout: HeadroomLayout, ops: Dict, mut) -> Tuple[
        Dict, Dirty]:
    """Apply one mutation as fixed-shape writes, in place, on the operand
    tensors (and on the graph's host mirror: names, domains, scopes).

    Returns ``(ops, dirty)`` — ``ops`` holds the same tensors as before.
    Raises :class:`HeadroomExhausted` when no free slot of the needed
    kind (or no plan depth) remains (the caller repacks), ``ValueError``
    on invalid mutations (unknown names, scope mismatches) — and in both
    cases the layout, operands and host metadata are left untouched.
    """
    if isinstance(mut, EditFactor):
        c = mut.constraint
        b, k = layout.factor_slot(c.name)
        bko = cap.buckets[b]
        slot_names = [cap.var_names[int(v)] for v in bko.var_idx[k]]
        if c.arity != layout.arities[b]:
            raise ValueError(
                f"factor {c.name!r} has arity {c.arity}, slot expects "
                f"{layout.arities[b]} — mutations must keep the scope"
            )
        table = _aligned_table(cap, c, slot_names, cap.sign)
        _put(ops["tensors"][b], k, table)
        return dict(ops), _factor_dirty(cap, layout, b, k, bko.var_idx[k])

    if isinstance(mut, AddFactor):
        c = mut.constraint
        if layout.has_factor(c.name):
            raise ValueError(f"factor {c.name!r} already exists")
        slots = [layout.var_slot(d.name) for d in c.dimensions]
        b = layout.bucket_for_arity(c.arity)
        if b is not None:
            _check_depth(cap, layout, b, slots)
        b, k = layout.claim_factor(c.name, c.arity)
        try:
            table = _aligned_table(
                cap, c, [d.name for d in c.dimensions], cap.sign
            )
        except ValueError:
            layout.release_factor(c.name)
            raise
        bko = cap.buckets[b]
        vi_row = np.asarray(slots, dtype=np.int32)
        old_row = np.array(bko.var_idx[k])
        _put(ops["tensors"][b], k, table)
        _put(ops["var_idx"][b], k, vi_row)
        eo = bko.edge_offset + k * bko.arity
        _put(ops["edge_var"], slice(eo, eo + bko.arity), vi_row)
        # host mirror: the slot's scope (assignment extraction, edits)
        bko.var_idx[k] = vi_row
        cap.factor_names[int(bko.factor_ids[k])] = c.name
        _rewire_plans(cap, layout, ops, b, k, old_row, vi_row)
        return dict(ops), _factor_dirty(cap, layout, b, k, vi_row)

    if isinstance(mut, RemoveFactor):
        b, k = layout.factor_slot(mut.name)
        bko = cap.buckets[b]
        old_row = np.array(bko.var_idx[k])
        layout.release_factor(mut.name)
        a = bko.arity
        D = cap.max_domain_size
        park = np.full(a, layout.parking, dtype=np.int32)
        _put(ops["tensors"][b], k, np.zeros((D,) * a, np.float32))
        _put(ops["var_idx"][b], k, park)
        eo = bko.edge_offset + k * a
        _put(ops["edge_var"], slice(eo, eo + a), park)
        bko.var_idx[k] = park
        cap.factor_names[int(bko.factor_ids[k])] = f"__slot_{a}_{k:04d}"
        _rewire_plans(cap, layout, ops, b, k, old_row, park)
        return dict(ops), _factor_dirty(cap, layout, b, k, old_row)

    if isinstance(mut, AddVariable):
        v = mut.variable
        if layout.has_var(v.name):
            raise ValueError(f"variable {v.name!r} already exists")
        D = cap.max_domain_size
        n = len(v.domain)
        if n > D:
            raise ValueError(
                f"variable {v.name!r} has domain size {n} > compiled "
                f"max {D} — repack required"
            )
        slot = layout.claim_var(v.name)
        mrow = np.zeros(D, dtype=np.float32)
        mrow[:n] = 1.0
        urow = np.full(D, PAD_COST, dtype=np.float32)
        urow[:n] = cap.sign * np.asarray(v.cost_vector(), dtype=np.float32)
        if mut.unary_noise is not None:
            urow[:n] = urow[:n] + np.asarray(
                mut.unary_noise, dtype=np.float32)[:n]
        _put(ops["mask"], slot, mrow)
        _put(ops["unary"], slot, urow)
        # host mirror
        cap.var_names[slot] = v.name
        cap.domain_values[slot] = tuple(v.domain.values)
        cap.domain_sizes[slot] = n
        if v.initial_value is not None:
            cap.initial_values[slot] = v.domain.index(v.initial_value)
            cap.has_initial[slot] = True
        else:
            cap.initial_values[slot] = 0
            cap.has_initial[slot] = True  # pinned until a factor moves it
        return dict(ops), Dirty(var_slots=[slot])

    if isinstance(mut, RemoveVariable):
        slot = layout.var_slot(mut.name)
        for b, names in enumerate(layout.fac_names):
            rows = np.flatnonzero(
                (np.asarray(cap.buckets[b].var_idx) == slot).any(axis=1))
            for k in rows:
                nm = names[int(k)]
                if nm is not FREE:
                    raise ValueError(
                        f"variable {mut.name!r} still has factor "
                        f"{nm!r}; remove its factors first"
                    )
        layout.release_var(mut.name)
        D = cap.max_domain_size
        mrow = np.zeros(D, dtype=np.float32)
        mrow[0] = 1.0
        urow = np.full(D, PAD_COST, dtype=np.float32)
        urow[0] = 0.0
        _put(ops["mask"], slot, mrow)
        _put(ops["unary"], slot, urow)
        cap.var_names[slot] = f"__free_{slot:04d}"
        cap.domain_values[slot] = (0,)
        cap.domain_sizes[slot] = 1
        cap.initial_values[slot] = 0
        cap.has_initial[slot] = True
        return dict(ops), Dirty(var_slots=[slot])

    raise TypeError(f"unknown mutation {type(mut).__name__}")


def _factor_dirty(cap, layout: HeadroomLayout, b: int, k: int,
                  vi_row: np.ndarray) -> Dirty:
    bko = cap.buckets[b]
    lo = bko.edge_offset + k * bko.arity
    return Dirty(
        var_slots=[int(v) for v in np.asarray(vi_row)
                   if int(v) != layout.parking],
        edge_lo=lo,
        edge_hi=lo + bko.arity,
    )
