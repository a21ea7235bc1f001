"""DCOP → padded tensor graph compilation, on a torch device.

Every constraint is materialized once into a dense cost tensor over
domain-index space, padded to uniform shapes and bucketed by arity, so a
whole round of an algorithm is a handful of batched tensor ops.  The
layout is the JAX package's (``ops/compile.py`` there), so a test can
compile a DCOP once in each package and compare the arrays exactly:

* ``D``: max domain size over all variables; every per-value axis is
  padded to D.  ``domain_mask[v, d] == 1`` iff d is a valid value of v.
* Unary (variable) costs: ``unary_costs[V, D]``, PAD_COST at invalid
  slots so a masked argmin can never select padding.
* Constraints are grouped into **arity buckets**; bucket ``a`` stacks its
  cost tensors as ``[F_a, D, ..., D]``.  Invalid combinations hold
  PAD_COST.
* An **edge** is a (factor, position) pair, laid out bucket by bucket,
  factor-major: global edge id = bucket.edge_offset + f * a + p.
  ``edge_var[e]`` is the variable of that edge; messages are ``[E, D]``.
* ``objective='max'`` problems are compiled by negating all costs:
  kernels always minimize; final costs are reported through
  DCOP.solution_cost on the host.
* The local-search family compiles a :class:`ConstraintGraphTensors`:
  the same fields plus every directed neighbour pair
  (``neighbor_src``/``neighbor_dst``).

Only dense float32 buckets exist here: the JAX package's table-free
(structured) buckets and its int8 table tier are not ported yet and
refuse with :class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.segments import SegmentPlan

# Large-but-finite padding cost: min-reductions never pick padded entries,
# and sums of a few pads stay finite in float32.
PAD_COST = 1e30


@dataclass
class FactorBucket:
    """All factors (constraints) of one arity, stacked."""

    arity: int
    tensors: torch.Tensor  # [F, D, ..., D] float32 (arity value axes)
    var_idx: np.ndarray  # [F, arity] int32 — variable index per position
    factor_ids: np.ndarray  # [F] global factor index
    edge_offset: int  # start of this bucket's edges in global edge arrays

    @property
    def n_factors(self) -> int:
        return int(self.var_idx.shape[0])

    @property
    def n_edges(self) -> int:
        return self.n_factors * self.arity


@dataclass
class FactorGraphTensors:
    """Compiled factor graph (bipartite var/factor view) — maxsum family."""

    var_names: List[str]
    domain_values: List[Tuple]  # per-variable valid values (host side)
    domain_sizes: np.ndarray  # [V] int32
    domain_mask: torch.Tensor  # [V, D] float32 (1 valid / 0 pad)
    unary_costs: torch.Tensor  # [V, D] float32, PAD_COST at invalid slots
    buckets: List[FactorBucket]
    edge_var: torch.Tensor  # [E] int64
    factor_names: List[str]
    sign: float  # +1 for min problems, -1 for max (costs pre-multiplied)
    initial_values: np.ndarray  # [V] int32 domain indices
    has_initial: Optional[np.ndarray] = None  # [V] bool

    @property
    def device(self) -> torch.device:
        return self.domain_mask.device

    @property
    def n_vars(self) -> int:
        return len(self.var_names)

    @property
    def n_factors(self) -> int:
        return len(self.factor_names)

    @property
    def n_edges(self) -> int:
        return int(self.edge_var.shape[0])

    @property
    def max_domain_size(self) -> int:
        return int(self.domain_mask.shape[1])

    def assignment_from_indices(self, x: np.ndarray) -> Dict[str, object]:
        """Map value indices [V] back to python domain values."""
        return {
            n: self.domain_values[i][int(x[i])]
            for i, n in enumerate(self.var_names)
        }


@dataclass
class ConstraintGraphTensors(FactorGraphTensors):
    """Compiled constraints hypergraph — local-search family.

    Adds the var↔var adjacency used for gain exchange (MGM & friends):
    ``neighbor_src/neighbor_dst`` list every directed neighbour pair,
    sorted by (src, dst)."""

    neighbor_src: Optional[torch.Tensor] = None  # [M] int64
    neighbor_dst: Optional[torch.Tensor] = None  # [M] int64

    @property
    def n_pairs(self) -> int:
        return int(self.neighbor_src.shape[0])


def _slice_externals(dcop: DCOP, constraints: Sequence[Constraint]
                     ) -> List[Constraint]:
    """Fix external (read-only sensor) variables at their current value:
    they are inputs, not decision variables."""
    if not dcop.external_variables:
        return list(constraints)
    ext_values = {
        ev.name: ev.value for ev in dcop.external_variables.values()
    }
    return [
        c.slice(ext_values) if any(
            n in ext_values for n in c.scope_names) else c
        for c in constraints
    ]


def _compile_fields(dcop: DCOP) -> Dict[str, Any]:
    """The fields of a compiled graph (see :func:`tensors_from_numpy`).
    Variables and constraints are taken in name order, as the JAX package
    does."""
    variables = [dcop.variables[n] for n in sorted(dcop.variables)]
    constraints = [dcop.constraints[n] for n in sorted(dcop.constraints)]
    constraints = [
        c for c in _slice_externals(dcop, constraints) if c.arity > 0
    ]
    sign = 1.0 if dcop.objective == "min" else -1.0
    var_names = [v.name for v in variables]
    var_pos = {n: i for i, n in enumerate(var_names)}
    domain_values = [tuple(v.domain.values) for v in variables]
    domain_sizes = np.array([len(d) for d in domain_values], dtype=np.int32)
    D = int(domain_sizes.max()) if len(domain_sizes) else 1

    V = len(variables)
    mask = np.zeros((V, D), dtype=np.float32)
    unary = np.full((V, D), PAD_COST, dtype=np.float32)
    init = np.zeros(V, dtype=np.int32)
    has_init = np.zeros(V, dtype=bool)
    for i, v in enumerate(variables):
        n = domain_sizes[i]
        mask[i, :n] = 1.0
        unary[i, :n] = sign * v.cost_vector()
        if v.initial_value is not None:
            init[i] = v.domain.index(v.initial_value)
            has_init[i] = True

    # bucket constraints by arity (stable order: by arity, then input order)
    by_arity: Dict[int, List[int]] = {}
    for gi, c in enumerate(constraints):
        by_arity.setdefault(c.arity, []).append(gi)
    buckets = []
    offset = 0
    for arity in sorted(by_arity):
        idxs = by_arity[arity]
        F = len(idxs)
        tensors = np.full((F,) + (D,) * arity, PAD_COST, dtype=np.float32)
        var_idx = np.zeros((F, arity), dtype=np.int32)
        for k, gi in enumerate(idxs):
            c = constraints[gi]
            t = sign * c.to_tensor()
            tensors[(k,) + tuple(slice(0, s) for s in t.shape)] = t
            var_idx[k] = [var_pos[v.name] for v in c.dimensions]
        buckets.append(dict(
            arity=arity, tensors=tensors, var_idx=var_idx,
            factor_ids=np.array(idxs, dtype=np.int32), edge_offset=offset,
        ))
        offset += F * arity
    edge_var = (
        np.concatenate([b["var_idx"].reshape(-1) for b in buckets])
        if buckets else np.zeros(0, dtype=np.int32)
    )
    return dict(
        var_names=var_names,
        domain_values=domain_values,
        domain_sizes=domain_sizes,
        domain_mask=mask,
        unary_costs=unary,
        buckets=buckets,
        edge_var=edge_var,
        factor_names=[c.name for c in constraints],
        sign=sign,
        initial_values=init,
        has_initial=has_init,
    )


def compile_factor_graph(dcop: DCOP,
                         device: DeviceLike = None) -> FactorGraphTensors:
    """Compile a DCOP for factor-graph algorithms (maxsum family), onto
    ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return tensors_from_numpy(_compile_fields(dcop), device=dev)


def neighbor_pairs(var_idxs: Sequence[np.ndarray],
                   n_vars: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every directed pair (a, b), a != b, of variables that share a
    constraint, deduplicated and sorted by (a, b) — the JAX package's
    ``sorted(set(pairs))``, from the buckets' ``[F, arity]`` index arrays
    in one vectorised pass."""
    keys = []
    for vi in var_idxs:
        vi = np.asarray(vi, dtype=np.int64)
        a = vi.shape[1]
        for p in range(a):
            for q in range(a):
                if p != q:
                    src, dst = vi[:, p], vi[:, q]
                    keep = src != dst
                    keys.append(src[keep] * n_vars + dst[keep])
    if not keys:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    uniq = np.unique(np.concatenate(keys))
    return ((uniq // n_vars).astype(np.int32),
            (uniq % n_vars).astype(np.int32))


def compile_constraint_graph(
        dcop: DCOP, device: DeviceLike = None) -> "ConstraintGraphTensors":
    """Compile a DCOP for local-search algorithms on the constraints
    hypergraph: the factor-graph fields plus the directed neighbour pairs
    (``neighbor_src``/``neighbor_dst``) that carry MGM's gain exchange."""
    dev = resolve_device(device)
    fields = _compile_fields(dcop)
    fields["neighbor_src"], fields["neighbor_dst"] = neighbor_pairs(
        [b["var_idx"] for b in fields["buckets"]], len(fields["var_names"]))
    return tensors_from_numpy(fields, device=dev)


def tensors_from_numpy(fields: Dict[str, Any],
                       device: DeviceLike = None) -> FactorGraphTensors:
    """Build a :class:`FactorGraphTensors` on ``device`` from host data.

    ``fields`` holds the fields of a compiled factor graph as numpy
    arrays and python lists — the same names as the dataclass, with
    ``buckets`` a list of dicts (``arity``, ``tensors``, ``var_idx``,
    ``factor_ids``, ``edge_offset``).  A test can thus compile once in
    the JAX package and run both packages on the very same arrays.
    Fields with ``neighbor_src``/``neighbor_dst`` (a compiled constraints
    hypergraph) give a :class:`ConstraintGraphTensors`.
    Table-free buckets (``sbuckets``) and int8 tables (``qscale``/
    ``qoffset``) are not ported and are refused."""
    dev = resolve_device(device)
    if fields.get("sbuckets"):
        raise NotPortedError(
            "structured (table-free) buckets are not ported to the "
            "PyTorch package yet"
        )
    def put(a, dtype):
        # np.array copies: the tensor never shares (possibly read-only)
        # memory with the caller's arrays
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)

    buckets = []
    for b in fields["buckets"]:
        if b.get("qscale") is not None or b.get("qoffset") is not None:
            raise NotPortedError(
                "int8 cost tables are not ported; only f32 buckets are"
            )
        if np.asarray(b["tensors"]).dtype != np.float32:
            raise NotPortedError(
                f"{np.asarray(b['tensors']).dtype} cost tables are not "
                f"ported; only float32"
            )
        buckets.append(FactorBucket(
            arity=int(b["arity"]),
            tensors=put(b["tensors"], np.float32),
            var_idx=np.asarray(b["var_idx"], dtype=np.int32),
            factor_ids=np.asarray(b["factor_ids"], dtype=np.int32),
            edge_offset=int(b["edge_offset"]),
        ))
    V = len(fields["var_names"])
    has_init = fields.get("has_initial")
    extra = {}
    cls = FactorGraphTensors
    if fields.get("neighbor_src") is not None:
        cls = ConstraintGraphTensors
        extra = dict(neighbor_src=put(fields["neighbor_src"], np.int64),
                     neighbor_dst=put(fields["neighbor_dst"], np.int64))
    return cls(
        var_names=list(fields["var_names"]),
        domain_values=[tuple(d) for d in fields["domain_values"]],
        domain_sizes=np.asarray(fields["domain_sizes"], dtype=np.int32),
        domain_mask=put(fields["domain_mask"], np.float32),
        unary_costs=put(fields["unary_costs"], np.float32),
        buckets=buckets,
        edge_var=put(fields["edge_var"], np.int64),
        factor_names=list(fields["factor_names"]),
        sign=float(fields["sign"]),
        initial_values=np.asarray(fields["initial_values"], dtype=np.int32),
        has_initial=(np.zeros(V, dtype=bool) if has_init is None
                     else np.asarray(has_init, dtype=bool)),
        **extra,
    )


def numpy_fields(t: Any) -> Dict[str, Any]:
    """The inverse of :func:`tensors_from_numpy`: the fields of a
    compiled factor graph as numpy arrays and python lists.  It reads
    attributes only, so it takes a compiled graph of this package or of
    the JAX package alike (its arrays convert with ``np.asarray``)."""

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    return dict(
        var_names=list(t.var_names),
        domain_values=[tuple(d) for d in t.domain_values],
        domain_sizes=host(t.domain_sizes),
        domain_mask=host(t.domain_mask),
        unary_costs=host(t.unary_costs),
        buckets=[dict(
            arity=b.arity, tensors=host(b.tensors),
            var_idx=host(b.var_idx), factor_ids=host(b.factor_ids),
            edge_offset=b.edge_offset,
            qscale=getattr(b, "qscale", None),
            qoffset=getattr(b, "qoffset", None),
        ) for b in t.buckets],
        sbuckets=list(getattr(t, "sbuckets", None) or []),
        edge_var=host(t.edge_var),
        factor_names=list(t.factor_names),
        sign=float(t.sign),
        initial_values=host(t.initial_values),
        has_initial=(None if t.has_initial is None
                     else host(t.has_initial)),
        neighbor_src=(None if getattr(t, "neighbor_src", None) is None
                      else host(t.neighbor_src)),
        neighbor_dst=(None if getattr(t, "neighbor_dst", None) is None
                      else host(t.neighbor_dst)),
    )


def compile_binary_from_arrays(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    matrices: np.ndarray,
    n_vars: int,
    unary: Optional[np.ndarray] = None,
    var_names: Optional[List[str]] = None,
    domain_values: Optional[List[Tuple]] = None,
    device: DeviceLike = None,
) -> FactorGraphTensors:
    """Direct tensor-graph construction for uniform binary-constraint
    problems — bypasses python constraint objects entirely:

    * edge_i/edge_j: [F] variable indices of each binary constraint,
    * matrices: [F, D, D] cost tables,
    * unary: optional [V, D] variable costs.
    """
    F = int(edge_i.shape[0])
    D = int(matrices.shape[1])
    var_idx = np.stack(
        [edge_i.astype(np.int32), edge_j.astype(np.int32)], axis=1
    )
    return tensors_from_numpy(dict(
        var_names=var_names or [f"v{i:06d}" for i in range(n_vars)],
        domain_values=domain_values or [tuple(range(D))] * n_vars,
        domain_sizes=np.full(n_vars, D, dtype=np.int32),
        domain_mask=np.ones((n_vars, D), dtype=np.float32),
        unary_costs=(np.zeros((n_vars, D), dtype=np.float32)
                     if unary is None else unary),
        buckets=[dict(arity=2, tensors=np.asarray(matrices, np.float32),
                      var_idx=var_idx,
                      factor_ids=np.arange(F, dtype=np.int32),
                      edge_offset=0)],
        edge_var=var_idx.reshape(-1),
        factor_names=[f"c{k:06d}" for k in range(F)],
        sign=1.0,
        initial_values=np.zeros(n_vars, dtype=np.int32),
    ), device=device)


# ---------------------------------------------------------------------------
# Device-side evaluation
# ---------------------------------------------------------------------------


def bucket_index(bucket: FactorBucket, device: torch.device
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``var_idx`` of the bucket on ``device`` as int64 ``[F, arity]``,
    and its columns as separate contiguous tensors, built once and kept
    on the bucket."""
    cache = bucket.__dict__.setdefault("_index", {})
    if device not in cache:
        vi = torch.as_tensor(np.asarray(bucket.var_idx, dtype=np.int64),
                             device=device)
        cache[device] = (vi, [vi[:, p].contiguous()
                              for p in range(bucket.arity)])
    return cache[device]


def bucket_plans(bucket: FactorBucket, device: torch.device,
                 n_vars: int) -> List[SegmentPlan]:
    """The ordered segment-sum plan of each scope position's variables,
    built once and kept on the bucket."""
    cache = bucket.__dict__.setdefault("_plans", {})
    if device not in cache:
        cache[device] = [SegmentPlan(c, n_vars)
                         for c in bucket_index(bucket, device)[1]]
    return cache[device]


def edge_plan(tensors: FactorGraphTensors) -> SegmentPlan:
    """The ordered segment-sum plan of ``edge_var`` over the variables,
    built once and kept on the compiled graph."""
    plan = tensors.__dict__.get("_edge_plan")
    if plan is None:
        plan = SegmentPlan(tensors.edge_var, tensors.n_vars)
        tensors.__dict__["_edge_plan"] = plan
    return plan


def bucket_factor_values(bucket: FactorBucket,
                         x: torch.Tensor) -> torch.Tensor:
    """Cost of each factor in the bucket under assignment x ([V] value
    indices) → [F]."""
    var_idx, _ = bucket_index(bucket, x.device)
    vals = x.long()[var_idx]  # [F, a]
    fidx = torch.arange(bucket.n_factors, device=x.device)
    return bucket.tensors[(fidx,) + tuple(
        vals[:, p] for p in range(bucket.arity))]


def total_cost(tensors: FactorGraphTensors, x: torch.Tensor) -> torch.Tensor:
    """Total (sign-adjusted) cost of assignment x on device: all factor
    costs + unary costs, a float32 scalar.  The float32 terms are added
    in float64 and the total rounded once: the card's and the CPU's
    reductions add in different orders, and float64 keeps every partial
    sum of these terms exact unless a total needs more than 53 bits, so
    both devices give the same float32 (the JAX package sums in float32;
    the two agree to its rounding)."""
    cost = torch.zeros((), dtype=torch.float64, device=x.device)
    for b in tensors.buckets:
        cost = cost + torch.sum(bucket_factor_values(b, x).double())
    vidx = torch.arange(tensors.n_vars, device=x.device)
    unary = tensors.unary_costs[vidx, x] * tensors.domain_mask[vidx, x]
    return (cost + torch.sum(unary.double())).float()


def bucket_factor_ids(bucket: FactorBucket,
                      device: torch.device) -> torch.Tensor:
    """``factor_ids`` of the bucket on ``device`` as int64 ``[F]``, built
    once and kept on the bucket."""
    cache = bucket.__dict__.setdefault("_factor_ids", {})
    if device not in cache:
        cache[device] = torch.as_tensor(
            np.asarray(bucket.factor_ids, dtype=np.int64), device=device)
    return cache[device]


def local_cost_tables(
    tensors: FactorGraphTensors,
    x: torch.Tensor,
    bucket_tensors: Optional[List[torch.Tensor]] = None,
    factor_weights: Optional[torch.Tensor] = None,
    include_unary: bool = True,
) -> torch.Tensor:
    """Per-variable cost of each candidate value given the neighbours'
    current values: ``out[v, d] = unary[v, d] + Σ_{factors containing v}
    cost(factor | v=d, others=x)``, ``[V, D]`` with PAD_COST on invalid
    slots — the workhorse of the local-search family.

    The arithmetic is the JAX package's: start from the unary costs (or
    from zeros when ``include_unary`` is False), then for each bucket and
    each scope position p add the ordered segment sum
    (:func:`bucket_plans`) of that position's gathered rows; so on the
    CPU and on the card the result equals the JAX package's XLA CPU
    result bit for bit.  The breakout knobs: ``bucket_tensors``
    substitutes each bucket's cost tensor (GDBA's effective tensors) and
    ``factor_weights`` (``[n_factors]``) multiplies each factor's
    gathered rows before the sum (DBA's breakout weights)."""
    V, D = tensors.n_vars, tensors.max_domain_size
    dev = x.device
    valid = tensors.domain_mask > 0
    if include_unary:
        out = torch.where(valid, tensors.unary_costs, PAD_COST)
    else:
        out = torch.zeros((V, D), dtype=torch.float32, device=dev)
    dvals = torch.arange(D, device=dev)[None, :]
    xl = x.long()
    for bi, b in enumerate(tensors.buckets):
        F, a = b.n_factors, b.arity
        if F == 0:
            continue
        T = b.tensors if bucket_tensors is None else bucket_tensors[bi]
        w = (None if factor_weights is None
             else factor_weights[bucket_factor_ids(b, dev)][:, None])
        var_idx, _ = bucket_index(b, dev)
        plans = bucket_plans(b, dev, V)
        vals = xl[var_idx]  # [F, a]
        fidx = torch.arange(F, device=dev)[:, None]
        for p in range(a):
            # axis p swept over D, every other axis at its current value
            idx = tuple(dvals if q == p else vals[:, q][:, None]
                        for q in range(a))
            rows = T[(fidx,) + idx]  # [F, D]
            if w is not None:
                rows = rows * w
            out = out + plans[p].sum(rows)
    return torch.where(valid, out, PAD_COST)
