"""Shape signatures and the bounded padding-waste bucketing policy.

The port's own copy of the JAX package's ``batch/bucketing.py`` (host
arithmetic, no JAX), with the same policy and the same plans.  Two
compiled instances can share one bucket runner only if their padded
array shapes match exactly.  Forcing every instance of a
sweep into ONE shape would make the smallest instance pay the largest
instance's cost tables, so buckets are formed greedily under a waste
bound: an instance joins the current bucket only while the bucket-wide
padding waste — the fraction of padded array cells that hold no real
data — stays at or below ``max_waste``.

Everything here is pure host-side arithmetic over
:class:`InstanceDims`; ``tests/test_torch_batch.py`` holds the plans to
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class InstanceDims:
    """Shape signature of one compiled instance.

    * ``graph_type``: computation-graph family (``factor_graph`` for
      the BP algorithms, ``constraints_hypergraph`` for local search) —
      instances never bucket across families;
    * ``D``: padded domain-size axis;
    * ``arities``: sorted tuple of constraint arities present (the
      arity *set* must match exactly — a missing arity bucket cannot be
      padded in);
    * ``V`` / ``F`` / ``M``: variable count, factor count per arity
      (aligned with ``arities``), and directed neighbor-pair count
      (0 for factor graphs).
    """

    graph_type: str
    D: int
    arities: Tuple[int, ...]
    V: int
    F: Tuple[int, ...]
    M: int

    @property
    def family_key(self) -> Tuple:
        """Instances may only share a bucket within one family key."""
        return (self.graph_type, self.arities)

    @property
    def cells(self) -> int:
        """Data cells of the dominant per-instance arrays — the unit
        the waste bound is measured in.  Counts the [V, D] mask+unary
        pair, the stacked cost tensors ([F_a, D^a] per arity), the
        message state of the BP family (2 edge arrays of [E, D]) and
        the neighbor-pair lists."""
        c = 2 * self.V * self.D
        edges = 0
        for a, f in zip(self.arities, self.F):
            c += f * self.D ** a
            edges += f * a
        if self.graph_type == "factor_graph":
            c += 2 * edges * self.D
        return c + 2 * self.M


@dataclass
class BucketPlan:
    """One planned bucket: which instances (by input index), the padded
    target shape they are stacked at, and the resulting waste."""

    indices: List[int]
    target: InstanceDims
    waste: float

    @property
    def batch_size(self) -> int:
        return len(self.indices)

    def signature(self) -> Tuple:
        """Hashable bucket signature — the shape part of the runner
        cache key (:mod:`pydcop_tpu_torch.batch.cache`)."""
        return bucket_signature(self.target, self.batch_size)


def bucket_signature(target: InstanceDims, batch_size: int) -> Tuple:
    """Hashable (padded shape, lane count) signature of one bucket —
    the shape part of the runner-cache key, shared by
    :meth:`BucketPlan.signature` and (when it is ported) the serve
    scheduler's workers, so both resolve to the SAME cached runner."""
    return (target.graph_type, target.D, target.arities, target.V,
            target.F, target.M, batch_size)


class StructuredBatchingUnsupported(NotImplementedError):
    """Typed refusal: structured (table-free) buckets reached the lane
    stacker, which cannot pad them.  Subclasses NotImplementedError, as
    the JAX package's does, with its message (it names the fallback
    path)."""


def dims_of(tensors, graph_type: str) -> InstanceDims:
    """Shape signature of a compiled tensor graph
    (:class:`~pydcop_tpu_torch.ops.compile.FactorGraphTensors` or its
    constraints-hypergraph subclass)."""
    if getattr(tensors, "sbuckets", None):
        raise StructuredBatchingUnsupported(
            "batched lanes do not yet pad table-free (structured) buckets; "
            "solve structured instances on a dedicated lane"
        )
    arities = tuple(b.arity for b in tensors.buckets)
    fs = tuple(b.n_factors for b in tensors.buckets)
    m = 0
    src = getattr(tensors, "neighbor_src", None)
    if src is not None:
        m = int(src.shape[0])
    return InstanceDims(
        graph_type=graph_type,
        D=tensors.max_domain_size,
        arities=arities,
        V=tensors.n_vars,
        F=fs,
        M=m,
    )


def padded_target(members: Sequence[InstanceDims]) -> InstanceDims:
    """Element-wise max of the members' dims, plus one dummy variable
    slot when any member needs factor or neighbor-pair padding: padded
    factors and padded neighbor pairs are routed to the dummy variable
    so they cannot perturb any real variable's tables, messages or
    neighborhood reductions (see
    :func:`~pydcop_tpu_torch.batch.engine.pad_instance`)."""
    first = members[0]
    v = max(m.V for m in members)
    fs = tuple(
        max(m.F[i] for m in members) for i in range(len(first.arities))
    )
    mm = max(m.M for m in members)
    d = max(m.D for m in members)
    needs_dummy = any(m.F != fs or m.M != mm for m in members)
    if needs_dummy:
        v += 1
    return InstanceDims(
        graph_type=first.graph_type,
        D=d,
        arities=first.arities,
        V=v,
        F=fs,
        M=mm,
    )


def bucket_waste(members: Sequence[InstanceDims]) -> float:
    """Padding waste of stacking ``members`` at their padded target:
    1 − (real cells) / (padded cells × B)."""
    target = padded_target(members)
    real = sum(m.cells for m in members)
    padded = target.cells * len(members)
    return 1.0 - real / padded if padded else 0.0


def plan_buckets(
    dims: Sequence[InstanceDims], max_waste: float = 0.25
) -> List[BucketPlan]:
    """Greedy shape-bucketing under the waste bound.

    Instances are first partitioned by family key (graph type + arity
    set — hard compatibility), then sorted by descending cell count
    (ties broken by input index, so the plan is deterministic) and
    packed sequentially: each instance joins the open bucket if the
    bucket's waste with it stays ≤ ``max_waste``, otherwise it opens a
    new bucket.  Sorting big-to-small means the open bucket's target
    rarely grows when a member joins, which keeps the greedy bound
    tight.
    """
    by_family = {}
    for i, dm in enumerate(dims):
        by_family.setdefault(dm.family_key, []).append(i)

    plans: List[BucketPlan] = []
    for fam in sorted(by_family):
        idxs = sorted(
            by_family[fam], key=lambda i: (-dims[i].cells, i)
        )
        open_idx: List[int] = []
        for i in idxs:
            if not open_idx:
                open_idx = [i]
                continue
            cand = [dims[j] for j in open_idx] + [dims[i]]
            if bucket_waste(cand) <= max_waste:
                open_idx.append(i)
            else:
                plans.append(_finalize(open_idx, dims))
                open_idx = [i]
        if open_idx:
            plans.append(_finalize(open_idx, dims))
    return plans


def _finalize(indices: List[int], dims: Sequence[InstanceDims]
              ) -> BucketPlan:
    members = [dims[i] for i in indices]
    return BucketPlan(
        indices=list(indices),
        target=padded_target(members),
        waste=round(bucket_waste(members), 6),
    )
