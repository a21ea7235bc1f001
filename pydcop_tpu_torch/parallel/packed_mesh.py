"""Per-shard packed layouts for the sharded engines (all-binary and
mixed-arity 1-4 graphs).

The counterpart of the JAX package's ``parallel/packed_mesh.py``
(``build_shard_packs`` with its binary branch and
``_build_mixed_shard_packs``, ``_stacked_move_extras`` and
``ops/pallas_local_search.py::move_extras``).

Every shard gets a packed layout of its own factor subset over ONE
common column map, so the shards' partial beliefs and partial tables
line up column by column and the cross-shard combine is a plain sum.
The common column of a variable is its index (``Vp = V``).  Within a
shard the slots follow the var-grouped layout of the single-device
packers (:func:`~pydcop_tpu_torch.ops.packed_maxsum.pack_binary_for_gpu`
for an all-binary graph, ``pack_mixed_for_gpu`` for a mixed one), built
from the shard's own degrees: the shard's threads walk the columns
sorted by the shard's degree (``tcol[t]`` = the column of thread t), and
thread t's k-th slot is ``t_slot0[t] + k * t_stride[t]``, so the threads
of a degree class read neighbouring slots.  A column the shard does not
touch has degree 0 there; its partial is 0.  The variables' unary costs
are zero on every shard and added once, after the combine.

Mixed-arity graphs: EVERY shard that holds a factor takes the mixed
layout (``ShardLayout.mixed``), also a shard whose factors are all
binary or all unary, so the engines and the kernels run one branch per
graph and never dispatch shard by shard.  A unary factor is a factor: it
lands on its assigned shard, where its slot gives its cost row, and is
summed once.  The JAX packer's shard-invariant sections (arity masks
over slot classes reserved on every shard, dummy slots) exist so that
one SPMD trace serves every shard; the port launches per shard and has
no dummy slot, so its arity masks are the shard's own occupancy.

The JAX packer's TPU machinery — one forced layout of 128-lane padded
degree classes shared by every shard, the Clos plans, the per-shard
degree limit of 96 — does not carry over: any graph in the packers'
scope packs (arity 1-4, D <= 8, and D <= 5 when a factor has arity 3 or
4).  Outside it :func:`build_shard_packs` raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`: the generic sharded
engine that the JAX package falls back to is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import FactorBucket, FactorGraphTensors
from pydcop_tpu_torch.ops.packed_maxsum import (
    ARITIES,
    MAX_D,
    MAX_D_NARY,
    pack_binary_for_gpu,
    pack_mixed_for_gpu,
)
from pydcop_tpu_torch.ops.packed_sharded import BIG_IDX
from pydcop_tpu_torch.parallel.boundary import BoundaryInfo, \
    analyze_boundary
from pydcop_tpu_torch.parallel.partition import partition_factors


@dataclasses.dataclass
class ShardMixed:
    """The mixed-arity slot arrays of one shard (the slots of
    ``pack_mixed_for_gpu`` on the shard's factors), on its device."""

    arity: torch.Tensor     # [N] int32 arity of each slot's factor
    #: [N] int32 column of each slot in its arity's cost array
    cost_idx: torch.Tensor
    mate2: torch.Tensor     # [N] int32 second sibling slot, -1 below 3
    mate3: torch.Tensor     # [N] int32 third sibling slot, -1 below 4
    mate2_col: torch.Tensor  # [N] int32 its column, -1 where absent
    mate3_col: torch.Tensor  # [N] int32 its column, -1 where absent
    #: [N] float32 the second / third sibling's variable, BIG_IDX where
    #: absent (MGM's tie-break index)
    mate2_idx: torch.Tensor
    mate3_idx: torch.Tensor
    gmask2: torch.Tensor    # [N] float32 1 on the slots of arity >= 3
    gmask3: torch.Tensor    # [N] float32 1 on the slots of arity 4
    #: cost1 [D, N1], cost2 [D², N2], cost3 [D³, N3], cost4 [D⁴, N4],
    #: other-values-major, each over its arity's slots only
    costs: Tuple[torch.Tensor, ...]
    slots: Tuple[torch.Tensor, ...]  # int64 slot ids of each arity


@dataclasses.dataclass
class ShardLayout:
    """One shard's packed slots over the common column map, on the
    shard's device.  ``N == 0`` for a shard that holds no factor: its
    tensors are empty and no kernel launches for it."""

    index: int
    D: int
    Vp: int
    N: int  # edge slots: one per endpoint of the shard's factors
    #: degree classes in thread space (deg, nvp, toff, soff): threads
    #: [toff, toff + nvp) have degree deg and own slots [soff, soff +
    #: deg * nvp); degree 0 is left out
    buckets: Tuple[Tuple[int, int, int, int], ...]
    tcol: torch.Tensor      # [Vp] int32 column of each thread
    t_deg: torch.Tensor     # [Vp] int32 degree of each thread's column
    t_slot0: torch.Tensor   # [Vp] int32 slot of each thread's rank 0
    t_stride: torch.Tensor  # [Vp] int32 slot step between ranks
    #: all-binary layout: [D*D, N], row j*D+i = cost(other endpoint at
    #: j, this end at i); None on the mixed layout (``mixed.costs``)
    cost_rows: Optional[torch.Tensor]
    vmask: torch.Tensor       # [D, N] 1 = valid value of the slot's var
    inv_dcount: torch.Tensor  # [N] 1 / |valid values| of the slot's var
    #: [N] int32 slot of the factor's (first) other end, -1 on a unary
    #: slot
    mate: torch.Tensor
    slot_col: torch.Tensor  # [N] int32 column (variable) of each slot
    mate_col: torch.Tensor  # [N] int32 column of the other end, or -1
    #: [N] float32 variable index of the other end (BIG_IDX on a unary
    #: slot): MGM's static tie-break index, float-encoded as the JAX
    #: package's move rule
    mate_idx: torch.Tensor
    gmask1: torch.Tensor    # [N] float32 1 where the slot routes a gain
    #: arity → slot of each local endpoint e = p*F + k of that arity,
    #: where local factor k is the shard's k-th factor of the arity in
    #: bucket order; host-side
    slot_of: Dict[int, np.ndarray]
    #: the mixed-arity slot arrays; None on the all-binary layout
    mixed: Optional[ShardMixed] = None

    @property
    def device(self) -> torch.device:
        return self.tcol.device


@dataclasses.dataclass
class ShardPacks:
    """The shards' layouts over the common column map (column = variable),
    plus the column-space arrays every shard shares, on the host."""

    D: int
    Vp: int
    n_shards: int
    shards: List[ShardLayout]
    unary_p: np.ndarray  # [D, Vp] unary * mask: added once, after the sum
    mask_p: np.ndarray   # [D, Vp] 1 = valid value
    #: per bucket of the graph, factor → shard
    assigns: List[np.ndarray]
    boundary: BoundaryInfo
    mixed: bool = False  # the shards take the mixed-arity layout
    _common: Dict[torch.device, Tuple[torch.Tensor, ...]] = \
        dataclasses.field(default_factory=dict, repr=False)

    def common_on(self, device: torch.device):
        """(unary_p, mask_p, idx_row) on ``device``, built once per device:
        idx_row [Vp] float32 is each column's variable index, the lexic
        tie-break key of MGM."""
        dev = torch.device(device)
        if dev not in self._common:
            self._common[dev] = (
                torch.as_tensor(self.unary_p, device=dev),
                torch.as_tensor(self.mask_p, device=dev),
                torch.arange(self.Vp, dtype=torch.float32, device=dev),
            )
        return self._common[dev]


def _empty_shard(index: int, D: int, Vp: int, dev) -> ShardLayout:
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return ShardLayout(
        index=index, D=D, Vp=Vp, N=0, buckets=(),
        tcol=torch.arange(Vp, **i32), t_deg=torch.zeros(Vp, **i32),
        t_slot0=torch.zeros(Vp, **i32), t_stride=torch.ones(Vp, **i32),
        cost_rows=torch.zeros((D * D, 0), **f32),
        vmask=torch.zeros((D, 0), **f32), inv_dcount=torch.zeros(0, **f32),
        mate=torch.zeros(0, **i32), slot_col=torch.zeros(0, **i32),
        mate_col=torch.zeros(0, **i32), mate_idx=torch.zeros(0, **f32),
        gmask1=torch.zeros(0, **f32), slot_of={},
    )


def _sub_graph(t: FactorGraphTensors, idxs: Sequence[np.ndarray],
               dev: torch.device) -> FactorGraphTensors:
    """``t`` cut to the factors ``idxs`` (one index array per bucket, in
    bucket order), its host-side arrays on ``dev``."""
    buckets, ends, off = [], [], 0
    for b, idx in zip(t.buckets, idxs):
        vi = np.asarray(b.var_idx)[idx]
        buckets.append(FactorBucket(
            arity=b.arity,
            tensors=b.tensors[torch.as_tensor(idx, dtype=torch.long)],
            var_idx=vi, factor_ids=np.asarray(b.factor_ids)[idx],
            edge_offset=off))
        ends.append(vi.T.ravel())  # edge e = p*F + k
        off += vi.size
    return dataclasses.replace(
        t, buckets=buckets, domain_mask=t.domain_mask.to(dev),
        unary_costs=t.unary_costs.to(dev),
        edge_var=torch.as_tensor(np.concatenate(ends), device=dev),
    )


def _sibling(slot_col: torch.Tensor, mate: torch.Tensor):
    """(column [N] int32, -1 where absent; variable index [N] float32,
    BIG_IDX where absent) of the sibling slots ``mate`` (-1 = none)."""
    m = mate.long()
    col = torch.where(m >= 0, slot_col[m.clamp_min(0)], -1)
    idx = torch.where(col >= 0, col.float(), BIG_IDX)
    return col.int().contiguous(), idx.contiguous()


def _shard_layout(t: FactorGraphTensors, index: int,
                  idxs: Sequence[np.ndarray], dev: torch.device,
                  mixed: bool) -> ShardLayout:
    """Shard ``index``'s layout of the factors ``idxs`` (per bucket, in
    bucket order), on ``dev``: the single-device packer run on the
    sub-graph (the mixed one when ``mixed``), its degree-sorted columns
    read as the shard's thread order."""
    V, D = t.n_vars, t.max_domain_size
    if sum(idx.size for idx in idxs) == 0:
        return _empty_shard(index, D, V, dev)
    sub = _sub_graph(t, idxs, dev)
    pg = (pack_mixed_for_gpu(sub, all_binary=True) if mixed
          else pack_binary_for_gpu(sub))
    if pg is None:  # the whole graph's scope was checked already
        raise AssertionError(f"shard {index} did not pack")
    tcol = torch.empty_like(pg.var_order)
    tcol[pg.var_order] = torch.arange(V, device=dev)
    slot_col = tcol[pg.slot_col].int()
    mate_col, mate_idx = _sibling(slot_col, pg.mate)
    extra = {}
    if mixed:
        m = pg.mixed
        arity = m.arity
        mate2_col, mate2_idx = _sibling(slot_col, m.mate2)
        mate3_col, mate3_idx = _sibling(slot_col, m.mate3)
        extra["mixed"] = ShardMixed(
            arity=arity, cost_idx=m.cost_idx, mate2=m.mate2, mate3=m.mate3,
            mate2_col=mate2_col, mate3_col=mate3_col, mate2_idx=mate2_idx,
            mate3_idx=mate3_idx, gmask2=(arity >= 3).float(),
            gmask3=(arity == 4).float(), costs=m.costs, slots=m.slots)
        gmask1 = (arity >= 2).float()
        slot_of = dict(m.slot_of)
    else:
        gmask1 = torch.ones(pg.N, dtype=torch.float32, device=dev)
        slot_of = {2: pg.slot_of_edge}
    return ShardLayout(
        index=index, D=D, Vp=V, N=pg.N, buckets=pg.buckets,
        tcol=tcol.int(), t_deg=pg.col_deg, t_slot0=pg.col_slot0,
        t_stride=pg.col_stride, cost_rows=pg.cost_rows, vmask=pg.vmask,
        inv_dcount=pg.inv_dcount, mate=pg.mate, slot_col=slot_col,
        mate_col=mate_col, mate_idx=mate_idx, gmask1=gmask1,
        slot_of=slot_of, **extra,
    )


def build_shard_packs(
    tensors: FactorGraphTensors,
    devices: Sequence[torch.device],
    assigns: Optional[List[np.ndarray]] = None,
) -> ShardPacks:
    """Pack every shard's factor subset over the common column map; shard
    s lives on ``devices[s]`` (``len(devices)`` shards).  ``assigns`` (one
    factor → shard array per bucket of ``tensors``) overrides
    :func:`partition_factors`.

    Raises :class:`NotPortedError` out of the packers' scope: a factor of
    arity outside 1-4, D > 8, or D > 5 with a factor of arity 3 or 4 (the
    kernels unroll D up to 8, the ternary and quaternary tables grow as
    D^3 and D^4; the generic sharded engine that the JAX package falls
    back to is not ported)."""
    n_shards = len(devices)
    if n_shards < 1:
        raise ValueError("build_shard_packs needs at least one device")
    V, D = tensors.n_vars, tensors.max_domain_size
    arities = {b.arity for b in tensors.buckets if b.n_factors}
    if arities - set(ARITIES):
        raise NotPortedError(
            f"the sharded engines take factors of arity 1-4 (got arity "
            f"{max(arities)}); the generic sharded engine is not ported to "
            f"the PyTorch package yet")
    if D > MAX_D or (D > MAX_D_NARY and max(arities, default=0) >= 3):
        limit = MAX_D if D > MAX_D else MAX_D_NARY
        raise NotPortedError(
            f"the sharded engines pack D <= {limit} here (got D = {D}); "
            f"the generic sharded engine is not ported to the PyTorch "
            f"package yet")
    mixed = bool(arities - {2})
    vis = [np.asarray(b.var_idx) for b in tensors.buckets]
    if not vis:
        vis = [np.zeros((0, 2), dtype=np.int64)]
    if assigns is None:
        assigns = partition_factors(vis, V, n_shards)
    if len(assigns) != len(vis) or any(
            np.asarray(a).shape != (vi.shape[0],)
            for a, vi in zip(assigns, vis)):
        raise ValueError(
            f"assigns must hold one factor→shard array per bucket, of "
            f"lengths {[vi.shape[0] for vi in vis]}")
    assigns = [np.asarray(a).astype(np.int64) for a in assigns]
    for a in assigns:
        if a.size and (a.min() < 0 or a.max() >= n_shards):
            raise ValueError(
                f"assigns name a shard outside [0, {n_shards})")

    shards = [_shard_layout(tensors, s,
                            [np.flatnonzero(a == s) for a in assigns],
                            torch.device(dev), mixed)
              for s, dev in enumerate(devices)]

    mask = tensors.domain_mask.detach().cpu().numpy()
    unary = tensors.unary_costs.detach().cpu().numpy()
    mask_p = np.ascontiguousarray(mask.T)
    return ShardPacks(
        D=D, Vp=V, n_shards=n_shards, shards=shards,
        unary_p=np.ascontiguousarray(unary.T) * mask_p, mask_p=mask_p,
        assigns=assigns, mixed=mixed,
        boundary=analyze_boundary(vis, assigns, V, n_shards),
    )
