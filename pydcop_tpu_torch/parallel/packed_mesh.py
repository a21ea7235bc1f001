"""Per-shard packed layouts for the sharded engines (all-binary graphs).

The counterpart of the JAX package's ``parallel/packed_mesh.py``
(``build_shard_packs``, binary branch, with ``_stacked_move_extras`` and
``ops/pallas_local_search.py::move_extras``).

Every shard gets a packed layout of its own factor subset over ONE
common column map, so the shards' partial beliefs and partial tables
line up column by column and the cross-shard combine is a plain sum.
The common column of a variable is its index (``Vp = V``).  Within a
shard the slots follow the var-grouped layout of
:func:`~pydcop_tpu_torch.ops.packed_maxsum.pack_binary_for_gpu`, built
from the shard's own degrees: the shard's threads walk the
columns sorted by the shard's degree (``tcol[t]`` = the column of thread
t), and thread t's k-th slot is ``t_slot0[t] + k * t_stride[t]``, so the
threads of a degree class read neighbouring slots.  A column the shard
does not touch has degree 0 there; its partial is 0.  Unary costs are
zero on every shard and added once, after the combine.

The JAX packer's TPU machinery — one forced layout of 128-lane padded
degree classes shared by every shard, the Clos plans, the per-shard
degree limit of 96 — does not carry over: any all-binary graph with
D ≤ 8 packs.  Mixed-arity graphs are not ported to the sharded engines
(:func:`build_shard_packs` raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import FactorBucket, FactorGraphTensors
from pydcop_tpu_torch.ops.packed_maxsum import MAX_D, pack_binary_for_gpu
from pydcop_tpu_torch.parallel.boundary import BoundaryInfo, \
    analyze_boundary
from pydcop_tpu_torch.parallel.partition import partition_factors


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
    #: [D*D, N], row j*D+i = cost(other endpoint at j, this end at i)
    cost_rows: torch.Tensor
    vmask: torch.Tensor       # [D, N] 1 = valid value of the slot's var
    inv_dcount: torch.Tensor  # [N] 1 / |valid values| of the slot's var
    mate: torch.Tensor      # [N] int32 slot of the factor's other end
    slot_col: torch.Tensor  # [N] int32 column (variable) of each slot
    mate_col: torch.Tensor  # [N] int32 column of the other end
    #: [N] float32 variable index of the other end: MGM's static
    #: tie-break index, float-encoded as the JAX package's move rule
    mate_idx: torch.Tensor
    gmask1: torch.Tensor    # [N] float32 1 where the slot routes a gain
    #: slot of each local edge endpoint e = p*F_s + k, host-side, where
    #: local factor k is the shard's k-th factor in bucket order
    slot_of_edge: np.ndarray

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
    assign: np.ndarray   # [F] factor → shard
    boundary: BoundaryInfo
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
        gmask1=torch.zeros(0, **f32),
        slot_of_edge=np.zeros(0, dtype=np.int64),
    )


def _shard_layout(t: FactorGraphTensors, index: int, idx: np.ndarray,
                  dev: torch.device) -> ShardLayout:
    """Shard ``index``'s layout of the factors ``idx`` (bucket order), on
    ``dev``: the single-device binary packer run on the sub-graph, its
    degree-sorted columns read as the shard's thread order."""
    b = t.buckets[0]
    V, D = t.n_vars, t.max_domain_size
    if idx.size == 0:
        return _empty_shard(index, D, V, dev)
    vi = np.asarray(b.var_idx)[idx]
    sub = dataclasses.replace(
        t,
        buckets=[FactorBucket(
            arity=2, tensors=b.tensors[torch.as_tensor(idx)],
            var_idx=vi, factor_ids=np.asarray(b.factor_ids)[idx],
            edge_offset=0)],
        domain_mask=t.domain_mask.to(dev),
        unary_costs=t.unary_costs.to(dev),
        edge_var=torch.as_tensor(np.concatenate([vi[:, 0], vi[:, 1]]),
                                 device=dev),
    )
    pg = pack_binary_for_gpu(sub)
    tcol = torch.empty_like(pg.var_order)
    tcol[pg.var_order] = torch.arange(V, device=dev)
    slot_col = tcol[pg.slot_col]
    mate_col = slot_col[pg.mate.long()]
    return ShardLayout(
        index=index, D=D, Vp=V, N=pg.N, buckets=pg.buckets,
        tcol=tcol.int(), t_deg=pg.col_deg, t_slot0=pg.col_slot0,
        t_stride=pg.col_stride, cost_rows=pg.cost_rows, vmask=pg.vmask,
        inv_dcount=pg.inv_dcount, mate=pg.mate, slot_col=slot_col.int(),
        mate_col=mate_col.int(), mate_idx=mate_col.float(),
        gmask1=torch.ones(pg.N, dtype=torch.float32, device=dev),
        slot_of_edge=pg.slot_of_edge,
    )


def build_shard_packs(
    tensors: FactorGraphTensors,
    devices: Sequence[torch.device],
    assigns: Optional[List[np.ndarray]] = None,
) -> ShardPacks:
    """Pack every shard's factor subset over the common column map; shard
    s lives on ``devices[s]`` (``len(devices)`` shards).  ``assigns`` (a
    one-bucket list, factor → shard) overrides :func:`partition_factors`.

    Raises :class:`NotPortedError` on a graph with a factor of another
    arity than 2 (the mixed branches of the per-shard kernels are not
    ported) and on D > 8 (the kernels unroll D up to 8; the generic
    sharded engine that the JAX package falls back to is not ported)."""
    n_shards = len(devices)
    if n_shards < 1:
        raise ValueError("build_shard_packs needs at least one device")
    if any(b.arity != 2 for b in tensors.buckets) \
            or len(tensors.buckets) > 1:
        raise NotPortedError(
            "the sharded engines take all-binary factor graphs only: the "
            "mixed-arity branches of the per-shard kernels are not ported "
            "to the PyTorch package yet")
    V, D = tensors.n_vars, tensors.max_domain_size
    if D > MAX_D:
        raise NotPortedError(
            f"the sharded engines pack D <= {MAX_D} (got D = {D}); the "
            f"generic sharded engine is not ported to the PyTorch package "
            f"yet")
    if tensors.buckets:
        vi = np.asarray(tensors.buckets[0].var_idx)
    else:
        vi = np.zeros((0, 2), dtype=np.int64)
    F = vi.shape[0]
    if assigns is None:
        assigns = partition_factors([vi], V, n_shards)
    if len(assigns) != 1 or np.asarray(assigns[0]).shape != (F,):
        raise ValueError(
            f"assigns must hold one factor→shard array of length {F}")
    assign = np.asarray(assigns[0]).astype(np.int64)
    if F and (assign.min() < 0 or assign.max() >= n_shards):
        raise ValueError(f"assigns name a shard outside [0, {n_shards})")

    shards = [_shard_layout(tensors, s, np.flatnonzero(assign == s),
                            torch.device(dev))
              for s, dev in enumerate(devices)]

    mask = tensors.domain_mask.detach().cpu().numpy()
    unary = tensors.unary_costs.detach().cpu().numpy()
    mask_p = np.ascontiguousarray(mask.T)
    return ShardPacks(
        D=D, Vp=V, n_shards=n_shards, shards=shards,
        unary_p=np.ascontiguousarray(unary.T) * mask_p, mask_p=mask_p,
        assign=assign,
        boundary=analyze_boundary([vi], [assign], V, n_shards),
    )
