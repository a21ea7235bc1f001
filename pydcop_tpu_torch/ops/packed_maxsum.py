"""Packed MaxSum engine for all-binary factor graphs (GPU layout).

The counterpart of the JAX package's ``ops/pallas_maxsum.py``
(``pack_for_pallas`` + ``packed_cycles``), re-laid for a GPU:

* messages are ``[D, N]``: one column per edge slot, N = 2F exactly;
* **var-grouped slots**: the columns (variables) are sorted by degree,
  the columns of one degree form a class block, and column c's k-th
  incoming edge sits in slot ``col_slot0[c] + k * col_stride[c]``
  (``soff + k·nvp + (c − voff)``, the Pallas layout without its padding
  to degree classes);
* the factor exchange is a plain gather through ``mate`` (the slot of
  the factor's other endpoint) — the Clos routing plan, the 128-lane
  padding of ``Vp`` and ``N``, hub splitting and the TPU packer's size
  limits are TPU machinery and are gone;
* ``cost_rows`` is other-value-major (row ``j*D+i`` = cost(other=j,
  target=i)), ``vmask`` is applied before damping, the belief sum runs in
  slot order and the mean is taken over the valid values via
  ``inv_dcount`` — the Pallas kernel's contract.

:func:`packed_cycles` launches the hand-written CUDA kernel
(``csrc/packed_maxsum.cu``, one launch per cycle) on CUDA tensors and runs
:func:`packed_cycles_plain`, the same arithmetic in torch ops, only on CPU
tensors.  A build or launch failure on CUDA raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.ops.segments import ordered_sum

#: the packed kernel unrolls its per-value loops for D in [1, MAX_D]
MAX_D = 8


@dataclass
class PackedMaxSumGraph:
    """Packed layout of an all-binary factor graph, on one device."""

    D: int
    Vp: int  # variable columns (one per variable)
    N: int  # edge slots (= 2F)
    #: degree classes (deg, nvp, voff, soff): nvp columns from voff, of
    #: degree deg, own slots [soff, soff + deg*nvp)
    buckets: Tuple[Tuple[int, int, int, int], ...]
    cost_rows: torch.Tensor  # [D*D, N] row j*D+i = cost(d_oth=j, d_tgt=i)
    unary_p: torch.Tensor  # [D, Vp] unary * mask
    mask_p: torch.Tensor  # [D, Vp] 1 = valid value
    vmask: torch.Tensor  # [D, N] mask_p spread to slots
    inv_dcount: torch.Tensor  # [N] 1 / |valid values| of the slot's var
    mate: torch.Tensor  # [N] int32 slot of the factor's other endpoint
    slot_col: torch.Tensor  # [N] int64 column that owns each slot
    col_deg: torch.Tensor  # [Vp] int32 degree of each column
    col_slot0: torch.Tensor  # [Vp] int32 slot of each column's rank 0
    col_stride: torch.Tensor  # [Vp] int32 slot step between ranks
    var_order: torch.Tensor  # [Vp] int64 column of each original var
    #: slot of each edge endpoint (edge e = p*F + f); host-side numpy
    slot_of_edge: np.ndarray = None

    @property
    def device(self) -> torch.device:
        return self.cost_rows.device


def pack_for_gpu(t: FactorGraphTensors) -> Optional[PackedMaxSumGraph]:
    """The packed layout of ``t`` on ``t``'s device, or None when the
    graph does not pack: arity other than 2, D > 8, or no factors.  There
    is no blanket fallback: any other failure raises."""
    if len(t.buckets) != 1 or t.buckets[0].arity != 2:
        return None
    b = t.buckets[0]
    F, V, D = b.n_factors, t.n_vars, t.max_domain_size
    if F == 0 or D > MAX_D:
        return None

    vi = np.asarray(b.var_idx, dtype=np.int64)  # [F, 2]
    edge_var = np.concatenate([vi[:, 0], vi[:, 1]])  # edge id e = p*F + f
    deg = np.bincount(edge_var, minlength=V)

    # columns = variables sorted by degree (stable: ties keep var order)
    col_var = np.argsort(deg, kind="stable")
    var_pcol = np.empty(V, dtype=np.int64)
    var_pcol[col_var] = np.arange(V)
    col_deg = deg[col_var]
    degs, voffs, nvps = np.unique(col_deg, return_index=True,
                                  return_counts=True)
    soffs = np.concatenate([[0], np.cumsum(degs * nvps)[:-1]])
    buckets = tuple(
        (int(d), int(nv), int(vo), int(so))
        for d, nv, vo, so in zip(degs, nvps, voffs, soffs) if d > 0
    )
    col_slot0 = np.zeros(V, dtype=np.int64)
    col_stride = np.ones(V, dtype=np.int64)
    for d, nv, vo, so in zip(degs, nvps, voffs, soffs):
        col_slot0[vo: vo + nv] = so + np.arange(nv)
        col_stride[vo: vo + nv] = nv

    # slot of each edge: its rank k among its variable's edges (stable by
    # edge id), at col_slot0 + k * stride
    order = np.argsort(edge_var, kind="stable")
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    k_of = np.empty(2 * F, dtype=np.int64)
    k_of[order] = np.arange(2 * F) - start[edge_var[order]]
    cole = var_pcol[edge_var]
    slot_of_edge = col_slot0[cole] + k_of * col_stride[cole]
    N = 2 * F
    slot_col = np.empty(N, dtype=np.int64)
    slot_col[slot_of_edge] = cole
    mate = np.empty(N, dtype=np.int64)
    mate_edge = np.concatenate([np.arange(F, 2 * F), np.arange(F)])
    mate[slot_of_edge] = slot_of_edge[mate_edge]

    # cost rows, other-value-major: the p=0 endpoint sees table[f, tgt,
    # oth], the p=1 endpoint table[f, oth, tgt]
    tens = b.tensors.detach().cpu().numpy()  # [F, D, D]
    cost_rows = np.empty((D * D, N), dtype=np.float32)
    cost_rows[:, slot_of_edge[:F]] = tens.transpose(0, 2, 1).reshape(F, -1).T
    cost_rows[:, slot_of_edge[F:]] = tens.reshape(F, -1).T

    mask = t.domain_mask.detach().cpu().numpy()
    unary = t.unary_costs.detach().cpu().numpy()
    mask_p = np.ascontiguousarray(mask[col_var].T)
    unary_p = np.ascontiguousarray(unary[col_var].T) * mask_p
    vmask = np.ascontiguousarray(mask_p[:, slot_col])
    dcount = vmask.sum(axis=0)
    inv_dcount = np.where(dcount > 0, 1.0 / np.maximum(dcount, 1.0), 0.0)

    dev = t.device

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return PackedMaxSumGraph(
        D=D, Vp=V, N=N, buckets=buckets,
        cost_rows=put(cost_rows, torch.float32),
        unary_p=put(unary_p, torch.float32),
        mask_p=put(mask_p, torch.float32),
        vmask=put(vmask, torch.float32),
        inv_dcount=put(inv_dcount, torch.float32),
        mate=put(mate, torch.int32),
        slot_col=put(slot_col, torch.int64),
        col_deg=put(col_deg, torch.int32),
        col_slot0=put(col_slot0, torch.int32),
        col_stride=put(col_stride, torch.int32),
        var_order=put(var_pcol, torch.int64),
        slot_of_edge=slot_of_edge,
    )


def packed_init_state(pg: PackedMaxSumGraph
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((pg.D, pg.N), dtype=torch.float32, device=pg.device)
    return z, z.clone()


def packed_values(pg: PackedMaxSumGraph,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Masked argmin per column, mapped to original variable order."""
    big = torch.where(pg.mask_p > 0, beliefs, PAD_COST)
    return torch.argmin(big, dim=0)[pg.var_order]


def _plain_cycle(pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
                 damping: float):
    D = pg.D
    qm = q[:, pg.mate.long()]  # the factor exchange: gather through mate
    cost = pg.cost_rows
    r_new = cost[0:D] + qm[0:1]
    for j in range(1, D):
        r_new = torch.minimum(r_new, cost[j * D:(j + 1) * D] + qm[j:j + 1])
    r_new = r_new * pg.vmask
    if damping:
        r_new = damping * r + (1.0 - damping) * r_new
    # belief sum per degree class, rank by rank (the kernel's slot order)
    acc = torch.zeros((D, pg.Vp), dtype=r_new.dtype, device=r_new.device)
    for deg, nvp, voff, soff in pg.buckets:
        block = r_new[:, soff: soff + deg * nvp].reshape(D, deg, nvp)
        part = block[:, 0]
        for k in range(1, deg):
            part = part + block[:, k]
        acc[:, voff: voff + nvp] = part
    beliefs = pg.unary_p + acc
    q_new = beliefs[:, pg.slot_col] - r_new
    mean = ordered_sum(q_new * pg.vmask, axis=0) * pg.inv_dcount
    q_new = (q_new - mean) * pg.vmask
    return q_new, r_new, beliefs


def packed_cycles_plain(
    pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
    n_cycles: int, damping: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: ``n_cycles`` cycles on the
    same packed layout, on any device.  Returns (q', r', beliefs, values)
    after the last cycle."""
    beliefs = None
    for _ in range(n_cycles):
        q, r, beliefs = _plain_cycle(pg, q, r, damping)
    return q, r, beliefs, packed_values(pg, beliefs)


def _check(pg: PackedMaxSumGraph, name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != (pg.D, pg.N):
        raise ValueError(
            f"{name} has shape {tuple(x.shape)}, expected {(pg.D, pg.N)}")
    if x.device != pg.device:
        raise ValueError(
            f"{name} is on {x.device} but the packed graph is on "
            f"{pg.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_kernel_fn = None


def _kernel():
    """The C entry of ``csrc/packed_maxsum.cu``, built and bound once."""
    global _kernel_fn
    if _kernel_fn is None:
        from pydcop_tpu_torch.ops.cuda_build import load

        fn = load("packed_maxsum").packed_maxsum_cycle
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13
                       + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        _kernel_fn = fn
    return _kernel_fn


def packed_cycles(
    pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
    n_cycles: int, damping: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_cycles`` MaxSum cycles on the packed layout; returns (q', r',
    beliefs [D, Vp], values [Vp] in variable order) after the last cycle.

    On CUDA tensors this launches the hand-written kernel once per cycle
    on the current stream (``packed_cycles.launches`` counts them); on
    CPU tensors it runs :func:`packed_cycles_plain`.  The inputs are not
    modified: q is double-buffered in fresh tensors, and r goes to a
    fresh tensor at the first launch that the later launches update in
    place (only its owner thread reads an element of r)."""
    if n_cycles < 1:
        raise ValueError(f"n_cycles must be >= 1, got {n_cycles}")
    _check(pg, "q", q)
    _check(pg, "r", r)
    if q.device.type == "cpu":
        return packed_cycles_plain(pg, q, r, n_cycles, damping)
    if q.device.type != "cuda":
        raise ValueError(f"packed_cycles runs on cuda or cpu, not {q.device}")
    if not 1 <= pg.D <= MAX_D:
        raise ValueError(f"the packed kernel takes D in [1, {MAX_D}]")
    fn = _kernel()
    bufs = [torch.empty_like(q), torch.empty_like(q)]
    r_out = torch.empty_like(r)
    beliefs = torch.empty((pg.D, pg.Vp), dtype=torch.float32,
                          device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    use_damping = 1 if damping else 0
    q_in, r_in = q, r
    for i in range(n_cycles):
        q_out = bufs[i % 2]
        err = fn(
            q_in.data_ptr(), q_out.data_ptr(), r_in.data_ptr(),
            r_out.data_ptr(), beliefs.data_ptr(), pg.cost_rows.data_ptr(),
            pg.unary_p.data_ptr(), pg.vmask.data_ptr(),
            pg.inv_dcount.data_ptr(), pg.mate.data_ptr(),
            pg.col_deg.data_ptr(), pg.col_slot0.data_ptr(),
            pg.col_stride.data_ptr(), pg.D, pg.N, pg.Vp,
            float(damping), float(1.0 - damping), use_damping, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"packed_maxsum_cycle launch failed: CUDA error {err}")
        packed_cycles.launches += 1
        q_in, r_in = q_out, r_out
    return q_in, r_out, beliefs, packed_values(pg, beliefs)


packed_cycles.launches = 0
