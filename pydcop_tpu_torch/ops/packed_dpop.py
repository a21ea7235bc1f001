"""Whole-sweep DPOP engine for width-1 pseudo-trees (GPU layout).

The counterpart of the JAX package's ``ops/pallas_dpop.py``
(``pack_sweep`` + ``whole_sweep_values``).  A width-1 plan — every node's
one separator is its parent: true trees and forests, both BASELINE DPOP
metrics — needs no digit alignment at all: a child's message is a [D]
vector over its parent's values, and a parent's child sum is a plain sum
of those vectors.  :func:`pack_sweep` lays a plan out for that:

* nodes in gid order, which is level order (``dpop_sweep._global_ids``),
  so each level is a contiguous gid range (``level_start``);
* the children of each node as CSR (``child_ptr``, ``child_idx``) in
  ascending gid — the slot order of the Pallas kernel and the row order
  of the level scan's ``segment_sum``;
* one ``[n_nodes, D, D]`` float32 table, own value major
  (``table[n, i, j]`` = local cost of own value i under parent value j);
* ``parent`` (-1 at roots).

The Pallas kernel's lane packing, Clos permutation, second table copy,
whole-forest iterations and its size caps (levels, children, VMEM) are
TPU machinery and are gone: :func:`pack_sweep` refuses only what the math
needs (W != 1, or a separator that is not the parent).

:func:`whole_sweep` launches the hand-written CUDA kernel
(``csrc/dpop_sweep.cu``: ONE cooperative launch a sweep that walks the L
UTIL levels, then the L VALUE levels, a grid barrier between consecutive
levels) on CUDA tensors, and runs :func:`whole_sweep_plain`, the same
arithmetic in the same order in torch ops, only on CPU tensors.
:func:`whole_sweep_batched` runs nb instances of one tree (one table
each) the same way: one launch on CUDA for all nb, the plain version over
a leading axis on the CPU.  A build or launch failure on CUDA raises;
nothing falls back.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.dpop_sweep import DpopSweepPlan
from pydcop_tpu_torch.ops.segments import SegmentPlan

#: the kernel keeps a node's D values in one block (and D <= 1024 always
#: holds for a plan compile_sweep accepts at W = 1: D*D <= 2**20)
MAX_D = 1024
#: the sweep kernel's most blocks, chosen from a sweep on an H100
#: (PERF.md, K10): a sweep meets 2L - 1 grid barriers, and a barrier over
#: few blocks is short, but a block takes its share of a level's tiles one
#: after the other (the capacity also caps the grid)
SWEEP_GRID_CAP = 264


@dataclass(eq=False)
class PackedDpopSweep:
    """A width-1 sweep plan laid out for the whole-sweep kernel."""

    D: int          # Dmax
    n_nodes: int
    L: int          # tree levels
    mode: str       # "min" | "max"
    table: torch.Tensor      # [n_nodes, D, D] f32, own value major
    child_ptr: torch.Tensor  # [n_nodes + 1] i32 CSR row pointers
    child_idx: torch.Tensor  # [n_nodes - roots] i32 children, ascending
    parent: torch.Tensor     # [n_nodes] i32 parent gid, -1 at roots
    #: [L + 1] i32, host: level l holds gids [level_start[l],
    #: level_start[l + 1])
    level_start: np.ndarray
    #: the same on the device, for the kernel
    level_start_dev: torch.Tensor
    max_children: int
    #: [n_nodes] int64 on the device: node n's row in the plan's
    #: ``local.reshape(L * Bmax, S)`` (:func:`pack_tables`)
    local_rows: Optional[torch.Tensor] = None
    #: plain version's per-level child-sum plans, built at its first call
    _plans: Optional[list] = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.table.device


def pack_sweep(plan: DpopSweepPlan) -> Optional[PackedDpopSweep]:
    """The whole-sweep layout of a width-1 plan, on the plan's device,
    or None when the plan is out of the kernel's scope (W != 1, or a
    node whose separator is not its parent)."""
    if plan.W != 1:
        return None
    N, L, dev = plan.n_nodes, plan.L, plan.device
    sizes = plan.level_sizes
    node_ids = plan.node_ids.cpu().numpy()
    parent_slot = plan.parent_slot.cpu().numpy()
    sep_ids = plan.sep_ids.cpu().numpy()

    level_start = np.zeros(L + 1, dtype=np.int32)
    level_start[1:] = np.cumsum(sizes)
    parent = np.full(N, -1, dtype=np.int64)
    lv_of = np.empty(N, dtype=np.int64)
    slot_of = np.empty(N, dtype=np.int64)
    for li in range(L):
        B = sizes[li]
        gids = node_ids[li, :B].astype(np.int64)
        if not np.array_equal(
                gids, np.arange(level_start[li], level_start[li + 1])):
            raise ValueError("plan gids are not in level order")
        lv_of[gids] = li
        slot_of[gids] = np.arange(B)
        if li > 0:
            pgids = node_ids[li - 1, parent_slot[li, :B]].astype(np.int64)
            if not np.array_equal(sep_ids[li, :B, 0], pgids):
                return None  # the separator is not the parent
            parent[gids] = pgids

    child_ids = np.flatnonzero(parent >= 0)  # ascending gid
    counts = np.bincount(parent[child_ids], minlength=N)
    child_ptr = np.zeros(N + 1, dtype=np.int64)
    child_ptr[1:] = np.cumsum(counts)
    child_idx = child_ids[np.argsort(parent[child_ids], kind="stable")]

    # plan.local at W = 1: flat slot = own * D + parent
    local_rows = torch.as_tensor(lv_of * plan.Bmax + slot_of, device=dev)
    table = plan.local.reshape(L * plan.Bmax, -1)[local_rows]
    D = plan.Dmax

    def put(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev).contiguous()

    return PackedDpopSweep(
        D=D, n_nodes=N, L=L, mode=plan.mode,
        table=table.reshape(N, D, D).contiguous(),
        child_ptr=put(child_ptr), child_idx=put(child_idx),
        parent=put(parent), level_start=level_start,
        level_start_dev=put(level_start),
        max_children=int(counts.max(initial=0)),
        local_rows=local_rows,
    )


def pack_tables(ps: PackedDpopSweep, local_b: torch.Tensor) -> torch.Tensor:
    """``[nb, n_nodes, D, D]`` tables (own value major, gid order) of nb
    instances of ``ps``'s tree from their stacked plan tables ``local_b``
    ``[nb, L, Bmax, D * D]``, as :func:`pack_sweep` packs one."""
    nb = local_b.shape[0]
    rows = local_b.reshape(nb, -1, ps.D * ps.D)[:, ps.local_rows]
    return rows.reshape(nb, ps.n_nodes, ps.D, ps.D).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch version (the kernel's arithmetic, in its order)
# ---------------------------------------------------------------------------


def _level_plans(ps: PackedDpopSweep) -> List[Optional[SegmentPlan]]:
    """Per level, the ordered child sum's plan: the next level's nodes
    (ascending gid) added into their parents' rows within this level;
    None for the deepest level, which has no children."""
    if ps._plans is None:
        ls = ps.level_start
        parent = ps.parent.cpu()
        ps._plans = [
            SegmentPlan((parent[ls[li + 1]:ls[li + 2]] - int(ls[li]))
                        .to(ps.device), int(ls[li + 1] - ls[li]))
            for li in range(ps.L - 1)
        ] + [None]
    return ps._plans


def whole_sweep_plain(ps: PackedDpopSweep,
                      table: Optional[torch.Tensor] = None):
    """(assign [n_nodes] int32, msg [n_nodes, D], cs [n_nodes, D]) of one
    whole sweep: each node's child sum from 0 in ascending child gid,
    its message reduced over own values, then the values top-down (first
    index on ties).  With ``table`` (``[nb, n_nodes, D, D]``, nb
    instances of the tree): the nb sweeps at once, (assign [nb, n_nodes],
    msg [nb, n_nodes, D], cs [nb, n_nodes, D]), each instance's equal to
    its single sweep."""
    single = table is None
    if single:
        table = ps.table[None]
    D, N, dev = ps.D, ps.n_nodes, ps.device
    nb = table.shape[0]
    # node-major inside: a level's rows are one slice, the child sums'
    # plans add along the node axis
    tab = table.transpose(0, 1)  # [N, nb, own i, parent j]
    msg = torch.zeros((N, nb, D), dtype=torch.float32, device=dev)
    cs = torch.zeros((N, nb, D), dtype=torch.float32, device=dev)
    assign = torch.zeros((N, nb), dtype=torch.int32, device=dev)
    plans = _level_plans(ps)
    ls = ps.level_start
    for li in range(ps.L - 1, -1, -1):
        lo, hi = int(ls[li]), int(ls[li + 1])
        c = (plans[li].sum(msg[hi:int(ls[li + 2])]) if plans[li] is not None
             else torch.zeros((hi - lo, nb, D), dtype=torch.float32,
                              device=dev))
        cs[lo:hi] = c
        t = tab[lo:hi] + c[:, :, :, None]  # [B, nb, own i, parent j]
        msg[lo:hi] = (torch.amin(t, dim=2) if ps.mode == "min"
                      else torch.amax(t, dim=2))
    for li in range(ps.L):
        lo, hi = int(ls[li]), int(ls[li + 1])
        par = ps.parent[lo:hi].long()
        j = torch.where(par[:, None] >= 0,
                        assign[par.clamp(min=0)].long(), 0)  # [B, nb]
        col = torch.gather(tab[lo:hi], 3,
                           j[:, :, None, None].expand(-1, -1, D, 1))[..., 0]
        score = col + cs[lo:hi]
        best = (torch.argmin(score, dim=2) if ps.mode == "min"
                else torch.argmax(score, dim=2))
        assign[lo:hi] = best.to(torch.int32)
    if single:
        return assign[:, 0], msg[:, 0], cs[:, 0]
    return (assign.t().contiguous(), msg.transpose(0, 1).contiguous(),
            cs.transpose(0, 1).contiguous())


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_fn = []


def _kernel():
    """The C entry of ``csrc/dpop_sweep.cu``, bound once."""
    if not _fn:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I = ctypes.c_void_p, ctypes.c_int
        fn = load("dpop_sweep").dpop_whole_sweep
        fn.restype = ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 3 + [P] * 3 + [I, P, P]
        _fn.append(fn)
    return _fn[0]


def _capacity(D: int, mode: str) -> Tuple[int, int]:
    """(resident blocks, threads a block) of the sweep kernel at domain
    size ``D`` on the current CUDA device (0 blocks when the device cannot
    be asked); a block's threads are a UTIL tile's (node, value) pairs."""
    from pydcop_tpu_torch.ops.cuda_build import load

    fn = load("dpop_sweep").dpop_sweep_capacity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    threads = ctypes.c_int(0)
    blocks = fn(D, int(mode == "max"), ctypes.byref(threads))
    return int(blocks), int(threads.value)


def sweep_blocks(ps: PackedDpopSweep, capacity: int, threads: int,
                 nb: int = 1) -> int:
    """Blocks of one sweep launch over ``nb`` instances: the UTIL tiles
    (``threads // D`` nodes each) of the widest level times ``nb``, at
    most ``capacity`` and :data:`SWEEP_GRID_CAP`, at least 1 (every level
    is a grid-stride loop)."""
    widest = int(np.diff(ps.level_start).max())
    tiles = -(-widest // max(1, threads // ps.D)) * nb
    return max(1, min(capacity, tiles, SWEEP_GRID_CAP))


def _on_cuda(ps: PackedDpopSweep) -> bool:
    """True when the packed sweep lies on CUDA (launch the kernel), False
    on the CPU (run the plain version)."""
    for name in ("table", "child_ptr", "child_idx", "parent",
                 "level_start_dev"):
        t = getattr(ps, name)
        if t.device != ps.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{ps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ps.device.type == "cpu":
        return False
    if ps.device.type != "cuda":
        raise ValueError(f"the whole-sweep kernel runs on cuda or cpu, "
                         f"not {ps.device}")
    if not 1 <= ps.D <= MAX_D:
        raise ValueError(f"the whole-sweep kernel takes D in [1, {MAX_D}]")
    if tuple(ps.table.shape) != (ps.n_nodes, ps.D, ps.D) \
            or ps.table.dtype != torch.float32:
        raise ValueError("table must be float32 [n_nodes, D, D]")
    if ps.level_start.dtype != np.int32 \
            or ps.level_start.shape != (ps.L + 1,) \
            or not ps.level_start.flags.c_contiguous:
        raise ValueError("level_start must be a contiguous int32 [L + 1] "
                         "host array")
    if ps.level_start_dev.dtype != torch.int32 \
            or tuple(ps.level_start_dev.shape) != (ps.L + 1,):
        raise ValueError("level_start_dev must be int32 [L + 1]")
    return True


def whole_sweep(ps: PackedDpopSweep, blocks: Optional[int] = None):
    """(assign [n_nodes] int32, msg [n_nodes, D], cs [n_nodes, D]) of one
    whole sweep.  On CUDA: one cooperative launch of the kernel that walks
    every UTIL and VALUE level (``whole_sweep.launches`` adds one a
    sweep), at ``blocks`` blocks when given (1 up to the kernel's
    capacity), else at those of :func:`sweep_blocks`; its barrier word is
    allocated zeroed by this call and shared with no other.  On the CPU:
    the plain version, and ``blocks`` has no use."""
    if not _on_cuda(ps):
        return whole_sweep_plain(ps)
    return _launch_sweep(ps, blocks)


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _grid(ps: PackedDpopSweep, blocks: Optional[int], nb: int = 1) -> int:
    """The blocks of a launch over ``nb`` instances: ``blocks`` checked
    against the kernel's capacity, or :func:`sweep_blocks`'s."""
    capacity, threads = _capacity(ps.D, ps.mode)
    if capacity <= 0:
        raise RuntimeError("dpop_whole_sweep: the device reports no "
                           "resident block for the cooperative launch")
    if blocks is None:
        return sweep_blocks(ps, capacity, threads, nb)
    if not 1 <= blocks <= capacity:
        raise ValueError(f"dpop_whole_sweep: {blocks} blocks, the capacity "
                         f"is {capacity}")
    return blocks


def _launch_sweep(ps: PackedDpopSweep, blocks: Optional[int]):
    """:func:`whole_sweep` on a checked CUDA sweep: the kernel's one
    launch, or RuntimeError."""
    blocks = _grid(ps, blocks)
    f = dict(dtype=torch.float32, device=ps.device)
    msg = torch.empty((ps.n_nodes, ps.D), **f)
    cs = torch.empty((ps.n_nodes, ps.D), **f)
    assign = torch.empty(ps.n_nodes, dtype=torch.int32, device=ps.device)
    bar = torch.zeros(1, dtype=torch.int32, device=ps.device)
    err = _kernel()(
        ps.table.data_ptr(), ps.child_ptr.data_ptr(),
        ps.child_idx.data_ptr(), ps.parent.data_ptr(),
        ps.level_start_dev.data_ptr(), ps.level_start.ctypes.data, ps.L,
        ps.D, int(ps.mode == "max"), msg.data_ptr(), cs.data_ptr(),
        assign.data_ptr(), blocks, bar.data_ptr(), _stream(ps.device))
    if err != 0:
        raise RuntimeError(f"dpop_whole_sweep launch failed: CUDA error "
                           f"{err}")
    whole_sweep.launches += 1
    return assign, msg, cs


whole_sweep.launches = 0


def _batched_kernel():
    """The C entry ``dpop_whole_sweep_batched``, bound once."""
    if not _batched_fn:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I = ctypes.c_void_p, ctypes.c_int
        fn = load("dpop_sweep").dpop_whole_sweep_batched
        fn.restype = ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 4 + [P] * 3 + [I, P, P]
        _batched_fn.append(fn)
    return _batched_fn[0]


_batched_fn = []


def whole_sweep_batched(ps: PackedDpopSweep, table: torch.Tensor,
                        blocks: Optional[int] = None):
    """The whole sweeps of ``nb`` instances of ``ps``'s tree, one table
    each (``table`` ``[nb, n_nodes, D, D]`` float32, own value major, on
    the sweep's device): (assign [nb, n_nodes] int32, msg [nb, n_nodes,
    D], cs [nb, n_nodes, D]), instance by instance what
    :func:`whole_sweep` gives for that table.  On CUDA: ONE cooperative
    launch for all nb (``whole_sweep.launches`` adds one), each level
    over every instance before its barrier, at ``blocks`` blocks when
    given, else at :func:`sweep_blocks`'s for nb; a failed launch raises.
    On the CPU: :func:`whole_sweep_plain` over the leading axis."""
    if table.dim() != 4 or tuple(table.shape[1:]) != (ps.n_nodes, ps.D,
                                                      ps.D) \
            or table.dtype != torch.float32 or table.shape[0] < 1:
        raise ValueError("table must be float32 [nb, n_nodes, D, D], "
                         "nb >= 1")
    if table.device != ps.device or not table.is_contiguous():
        raise ValueError(f"table must be contiguous on {ps.device}")
    if not _on_cuda(ps):
        return whole_sweep_plain(ps, table)
    nb = int(table.shape[0])
    blocks = _grid(ps, blocks, nb)
    f = dict(dtype=torch.float32, device=ps.device)
    msg = torch.empty((nb, ps.n_nodes, ps.D), **f)
    cs = torch.empty((nb, ps.n_nodes, ps.D), **f)
    assign = torch.empty((nb, ps.n_nodes), dtype=torch.int32,
                         device=ps.device)
    bar = torch.zeros(1, dtype=torch.int32, device=ps.device)
    err = _batched_kernel()(
        table.data_ptr(), ps.child_ptr.data_ptr(),
        ps.child_idx.data_ptr(), ps.parent.data_ptr(),
        ps.level_start_dev.data_ptr(), ps.level_start.ctypes.data, ps.L,
        ps.D, nb, int(ps.mode == "max"), msg.data_ptr(), cs.data_ptr(),
        assign.data_ptr(), blocks, bar.data_ptr(), _stream(ps.device))
    if err != 0:
        raise RuntimeError(f"dpop_whole_sweep_batched launch failed: CUDA "
                           f"error {err}")
    whole_sweep.launches += 1
    return assign, msg, cs


def reset_launches() -> None:
    whole_sweep.launches = 0


def whole_sweep_values(ps: PackedDpopSweep) -> torch.Tensor:
    """Run UTIL+VALUE as one whole sweep.  Returns assign [n_nodes] int32
    in gid order (the same contract as ``dpop_sweep.run_sweep``), on the
    packed sweep's device."""
    return whole_sweep(ps)[0]
