"""Packed MaxSum engine on the GPU layout: all-binary and mixed-arity
(1-4) factor graphs.

The counterpart of the JAX package's ``ops/pallas_maxsum.py``
(``pack_for_pallas``, ``pack_mixed_for_pallas`` + ``packed_cycles``),
re-laid for a GPU:

* messages are ``[D, N]``: one column per edge slot, N = the number of
  factor endpoints exactly;
* **var-grouped slots**: the columns (variables) are sorted by degree
  (mixed graphs: by their exact per-arity degree tuple (c1, c2, c3,
  c4)), the columns of one class form a block, and column c's k-th
  incoming edge sits in slot ``col_slot0[c] + k * col_stride[c]``
  (``soff + k·nvp + (c − voff)``, the Pallas layout without its padding
  to degree classes).  A mixed column's slots run unary, binary,
  ternary, quaternary; within an arity they are ranked by edge id
  ``e = p*F + f``, as the Pallas packer ranks them;
* the factor exchange is a plain gather through ``mate`` (the slot of
  the factor's first sibling; mixed graphs add ``mate2``/``mate3`` for
  the second and third, taken cyclically from the slot's position, as
  the Pallas kernel's routing plans do) — the Clos routing plans, the
  128-lane padding of ``Vp`` and ``N``, quantised class tuples, hub
  splitting and the TPU packer's size limits are TPU machinery and are
  gone;
* cost rows are other-values-major (binary row ``j*D+i`` =
  cost(other=j, target=i); ternary row ``(j*D+k)*D+i``, quaternary
  ``((j*D+k)*D+m)*D+i``); a mixed graph keeps one cost array per arity,
  ``[D^a, N_a]`` over that arity's slots only, and a per-slot index into
  it; ``vmask`` is applied before damping, the belief sum runs in slot
  order and the mean is taken over the valid values via ``inv_dcount`` —
  the Pallas kernel's contract.

:func:`packed_cycles` launches the hand-written CUDA kernel
(``csrc/packed_maxsum.cu``) on CUDA tensors: on the binary layout ONE
cooperative launch a call that runs all its cycles, each degree class cut
into tiles of neighbouring columns (:func:`tile_table`), a block's tile
r' of every (rank, column) unit, then the columns' beliefs, then q' of the
units, and a grid barrier between cycles; on the mixed layout one
cooperative launch a cycle of two phases, the slots' r' spread over the
grid — a ternary or quaternary slot one thread a value — then a grid
barrier and one thread a column.  It runs :func:`packed_cycles_plain`, the
same arithmetic in torch ops, only on CPU tensors.  A build or launch
failure on CUDA raises; nothing falls back.

Engine choice (:func:`solver_layout`, the solvers' ``use_packed``): an
all-binary graph packs on every device; a mixed-arity graph packs by
default on CUDA only, as the JAX package packs only on its accelerator —
on the CPU both packages run their generic engine for mixed graphs, whose
float32 sums run in another order (a stated deviation of neither package
from the other: they agree engine for engine).  ``use_packed=True`` packs
a mixed graph on the CPU too, through the plain versions.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.ops.segments import ordered_sum

#: the packed kernel unrolls its per-value loops for D in [1, MAX_D]
MAX_D = 8
#: the largest D a graph with a ternary or quaternary factor packs at
#: (its cost arrays grow as D^3 / D^4 — the JAX mixed packer's limit)
MAX_D_NARY = 5
#: factor arities the mixed layout takes
ARITIES = (1, 2, 3, 4)
#: the binary kernel's launch shape, chosen from a sweep on an H100 (PERF.md,
#: K1): threads a block, columns a tile at most (no more than the threads),
#: and blocks at most (fewer blocks meet at a grid barrier sooner; the
#: capacity also caps the grid)
BINARY_THREADS = 256
TILE_COLS = 64
BINARY_GRID_CAP = 264


@dataclass
class MixedSlots:
    """The per-slot arrays of the mixed-arity layout, on the graph's
    device (the host maps excepted)."""

    arity: torch.Tensor  # [N] int32 arity of each slot's factor
    #: [N] int32 column of each slot in its arity's cost array
    cost_idx: torch.Tensor
    mate2: torch.Tensor  # [N] int32 second sibling slot, -1 below arity 3
    mate3: torch.Tensor  # [N] int32 third sibling slot, -1 below arity 4
    #: cost1 [D, N1], cost2 [D², N2], cost3 [D³, N3], cost4 [D⁴, N4],
    #: other-values-major, each over its arity's slots only
    costs: Tuple[torch.Tensor, ...]
    #: int64 slot ids of each arity, in cost-array column order
    slots: Tuple[torch.Tensor, ...]
    #: arity → slot of each endpoint of that arity's factors (e = p*F +
    #: f), host-side numpy
    slot_of: Dict[int, np.ndarray] = None


@dataclass
class PackedMaxSumGraph:
    """Packed layout of a factor graph, on one device."""

    D: int
    Vp: int  # variable columns (one per variable)
    N: int  # edge slots (one per factor endpoint)
    #: degree classes (deg, nvp, voff, soff): nvp columns from voff, of
    #: degree deg, own slots [soff, soff + deg*nvp)
    buckets: Tuple[Tuple[int, int, int, int], ...]
    #: all-binary layout: [D*D, N], row j*D+i = cost(d_oth=j, d_tgt=i);
    #: None on the mixed layout (its costs are in ``mixed.costs``)
    cost_rows: Optional[torch.Tensor]
    unary_p: torch.Tensor  # [D, Vp] unary * mask
    mask_p: torch.Tensor  # [D, Vp] 1 = valid value
    vmask: torch.Tensor  # [D, N] mask_p spread to slots
    inv_dcount: torch.Tensor  # [N] 1 / |valid values| of the slot's var
    #: [N] int32 slot of the factor's (first) other endpoint; -1 on the
    #: unary slots of the mixed layout
    mate: torch.Tensor
    slot_col: torch.Tensor  # [N] int64 column that owns each slot
    col_deg: torch.Tensor  # [Vp] int32 degree of each column
    col_slot0: torch.Tensor  # [Vp] int32 slot of each column's rank 0
    col_stride: torch.Tensor  # [Vp] int32 slot step between ranks
    var_order: torch.Tensor  # [Vp] int64 column of each original var
    #: all-binary layout: slot of each edge endpoint (edge e = p*F + f);
    #: host-side numpy.  None on the mixed layout (see ``mixed.slot_of``)
    slot_of_edge: np.ndarray = None
    #: the mixed-arity slot arrays; None on the all-binary layout
    mixed: Optional[MixedSlots] = None
    #: the binary kernel's tile tables on the layout's device, by tile
    #: width, built at the first launch (:func:`tile_table`)
    tile_tables: Dict[int, torch.Tensor] = field(
        default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.unary_p.device


def _columns(keys: np.ndarray):
    """The class blocks of per-variable class keys ``[V, K]`` (the
    degree, or the per-arity degree tuple): variables sorted by key
    (stable: ties keep variable order).  Returns (col_var, var_pcol,
    blocks [(key, nvp, voff, soff)], col_slot0, col_stride), a key's
    degree being the sum of its entries."""
    V = keys.shape[0]
    col_var = np.lexsort((np.arange(V),) + tuple(keys.T[::-1]))
    var_pcol = np.empty(V, dtype=np.int64)
    var_pcol[col_var] = np.arange(V)
    ck = keys[col_var]
    uniq, voffs, nvps = np.unique(ck, axis=0, return_index=True,
                                  return_counts=True)
    order = np.argsort(voffs)
    uniq, voffs, nvps = uniq[order], voffs[order], nvps[order]
    degs = uniq.sum(axis=1)
    soffs = np.concatenate([[0], np.cumsum(degs * nvps)[:-1]])
    col_slot0 = np.zeros(V, dtype=np.int64)
    col_stride = np.ones(V, dtype=np.int64)
    blocks = []
    for key, nv, vo, so in zip(uniq, nvps, voffs, soffs):
        col_slot0[vo: vo + nv] = so + np.arange(nv)
        col_stride[vo: vo + nv] = nv
        blocks.append((tuple(int(k) for k in key), int(nv), int(vo),
                       int(so)))
    return col_var, var_pcol, blocks, col_slot0, col_stride


def _ranks(ends: np.ndarray, V: int) -> np.ndarray:
    """Rank of each endpoint among its variable's (stable by edge id)."""
    order = np.argsort(ends, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(ends,
                                                       minlength=V))[:-1]])
    rank = np.empty(len(ends), dtype=np.int64)
    rank[order] = np.arange(len(ends)) - start[ends[order]]
    return rank


def _common(t: FactorGraphTensors, col_var, slot_col):
    """(unary_p, mask_p, vmask, inv_dcount) of a column layout."""
    mask = t.domain_mask.detach().cpu().numpy()
    unary = t.unary_costs.detach().cpu().numpy()
    mask_p = np.ascontiguousarray(mask[col_var].T)
    unary_p = np.ascontiguousarray(unary[col_var].T) * mask_p
    vmask = np.ascontiguousarray(mask_p[:, slot_col])
    dcount = vmask.sum(axis=0)
    inv_dcount = np.where(dcount > 0, 1.0 / np.maximum(dcount, 1.0), 0.0)
    return unary_p, mask_p, vmask, inv_dcount


def _putter(dev):
    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    return put


def pack_binary_for_gpu(t: FactorGraphTensors
                        ) -> Optional[PackedMaxSumGraph]:
    """The all-binary layout of ``t`` on ``t``'s device, or None when
    ``t`` has a factor of another arity, D > 8, or no factors."""
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
    col_var, var_pcol, blocks, col_slot0, col_stride = _columns(
        deg[:, None])
    col_deg = deg[col_var]
    buckets = tuple((k[0], nv, vo, so) for k, nv, vo, so in blocks
                    if k[0] > 0)

    # slot of each edge: its rank k among its variable's edges (stable by
    # edge id), at col_slot0 + k * stride
    k_of = _ranks(edge_var, V)
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

    unary_p, mask_p, vmask, inv_dcount = _common(t, col_var, slot_col)
    put = _putter(t.device)
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


def pack_mixed_for_gpu(t: FactorGraphTensors, all_binary: bool = False
                       ) -> Optional[PackedMaxSumGraph]:
    """The mixed-arity layout of ``t`` on ``t``'s device, or None out of
    the JAX mixed packer's scope: a factor of arity outside 1-4, D > 8,
    D > 5 when a factor has arity 3 or 4, or no factors; and None for an
    all-binary graph, which takes :func:`pack_binary_for_gpu`'s layout —
    unless ``all_binary`` is set (a shard of a mixed graph that holds
    binary factors only still takes the mixed layout)."""
    by_arity = {b.arity: b for b in t.buckets if b.n_factors > 0}
    if not by_arity or any(a not in ARITIES for a in by_arity) \
            or (set(by_arity) == {2} and not all_binary):
        return None
    V, D = t.n_vars, t.max_domain_size
    if D > MAX_D or (D > MAX_D_NARY and max(by_arity) >= 3):
        return None

    # endpoints per arity (e = p*F + f) and per-arity degrees
    ends = {a: np.asarray(b.var_idx, dtype=np.int64).T.ravel()
            for a, b in by_arity.items()}
    keys = np.zeros((V, 4), dtype=np.int64)
    for a, e in ends.items():
        keys[:, a - 1] = np.bincount(e, minlength=V)
    col_var, var_pcol, blocks, col_slot0, col_stride = _columns(keys)
    ckeys = keys[col_var]
    col_deg = ckeys.sum(axis=1)
    # rank base of each arity within a column: unary, binary, ternary,
    # quaternary
    base = np.concatenate([np.zeros((V, 1), np.int64),
                           np.cumsum(ckeys, axis=1)[:, :3]], axis=1)

    N = int(col_deg.sum())
    slot_col = np.empty(N, dtype=np.int64)
    slot_arity = np.empty(N, dtype=np.int64)
    slot_of = {}
    for a, e in ends.items():
        col = var_pcol[e]
        k = base[col, a - 1] + _ranks(e, V)
        slot_of[a] = col_slot0[col] + k * col_stride[col]
        slot_col[slot_of[a]] = col
        slot_arity[slot_of[a]] = a

    # siblings, cyclically from the slot's position p: mate = (p+1)%a,
    # mate2 = (p+2)%a, mate3 = (p+3)%a
    mates = [np.full(N, -1, dtype=np.int64) for _ in range(3)]
    for a, s in slot_of.items():
        F = len(s) // a
        for p in range(a):
            mine = s[p * F: (p + 1) * F]
            for step in range(1, a):
                sib = (p + step) % a
                mates[step - 1][mine] = s[sib * F: (sib + 1) * F]

    # cost arrays per arity over that arity's slots, in slot order
    cost_idx = np.zeros(N, dtype=np.int64)
    slots, costs = [], []
    for a in ARITIES:
        sl = np.flatnonzero(slot_arity == a) if a in slot_of \
            else np.zeros(0, dtype=np.int64)
        cost_idx[sl] = np.arange(len(sl))
        arr = np.zeros((D ** a, len(sl)), dtype=np.float32)
        if a in slot_of:
            T = by_arity[a].tensors.detach().cpu().numpy()  # [F, D^a]
            F = T.shape[0]
            for p in range(a):
                mine = cost_idx[slot_of[a][p * F: (p + 1) * F]]
                # target axis first, then the siblings in cyclic order;
                # the target moves last: row ((j*D+k)*D+m)*D + i
                axes = (0,) + tuple(1 + (p + s) % a for s in range(a))
                Tp = np.moveaxis(np.transpose(T, axes), 1, -1)
                arr[:, mine] = Tp.reshape(F, -1).T
        slots.append(sl)
        costs.append(arr)

    unary_p, mask_p, vmask, inv_dcount = _common(t, col_var, slot_col)
    put = _putter(t.device)
    mixed = MixedSlots(
        arity=put(slot_arity, torch.int32),
        cost_idx=put(cost_idx, torch.int32),
        mate2=put(mates[1], torch.int32),
        mate3=put(mates[2], torch.int32),
        costs=tuple(put(c, torch.float32) for c in costs),
        slots=tuple(put(sl, torch.int64) for sl in slots),
        slot_of=slot_of,
    )
    return PackedMaxSumGraph(
        D=D, Vp=V, N=N,
        buckets=tuple((sum(k), nv, vo, so) for k, nv, vo, so in blocks
                      if sum(k) > 0),
        cost_rows=None,
        unary_p=put(unary_p, torch.float32),
        mask_p=put(mask_p, torch.float32),
        vmask=put(vmask, torch.float32),
        inv_dcount=put(inv_dcount, torch.float32),
        mate=put(mates[0], torch.int32),
        slot_col=put(slot_col, torch.int64),
        col_deg=put(col_deg, torch.int32),
        col_slot0=put(col_slot0, torch.int32),
        col_stride=put(col_stride, torch.int32),
        var_order=put(var_pcol, torch.int64),
        mixed=mixed,
    )


def pack_for_gpu(t: FactorGraphTensors) -> Optional[PackedMaxSumGraph]:
    """The packed layout of ``t`` on ``t``'s device: the binary layout
    for an all-binary graph, else the mixed one, else None (see the two
    packers for their scopes).  There is no blanket fallback: any other
    failure raises."""
    pg = pack_binary_for_gpu(t)
    return pg if pg is not None else pack_mixed_for_gpu(t)


def solver_layout(t: FactorGraphTensors,
                  use_packed: Optional[bool] = None
                  ) -> Optional[PackedMaxSumGraph]:
    """The layout a solver runs on, or None for its generic engine.

    ``use_packed`` has the JAX solvers' meaning: False never packs, True
    packs whatever :func:`pack_for_gpu` packs, and None (the default)
    packs an all-binary graph on every device and a mixed-arity graph on
    CUDA only — the JAX package packs only on its accelerator, so on the
    CPU both packages run their generic engine for mixed graphs."""
    if use_packed is False:
        return None
    if use_packed is None and t.device.type != "cuda":
        return pack_binary_for_gpu(t)
    return pack_for_gpu(t)


def swap_factor(pg: PackedMaxSumGraph, k: int,
                table) -> PackedMaxSumGraph:
    """Swap ONE binary factor's cost table into the binary layout, in
    place: writes the two ``cost_rows`` columns of factor ``k`` (bucket
    row order) — no re-ranking, no re-packing, O(D²) host work instead of
    O(F·D²).  Returns ``pg``, whose every other field (the degree
    classes, mates, masks and the cached tile tables, which depend on the
    degrees only) is unchanged.  The JAX package's ``packed_swap_factor``
    (``ops/pallas_maxsum.py``) on this package's layout.

    ``table`` is the factor's full padded sign-adjusted ``[D, D]`` tensor
    in the bucket slot's axis order (axis 0 is the endpoint p = 0).
    ``cost_rows`` is ``[D·D, N]``, other-value-major (row ``j*D+i`` =
    cost(other=j, target=i)): the p = 0 endpoint, at
    ``slot_of_edge[k]``, sees the table as [target, other], so its column
    is ``table.T`` flattened; the p = 1 endpoint, at
    ``slot_of_edge[F + k]``, sees [other, target], so its column is
    ``table`` flattened — the orientation :func:`pack_binary_for_gpu`
    writes.  The write is stream-ordered: a launch made before it reads
    the old table, one made after it the new."""
    if pg.mixed is not None or pg.slot_of_edge is None:
        raise NotImplementedError(
            "swap_factor takes the all-binary layout; a mixed-arity "
            "layout is re-packed by solver_layout")
    D = pg.D
    t = np.asarray(table, dtype=np.float32)
    if t.shape != (D, D):
        raise ValueError(
            f"swap table shape {t.shape} != ({D}, {D}) — the factor's "
            f"scope must be unchanged")
    F = pg.slot_of_edge.shape[0] // 2
    if not 0 <= k < F:
        raise ValueError(f"factor index {k} out of range [0, {F})")
    s0 = int(pg.slot_of_edge[k])
    s1 = int(pg.slot_of_edge[F + k])
    cols = np.stack([np.ascontiguousarray(t.T).reshape(-1),
                     t.reshape(-1)], axis=1)
    pg.cost_rows[:, [s0, s1]] = torch.as_tensor(cols, device=pg.device)
    return pg


def packed_init_state(pg: PackedMaxSumGraph
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((pg.D, pg.N), dtype=torch.float32, device=pg.device)
    return z, z.clone()


def packed_values(pg: PackedMaxSumGraph,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Masked argmin per column, mapped to original variable order."""
    big = torch.where(pg.mask_p > 0, beliefs, PAD_COST)
    return torch.argmin(big, dim=0)[pg.var_order]


def _mixed_r_new(pg: PackedMaxSumGraph, q: torch.Tensor) -> torch.Tensor:
    """factor→var messages of the mixed layout, arity by arity, in the
    Pallas kernel's order (``_mixed_r_new``): a unary slot takes its cost;
    a binary slot min_j cost + q1[j], folded from j = 0; a ternary slot
    min over (j outer, k inner) of (cost + q1[j]) + q2[k]; a quaternary
    slot min over (j, k, m) of (cost + (q1[j] + q2[k])) + q3[m]."""
    D, m = pg.D, pg.mixed
    r = torch.empty((D, pg.N), dtype=q.dtype, device=q.device)
    sibs = (pg.mate.long(), m.mate2.long(), m.mate3.long())
    for a, sl, cost in zip(ARITIES, m.slots, m.costs):
        if sl.numel() == 0:
            continue
        qs = [q[:, sib[sl]] for sib in sibs[:a - 1]]  # routed siblings
        if a == 1:
            out = cost
        elif a == 2:
            out = cost[0:D] + qs[0][0:1]
            for j in range(1, D):
                out = torch.minimum(
                    out, cost[j * D:(j + 1) * D] + qs[0][j:j + 1])
        elif a == 3:
            out = None
            for j in range(D):
                for k in range(D):
                    row = (j * D + k) * D
                    cand = (cost[row:row + D] + qs[0][j:j + 1]) \
                        + qs[1][k:k + 1]
                    out = cand if out is None else torch.minimum(out, cand)
        else:
            out = None
            for j in range(D):
                for k in range(D):
                    qjk = qs[0][j:j + 1] + qs[1][k:k + 1]
                    for mm in range(D):
                        row = ((j * D + k) * D + mm) * D
                        cand = (cost[row:row + D] + qjk) + qs[2][mm:mm + 1]
                        out = cand if out is None \
                            else torch.minimum(out, cand)
        r[:, sl] = out
    return r


def _plain_cycle(pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
                 damping: float):
    D = pg.D
    if pg.mixed is not None:
        r_new = _mixed_r_new(pg, q)
    else:
        qm = q[:, pg.mate.long()]  # the factor exchange: gather by mate
        cost = pg.cost_rows
        r_new = cost[0:D] + qm[0:1]
        for j in range(1, D):
            r_new = torch.minimum(r_new,
                                  cost[j * D:(j + 1) * D] + qm[j:j + 1])
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


_kernel_fns = {}


def _kernel(mixed: bool):
    """The C entry of ``csrc/packed_maxsum.cu`` for the binary or the
    mixed layout, built and bound once."""
    name = "packed_maxsum_mixed_cycle" if mixed else "packed_maxsum_coop"
    if name not in _kernel_fns:
        from pydcop_tpu_torch.ops.cuda_build import load

        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(load("packed_maxsum"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([P] * 22 + [I] * 9 + [F, F, I, P, P] if mixed
                       else [P] * 12 + [I] * 8 + [F, F, I, P, P])
        _kernel_fns[name] = fn
    return _kernel_fns[name]


def _capacity(D: int) -> Tuple[int, int]:
    """(resident blocks, threads a block) of the mixed kernel at domain
    size ``D`` on the current CUDA device (0 blocks when the device cannot
    be asked)."""
    from pydcop_tpu_torch.ops.cuda_build import load

    fn = load("packed_maxsum").packed_maxsum_mixed_capacity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    threads = ctypes.c_int(0)
    return int(fn(D, ctypes.byref(threads))), int(threads.value)


def _binary_capacity(D: int, threads: int, cols: int) -> int:
    """Resident blocks of the binary kernel at domain size ``D``, with
    ``threads`` threads a block and tiles of up to ``cols`` columns, on the
    current CUDA device (0 when the device cannot be asked)."""
    from pydcop_tpu_torch.ops.cuda_build import load

    fn = load("packed_maxsum").packed_maxsum_binary_capacity
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return int(fn(D, threads, cols))


def mixed_work(pg: PackedMaxSumGraph) -> int:
    """Phase 1's work units of the mixed kernel: one a unary or binary
    slot, D a ternary or quaternary slot (one a value)."""
    n1, n2, n3, n4 = (int(sl.numel()) for sl in pg.mixed.slots)
    return n1 + n2 + pg.D * (n3 + n4)


def mixed_blocks(pg: PackedMaxSumGraph, capacity: int, threads: int) -> int:
    """Blocks of one mixed launch: enough for one thread a unit of phase
    1 or a column of phase 2, at most ``capacity`` (both phases are
    grid-stride loops)."""
    need = -(-max(mixed_work(pg), pg.Vp) // threads)
    return max(1, min(capacity, need))


def tile_table(pg: PackedMaxSumGraph, cols: int) -> np.ndarray:
    """The binary kernel's tiles, ``[n_tiles, 5]`` int32 rows (first
    column, width, degree, slot of the first column's rank 0, slot stride
    between ranks): each degree class of ``pg.buckets`` cut into runs of
    up to ``cols`` neighbouring columns, whose slots at one rank are
    contiguous, and each run of degree-0 columns (in no class) likewise,
    with degree 0 (their beliefs are their unary costs).  Every column
    lies in one tile, and every slot in one (rank, column) unit of one.
    Built from the host-side classes alone."""
    runs = np.array([(voff, nv, deg, soff, nv)
                     for deg, nv, voff, soff in pg.buckets],
                    dtype=np.int64).reshape(-1, 5)
    free = np.ones(pg.Vp, dtype=bool)
    for voff, nv in runs[:, :2]:
        free[voff:voff + nv] = False
    free = np.flatnonzero(free)
    if free.size:
        cut = np.flatnonzero(np.diff(free) != 1) + 1
        runs = np.concatenate([runs, [(r[0], len(r), 0, 0, 0)
                                      for r in np.split(free, cut)]])
    runs = runs[np.argsort(runs[:, 0])]
    # tile x of a run starts x * cols columns into it
    per_run = -(-runs[:, 1] // cols)
    rows = np.repeat(runs, per_run, axis=0)
    skip = (np.arange(len(rows))
            - np.repeat(np.cumsum(per_run) - per_run, per_run)) * cols
    rows[:, 0] += skip
    rows[:, 1] = np.minimum(cols, rows[:, 1] - skip)
    rows[:, 3] = np.where(rows[:, 2] > 0, rows[:, 3] + skip, 0)
    return rows.astype(np.int32)


def _tiles(pg: PackedMaxSumGraph, cols: int) -> torch.Tensor:
    """:func:`tile_table` at ``cols`` on the layout's device, built once
    per layout and width."""
    if cols not in pg.tile_tables:
        pg.tile_tables[cols] = torch.as_tensor(tile_table(pg, cols),
                                               device=pg.device)
    return pg.tile_tables[cols]


def binary_blocks(n_tiles: int, capacity: int) -> int:
    """Blocks of one binary launch: one a tile, at most ``capacity`` and
    :data:`BINARY_GRID_CAP`, at least 1 (blocks take tiles
    grid-stride)."""
    return max(1, min(capacity, n_tiles, BINARY_GRID_CAP))


def _mixed_layout_args(pg: PackedMaxSumGraph):
    """The mixed layout's operands of one launch, after its state
    operands."""
    m = pg.mixed
    return (*(c.data_ptr() for c in m.costs),
            *(sl.data_ptr() for sl in m.slots), pg.mate.data_ptr(),
            m.mate2.data_ptr(), m.mate3.data_ptr(), pg.unary_p.data_ptr(),
            pg.vmask.data_ptr(), pg.inv_dcount.data_ptr(),
            pg.col_deg.data_ptr(), pg.col_slot0.data_ptr(),
            pg.col_stride.data_ptr(), pg.D, pg.N, pg.Vp,
            *(int(sl.numel()) for sl in m.slots))


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def packed_cycles(
    pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
    n_cycles: int, damping: float = 0.0, blocks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_cycles`` MaxSum cycles on the packed layout; returns (q', r',
    beliefs [D, Vp], values [Vp] in variable order) after the last cycle.

    On CUDA tensors this launches the hand-written kernel on the current
    stream: on the binary layout one cooperative launch that runs every
    cycle (``packed_cycles.launches`` adds one a call; ``blocks`` forces
    its grid, 1 up to the kernel's capacity), on the mixed layout one
    launch a cycle (``packed_cycles.mixed_launches``; ``blocks`` is
    refused there).  On CPU tensors it runs :func:`packed_cycles_plain`,
    and ``blocks`` has no use.  The inputs are not modified: q' goes to
    fresh tensors, double-buffered by cycle, and r' to a fresh tensor at
    the first cycle that the later cycles update in place (each element
    of r is read and written by its one owner)."""
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
    return _launch_cycles(pg, q, r, n_cycles, damping, blocks)


def _launch_cycles(pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
                   n_cycles: int, damping: float,
                   blocks: Optional[int] = None):
    """:func:`packed_cycles` on CUDA tensors: the kernel's launches, or
    RuntimeError."""
    if pg.mixed is None:
        return _launch_binary(pg, q, r, n_cycles, damping, blocks)
    if blocks is not None:
        raise ValueError("blocks= forces the binary kernel's grid; the "
                         "mixed kernel sizes its own")
    return _launch_mixed(pg, q, r, n_cycles, damping)


def _launch_binary(pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
                   n_cycles: int, damping: float, blocks: Optional[int]):
    """The binary kernel's one cooperative launch for all ``n_cycles``
    cycles, at ``blocks`` blocks (1 up to the capacity) or at those of
    :func:`binary_blocks`.  Its barrier word is allocated zeroed by this
    call and shared with no other; the result's q' is the buffer of cycle
    n - 1."""
    threads, cols = BINARY_THREADS, TILE_COLS
    tiles = _tiles(pg, cols)
    capacity = _binary_capacity(pg.D, threads, cols)
    if capacity <= 0:
        raise RuntimeError("packed_maxsum_coop: the device reports no "
                           "resident block for the cooperative launch")
    if blocks is None:
        blocks = binary_blocks(tiles.shape[0], capacity)
    elif not 1 <= blocks <= capacity:
        raise ValueError(f"packed_maxsum_coop: {blocks} blocks, the "
                         f"capacity is {capacity}")
    bufs = [torch.empty_like(q), torch.empty_like(q)]
    r_out = torch.empty_like(r)
    beliefs = torch.empty((pg.D, pg.Vp), dtype=torch.float32,
                          device=q.device)
    bar = torch.zeros(1, dtype=torch.int32, device=q.device)
    err = _kernel(False)(
        q.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), r.data_ptr(),
        r_out.data_ptr(), beliefs.data_ptr(), pg.cost_rows.data_ptr(),
        pg.unary_p.data_ptr(), pg.vmask.data_ptr(),
        pg.inv_dcount.data_ptr(), pg.mate.data_ptr(), tiles.data_ptr(),
        tiles.shape[0], cols, pg.D, pg.N, pg.Vp, n_cycles, blocks, threads,
        float(damping), float(1.0 - damping), 1 if damping else 0,
        bar.data_ptr(), _stream(q))
    if err != 0:
        raise RuntimeError(f"packed_maxsum_coop launch failed: CUDA error "
                           f"{err}")
    packed_cycles.launches += 1
    out = bufs[(n_cycles - 1) % 2]
    return out, r_out, beliefs, packed_values(pg, beliefs)


def _launch_mixed(pg: PackedMaxSumGraph, q: torch.Tensor, r: torch.Tensor,
                  n_cycles: int, damping: float):
    """The mixed kernel's launches, one a cycle.  Its grid barrier takes
    two words that this call allocates zeroed and no other call shares."""
    fn = _kernel(True)
    capacity, threads = _capacity(pg.D)
    if capacity <= 0:
        raise RuntimeError(
            "packed_maxsum mixed cycle: the device reports no resident "
            "block for the cooperative launch")
    layout = _mixed_layout_args(pg) + (
        mixed_work(pg), mixed_blocks(pg, capacity, threads))
    bar = torch.zeros(2, dtype=torch.int32, device=q.device)
    bufs = [torch.empty_like(q), torch.empty_like(q)]
    r_out = torch.empty_like(r)
    beliefs = torch.empty((pg.D, pg.Vp), dtype=torch.float32,
                          device=q.device)
    stream = _stream(q)
    use_damping = 1 if damping else 0
    q_in, r_in = q, r
    for i in range(n_cycles):
        q_out = bufs[i % 2]
        err = fn(
            q_in.data_ptr(), q_out.data_ptr(), r_in.data_ptr(),
            r_out.data_ptr(), beliefs.data_ptr(), *layout,
            float(damping), float(1.0 - damping), use_damping,
            bar.data_ptr(), stream,
        )
        if err != 0:
            raise RuntimeError(
                f"packed_maxsum mixed cycle launch failed: CUDA error {err}")
        packed_cycles.mixed_launches += 1
        q_in, r_in = q_out, r_out
    return q_in, r_out, beliefs, packed_values(pg, beliefs)


packed_cycles.launches = 0
packed_cycles.mixed_launches = 0
