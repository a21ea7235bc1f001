"""The generic ``[E, D]`` sharded layout and its per-device blocks.

The counterpart of the JAX package's generic sharded engine in
``parallel/mesh.py`` (``ShardedBucket``, ``ShardedFactorGraph``,
``shard_factor_graph``, ``_local_row_layout``, ``_exchange_to_local``,
``_neighbor_pair_blocks``, and the per-shard arithmetic of
``_r_new_block``, ``_var_side`` and ``_tables_block``).  It runs every
graph, whatever its arity and domain size: the engines of
``parallel/mesh.py`` take it for ``use_packed=False``, for graphs the
packers decline, and for the breakout rules (dba, gdba).

The layout is the JAX package's, array for array: each bucket padded to
a common per-shard factor count ``Fs`` with zero-cost dummy factors wired
to a phantom variable V, shard-major (shard s's factors are rows ``[s *
Fs, (s + 1) * Fs)``); a shard's edges are its buckets' factors in bucket
order, each factor's scope positions in a row (``edge_var``: ``[S * Es]``,
shard-major), so the message state ``(q, r)`` is ``[S * Es, D]`` as in
JAX.  The variables are replicated: a shard's partial beliefs or tables
are ``[V + 1, D]`` (row V the phantom), combined across shards by the
engines.

:class:`GenericGroup` holds the blocks of the shards one device holds
(the shards of :func:`~pydcop_tpu_torch.parallel.packed_mesh._device_groups`),
stacked so that one tensor op serves them all: a factor's messages and
tables never mix shards, and each shard's partial is an ordered segment
sum (``ops/segments.py``: rows added in ascending order, as XLA's CPU
scatter-add, on every device) over segments ``k * (V + 1) + var`` of the
k-th shard of the group.  Plain PyTorch: the JAX package's generic engine
is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.ops.compile import PAD_COST, FactorBucket, \
    FactorGraphTensors
from pydcop_tpu_torch.ops.maxsum_kernels import factor_to_var_messages
from pydcop_tpu_torch.ops.segments import SegmentPlan, masked_argmin, \
    masked_mean, segment_max, segment_min
from pydcop_tpu_torch.parallel.boundary import BoundaryInfo, \
    analyze_boundary
from pydcop_tpu_torch.parallel.partition import partition_factors

#: the local-row layout's fan-in bound (``_LOCAL_ROW_MAX_DEG``): above it
#: the compact MaxSum cycle keeps the global-row sums
LOCAL_ROW_MAX_DEG = 64


@dataclasses.dataclass
class ShardedBucket:
    arity: int
    factors_per_shard: int  # padded count per shard
    tensors: np.ndarray  # [S*Fs, D, ..., D], shard-major, dummies zeroed
    var_idx: np.ndarray  # [S*Fs, arity], dummy rows point at var V


@dataclasses.dataclass
class ShardedFactorGraph:
    """The generic sharded layout, on the host."""

    base: FactorGraphTensors
    n_shards: int
    buckets: List[ShardedBucket]
    edge_var: np.ndarray  # [S*Es] shard-major; dummy edges point at var V
    edges_per_shard: int
    boundary: BoundaryInfo  # built with keep_touch=True
    #: per bucket of ``base`` (buckets with factors), factor → shard
    assigns: List[np.ndarray]
    #: per sharded bucket, original factor → stacked row
    factor_rows: List[np.ndarray]

    @property
    def n_vars(self) -> int:
        return self.base.n_vars

    @property
    def max_domain_size(self) -> int:
        return self.base.max_domain_size


def shard_factor_graph(
    tensors: FactorGraphTensors, n_shards: int,
    assigns: Optional[List[np.ndarray]] = None,
) -> ShardedFactorGraph:
    """Partition the factors over ``n_shards`` shards and pad each bucket
    to a common per-shard factor count with zero-cost dummy factors wired
    to the phantom variable V.  ``assigns`` (per bucket, factor → shard)
    overrides the locality partition."""
    V = tensors.n_vars
    vis = [np.asarray(b.var_idx) for b in tensors.buckets]
    if assigns is None:
        assigns = partition_factors(vis, V, n_shards)
    assigns = [np.asarray(a).astype(np.int64) for a in assigns]
    if len(assigns) != len(vis) or any(
            a.shape != (vi.shape[0],) for a, vi in zip(assigns, vis)):
        raise ValueError(
            f"assigns must hold one factor→shard array per bucket, of "
            f"lengths {[vi.shape[0] for vi in vis]}")
    for a in assigns:
        if a.size and (a.min() < 0 or a.max() >= n_shards):
            raise ValueError(
                f"assigns name a shard outside [0, {n_shards})")
    buckets: List[ShardedBucket] = []
    factor_rows: List[np.ndarray] = []
    edge_var_shards: List[List[np.ndarray]] = [[] for _ in range(n_shards)]
    for b, assign in zip(tensors.buckets, assigns):
        a = b.arity
        counts = np.bincount(assign, minlength=n_shards)
        Fs = int(counts.max()) if counts.size else 0
        if Fs == 0:
            continue
        t_np = b.tensors.detach().cpu().numpy()
        new_t = np.zeros((n_shards * Fs,) + t_np.shape[1:], dtype=t_np.dtype)
        new_vi = np.full((n_shards * Fs, a), V, dtype=np.int64)
        rows = np.full(b.n_factors, -1, dtype=np.int64)
        for s in range(n_shards):
            idx = np.flatnonzero(assign == s)
            new_t[s * Fs: s * Fs + idx.size] = t_np[idx]
            new_vi[s * Fs: s * Fs + idx.size] = np.asarray(b.var_idx)[idx]
            rows[idx] = s * Fs + np.arange(idx.size)
            edge_var_shards[s].append(
                new_vi[s * Fs: (s + 1) * Fs].reshape(-1))
        factor_rows.append(rows)
        buckets.append(ShardedBucket(arity=a, factors_per_shard=Fs,
                                     tensors=new_t, var_idx=new_vi))
    edge_var = (np.concatenate([np.concatenate(evs)
                                for evs in edge_var_shards])
                if edge_var_shards and edge_var_shards[0]
                else np.zeros(0, dtype=np.int64))
    return ShardedFactorGraph(
        base=tensors, n_shards=n_shards, buckets=buckets,
        edge_var=edge_var.astype(np.int64),
        edges_per_shard=edge_var.shape[0] // n_shards if n_shards else 0,
        boundary=analyze_boundary(vis, assigns, V, n_shards,
                                  keep_touch=True),
        assigns=assigns, factor_rows=factor_rows)


def local_row_layout(st: ShardedFactorGraph, bnd_rows: np.ndarray):
    """The shard-local row layout of the compact MaxSum cycle
    (``_local_row_layout``): each shard reduces its messages into the
    rows of the variables it touches, by a padded slot-table gather and
    a fold in ascending slot order (the order of the global-row sum, so
    the cycle is the same to the bit), and only the ``[Bp, D]`` boundary
    slab, gathered from those rows, is combined.  None when a shard's
    fan-in exceeds :data:`LOCAL_ROW_MAX_DEG` or there is no edge.

    Arrays (numpy, per shard): gather_tbl [S, (L+1)*deg] slot ids into
    [0, Es] (Es = the zero pad), edge_loc [S, Es] the local row of each
    slot (dummy row L), unary_loc / dmask_loc [S, L+1, D], slab_loc
    [S, Bp] the local row of each boundary column (L where untouched),
    glob_loc [S, L+1] local → global variable (L → V)."""
    S, V = st.n_shards, st.n_vars
    Es = st.edges_per_shard
    if Es == 0:
        return None
    ev = st.edge_var.reshape(S, Es)
    unary = st.base.unary_costs.detach().cpu().numpy()
    dmask = st.base.domain_mask.detach().cpu().numpy()
    D = st.max_domain_size
    locs, slots_per = [], []
    deg_max = 0
    for s in range(S):
        real = np.flatnonzero(ev[s] < V)
        gvars = np.unique(ev[s][real])
        slots = {int(g): [] for g in gvars}
        for e in real:
            slots[int(ev[s][e])].append(int(e))
        locs.append(gvars)
        slots_per.append(slots)
        if slots:
            deg_max = max(deg_max, max(len(v) for v in slots.values()))
    if deg_max == 0 or deg_max > LOCAL_ROW_MAX_DEG:
        return None
    L = max(len(g) for g in locs)
    gather_tbl = np.full((S, (L + 1) * deg_max), Es, dtype=np.int64)
    edge_loc = np.full((S, Es), L, dtype=np.int64)
    unary_loc = np.zeros((S, L + 1, D), dtype=np.float32)
    dmask_loc = np.zeros((S, L + 1, D), dtype=np.float32)
    glob_loc = np.full((S, L + 1), V, dtype=np.int64)
    slab_loc = np.full((S, bnd_rows.shape[0]), L, dtype=np.int64)
    for s in range(S):
        loc_of = {int(g): i for i, g in enumerate(locs[s])}
        for g, i in loc_of.items():
            sl = slots_per[s][g]
            gather_tbl[s, i * deg_max: i * deg_max + len(sl)] = sl
            unary_loc[s, i] = unary[g]
            dmask_loc[s, i] = dmask[g]
            glob_loc[s, i] = g
        for e in range(Es):
            g = int(ev[s][e])
            if g < V:
                edge_loc[s, e] = loc_of[g]
        for j, g in enumerate(np.asarray(bnd_rows).tolist()):
            slab_loc[s, j] = loc_of.get(int(g), L)
    return {"deg": deg_max, "rows": L + 1, "gather_tbl": gather_tbl,
            "edge_loc": edge_loc, "unary_loc": unary_loc,
            "dmask_loc": dmask_loc, "slab_loc": slab_loc,
            "glob_loc": glob_loc}


def exchange_to_local(st: ShardedFactorGraph, lr: dict, send: np.ndarray,
                      recv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """An exchange plan's variable ids ([S, R, Bpair]) as each shard's
    local rows (``_exchange_to_local``): a sent or received column is
    always touched by its shard, so the map is total; padding positions
    keep pointing at a real column and are masked by the valid bits."""
    glob = lr["glob_loc"]
    S, rows = glob.shape
    loc_of = np.full((S, st.n_vars + 1), rows - 1, dtype=np.int64)
    for s in range(S):
        loc_of[s, glob[s]] = np.arange(rows, dtype=np.int64)
    send_l = np.take_along_axis(loc_of, send.reshape(S, -1).astype(
        np.int64), axis=1).reshape(send.shape)
    recv_l = np.take_along_axis(loc_of, recv.reshape(S, -1).astype(
        np.int64), axis=1).reshape(recv.shape)
    return send_l, recv_l


def neighbor_pair_blocks(st: ShardedFactorGraph):
    """Per-shard directed neighbour pairs (src, dst), [S, P] each, from
    the sharded factor blocks (``_neighbor_pair_blocks``): the operand of
    the compact MGM-family arbitration.  A pair (i, j) lives on every
    shard holding a factor whose scope has both; dummy factors give
    (V, V) pairs on the ignored phantom row."""
    S = st.n_shards
    src_per = [[] for _ in range(S)]
    dst_per = [[] for _ in range(S)]
    for sb in st.buckets:
        vi = sb.var_idx
        Fs, a = sb.factors_per_shard, sb.arity
        for s in range(S):
            blk = vi[s * Fs: (s + 1) * Fs]
            for p in range(a):
                for q in range(a):
                    if p != q:
                        src_per[s].append(blk[:, p])
                        dst_per[s].append(blk[:, q])
    if not src_per[0]:
        z = np.zeros((S, 0), dtype=np.int64)
        return z, z.copy()
    return (np.stack([np.concatenate(x) for x in src_per]).astype(np.int64),
            np.stack([np.concatenate(x) for x in dst_per]).astype(np.int64))


# ---------------------------------------------------------------------------
# per-device blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GenericGroup:
    """The generic blocks of the shards one device holds (``index``, in
    shard order), stacked: the k-th shard's factor rows of bucket b are
    ``[k * Fs_b, (k + 1) * Fs_b)`` of ``tensors[b]``, its edges
    ``[k * Es, (k + 1) * Es)`` of ``edge_var``."""

    device: torch.device
    index: Tuple[int, ...]
    V: int
    D: int
    Es: int
    tensors: List[torch.Tensor]   # per bucket [k*Fs, D, ..., D]
    var_idx: List[torch.Tensor]   # per bucket [k*Fs, a] int64 (dummy V)
    arity: List[int]
    edge_var: torch.Tensor        # [k*Es] int64
    #: [k*Es] int64: segment k*(V+1) + var of each edge (the flat row of
    #: its shard's [V+1] view)
    edge_seg: torch.Tensor
    vmask: torch.Tensor           # [k*Es, D] domain mask of each edge
    #: per bucket, [k*Fs*a] int64 positions of its edges (factor-major)
    bucket_edges: List[torch.Tensor]
    #: [k*Es] int64: the concatenation of the buckets' edges → edge order
    assemble: torch.Tensor
    edge_plan: SegmentPlan        # segments k*(V+1) + var, k*(V+1) rows
    #: per bucket, per scope position: the plan of its factor rows'
    #: variables (segments k*(V+1) + var)
    pos_plans: List[List[SegmentPlan]]
    #: per bucket [k*Fs] int64: the flat [V+1] row offset of each
    #: factor's shard (k * (V+1))
    row_base: List[torch.Tensor]
    unary: torch.Tensor           # [V, D]
    mask: torch.Tensor            # [V, D]

    @property
    def k(self) -> int:
        return len(self.index)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """[k*(V+1), ...] → [k, V+1, ...]."""
        return t.view((self.k, self.V + 1) + tuple(t.shape[1:]))


def build_group(st: ShardedFactorGraph, index: Sequence[int],
                device: torch.device) -> GenericGroup:
    """The blocks of the shards ``index`` (in shard order) on ``device``."""
    V, D, Es = st.n_vars, st.max_domain_size, st.edges_per_shard
    k = len(index)
    dev = torch.device(device)
    i64 = dict(dtype=torch.long, device=dev)
    tensors, var_idx, arity, bucket_edges, pos_plans, row_base = \
        [], [], [], [], [], []
    ev = st.edge_var.reshape(st.n_shards, Es) if st.n_shards else \
        np.zeros((0, 0), np.int64)
    edge_var = ev[list(index)].reshape(-1)
    off = 0
    for sb in st.buckets:
        Fs, a = sb.factors_per_shard, sb.arity
        rows = np.concatenate([np.arange(s * Fs, (s + 1) * Fs)
                               for s in index])
        tensors.append(torch.as_tensor(sb.tensors[rows], device=dev))
        vi = torch.as_tensor(sb.var_idx[rows], **i64)
        var_idx.append(vi)
        arity.append(a)
        bucket_edges.append(torch.as_tensor(np.concatenate(
            [kk * Es + off + np.arange(Fs * a) for kk in range(k)]), **i64))
        base = torch.as_tensor(
            np.repeat(np.arange(k) * (V + 1), Fs), **i64)
        row_base.append(base)
        pos_plans.append([SegmentPlan(base + vi[:, p], k * (V + 1))
                          for p in range(a)])
        off += Fs * a
    order = (torch.cat(bucket_edges) if bucket_edges
             else torch.zeros(0, **i64))
    assemble = torch.empty_like(order)
    assemble[order] = torch.arange(order.numel(), **i64)
    edge_var_t = torch.as_tensor(edge_var, **i64)
    edge_seg = edge_var_t + torch.as_tensor(
        np.repeat(np.arange(k) * (V + 1), Es), **i64)
    mask = st.base.domain_mask.to(dev)
    mask_ext = torch.cat([mask, torch.zeros((1, D), device=dev)])
    return GenericGroup(
        device=dev, index=tuple(index), V=V, D=D, Es=Es, tensors=tensors,
        var_idx=var_idx, arity=arity, edge_var=edge_var_t,
        edge_seg=edge_seg, vmask=mask_ext[edge_var_t],
        bucket_edges=bucket_edges, assemble=assemble,
        edge_plan=SegmentPlan(edge_seg, k * (V + 1)), pos_plans=pos_plans,
        row_base=row_base, unary=st.base.unary_costs.to(dev), mask=mask)


def _bucket(g: GenericGroup, b: int, t: torch.Tensor) -> FactorBucket:
    return FactorBucket(arity=g.arity[b], tensors=t,
                        var_idx=np.zeros((1, g.arity[b]), dtype=np.int64),
                        factor_ids=np.zeros(1, dtype=np.int64),
                        edge_offset=0)


def r_new_block(g: GenericGroup, q: torch.Tensor, r: torch.Tensor,
                damping: float) -> torch.Tensor:
    """The damped, masked factor→variable messages [k*Es, D] of the
    group's shards from their q (``_r_new_block``)."""
    if not g.tensors:
        return r
    parts = []
    for b, t in enumerate(g.tensors):
        a = g.arity[b]
        qb = q[g.bucket_edges[b]].reshape(t.shape[0], a, g.D)
        parts.append(factor_to_var_messages(_bucket(g, b, t), qb)
                     .reshape(-1, g.D))
    r_new = torch.cat(parts)[g.assemble] * g.vmask
    if damping:
        r_new = damping * r + (1.0 - damping) * r_new
    return r_new


def partial_beliefs(g: GenericGroup, r_new: torch.Tensor) -> torch.Tensor:
    """Each shard's partial belief sums [k, V+1, D]: its edges' messages
    added per variable in ascending edge order."""
    return g.rows(g.edge_plan.sum(r_new))


def beliefs_of(g: GenericGroup, total: torch.Tensor) -> torch.Tensor:
    """``unary + total[:V]`` per shard view ([k, V+1, D] totals →
    [k, V, D] beliefs)."""
    return g.unary + total[:, :g.V]


def var_side(g: GenericGroup, q: torch.Tensor, r: torch.Tensor,
             r_new: torch.Tensor, beliefs: torch.Tensor,
             active: Optional[torch.Tensor]):
    """The variable side (``_var_side``): each edge's outgoing message
    from its shard's beliefs view ([k, V, D]), centred on the valid
    values' mean, and amaxsum's commit (``active`` [k*Es] bool)."""
    ext = torch.cat([beliefs, beliefs.new_zeros((g.k, 1, g.D))], dim=1)
    q_new = ext.reshape(-1, g.D)[g.edge_seg] - r_new
    q_new = (q_new - masked_mean(q_new, g.vmask)) * g.vmask
    if active is not None:
        on = active[:, None]
        q_new = torch.where(on, q_new, q)
        r_new = torch.where(on, r_new, r)
    return q_new, r_new


@dataclasses.dataclass
class LocalRows:
    """A group's shards' local-row layout (:func:`local_row_layout` cut
    to the group, flat): each shard's messages reduce into the ``rows``
    rows of the variables it touches (row ``rows - 1`` a dummy)."""

    rows: int
    deg: int
    #: [k*rows*deg] int64 into the group's messages with one zero row
    #: appended (index k*Es)
    gather: torch.Tensor
    #: [k*Es] int64: each edge's flat row k*rows + its local row
    edge_row: torch.Tensor
    unary: torch.Tensor  # [k, rows, D] unary costs (dummy row 0)
    dmask: torch.Tensor  # [k, rows, D] domain mask (dummy row 0)


def local_rows(g: GenericGroup, lr: dict) -> LocalRows:
    idx = list(g.index)
    rows, deg, Es = lr["rows"], lr["deg"], g.Es
    tbl = lr["gather_tbl"][idx]
    base = (np.arange(g.k) * Es)[:, None]
    gather = np.where(tbl < Es, tbl + base, g.k * Es)
    edge_row = lr["edge_loc"][idx] + (np.arange(g.k) * rows)[:, None]
    i64 = dict(dtype=torch.long, device=g.device)
    return LocalRows(
        rows=rows, deg=deg,
        gather=torch.as_tensor(gather.reshape(-1), **i64),
        edge_row=torch.as_tensor(edge_row.reshape(-1), **i64),
        unary=torch.as_tensor(lr["unary_loc"][idx], device=g.device),
        dmask=torch.as_tensor(lr["dmask_loc"][idx], device=g.device))


def local_partial(g: GenericGroup, L: LocalRows,
                  r_new: torch.Tensor) -> torch.Tensor:
    """Each shard's partial belief sums on its local rows [k, rows, D]: a
    gather of its padded slot table and a fold in ascending slot order
    (``_local_cycle_lr``; the order of the global-row sum)."""
    ext = torch.cat([r_new, r_new.new_zeros((1, g.D))])
    gg = ext[L.gather].view(g.k, L.rows, L.deg, g.D)
    part = gg[:, :, 0]
    for j in range(1, L.deg):
        part = part + gg[:, :, j]
    return part


def local_var_side(g: GenericGroup, L: LocalRows, q: torch.Tensor,
                   r: torch.Tensor, r_new: torch.Tensor,
                   beliefs: torch.Tensor, active: Optional[torch.Tensor]):
    """:func:`var_side` on the local rows (``beliefs`` [k, rows, D])."""
    q_new = beliefs.reshape(-1, g.D)[L.edge_row] - r_new
    q_new = (q_new - masked_mean(q_new, g.vmask)) * g.vmask
    if active is not None:
        on = active[:, None]
        q_new = torch.where(on, q_new, q)
        r_new = torch.where(on, r_new, r)
    return q_new, r_new


def values_of(g: GenericGroup, beliefs: torch.Tensor) -> torch.Tensor:
    """[k, V] masked argmin of each shard's beliefs view."""
    return masked_argmin(beliefs, g.mask)


def partial_tables(g: GenericGroup, x: torch.Tensor,
                   tensors: Optional[Sequence[torch.Tensor]] = None,
                   weights: Optional[Sequence[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Each shard's partial local-cost tables [k, V+1, D] at its view of
    the assignment ``x`` ([k, V]) (``_tables_block``): per bucket and
    scope position, the rows at the other positions' values summed per
    variable, added to the partial in that order.  ``tensors`` replaces
    the cost tensors (gdba's effective ones, dba's indicators),
    ``weights`` scales each factor's rows (dba)."""
    D = g.D
    x_ext = torch.cat([x.long(), x.new_zeros((g.k, 1)).long()], dim=1)
    x_flat = x_ext.reshape(-1)
    partial = torch.zeros((g.k * (g.V + 1), D), dtype=torch.float32,
                          device=x.device)
    d = torch.arange(D, device=x.device)[None, :]
    for b, t in enumerate(g.tensors):
        T = t if tensors is None else tensors[b]
        a = g.arity[b]
        vals = x_flat[g.row_base[b][:, None] + g.var_idx[b]]  # [k*Fs, a]
        fidx = torch.arange(t.shape[0], device=x.device)[:, None]
        for p in range(a):
            idx = tuple(d if q == p else vals[:, q][:, None]
                        for q in range(a))
            rows = T[(fidx,) + idx]
            if weights is not None:
                rows = rows * weights[b][:, None]
            partial = partial + g.pos_plans[b][p].sum(rows)
    return g.rows(partial)


def factor_values(g: GenericGroup, b: int, x: torch.Tensor) -> torch.Tensor:
    """[k*Fs, a] each factor's variables' values in its shard's view of
    ``x`` ([k, V]; the phantom variable reads 0)."""
    x_ext = torch.cat([x.long(), x.new_zeros((g.k, 1)).long()], dim=1)
    return x_ext.reshape(-1)[g.row_base[b][:, None] + g.var_idx[b]]


def factor_flags(g: GenericGroup, b: int, flags: torch.Tensor
                 ) -> torch.Tensor:
    """[k*Fs] True where a factor's scope has a flagged variable in its
    shard's view of ``flags`` ([k, V] bool; the phantom is False)."""
    ext = torch.cat([flags, flags.new_zeros((g.k, 1))], dim=1)
    return ext.reshape(-1)[g.row_base[b][:, None] + g.var_idx[b]].any(
        dim=1)


def cur_best_gain(tables: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                  prefer_change: bool):
    """``gains_and_best`` over views: (cur, best int32, gain) [k, V] from
    tables [k, V, D] at ``x`` [k, V]."""
    xl = x.long()[..., None]
    cur = tables.gather(-1, xl)[..., 0]
    pick = tables
    if prefer_change:
        pick = tables + torch.zeros_like(tables).scatter_(-1, xl, 1e-6)
    best = masked_argmin(pick, mask)
    gain = cur - tables.gather(-1, best[..., None])[..., 0]
    return cur, best.to(torch.int32), torch.clamp_min(gain, 0.0)


@dataclasses.dataclass
class PairBlocks:
    """A group's shards' directed neighbour pairs, flat: ``src``/``dst``
    [k*P] the variables, ``src_flat`` / ``dst_seg`` their rows in the
    shards' [V+1] views (``k * (V+1) + var``)."""

    src: torch.Tensor
    src_flat: torch.Tensor
    dst_seg: torch.Tensor
    n: int  # k * (V + 1)


def pair_blocks(g: GenericGroup, src: np.ndarray,
                dst: np.ndarray) -> PairBlocks:
    P = src.shape[1]
    base = np.repeat(np.arange(g.k) * (g.V + 1), P)
    s = src[list(g.index)].reshape(-1)
    t = dst[list(g.index)].reshape(-1)
    i64 = dict(dtype=torch.long, device=g.device)
    return PairBlocks(src=torch.as_tensor(s, **i64),
                      src_flat=torch.as_tensor(base + s, **i64),
                      dst_seg=torch.as_tensor(base + t, **i64),
                      n=g.k * (g.V + 1))


def neighbour_max_part(g: GenericGroup, pb: PairBlocks,
                       gain: torch.Tensor) -> torch.Tensor:
    """[k, V+1] each shard's partial neighbourhood max of ``gain``
    ([k, V] views) over its own pairs (-inf where none)."""
    ext = torch.cat([gain, gain.new_zeros((g.k, 1))], dim=1).reshape(-1)
    return g.rows(segment_max(ext[pb.src_flat], pb.dst_seg, pb.n))


def tiebreak_part(g: GenericGroup, pb: PairBlocks, gain: torch.Tensor,
                  neigh_max: torch.Tensor) -> torch.Tensor:
    """[k, V+1] int64 each shard's partial smallest neighbour index at
    the combined neighbourhood max (V where none at it)."""
    ext = torch.cat([gain, gain.new_zeros((g.k, 1))], dim=1).reshape(-1)
    nm = torch.cat([neigh_max, neigh_max.new_zeros((g.k, 1))],
                   dim=1).reshape(-1)
    at_max = ext[pb.src_flat] >= nm[pb.dst_seg] - 1e-9
    cand = torch.where(at_max, pb.src, torch.full_like(pb.src, g.V))
    return g.rows(segment_min(cand, pb.dst_seg, pb.n))


def mgm_move(gain: torch.Tensor, neigh_max: torch.Tensor,
             idx_at_max: torch.Tensor) -> torch.Tensor:
    """MGM's decision from the combined neighbourhood max and tie-break
    index (``neighborhood_winner`` semantics)."""
    me = torch.arange(gain.shape[-1], device=gain.device)
    return (gain > 0) & (
        (gain > neigh_max + 1e-9)
        | (((gain - neigh_max).abs() <= 1e-9) & (me < idx_at_max)))


def masked_tables(g: GenericGroup, total: torch.Tensor,
                  include_unary: bool = True) -> torch.Tensor:
    """``where(mask, unary + total[:V], PAD_COST)`` per view."""
    t = total[:, :g.V]
    t = (g.unary + t) if include_unary else (0.0 + t)
    return torch.where(g.mask > 0, t, PAD_COST)

