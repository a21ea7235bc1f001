"""BatchEngine — many instances solved together, a bucket at a time.

The port of the JAX package's ``batch/engine.py``.  There, B same-shaped
instances are one cycle program ``jax.vmap``-ed over stacked ``[B, ...]``
arrays.  Here a bucket is ONE graph, the disjoint union of its B padded
instances: lane ``l``'s variables, factors and neighbour pairs are its
own, their indices offset by ``l`` times the padded size, and the port's
generic cycle (``ops/maxsum_kernels.py::maxsum_cycle``,
``algorithms/{mgm,dsa,adsa,gdba}.py``) runs once over the union.  The
per-lane freeze masks, convergence and finiteness come from ``[B, Vp]``
and per-bucket ``[B, Fp·a, D]`` views of the union's arrays.

Bit-identity with the sequential solves is the contract
(``tests/test_torch_batch.py``, ``chip_smoke.py`` phase ``batch``):

* **the sums keep their order**: every sum of the generic cycles is an
  ordered segment sum (``ops/segments.py``) that adds a segment's rows
  in ascending row order from 0.  In the union a segment (a variable)
  has the same rows in the same order as in its lane alone, padded
  factors come after a lane's real ones, and the bucket's rank tables
  (:class:`RankTable`) add them in that order;
* **randomness is drawn at each instance's true shape**: each lane's
  solver is built on the host at its true shape, the port's solver of
  the sequential solve, with ``use_packed=False``: maxsum's noise
  (``seed + 1``), the initial values (``seed + 17``) and the DSA/A-DSA
  coins (``seed``, per chunk, at the harness's chunk policy
  :func:`~pydcop_tpu_torch.algorithms.base.default_chunk`) come from its
  CPU ``torch.Generator``s, and the coins are padded with 1.0 (never
  activate), as the JAX package's ``_pad_xs``;
* **padding is inert by routing**: padded variables have one valid
  value and no factors; padded factors hold all-zero cost tables and
  point every position at a reserved dummy variable (a serve lane's
  spread over all its padded variables); padded neighbour pairs join
  the dummy to itself;
* **convergence is the harness's**: per lane, at chunk boundaries, the
  same prime chunk and two-stable-chunks rule; a converged lane is
  frozen (its state no longer changes) and the bucket stops once every
  lane has converged or the cycle limit is reached.  The ``[2, B]``
  flags (convergence, finiteness) are the one device→host read a chunk.

Each bucket runs ONE fixed-shape runner (:class:`BucketRunner`), kept in
the runner cache (:mod:`pydcop_tpu_torch.batch.cache`) by
:func:`runner_cache_key`: its chunk is the harness's
:class:`~pydcop_tpu_torch.algorithms.capture.ChunkRunner` over the union
(a tail chunk freezes its surplus cycles), captured as a CUDA graph on
the card at its second call (:data:`WARMUP_CALLS`) and replayed after;
on the CPU it runs eagerly.  A runner holds the union's arrays in
buffers of the bucket's shape, and a later bucket of that shape copies
its own arrays in, so a repeat sweep replays the graph.  The rank
tables' depth (a segment's largest row count) is the one dimension that
depends on the data: a bucket deeper than the runner's tables grows
them and starts a new graph (``regrows``).

The serve scheduler (:mod:`pydcop_tpu_torch.serve.scheduler`) keeps a
runner's bucket open: a call takes a per-lane cycle count (a ``[B]``
count of cycles left rides the chunk's state beside ``done``, so lane
``i`` runs its own ``n_i`` cycles of the chunk and then freezes), each
lane draws its own coins (:meth:`_AdapterBase.chunk_coins_per_lane`,
idle lanes none), and one lane's arrays are written into the buffers in
place (:meth:`BucketRunner.load_lane`, rows and rank-table columns).
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import (
    DEFAULT_INFINITY,
    AlgorithmDef,
    load_algorithm_module,
)
from pydcop_tpu_torch.algorithms.base import (
    MAX_CYCLES,
    STABLE_CHUNKS,
    SolveResult,
    default_chunk,
)
from pydcop_tpu_torch.algorithms.capture import ChunkRunner
from pydcop_tpu_torch.batch.bucketing import (
    BucketPlan,
    InstanceDims,
    dims_of,
    plan_buckets,
)
from pydcop_tpu_torch.batch.cache import (
    CompileCache,
    global_compile_cache,
    refuse_persistent_cache,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    ConstraintGraphTensors,
    FactorBucket,
    FactorGraphTensors,
)
from pydcop_tpu_torch.runtime.events import send_batch
from pydcop_tpu_torch.runtime.stats import BatchCounters

#: algorithms with a batched engine; anything else is solved
#: sequentially by the fallback path (counted, never silently dropped)
SUPPORTED_ALGOS = ("maxsum", "mgm", "dsa", "adsa", "gdba")

#: default cycle ceiling for run-to-convergence: the harness's
DEFAULT_MAX_CYCLES = MAX_CYCLES

#: eager calls of a bucket runner on CUDA before it captures its chunk:
#: one warm-up (the runner is kept across solves, so a repeat sweep's
#: first chunk already replays)
WARMUP_CALLS = 1


@dataclasses.dataclass
class BatchItem:
    """One solve request: a problem plus how to solve it."""

    dcop: DCOP
    algo: Union[str, AlgorithmDef]
    algo_params: Optional[Dict[str, Any]] = None
    seed: int = 0
    label: Optional[str] = None

    def algo_def(self) -> AlgorithmDef:
        if isinstance(self.algo, AlgorithmDef):
            return self.algo
        return AlgorithmDef.build_with_default_params(
            self.algo, self.algo_params or {}, mode=self.dcop.objective
        )


@dataclasses.dataclass
class _Spec:
    """One compiled instance inside a group."""

    item: BatchItem
    solver: Any
    tensors: Any  # the solver's (possibly noise-adjusted) tensor graph
    dims: InstanceDims


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def pad_instance(tensors, target: InstanceDims,
                 spread: bool = False) -> Dict[str, np.ndarray]:
    """Pad one compiled instance's arrays to the bucket target shape
    (numpy, the JAX package's arrays and names).  Padding is inert by
    construction — see the module docstring.  Padded factor positions
    and pairs go to the dummy variable ``Vp - 1``; with ``spread`` (the
    serve path's lanes) they go round-robin over the padded variables
    ``V .. Vp-1`` instead, so no padded variable's segment, and so no
    rank table of the union, is as deep as the instance's padding."""
    V, D = tensors.n_vars, tensors.max_domain_size
    Vp, Dp = target.V, target.D
    pad_vars = Vp - V if spread and V < Vp else 1
    routed = 0  # padded positions routed so far

    def route(n: int) -> np.ndarray:
        # the next n padded positions' variables
        nonlocal routed
        out = (Vp - pad_vars + (routed + np.arange(n)) % pad_vars)
        routed += n
        return out.astype(np.int32)

    mask = np.zeros((Vp, Dp), np.float32)
    mask[:V, :D] = _host(tensors.domain_mask)
    mask[V:, 0] = 1.0  # padded vars: one valid value
    unary = np.full((Vp, Dp), PAD_COST, np.float32)
    unary[:V, :D] = _host(tensors.unary_costs)
    unary[V:, 0] = 0.0
    arr: Dict[str, np.ndarray] = {"mask": mask, "unary": unary}

    ev_parts: List[np.ndarray] = []
    for i, (a, fp) in enumerate(zip(target.arities, target.F)):
        b = tensors.buckets[i]
        F = b.n_factors
        t = np.full((fp,) + (Dp,) * a, PAD_COST, np.float32)
        t[(slice(0, F),) + (slice(0, D),) * a] = _host(b.tensors)
        # padded factors: zero costs routed at padded vars — zero
        # messages / zero table rows, landing on padded vars only
        t[F:] = 0.0
        vi = np.empty((fp, a), np.int32)
        vi[:F] = b.var_idx
        # column by column: each position's rank table stays shallow
        vi[F:] = route((fp - F) * a).reshape(a, fp - F).T
        arr[f"bt{i}"] = t
        arr[f"bv{i}"] = vi
        ev_parts.append(vi.reshape(-1))
    arr["edge_var"] = (
        np.concatenate(ev_parts) if ev_parts else np.zeros(0, np.int32)
    )

    if target.graph_type == "constraints_hypergraph":
        src = _host(tensors.neighbor_src)
        dst = _host(tensors.neighbor_dst)
        M = src.shape[0]
        nsrc = np.empty(target.M, np.int32)
        ndst = np.empty(target.M, np.int32)
        nsrc[:M] = src
        ndst[:M] = dst
        # a padded pair joins a padded variable to itself
        nsrc[M:] = ndst[M:] = route(target.M - M)
        arr["nsrc"] = nsrc
        arr["ndst"] = ndst
    return arr


def pad_vec(x: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad a per-variable (or per-factor) array to ``n`` rows."""
    x = np.asarray(x)
    if x.shape[0] == n:
        return x
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


@dataclasses.dataclass(frozen=True)
class BucketMeta:
    """Static shape of a bucket's instances."""

    graph_type: str
    V: int
    D: int
    arities: Tuple[int, ...]
    F: Tuple[int, ...]

    @classmethod
    def of(cls, target: InstanceDims) -> "BucketMeta":
        return cls(target.graph_type, target.V, target.D,
                   target.arities, target.F)


# ---------------------------------------------------------------------------
# the union layout: B padded lanes as one graph
# ---------------------------------------------------------------------------


def rank_block(ids: np.ndarray, rows: np.ndarray, num_segments: int,
               sentinel: int, depth: int = 0) -> np.ndarray:
    """``[max(depth, ranks), num_segments]`` int64 rank table of the rows
    ``rows`` (ascending row ids) whose segments are ``ids``: entry ``[k,
    s]`` is segment ``s``'s k-th row, or ``sentinel`` when it has
    fewer."""
    ids = np.asarray(ids, dtype=np.int64)
    counts = np.bincount(ids, minlength=num_segments)
    R = max(int(counts.max(initial=0)), depth, 1)
    order = np.argsort(ids, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(ids.shape[0], dtype=np.int64)
    rank[order] = np.arange(ids.shape[0]) - start[ids[order]]
    table = np.full((R, num_segments), sentinel, np.int64)
    table[rank, ids] = rows
    return table


class RankTable:
    """The ordered segment sum of
    :class:`~pydcop_tpu_torch.ops.segments.SegmentPlan` at a fixed shape:
    ``table[k, s]`` is the id of segment ``s``'s k-th row (ascending), or
    the sentinel ``n_rows`` (a zero row) when it has fewer; :meth:`sum`
    adds rank by rank from 0, so every segment gets ``((0 + row_0) +
    row_1) + ...`` as the plan's ``index_add_`` gives it (an added 0.0
    changes no sum that starts from +0.0).  The table is a
    buffer: a bucket of the same shape copies its own in, a serve lane
    writes its columns (:meth:`_Union.load_lane`), and a captured graph
    reads it.  ``depth`` is the least rank count to allocate."""

    def __init__(self, segment_ids: np.ndarray, num_segments: int,
                 device: torch.device, depth: int = 0):
        self.num_segments = int(num_segments)
        self.n_rows = int(segment_ids.shape[0])
        host = self.host_table(segment_ids, depth)
        self.table = torch.as_tensor(host, device=device)

    def host_table(self, segment_ids: np.ndarray,
                   depth: int = 0) -> np.ndarray:
        """``[max(depth, ranks), num_segments]`` int64 rank table."""
        return rank_block(segment_ids, np.arange(self.n_rows),
                          self.num_segments, self.n_rows, depth)

    @property
    def depth(self) -> int:
        return int(self.table.shape[0])

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if data.shape[0] != self.n_rows:
            raise ValueError(
                f"data has {data.shape[0]} rows, the table {self.n_rows}")
        ext = torch.cat([data, data.new_zeros((1,) + tuple(data.shape[1:]))])
        out = data.new_zeros((self.num_segments,) + tuple(data.shape[1:]))
        for k in range(self.depth):
            out = out + ext.index_select(0, self.table[k])
        return out


class _Layout:
    """Where each lane's rows sit in the union.  Variables and each
    bucket's factors are lane-major (lane l's padded block at ``l·Vp`` /
    ``l·Fp``); edges are bucket-major as in a compiled graph, lane-major
    within a bucket.  A state leaf is of kind ``"var"``, ``"edge"`` or
    ``("factor", i)``."""

    def __init__(self, meta: BucketMeta, B: int, device: torch.device):
        self.B, self.Vp, self.F = B, meta.V, meta.F
        #: each bucket's edges a lane, and where the bucket starts in the
        #: union's edge axis
        self.lane_edges = [f * a for f, a in zip(meta.F, meta.arities)]
        self.edge_start = np.concatenate(
            [[0], np.cumsum([B * e for e in self.lane_edges])]).astype(int)
        lanes = torch.arange(B, device=device)
        self._lane_of = {
            "var": lanes.repeat_interleave(self.Vp),
            "edge": torch.cat([lanes.repeat_interleave(e)
                               for e in self.lane_edges])
            if self.lane_edges else lanes[:0],
        }
        for i, f in enumerate(self.F):
            self._lane_of["factor", i] = lanes.repeat_interleave(f)

    def lane_of(self, kind) -> torch.Tensor:
        """[rows] lane of each union row of a leaf of ``kind``."""
        return self._lane_of[kind]

    def stack(self, kind, leaves: Sequence[np.ndarray]) -> np.ndarray:
        """The union array of one leaf from the B lanes' padded arrays."""
        if kind != "edge":
            return np.concatenate(leaves)
        lane_start = np.concatenate([[0], np.cumsum(self.lane_edges)])
        return np.concatenate([
            leaf[lane_start[i]:lane_start[i + 1]]
            for i in range(len(self.lane_edges)) for leaf in leaves])

    def spans(self, kind, lane: int) -> List[Tuple[int, int]]:
        """The ``(start, stop)`` union rows of lane ``lane`` in a leaf of
        ``kind``, in the lane's own padded order."""
        if kind == "var":
            return [(lane * self.Vp, (lane + 1) * self.Vp)]
        if kind == "edge":
            return [(int(s) + lane * e, int(s) + (lane + 1) * e)
                    for s, e in zip(self.edge_start, self.lane_edges)]
        f = self.F[kind[1]]
        return [(lane * f, (lane + 1) * f)]

    def lane(self, kind, union: torch.Tensor, lane: int) -> torch.Tensor:
        """Lane ``lane``'s rows of a union leaf, in its padded layout."""
        spans = self.spans(kind, lane)
        if len(spans) == 1:
            a, b = spans[0]
            return union[a:b]
        return torch.cat([union[a:b] for a, b in spans])

    def write(self, kind, union: torch.Tensor, lane: int, data) -> None:
        """Copy lane ``lane``'s rows (``data``, in its padded layout) into
        a union leaf in place."""
        data = torch.as_tensor(np.ascontiguousarray(data)) \
            if not torch.is_tensor(data) else data
        off = 0
        for a, b in self.spans(kind, lane):
            union[a:b].copy_(data[off:off + b - a])
            off += b - a

    def fill(self, kind, union: torch.Tensor, lane: int, value) -> None:
        """Fill lane ``lane``'s rows of a union leaf in place."""
        for a, b in self.spans(kind, lane):
            union[a:b].fill_(value)

    def lane_all(self, kind, rows: torch.Tensor) -> torch.Tensor:
        """[B] bool: every row of the lane is True (``rows`` [rows])."""
        B = self.B
        if kind != "edge":
            return rows.view(B, -1).all(dim=1)
        out = torch.ones(B, dtype=torch.bool, device=rows.device)
        for s, e in zip(self.edge_start, self.lane_edges):
            if e:
                out = out & rows[s:s + B * e].view(B, e).all(dim=1)
        return out


def _union_fields(meta: BucketMeta, layout: _Layout,
                  arrays: Sequence[Dict[str, np.ndarray]]):
    """The union's numpy arrays from the lanes' padded ones: offset
    variable indices, lane-major blocks, edges bucket-major."""
    B, Vp = layout.B, meta.V
    off = (np.arange(B, dtype=np.int64) * Vp)
    out = {
        "mask": np.concatenate([a["mask"] for a in arrays]),
        "unary": np.concatenate([a["unary"] for a in arrays]),
    }
    ev = []
    for i in range(len(meta.arities)):
        out[f"bt{i}"] = np.concatenate([a[f"bt{i}"] for a in arrays])
        vi = np.concatenate([a[f"bv{i}"].astype(np.int64) + o
                             for a, o in zip(arrays, off)])
        out[f"bv{i}"] = vi
        ev.append(vi.reshape(-1))
    out["edge_var"] = (np.concatenate(ev) if ev
                       else np.zeros(0, np.int64))
    if meta.graph_type == "constraints_hypergraph":
        for k in ("nsrc", "ndst"):
            out[k] = np.concatenate([a[k].astype(np.int64) + o
                                     for a, o in zip(arrays, off)])
    for k in arrays[0]:
        if k.startswith("x:"):
            out[k] = np.concatenate([a[k] for a in arrays])
    return out


class _Union:
    """A bucket's union graph on the device, in buffers of the bucket's
    shape: the compiled-graph dataclass the generic cycles run on, its
    index tensors and rank tables (pre-set in the caches
    ``ops/compile.py`` keeps on a graph, so the cycles build none), and
    the adapter's extra (``x:``) arrays."""

    def __init__(self, meta: BucketMeta, B: int, fields, device,
                 depths: Optional[Dict[Tuple[str, Optional[int]], int]]
                 = None):
        put = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=dt, device=device)
        depths = depths or {}
        Vu = B * meta.V
        self.layout = _Layout(meta, B, device)
        #: (rank table, field, column or None) of every ordered sum
        self.tables: List[Tuple[RankTable, str, Optional[int]]] = []
        #: each bucket's [F, a] index tensor and its columns
        self.index = []
        buckets = []
        off = 0
        for i, (a, f) in enumerate(zip(meta.arities, meta.F)):
            vi = fields[f"bv{i}"]
            b = FactorBucket(
                arity=a, tensors=put(fields[f"bt{i}"], torch.float32),
                var_idx=np.zeros((B * f, a), np.int32),
                factor_ids=np.arange(B * f, dtype=np.int32),
                edge_offset=off)
            vi_t = put(vi, torch.int64)
            dev = vi_t.device
            self.index.append((vi_t, [vi_t[:, p].contiguous()
                                      for p in range(a)]))
            b.__dict__["_index"] = {dev: self.index[-1]}
            if meta.graph_type == "constraints_hypergraph":
                # the local tables' ordered sums, one a scope position
                plans = [RankTable(vi[:, p], Vu, dev,
                                   depths.get((f"bv{i}", p), 0))
                         for p in range(a)]
                b.__dict__["_plans"] = {dev: plans}
                self.tables += [(rt, f"bv{i}", p)
                                for p, rt in enumerate(plans)]
            buckets.append(b)
            off += B * f * a
        common = dict(
            var_names=[""] * Vu,
            domain_values=[()] * Vu,
            domain_sizes=np.ones(Vu, np.int32),
            domain_mask=put(fields["mask"], torch.float32),
            unary_costs=put(fields["unary"], torch.float32),
            buckets=buckets,
            edge_var=put(fields["edge_var"], torch.int64),
            factor_names=[""] * (B * sum(meta.F)),
            sign=1.0,
            initial_values=np.zeros(Vu, np.int32),
            has_initial=np.zeros(Vu, bool),
        )
        if meta.graph_type == "factor_graph":
            t = FactorGraphTensors(**common)
            # the beliefs' ordered sum over the edges
            rt = RankTable(fields["edge_var"], Vu, t.device,
                           depths.get(("edge_var", None), 0))
            t.__dict__["_edge_plan"] = rt
            self.tables.append((rt, "edge_var", None))
        else:
            t = ConstraintGraphTensors(
                **common, neighbor_src=put(fields["nsrc"], torch.int64),
                neighbor_dst=put(fields["ndst"], torch.int64))
        self.t = t
        self.meta = meta
        self.extra = {k: put(v, torch.float32) for k, v in fields.items()
                      if k.startswith("x:")}

    def load(self, fields) -> bool:
        """Copy a bucket of this shape in; False, copying nothing, when a
        rank table is too shallow for it (the caller then rebuilds)."""
        tables = []
        for rt, name, p in self.tables:
            col = fields[name] if p is None else fields[name][:, p]
            host = rt.host_table(col, rt.depth)
            if host.shape[0] > rt.depth:
                return False
            tables.append((rt.table, host))
        t = self.t
        pairs = [(t.domain_mask, fields["mask"]),
                 (t.unary_costs, fields["unary"]),
                 (t.edge_var, fields["edge_var"]), *tables]
        for i, b in enumerate(t.buckets):
            pairs += [(b.tensors, fields[f"bt{i}"]),
                      (self.index[i][0], fields[f"bv{i}"])]
        if isinstance(t, ConstraintGraphTensors):
            pairs += [(t.neighbor_src, fields["nsrc"]),
                      (t.neighbor_dst, fields["ndst"])]
        pairs += [(buf, fields[k]) for k, buf in self.extra.items()]
        for dst, a in pairs:
            dst.copy_(torch.as_tensor(np.ascontiguousarray(a)))
        for vi_t, cols in self.index:
            for p, c in enumerate(cols):
                c.copy_(vi_t[:, p])
        return True

    def depths(self) -> Dict[Tuple[str, Optional[int]], int]:
        """Each rank table's depth, by ``(field, column)``."""
        return {(name, p): rt.depth for rt, name, p in self.tables}

    def _lane_rows(self, name: str, lane: int) -> np.ndarray:
        """The union rows of lane ``lane`` in the rows of the table over
        ``name``, in the lane's own row order (ascending)."""
        lay = self.layout
        if name == "edge_var":
            return np.concatenate(
                [np.arange(a, b) for a, b in lay.spans("edge", lane)]
                or [np.zeros(0, np.int64)])
        f = lay.F[int(name[2:])]
        return np.arange(lane * f, (lane + 1) * f)

    def lane_blocks(self, lane: int, arrays) -> Optional[List[np.ndarray]]:
        """Lane ``lane``'s columns of every rank table for its padded
        ``arrays`` (lane-local variable ids), or None when a table is too
        shallow for them."""
        Vp = self.meta.V
        out = []
        for rt, name, p in self.tables:
            ids = arrays[name] if p is None else arrays[name][:, p]
            block = rank_block(np.asarray(ids).reshape(-1),
                               self._lane_rows(name, lane), Vp, rt.n_rows,
                               rt.depth)
            if block.shape[0] > rt.depth:
                return None
            out.append(block)
        return out

    def load_lane(self, lane: int, arrays) -> bool:
        """Write lane ``lane``'s padded ``arrays`` (lane-local indices, as
        :func:`pad_instance` gives them) into its rows of every field and
        its columns of every rank table, in place in the buffers a
        captured graph reads; False, writing nothing, when a rank table
        is too shallow for the lane (the caller then regrows)."""
        blocks = self.lane_blocks(lane, arrays)
        if blocks is None:
            return False
        lay, t, Vp = self.layout, self.t, self.meta.V
        off = lane * Vp
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a))
        lay.write("var", t.domain_mask, lane, arrays["mask"])
        lay.write("var", t.unary_costs, lane, arrays["unary"])
        lay.write("edge", t.edge_var, lane,
                  as_t(arrays["edge_var"]).to(torch.int64) + off)
        for i, b in enumerate(t.buckets):
            kind = ("factor", i)
            lay.write(kind, b.tensors, lane, arrays[f"bt{i}"])
            vi = as_t(arrays[f"bv{i}"]).to(torch.int64) + off
            vi_t, cols = self.index[i]
            lay.write(kind, vi_t, lane, vi)
            for p, c in enumerate(cols):
                lay.write(kind, c, lane, vi[:, p].contiguous())
        if isinstance(t, ConstraintGraphTensors):
            M = int(np.asarray(arrays["nsrc"]).shape[0])
            for buf, k in ((t.neighbor_src, "nsrc"),
                           (t.neighbor_dst, "ndst")):
                buf[lane * M:(lane + 1) * M].copy_(
                    as_t(arrays[k]).to(torch.int64) + off)
        for k, buf in self.extra.items():
            a = np.asarray(arrays[k])
            n = a.shape[0]
            buf[lane * n:(lane + 1) * n].copy_(as_t(a))
        for (rt, _name, _p), block in zip(self.tables, blocks):
            rt.table[:, off:off + Vp].copy_(as_t(block))
        return True


# ---------------------------------------------------------------------------
# per-algorithm adapters
# ---------------------------------------------------------------------------


class _AdapterBase:
    """What the engine needs to batch one algorithm family.  A state is
    a flat tuple of leaves whose kinds are :meth:`leaf_kinds`."""

    algo: str = ""
    graph_type = "constraints_hypergraph"
    #: index of the value leaf in the state
    values_leaf = 0

    def build_spec(self, item: BatchItem,
                   compiled: Optional[Dict[int, Any]] = None) -> _Spec:
        """The instance compiled and its solver built on the host, at its
        true shape (``use_packed=False``: the generic engine).  Items
        that share one DCOP object (a problem solved at several seeds)
        share its compiled graph through ``compiled`` (by object id,
        within one :meth:`BatchEngine.solve` call)."""
        from pydcop_tpu_torch.ops.compile import (
            compile_constraint_graph,
            compile_factor_graph,
        )

        compiled = {} if compiled is None else compiled
        tensors = compiled.get(id(item.dcop))
        if tensors is None:
            compile_fn = (compile_factor_graph
                          if self.graph_type == "factor_graph"
                          else compile_constraint_graph)
            tensors = compiled[id(item.dcop)] = compile_fn(item.dcop,
                                                           device="cpu")
        solver = self.make_solver(item, tensors)
        return _Spec(item, solver, solver.tensors,
                     dims_of(solver.tensors, self.graph_type))

    def make_solver(self, item: BatchItem, tensors):
        raise NotImplementedError

    def leaf_kinds(self, meta: BucketMeta) -> List[Any]:
        return ["var"]

    def extra_arrays(self, spec: _Spec, target: InstanceDims
                     ) -> Dict[str, np.ndarray]:
        """Per-instance arrays besides the graph (``x:`` names)."""
        return {}

    def lane_arrays(self, spec: _Spec, target: InstanceDims,
                    spread: bool = False) -> Dict[str, np.ndarray]:
        """The lane's padded arrays: the graph's and the extra ones
        (``spread``: see :func:`pad_instance`)."""
        return {**pad_instance(spec.tensors, target, spread),
                **self.extra_arrays(spec, target)}

    def idle_arrays(self, target: InstanceDims) -> Dict[str, np.ndarray]:
        """An idle lane's arrays (a serve bucket's free lanes): one valid
        value a variable, zero costs, each factor position on its own
        variable in turn (so the rank tables stay shallow), the pairs on
        variable 0.  Idle lanes are frozen; this keeps their cycles
        finite."""
        Vp, Dp = target.V, target.D
        mask = np.zeros((Vp, Dp), np.float32)
        mask[:, 0] = 1.0
        arr = {"mask": mask, "unary": np.zeros((Vp, Dp), np.float32)}
        ev = []
        for i, (a, f) in enumerate(zip(target.arities, target.F)):
            arr[f"bt{i}"] = np.zeros((f,) + (Dp,) * a, np.float32)
            vi = (np.arange(f * a) % Vp).astype(np.int32).reshape(f, a)
            arr[f"bv{i}"] = vi
            ev.append(vi.reshape(-1))
        arr["edge_var"] = (np.concatenate(ev) if ev
                           else np.zeros(0, np.int32))
        if target.graph_type == "constraints_hypergraph":
            arr["nsrc"] = np.zeros(target.M, np.int32)
            arr["ndst"] = np.zeros(target.M, np.int32)
        return arr

    def initial_leaves(self, spec: _Spec, target: InstanceDims
                       ) -> List[np.ndarray]:
        """The lane's padded initial state, from its own solver at its
        TRUE shape."""
        (x,) = spec.solver.initial_state()
        return [pad_vec(_host(x), target.V, 0).astype(np.int32)]

    def idle_leaves(self, target: InstanceDims) -> List[np.ndarray]:
        """An idle lane's state leaves (zeros, the initial leaves'
        shapes and dtypes)."""
        return [np.zeros(target.V, np.int32)]

    def lane_generators(self, spec: _Spec) -> Tuple[torch.Generator, ...]:
        """The generators a lane draws its coins from: its solver's (the
        lane's stream, which a serve checkpoint stores and a merge moves
        with the lane); empty when the algorithm draws none."""
        return ()

    def make_cycle(self, params: Dict[str, Any]):
        """cycle(union, leaves, coins) -> leaves, one cycle of every lane
        over the union graph."""
        raise NotImplementedError

    def chunk_coins(self, specs: Sequence[_Spec], n: int,
                    target: InstanceDims) -> Tuple[torch.Tensor, ...]:
        """The next ``n`` cycles' coins of every lane: each lane's solver
        draws its own at its true V (``draw_chunk_coins``), padded with
        1.0 to Vp and laid lane-major: a tuple of ``[n, B·Vp]`` CPU
        tensors (empty when the algorithm draws none)."""
        return self.chunk_coins_per_lane(specs, [n] * len(specs), target, n)

    def chunk_coins_per_lane(self, specs: Sequence[Optional[_Spec]],
                             ns: Sequence[int], target: InstanceDims,
                             chunk: int) -> Tuple[torch.Tensor, ...]:
        """Per-lane :meth:`chunk_coins` for the serve scheduler (the JAX
        package's ``chunk_xs_per_lane``): lane ``i``'s solver draws its
        own ``ns[i]`` cycles at its true V, padded with 1.0 to Vp and to
        ``chunk`` rows; an idle lane (``specs[i]`` None or ``ns[i] <=
        0``) draws nothing, so its generator does not advance, and gives
        all-ones rows.  A tuple of ``[chunk, B·Vp]`` CPU tensors, empty
        when the algorithm draws none."""
        return ()

    def make_converged(self, params: Dict[str, Any], layout: _Layout):
        """conv(prev, cur) -> [B] bool, the sequential solver's
        ``chunk_converged_device`` lane by lane: the assignment did not
        change."""
        v = self.values_leaf

        def conv(prev, cur):
            return layout.lane_all("var", prev[v] == cur[v])

        return conv


class _LocalSearchAdapter(_AdapterBase):
    """mgm / dsa / adsa — state = (x,)."""

    def __init__(self, algo: str):
        self.algo = algo

    def solver_class(self):
        mod = load_algorithm_module(self.algo)
        return getattr(mod, {"mgm": "MgmSolver", "dsa": "DsaSolver",
                             "adsa": "ADsaSolver"}[self.algo])

    def make_solver(self, item, tensors):
        return self.solver_class()(item.dcop, tensors, item.algo_def(),
                                   seed=item.seed, use_packed=False)

    def make_cycle(self, params):
        if self.algo == "mgm":
            from pydcop_tpu_torch.algorithms.mgm import mgm_cycle

            def cycle(u, st, coins):
                return (mgm_cycle(u.t, st[0]),)
        elif self.algo == "dsa":
            from pydcop_tpu_torch.algorithms.dsa import dsa_cycle

            p = float(params.get("probability", 0.7))
            variant = params.get("variant", "B")

            def cycle(u, st, coins):
                return (dsa_cycle(u.t, st[0], coins[0], p, variant),)
        else:  # adsa
            from pydcop_tpu_torch.algorithms.adsa import adsa_cycle

            p = float(params.get("probability", 0.7))
            variant = params.get("variant", "B")
            act = float(params.get("activation", 0.5))

            def cycle(u, st, coins):
                wake, move = coins
                return (adsa_cycle(u.t, st[0], wake, move, p, variant,
                                   act),)
        return cycle

    def lane_generators(self, spec):
        return () if self.algo == "mgm" else (spec.solver.coins,)

    def chunk_coins_per_lane(self, specs, ns, target, chunk):
        if self.algo == "mgm":
            return ()
        Vp = target.V
        # the coin arrays a cycle draws, as the solver's draw_chunk_coins
        k = 2 if self.solver_class().wake_coins else 1
        out = [torch.ones((chunk, len(specs) * Vp), dtype=torch.float32)
               for _ in range(k)]
        for i, (spec, n) in enumerate(zip(specs, ns)):
            if spec is None or int(n) <= 0:
                continue
            for c, d in zip(out, spec.solver.draw_chunk_coins(int(n))):
                c[:int(n), i * Vp:i * Vp + d.shape[1]] = d
        return tuple(out)


class _GdbaAdapter(_AdapterBase):
    """gdba — state = (x, one weight tensor per bucket)."""

    algo = "gdba"

    def make_solver(self, item, tensors):
        from pydcop_tpu_torch.algorithms.gdba import GdbaSolver

        return GdbaSolver(item.dcop, tensors, item.algo_def(),
                          seed=item.seed)

    def leaf_kinds(self, meta):
        return ["var"] + [("factor", i) for i in range(len(meta.F))]

    def extra_arrays(self, spec, target):
        out = {}
        for i, fp in enumerate(target.F):
            for name, vals in (("fmin", spec.solver._fmin),
                               ("fmax", spec.solver._fmax)):
                out[f"x:{name}{i}"] = pad_vec(
                    _host(vals[i]), fp, 0.0).astype(np.float32)
        return out

    def idle_arrays(self, target):
        return {**super().idle_arrays(target),
                **{f"x:{name}{i}": np.zeros(fp, np.float32)
                   for i, fp in enumerate(target.F)
                   for name in ("fmin", "fmax")}}

    def idle_leaves(self, target):
        return [np.zeros(target.V, np.int32)] + [
            np.zeros((fp,) + (target.D,) * a, np.float32)
            for a, fp in zip(target.arities, target.F)]

    def initial_leaves(self, spec, target):
        x, ws = spec.solver.initial_state()
        init = 0.0 if spec.solver.modifier == "A" else 1.0
        out = [pad_vec(_host(x), target.V, 0).astype(np.int32)]
        for i, (a, fp) in enumerate(zip(target.arities, target.F)):
            w = np.full((fp,) + (target.D,) * a, init, np.float32)
            true = _host(ws[i])
            w[(slice(0, true.shape[0]),)
              + (slice(0, true.shape[1]),) * a] = true
            out.append(w)
        return out

    def make_cycle(self, params):
        from pydcop_tpu_torch.algorithms.gdba import gdba_cycle

        modifier = params.get("modifier", "A")
        violation = params.get("violation", "NZ")
        increase_mode = params.get("increase_mode", "E")

        def cycle(u, st, coins):
            n = len(u.t.buckets)
            fmins = [u.extra[f"x:fmin{i}"] for i in range(n)]
            fmaxs = [u.extra[f"x:fmax{i}"] for i in range(n)]
            x, ws = gdba_cycle(u.t, st[0], st[1:], fmins, fmaxs, modifier,
                               violation, increase_mode)
            return (x, *ws)

        return cycle


class _MaxSumAdapter(_AdapterBase):
    """maxsum — state = (q, r, values)."""

    algo = "maxsum"
    graph_type = "factor_graph"
    values_leaf = 2

    def make_solver(self, item, tensors):
        from pydcop_tpu_torch.algorithms.maxsum import MaxSumSolver

        # use_packed=False: the generic cycle; the solver bakes the
        # symmetry-breaking noise into the unary costs at the instance's
        # TRUE shape
        return MaxSumSolver(item.dcop, tensors, item.algo_def(),
                            seed=item.seed, use_packed=False)

    def leaf_kinds(self, meta):
        return ["edge", "edge", "var"]

    def initial_leaves(self, spec, target):
        _, _, values = spec.solver.initial_state()
        Ep = sum(f * a for f, a in zip(target.F, target.arities))
        # messages start at zero: fresh zeros at the padded layout
        z = np.zeros((Ep, target.D), np.float32)
        return [z, z.copy(),
                pad_vec(_host(values), target.V, 0).astype(np.int64)]

    def idle_leaves(self, target):
        Ep = sum(f * a for f, a in zip(target.F, target.arities))
        z = np.zeros((Ep, target.D), np.float32)
        return [z, z.copy(), np.zeros(target.V, np.int64)]

    def make_cycle(self, params):
        from pydcop_tpu_torch.ops.maxsum_kernels import maxsum_cycle

        damping = params.get("damping")
        damping = 0.5 if damping is None else float(damping)

        def cycle(u, st, coins):
            q, r, _ = st
            q2, r2, _beliefs, values = maxsum_cycle(u.t, q, r,
                                                    damping=damping)
            return (q2, r2, values)

        return cycle

    def make_converged(self, params, layout):
        from pydcop_tpu_torch.algorithms.maxsum import messages_stable

        # the reference's message-stability coefficient; padded message
        # rows are zeros on both sides and always compare stable
        stability = float(params.get("stability", 0.1))

        def conv(prev, cur):
            same = layout.lane_all("var", prev[2] == cur[2])
            stable = messages_stable(prev[1], cur[1], stability)
            return same | layout.lane_all("edge", stable.all(dim=1))

        return conv


def adapter_for(algo: str) -> _AdapterBase:
    """Batching adapter for one algorithm family."""
    if algo in ("mgm", "dsa", "adsa"):
        return _LocalSearchAdapter(algo)
    if algo == "gdba":
        return _GdbaAdapter()
    if algo == "maxsum":
        return _MaxSumAdapter()
    raise KeyError(algo)


# ---------------------------------------------------------------------------
# the bucket runner
# ---------------------------------------------------------------------------


def _params_key(params: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in (params or {}).items()))


def runner_cache_key(algo: str, pkey: Tuple, signature: Tuple, chunk: int,
                     device: torch.device) -> Tuple:
    """Cache key of one bucket runner: the JAX package's (algo, params,
    the bucket's shape signature, chunk) and the device it runs on."""
    return (algo, pkey) + tuple(signature) + ("chunk", chunk, "device",
                                              str(device))


class _BucketProgram:
    """The union's cycle as the solver a
    :class:`~pydcop_tpu_torch.algorithms.capture.ChunkRunner` drives:
    state = (leaves, done [B] bool, left [B] int64); a cycle leaves the
    leaves of a lane that is done or has no cycle left unchanged and
    counts down every other lane's ``left`` (so lane ``i`` runs its own
    ``n_i`` cycles of a chunk, the JAX runner's per-lane ``n_active``),
    and the chunk's "convergence" is the ``[2, B]`` flags (each lane's
    convergence, and its float leaves all finite or the lane done)."""

    def __init__(self, adapter: _AdapterBase, union: _Union,
                 layout: _Layout, params: Dict[str, Any]):
        self.union = union
        self.layout = layout
        self.kinds = adapter.leaf_kinds(union.meta)
        self.cycle = adapter.make_cycle(params)
        self.conv = adapter.make_converged(params, layout)
        self.device = union.t.device
        self.check_chunk_syncs = False

    def resident_leaves(self) -> tuple:
        """None: the union's arrays are graph constants, its state leaves
        the runner's own buffers."""
        return ()

    def step(self, state, coins):
        leaves, done, left = state
        new = self.cycle(self.union, leaves, coins)
        lane_frozen = done | (left <= 0)
        out = []
        for kind, old, cur in zip(self.kinds, leaves, new):
            frozen = lane_frozen[self.layout.lane_of(kind)]
            frozen = frozen.view((-1,) + (1,) * (cur.dim() - 1))
            out.append(torch.where(frozen, old, cur))
        return tuple(out), done, torch.clamp_min(left - 1, 0)

    def chunk_converged_device(self, prev, state):
        leaves, done, _left = state
        conv = self.conv(prev[0], leaves)
        finite = torch.ones_like(done)
        for kind, leaf in zip(self.kinds, leaves):
            if leaf.dtype.is_floating_point:
                rows = torch.isfinite(leaf).reshape(leaf.shape[0], -1)
                finite = finite & self.layout.lane_all(kind, rows.all(dim=1))
        return torch.stack([conv, finite | done])


class BucketRunner:
    """ONE fixed-shape runner per bucket signature and chunk: the union
    of B lanes in buffers of the bucket's shape (:class:`_Union`) and a
    :class:`~pydcop_tpu_torch.algorithms.capture.ChunkRunner` over it.
    :meth:`load` copies a bucket's arrays in and returns its initial
    state; a call ``(state, coins, n)`` runs lane ``i``'s own ``n[i] <=
    chunk`` live cycles, every lane not done, and returns ``(state,
    None, flags [2, B])``.
    Eager on the CPU; on CUDA eager for its first call
    (:data:`WARMUP_CALLS`), then one captured CUDA graph replayed.

    The serve scheduler (:mod:`pydcop_tpu_torch.serve.scheduler`) keeps
    a runner open: :meth:`load_idle` builds the buffers with every lane
    idle, :meth:`load_lane` writes one lane's arrays in place, and
    :meth:`write_lane`/:meth:`read_lane` move a lane's state rows.  A
    runner holds one bucket at a time, so it serves one worker at a
    time (the cache hands it out exclusively,
    :meth:`~pydcop_tpu_torch.batch.cache.CompileCache.checkout`)."""

    def __init__(self, adapter: _AdapterBase, meta: BucketMeta, B: int,
                 params: Dict[str, Any], chunk: int, device: torch.device):
        self.adapter, self.meta, self.B = adapter, meta, B
        self.params, self.chunk, self.device = params, chunk, device
        self.layout = _Layout(meta, B, device)
        self.kinds = adapter.leaf_kinds(meta)
        self.union = None
        self.chunk_runner = None
        #: each lane's padded host arrays: what a regrow rebuilds from
        self.lane_arrays: Optional[List[Dict[str, np.ndarray]]] = None
        self._pending_depths = None
        #: rank tables grown for a deeper bucket (each starts a new graph)
        self.regrows = 0
        self._retired = {"eager_calls": 0, "captures": 0, "replays": 0}

    def calls(self) -> Dict[str, int]:
        """Eager calls, captures and replays of this runner's chunks."""
        out = dict(self._retired)
        if self.chunk_runner is not None:
            for k in out:
                out[k] += getattr(self.chunk_runner, k)
        return out

    def _build(self, fields, depths=None) -> None:
        if self.chunk_runner is not None:
            self._retired = self.calls()
            self.regrows += 1
        self.union = _Union(self.meta, self.B, fields, self.device, depths)
        program = _BucketProgram(self.adapter, self.union, self.layout,
                                 self.params)
        self.chunk_runner = ChunkRunner(program, self.chunk, False,
                                        warmup=WARMUP_CALLS)

    def load(self, specs: Sequence[_Spec], target: InstanceDims):
        """Copy the bucket's arrays in (building the buffers at the first
        bucket, or deeper rank tables); returns its initial state."""
        arrays = [self.adapter.lane_arrays(s, target) for s in specs]
        fields = _union_fields(self.meta, self.layout, arrays)
        if self.union is None or not self.union.load(fields):
            self._build(fields)
        self.lane_arrays = arrays
        lanes = [self.adapter.initial_leaves(s, target) for s in specs]
        leaves = tuple(
            torch.as_tensor(self.layout.stack(kind, [ln[j] for ln in lanes]),
                            device=self.device)
            for j, kind in enumerate(self.kinds))
        done = torch.zeros(self.B, dtype=torch.bool, device=self.device)
        return leaves, done

    # -- serve: an open bucket, lane by lane ---------------------------------

    def load_idle(self, target: InstanceDims, depths=None):
        """Every lane idle (:meth:`_AdapterBase.idle_arrays`) unless the
        buffers exist (a pooled runner keeps its own); the buffers are
        built at the first call, from the lanes loaded by then, each
        rank table at least ``depths`` deep (by ``(field, column)``).
        Returns the all-done state of idle lanes."""
        if self.union is None:
            self.lane_arrays = [self.adapter.idle_arrays(target)] * self.B
            self._pending_depths = depths
        idle = self.adapter.idle_leaves(target)
        leaves = tuple(
            torch.as_tensor(self.layout.stack(kind, [leaf] * self.B),
                            device=self.device)
            for kind, leaf in zip(self.kinds, idle))
        done = torch.ones(self.B, dtype=torch.bool, device=self.device)
        return leaves, done

    def load_lane(self, lane: int, arrays: Dict[str, np.ndarray]) -> bool:
        """Write lane ``lane``'s padded arrays into the buffers in place;
        a lane deeper than the rank tables regrows them (every lane's
        arrays rebuilt into new buffers, a new graph; the lanes' states
        are the caller's and are not touched).  True when it regrew."""
        self.lane_arrays = list(self.lane_arrays)
        self.lane_arrays[lane] = arrays
        if self.union is None or self.union.load_lane(lane, arrays):
            return False
        self._build(_union_fields(self.meta, self.layout, self.lane_arrays),
                    self.union.depths())
        return True

    def write_lane(self, state, lane: int, leaves) -> None:
        """Lane ``lane``'s leaves (its padded layout) into ``state``'s
        union leaves, in place."""
        for kind, union, leaf in zip(self.kinds, state[0], leaves):
            self.layout.write(kind, union, lane, leaf)

    def read_lane(self, state, lane: int) -> Tuple[torch.Tensor, ...]:
        """A copy of lane ``lane``'s leaves, in its padded layout."""
        return tuple(self.layout.lane(kind, union, lane).clone()
                     for kind, union in zip(self.kinds, state[0]))

    def __call__(self, state, coins, n):
        leaves, done = state
        if self.union is None:
            self._build(_union_fields(self.meta, self.layout,
                                      self.lane_arrays),
                        self._pending_depths)
        # lanes with no cycle left run none; a chunk runs at least one
        # (frozen) cycle
        ns = np.asarray(n, dtype=np.int64)
        n_max = max(1, int(ns.max()))
        left = torch.as_tensor(ns).to(self.device)
        coins = tuple(c[:n_max] for c in coins)
        (leaves, done, _), _, flags = self.chunk_runner(
            (leaves, done, left), coins, n_max)
        return (leaves, done), None, flags


def build_bucket_runner(adapter: _AdapterBase, meta: BucketMeta, B: int,
                        params: Dict[str, Any], chunk: int,
                        device: torch.device) -> BucketRunner:
    """ONE fixed-shape runner per bucket signature (see
    :class:`BucketRunner`)."""
    return BucketRunner(adapter, meta, B, params, chunk, device)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class BatchEngine:
    """Shape-bucketed solver for sweeps.

    ``cache=None`` shares the process-wide runner cache; pass a fresh
    :class:`~pydcop_tpu_torch.batch.cache.CompileCache` to isolate.
    ``device`` is cuda unless the caller asks for the CPU.
    ``persistent_cache_dir`` is refused (no persistent cache is
    ported)."""

    def __init__(
        self,
        max_padding_waste: float = 0.25,
        cache: Optional[CompileCache] = None,
        persistent_cache_dir: Optional[str] = None,
        counters: Optional[BatchCounters] = None,
        device: DeviceLike = None,
    ):
        refuse_persistent_cache(persistent_cache_dir)
        self.device = resolve_device(device)
        self.max_padding_waste = float(max_padding_waste)
        self.cache = cache if cache is not None else global_compile_cache()
        self.counters = counters if counters is not None else BatchCounters()
        #: eager calls, captures and replays of the runners this engine
        #: drove, and rank-table regrows
        self.runner_calls = {"eager_calls": 0, "captures": 0,
                             "replays": 0, "regrows": 0}
        #: host wall seconds of the supported groups' solves, by part:
        #: compiling the instances and building their solvers, loading the
        #: buckets into their runners, the chunk loops (from the first
        #: chunk to the values on the host), scoring the assignments
        self.seconds = {"specs_s": 0.0, "load_s": 0.0, "loop_s": 0.0,
                        "score_s": 0.0}

    def metrics(self) -> Dict[str, Any]:
        out = self.counters.as_dict()
        out["padding_waste"] = round(self.counters.padding_waste, 4)
        out["cache"] = self.cache.stats()
        out["runners"] = dict(self.runner_calls)
        out["seconds"] = {k: round(v, 6) for k, v in self.seconds.items()}
        return out

    # -- public API ---------------------------------------------------------

    def solve(
        self,
        items: Sequence[BatchItem],
        cycles: Optional[int] = None,
        timeout: Optional[float] = None,
        max_cycles: int = DEFAULT_MAX_CYCLES,
        on_lane_release: Optional[Callable[[int, int, Any], None]] = None,
    ) -> List[SolveResult]:
        """Solve every item; results align with ``items`` by index.

        ``cycles`` set → every instance runs exactly that many cycles
        (the harness's fixed-cycle mode, results equal to
        ``solver.run(cycles=n)``); ``cycles=None`` → run to convergence
        with per-lane freeze masks and an early bucket exit.

        ``on_lane_release(lane, stop_cycle, final_state)`` fires the
        moment one lane of a bucket converges and stops advancing, and
        for a lane frozen ``ERROR`` by the chunk-boundary NaN/Inf check
        (counted ``lanes_nonfinite``).  ``lane`` is the index inside its
        bucket and ``final_state`` the lane's state (a tuple of tensors
        on the device, at its padded shape).
        """
        t0 = perf_counter()
        self.counters.inc("instances_enqueued", len(items))
        results: List[Optional[SolveResult]] = [None] * len(items)

        groups: Dict[Tuple, List[int]] = {}
        for i, item in enumerate(items):
            algo_def = item.algo_def()
            groups.setdefault(
                (algo_def.algo, _params_key(algo_def.params)), []
            ).append(i)

        n_buckets = 0
        for (algo, _pkey), idxs in sorted(groups.items()):
            if algo not in SUPPORTED_ALGOS:
                self._solve_fallback(items, idxs, results, cycles, timeout)
                continue
            adapter = adapter_for(algo)
            compiled: Dict[int, Any] = {}
            t_specs = perf_counter()
            specs = [adapter.build_spec(items[i], compiled) for i in idxs]
            self.seconds["specs_s"] += perf_counter() - t_specs
            plans = plan_buckets(
                [s.dims for s in specs], self.max_padding_waste
            )
            for plan in plans:
                n_buckets += 1
                self.counters.inc("buckets_formed")
                self.counters.inc(
                    "stacked_cells", plan.target.cells * plan.batch_size
                )
                self.counters.inc(
                    "padded_cells",
                    plan.target.cells * plan.batch_size
                    - sum(specs[j].dims.cells for j in plan.indices),
                )
                send_batch("bucket.formed", {
                    "algo": algo,
                    "signature": plan.signature(),
                    "size": plan.batch_size,
                    "waste": plan.waste,
                })
                bucket_results = self._solve_bucket(
                    adapter, [specs[j] for j in plan.indices], plan,
                    cycles, timeout, max_cycles, on_lane_release,
                )
                for j, res in zip(plan.indices, bucket_results):
                    results[idxs[j]] = res
        self.counters.inc("instances_solved", len(items))
        send_batch("run.done", {
            "instances": len(items),
            "buckets": n_buckets,
            "wall": round(perf_counter() - t0, 3),
            "cache": self.cache.stats(),
        })
        return results  # type: ignore[return-value]

    # -- internals ----------------------------------------------------------

    def _solve_fallback(self, items, idxs, results, cycles, timeout):
        """Sequential per-instance path for algorithms without a
        batched engine — counted, never silent."""
        from pydcop_tpu_torch.runtime.run import solve_result

        for i in idxs:
            item = items[i]
            self.counters.inc("fallback_sequential")
            results[i] = solve_result(
                item.dcop, item.algo_def(), cycles=cycles,
                timeout=timeout, seed=item.seed, device=self.device,
            )

    def _solve_bucket(
        self,
        adapter: _AdapterBase,
        specs: List[_Spec],
        plan: BucketPlan,
        cycles: Optional[int],
        timeout: Optional[float],
        max_cycles: int,
        on_lane_release: Optional[Callable] = None,
    ) -> List[SolveResult]:
        t0 = perf_counter()
        B = len(specs)
        target = plan.target
        meta = BucketMeta.of(target)
        params = specs[0].item.algo_def().params

        target_cycles = cycles if cycles else None
        limit = target_cycles if target_cycles is not None else max_cycles
        chunk = default_chunk(target_cycles, False, False, timeout, limit)

        # ONE fixed-shape runner per bucket signature: remainder chunks
        # run cycle-masked through it (the coins are still drawn at the
        # true cycle count, so every lane's stream is the sequential
        # harness's)
        key = runner_cache_key(adapter.algo, _params_key(params),
                               plan.signature(), chunk, self.device)
        runner, hit = self.cache.get_or_build(
            key,
            lambda: build_bucket_runner(adapter, meta, B, params, chunk,
                                        self.device),
        )
        self.counters.inc("compile_hits" if hit else "compile_misses")
        before = {**runner.calls(), "regrows": runner.regrows}
        t_load = perf_counter()
        state = runner.load(specs, target)
        for s in specs:
            # a fresh run's coin stream, as solver.run restarts it
            s.solver._restart_streams(False)
        self.seconds["load_s"] += perf_counter() - t_load

        done = 0
        done_mask = np.zeros(B, bool)
        stable = np.zeros(B, np.int64)
        stop_cycle = np.zeros(B, np.int64)
        statuses = ["FINISHED"] * B
        first_chunk = True

        def release(i):
            if on_lane_release is not None:
                kinds = adapter.leaf_kinds(meta)
                on_lane_release(i, int(stop_cycle[i]), tuple(
                    runner.layout.lane(k, leaf, i).clone()
                    for k, leaf in zip(kinds, state[0])))

        t_loop = perf_counter()
        while done < limit:
            n = min(chunk, limit - done)
            coins = adapter.chunk_coins(specs, n, target)
            state, _, flags = runner(state, coins, [n] * B)
            done += n
            stop_cycle[~done_mask] = done

            if target_cycles is None:
                # per-lane convergence and finiteness ride the runner's
                # [2, B] flags — the only device→host read of the chunk;
                # the first chunk's convergence (against the initial
                # state) is skipped, as the sequential harness does
                conv_np, finite_np = flags.cpu().numpy()
                changed = False
                for i in range(B):
                    # a lane whose float state went NaN/Inf is frozen
                    # ERROR at this boundary
                    if done_mask[i] or finite_np[i]:
                        continue
                    done_mask[i] = changed = True
                    statuses[i] = "ERROR"
                    self.counters.inc("lanes_nonfinite")
                    send_batch("lane.nonfinite", {
                        "label": specs[i].item.label or i,
                        "lane": i,
                        "cycle": int(stop_cycle[i]),
                    })
                    release(i)
                if not first_chunk:
                    for i in range(B):
                        if done_mask[i]:
                            continue
                        stable[i] = stable[i] + 1 if conv_np[i] else 0
                        if stable[i] >= STABLE_CHUNKS:
                            done_mask[i] = changed = True
                            self.counters.inc("instances_converged")
                            send_batch("instance.converged", {
                                "label": specs[i].item.label or i,
                                "cycle": int(stop_cycle[i]),
                            })
                            release(i)
                if done_mask.all():
                    break
                if changed:
                    state = (state[0], torch.as_tensor(
                        done_mask, device=self.device))
            first_chunk = False
            if timeout is not None and perf_counter() - t0 > timeout:
                for i in range(B):
                    if not done_mask[i]:
                        statuses[i] = "TIMEOUT"
                break

        values = state[0][adapter.values_leaf].view(B, -1).cpu().numpy()
        self.seconds["loop_s"] += perf_counter() - t_loop
        after = {**runner.calls(), "regrows": runner.regrows}
        for k in self.runner_calls:
            self.runner_calls[k] += after[k] - before[k]
        wall = perf_counter() - t0
        t_score = perf_counter()
        out: List[SolveResult] = []
        for i, spec in enumerate(specs):
            assignment = spec.tensors.assignment_from_indices(
                values[i][:spec.dims.V])
            violation, cost = spec.item.dcop.solution_cost(
                assignment, DEFAULT_INFINITY)
            n_cyc = int(stop_cycle[i])
            solver = spec.solver
            out.append(SolveResult(
                status=statuses[i],
                assignment=assignment,
                cost=cost,
                violation=violation,
                cycle=n_cyc,
                msg_count=solver.msgs_per_cycle * n_cyc,
                msg_size=(solver.msgs_per_cycle * n_cyc
                          * solver.msg_size_per_msg),
                time=wall,
            ))
        self.seconds["score_s"] += perf_counter() - t_score
        return out


__all__ = ["BatchEngine", "BatchItem", "BucketMeta", "BucketRunner",
           "DEFAULT_MAX_CYCLES", "RankTable", "SUPPORTED_ALGOS",
           "adapter_for", "build_bucket_runner", "pad_instance", "pad_vec",
           "rank_block", "runner_cache_key"]
