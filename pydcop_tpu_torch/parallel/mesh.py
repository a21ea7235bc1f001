"""Sharded engines in one process: MaxSum and the local-search family with
the factors split over S shards.

The counterpart of the JAX package's ``parallel/mesh.py``
(``ShardedMaxSum``, ``ShardedLocalSearch``, ``build_mesh``, ``CommPlan``
and ``_plan_comm``).  There one process drives every local device through
``shard_map``; here one process drives S shards, shard s on device
``mesh[s]``.  Two engines, as in JAX:

* **packed** (:mod:`~pydcop_tpu_torch.parallel.packed_mesh`): each shard
  a packed layout of its factor subset over one common column map (column
  = variable); the shards a device holds form one group, and every cycle
  launches K7 (MaxSum) or K9 (the local-search tables) ONCE PER DEVICE
  over its group (``ops/packed_sharded.py``), MGM's arbitration K8 once
  per device after it.  When one device holds every shard (all of them on
  the one H100, or on the CPU) the launch adds the shards' partials in
  shard order itself — the counterpart of the cycle's ``psum`` — else it
  writes each shard's partial and the groups combine them
  (:mod:`~pydcop_tpu_torch.parallel.collectives`).
* **generic** (:mod:`~pydcop_tpu_torch.parallel.generic_mesh`): the JAX
  package's ``[E, D]`` sharded layout, plain PyTorch, for every graph —
  ``use_packed=False``, graphs the packers decline (arity > 4, D > 8, or
  D > 5 with a ternary or quaternary factor), and the breakout rules dba
  and gdba, whose weights live with their factor blocks.  A packer error
  on a graph in scope is raised, never taken as a cue to run the generic
  engine.

The collective path (``overlap``, ``boundary_threshold``, ``exchange``)
is the JAX package's :class:`CommPlan`: ``dense`` combines the whole
space every cycle; ``exact`` only the boundary columns
(``parallel/boundary.py``), interior columns keeping the owner's partial
— the same sums in the same order, so bit for bit the dense run;
``exchange=True`` (or the auto choice on a pairwise cut) runs the
neighbour-exchange rounds instead of the boundary sum; ``stale`` combines
the previous cycle's boundary slab (a one-cycle halo; its pending slab
starts afresh at every ``run`` call, as in JAX).  "auto" compacts when
the cut fraction is at most ``boundary_threshold``.  In the compact modes
a unit that combines (a device group of the packed engine, a shard of the
generic one) holds a VIEW, right at the columns it touches; values and
beliefs are read from each column's owner.  On the one card the packed
engine's single group adds its shards inside the launch, so ``exact`` and
``exchange`` move nothing there, and ``stale`` still replaces the
boundary columns by the previous cycle's.

Refused with :class:`~pydcop_tpu_torch.errors.NotPortedError`:
``precision`` other than f32 and ``sentinel=True``; a structured
(table-free) bucket never reaches an engine (``ops/compile.py`` refuses
it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.ops.segments import masked_argmin
from pydcop_tpu_torch.parallel import generic_mesh as G
from pydcop_tpu_torch.parallel import packed_mesh
from pydcop_tpu_torch.parallel.boundary import BoundaryInfo, \
    ExchangePlan, build_exchange_plan, padded_boundary_idx
from pydcop_tpu_torch.parallel.collectives import all_max, all_min, \
    all_sum, boundary_reduce, exchange, put_boundary
from pydcop_tpu_torch.parallel.packed_mesh import ShardPacks, \
    build_shard_packs, packers_decline
from pydcop_tpu_torch.runtime.stats import ShardCommCounters

_REDUCE = {"sum": all_sum, "max": all_max, "min": all_min}


@dataclasses.dataclass
class CommPlan:
    """The resolved collective path of a sharded engine.

    ``mode``: ``dense`` (the whole space combined every cycle),
    ``exact`` (the boundary columns only, bit for bit the dense run) or
    ``stale`` (the previous cycle's boundary slab, a one-cycle halo).
    ``collective``: ``psum`` (the boundary sum), ``ppermute`` (the
    neighbour-exchange rounds; pairwise cuts only) or ``none`` (no
    boundary: the cycle combines nothing)."""

    requested: str
    mode: str
    collective: str
    threshold: float
    info: Optional[BoundaryInfo] = None
    bnd: Optional[np.ndarray] = None       # [Bp] padded boundary index
    exch: Optional[ExchangePlan] = None    # the exchange plan, if chosen
    rounds: Optional[list] = None          # its rounds of (src, dst)
    #: per-shard collective payload width, in columns (dense vs chosen)
    width_dense: int = 0
    width_compact: int = 0
    rows: int = 1                          # rows per column of the payload
    #: single-row arbitration collectives riding alongside the main one
    #: (MGM's max/min pair): the packed engine's in dense mode too, the
    #: generic engine's only when compact (it arbitrates replicated)
    extra_dense: int = 0
    extra_compact: int = 0

    @property
    def compact(self) -> bool:
        return self.mode != "dense"

    def counters(self, n_shards: int) -> ShardCommCounters:
        info = self.info
        dense = self.mode == "dense"
        width_c = self.width_dense if dense else self.width_compact
        return ShardCommCounters(
            mode="dense" if dense else f"compact-{self.mode}",
            collective="psum" if dense else self.collective,
            n_shards=n_shards,
            boundary_columns=info.n_boundary if info else 0,
            total_columns=self.width_dense,
            cut_fraction=info.cut_fraction if info else 0.0,
            boundary_fraction=info.boundary_fraction if info else 0.0,
            bytes_per_cycle_dense=self.width_dense * 4 * (
                self.rows + self.extra_dense),
            bytes_per_cycle_compact=width_c * 4 * (
                self.rows + (self.extra_dense if dense
                             else self.extra_compact)),
            exchange_rounds=(len(self.rounds)
                             if self.collective == "ppermute" and self.rounds
                             else 0),
            threshold=self.threshold,
        )


def _plan_comm(requested, threshold, exchange, info: BoundaryInfo,
               bnd: np.ndarray, exch: Optional[ExchangePlan],
               width_dense: int, rows: int, extra_dense: int = 0,
               extra_compact: int = 0) -> CommPlan:
    """Resolve the overlap request against the partition's boundary
    (``_plan_comm``).  "auto" (the default) compacts only when the cut
    fraction is at most ``threshold``: an all-boundary cut keeps the dense
    sum.  "exact"/"stale" force the compact path.  The neighbour exchange
    runs on pairwise cuts only, when forced (``exchange=True``) or when
    its payload undercuts the boundary slab (``exchange=None``);
    ``exchange=True`` on a cut that is not pairwise raises."""
    req = "auto" if requested in (None, "auto") else str(requested)
    if req not in ("auto", "off", "dense", "exact", "stale"):
        raise ValueError(
            f"unknown shard overlap mode {requested!r}; expected one "
            f"of off/exact/stale (or auto)")
    plan = CommPlan(
        requested=req, mode="dense", collective="psum",
        threshold=float(threshold), info=info,
        width_dense=int(width_dense), rows=int(rows),
        extra_dense=int(extra_dense), extra_compact=int(extra_compact))
    if req in ("off", "dense") or info is None:
        return plan
    if req == "auto" and (info.n_touched == 0
                          or info.cut_fraction > float(threshold)):
        return plan
    mode = "exact" if req == "auto" else req
    n_bnd = int(bnd.shape[0]) if bnd is not None else 0
    if n_bnd == 0:
        # nothing crosses: no collective at all (and nothing for stale to
        # double-buffer: it runs as exact)
        plan.mode, plan.collective = "exact", "none"
        plan.bnd, plan.width_compact = bnd, 0
        return plan
    plan.mode, plan.bnd, plan.width_compact = mode, bnd, n_bnd
    use_exch = False
    if exch is not None and mode == "exact":
        use_exch = exchange is True or (exchange is None
                                        and exch.lanes_moved < n_bnd)
    if exchange is True and exch is None:
        raise ValueError(
            "exchange=True requested but the cut graph is not pairwise "
            "(a boundary variable is shared by 3+ shards) — no "
            "neighbor-exchange schedule exists for this partition")
    if use_exch:
        plan.collective, plan.exch, plan.rounds = "ppermute", exch, \
            exch.rounds
        plan.width_compact = exch.lanes_moved
    return plan


def _announce_comm(plan: CommPlan, n_shards: int, engine: str,
                   packed: bool) -> None:
    """Publish the chosen collective path on the event bus
    (``shard.comm.selected``, the JAX package's payload; a no-op unless
    observability is on)."""
    from pydcop_tpu_torch.runtime.events import send_shard

    payload = plan.counters(n_shards).as_dict()
    payload.update(engine=engine, packed=packed)
    send_shard("comm.selected", payload)


def build_mesh(n_shards: Optional[int] = None,
               device: DeviceLike = None) -> List[torch.device]:
    """The devices of ``n_shards`` shards, shard s on device s mod the
    number of devices (shards share a device when there are fewer
    devices than shards).

    ``device`` is resolved as every entry point does: None means cuda, a
    missing GPU raises.  Its devices are every visible card for "cuda",
    the one card for "cuda:k", the CPU for "cpu".  ``n_shards`` defaults
    to that number of devices: the card count on cuda, 1 on the CPU —
    the counterpart of the JAX package's one device per mesh shard."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif dev.type == "cuda":
        devs = [dev]
    else:
        devs = [torch.device("cpu")]
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    return [devs[s % len(devs)] for s in range(n)]


def _canonical(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card, as a
    tensor placed there reports it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _refuse(what: str, reason: str) -> None:
    raise NotPortedError(
        f"{what} is not ported to the PyTorch package's sharded engines "
        f"yet: {reason}")


class _ShardedEngine:
    """What both engines share: the mesh, the layout (packed or generic),
    the collective plan and its operands, the combines and the owner
    reconcile, and the staged operands."""

    def __init__(self, tensors: FactorGraphTensors, mesh, assigns, overlap,
                 boundary_threshold, exchange, use_packed, sentinel,
                 precision, arb: int = 0, packable: bool = True):
        if sentinel:
            _refuse("sentinel=True", "the integrity sentinels come with "
                    "the elastic mesh")
        if precision not in (None, "f32"):
            _refuse(f"precision={precision!r}", "only f32 runs")
        self.base = tensors
        self.mesh: List[torch.device] = [
            _canonical(d) for d in (build_mesh() if mesh is None else mesh)]
        self.n_shards = len(self.mesh)
        self.precision = "f32"
        self.packs: Optional[ShardPacks] = None
        self.st: Optional[G.ShardedFactorGraph] = None
        if use_packed is not False and packable \
                and packers_decline(tensors) is None:
            self.packs = build_shard_packs(tensors, self.mesh, assigns)
            info, assigns = self.packs.boundary, self.packs.assigns
            width = self.packs.Vp
        else:
            self.st = G.shard_factor_graph(tensors, self.n_shards, assigns)
            info, assigns = self.st.boundary, self.st.assigns
            width = tensors.n_vars + 1
            self.ggroups = [
                G.build_group(self.st, idx, self.mesh[idx[0]])
                for idx in packed_mesh._device_groups(self.mesh)]
        vis = [np.asarray(b.var_idx) for b in tensors.buckets]
        if not vis:
            vis = [np.zeros((0, 2), dtype=np.int64)]
        bnd = padded_boundary_idx(info, quantum=8)
        self.comm = _plan_comm(
            overlap, boundary_threshold, exchange, info, bnd,
            build_exchange_plan(info, vis, assigns), width,
            tensors.max_domain_size,
            extra_dense=arb if self.packs is not None else 0,
            extra_compact=arb)
        self._comm_operands()
        self._pend = None

    # -- the plan's operands -------------------------------------------------

    @property
    def shards(self):
        return self.packs.shards

    @property
    def groups(self):
        return self.packs.groups if self.packs is not None else self.ggroups

    def _units(self) -> List[int]:
        """The unit of each shard in the compact combines: its device
        group's position (packed), the shard itself (generic)."""
        if self.packs is None:
            return list(range(self.n_shards))
        unit = [0] * self.n_shards
        for gi, g in enumerate(self.groups):
            for s in g.index:
                unit[s] = gi
        return unit

    def _comm_operands(self, send=None, recv=None) -> None:
        """The boundary index per device (and per shard, ``_row_bnd``: the
        rows each shard's partial holds the boundary columns at), the
        owner unit of every column and, for the exchange, the rounds of
        sends between units (every shard pair on the generic engine; the
        pairs across groups on the packed one, whose groups add their own
        shards in the launch).  ``send``/``recv`` replace the plan's
        column ids (the local-row layout's rows)."""
        comm = self.comm
        devs = list(dict.fromkeys(self.mesh))
        self._bnd: Dict[torch.device, torch.Tensor] = {}
        if comm.bnd is not None and comm.bnd.size:
            self._bnd = {d: torch.as_tensor(comm.bnd.astype(np.int64),
                                            device=d) for d in devs}
        self._row_bnd = [self._bnd.get(d) for d in self.mesh]
        units = self._units()
        owner = np.asarray(units)[comm.info.owner]
        self._owner_unit = torch.as_tensor(owner, dtype=torch.long,
                                           device=self.mesh[0])
        self._xsteps = []
        if comm.collective != "ppermute":
            return
        ex = comm.exch
        send = ex.send_idx if send is None else send
        recv = ex.recv_idx if recv is None else recv
        unit_dev = ([g.device for g in self.groups] if self.packs is not None
                    else self.mesh)

        def on(a, d):
            return torch.as_tensor(a, device=d)

        for r, pairs in enumerate(comm.rounds):
            steps = []
            for a, b in pairs:
                ua, ub = units[a], units[b]
                if self.packs is not None and ua == ub:
                    continue  # one group adds both shards in its launch
                steps.append((ua, ub,
                              on(send[a, r].astype(np.int64), unit_dev[ua]),
                              on(recv[b, r].astype(np.int64), unit_dev[ub]),
                              on(ex.recv_valid[b, r], unit_dev[ub])))
            self._xsteps.append(steps)

    def _bnds(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self._bnd[t.device] for t in tensors]

    @property
    def _stale(self) -> bool:
        return self.comm.mode == "stale"

    def _pick_owner(self, views: Sequence[torch.Tensor],
                    axis: int) -> torch.Tensor:
        """One tensor from the units' views: each column (along ``axis``)
        read from its owner's unit — the owner-masked reconcile, once per
        run."""
        dev = self.mesh[0]
        st = torch.stack([v.to(dev) for v in views])
        shape = [1] * st.dim()
        shape[axis + 1] = -1
        idx = self._owner_unit.view(shape).expand(
            (1,) + tuple(st.shape[1:]))
        return st.gather(0, idx)[0]

    # -- the combines ----------------------------------------------------------

    def _finish(self, g, total: torch.Tensor, fill) -> torch.Tensor:
        out = g.unary_p + total
        return out if fill is None else torch.where(g.mask_p > 0, out, fill)

    def _finish_slab(self, g, total: torch.Tensor, fill) -> torch.Tensor:
        """``_finish`` at the boundary columns only."""
        bnd = self._bnd[g.device]
        out = g.unary_p.index_select(1, bnd) + total
        if fill is None:
            return out
        return torch.where(g.mask_p.index_select(1, bnd) > 0, out, fill)

    def _packed_pend0(self, fill=None) -> Optional[List[torch.Tensor]]:
        """stale's pending boundary slab at the start of a run: a zero
        total, finished (unary, and ``fill`` off the domain)."""
        if not self._stale:
            return None
        return [self._finish_slab(g, torch.zeros(
            (self.packs.D, self.comm.bnd.shape[0]), device=g.device), fill)
            for g in self.groups]

    def _gathered(self, results, fill=None) -> List[torch.Tensor]:
        """The groups' device-level results → one combined [R, Vp] tensor
        per group (a view in the compact modes, right at the group's
        columns).  A whole group's launch combined already (stale: its
        boundary columns swapped for the pending slab's).  Else dense:
        every shard's partial added in shard order across the devices,
        then the unary row (``fill``: where(mask > 0, that, fill)), as
        the launch does for a whole group; compact: each group's own
        shards' partials added in shard order, the boundary columns from
        the ordered sum of every shard's boundary slab (exact), the
        previous cycle's (stale) or the exchange rounds."""
        groups = self.groups
        stale = self._stale
        if groups[0].whole:
            out = results[0]
            if stale:
                bnd = self._bnd[out.device]
                new = out.index_select(1, bnd)
                out = put_boundary(out, bnd, self._pend[0], 1)
                self._pend = [new]
            return [out]
        parts = [None] * self.n_shards
        for g, res in zip(groups, results):
            for k, s in enumerate(g.index):
                parts[s] = res[k]
        comm = self.comm
        if not comm.compact:
            totals = all_sum(parts, self.mesh)
            return [self._finish(g, totals[g.index[0]], fill)
                    for g in groups]
        local = []
        for res in results:
            acc = res[0]
            for p in res[1:]:
                acc = acc + p
            local.append(acc)
        if comm.collective == "ppermute":
            local = exchange(local, self._xsteps, 1, "sum")
        elif comm.collective == "psum":
            tot = boundary_reduce(parts, self.mesh, self._bnds(parts), 1)
            if stale:
                new = [self._finish_slab(g, tot[g.index[0]], fill)
                       for g in groups]
                out = [put_boundary(self._finish(g, loc, fill),
                                    self._bnd[g.device], pend, 1)
                       for g, loc, pend in zip(groups, local, self._pend)]
                self._pend = new
                return out
            local = [put_boundary(loc, self._bnd[g.device],
                                  tot[g.index[0]], 1)
                     for g, loc in zip(groups, local)]
        return [self._finish(g, loc, fill) for g, loc in zip(groups, local)]

    def _arb(self, parts: List[torch.Tensor], op: str,
             axis: int = 0) -> List[torch.Tensor]:
        """The arbitration's max / min across the units (``parts`` one per
        unit): the whole rows (dense), the boundary (exact and stale: the
        gains are this cycle's in every mode) or the exchange rounds."""
        comm = self.comm
        devs = [p.device for p in parts]
        if not comm.compact:
            return _REDUCE[op](parts, devs)
        if comm.collective == "none":
            return list(parts)
        if comm.collective == "ppermute":
            return exchange(parts, self._xsteps, axis, op)
        tot = boundary_reduce(parts, devs, self._bnds(parts), axis, op)
        return [put_boundary(p, self._bnd[p.device], t, axis)
                for p, t in zip(parts, tot)]

    def _generic_combine(self, parts: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """The generic engine's per-shard partials ([V+1, D], or a shard's
        local rows) → each shard's total (a view in the compact modes):
        the dense ordered sum, or the boundary rows only (exact), the
        previous cycle's (stale: ``self._pend``, one total per shard) or
        the exchange."""
        comm = self.comm
        if not comm.compact:
            return all_sum(parts, self.mesh)
        if comm.collective == "none":
            return list(parts)
        if comm.collective == "ppermute":
            return exchange(parts, self._xsteps, 0, "sum")
        tot = boundary_reduce(parts, self.mesh, self._row_bnd, 0)
        if self._stale:
            tot, self._pend = self._pend, tot
        return [put_boundary(p, b, t, 0)
                for p, b, t in zip(parts, self._row_bnd, tot)]

    def _generic_pend0(self) -> Optional[List[torch.Tensor]]:
        if not self._stale:
            return None
        shape = (self.comm.bnd.shape[0], self.base.max_domain_size)
        zeros = {d: torch.zeros(shape, device=d)
                 for d in dict.fromkeys(self.mesh)}
        return [zeros[d] for d in self.mesh]

    def _per_shard(self, per_group: Sequence[torch.Tensor],
                   rows: Optional[int] = None, slab: bool = True) -> tuple:
        """One slab per group → the shards' views of them (``rows`` as
        :meth:`ShardGroup.views`); ``slab=False``: one tensor per group,
        shared by its shards."""
        out = [None] * self.n_shards
        for g, t in zip(self.groups, per_group):
            pieces = g.views(t, rows) if slab else [t] * len(g.index)
            for s, v in zip(g.index, pieces):
                out[s] = v
        return tuple(out)

    def _shard_views(self, per_group: Sequence[torch.Tensor]) -> List:
        """Per generic group a [k, ...] tensor → its rows per shard, in
        shard order."""
        out = [None] * self.n_shards
        for g, t in zip(self.groups, per_group):
            for k, s in enumerate(g.index):
                out[s] = t[k]
        return out

    def _group_stack(self, per_shard: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Per-shard tensors → a [k, ...] tensor per generic group (a
        broadcast view where its shards share one tensor)."""
        out = []
        for g in self.groups:
            ts = [per_shard[s] for s in g.index]
            if all(t is ts[0] for t in ts):
                out.append(ts[0].unsqueeze(0).expand(
                    (g.k,) + tuple(ts[0].shape)))
            else:
                out.append(torch.stack(ts))
        return out

    def comm_stats(self) -> dict:
        """The collective path and partition quality as a plain dict
        (``SolveResult.metrics()["shard"]``): the JAX package's fields and
        values for the same partition and engine."""
        return self.comm.counters(self.n_shards).as_dict()

    # -- staged operands -----------------------------------------------------

    def operand_names(self) -> tuple:
        """The staged operands a fault or an edit can address: the packed
        engine's cost array (``cost``), or the generic engine's per-bucket
        cost slabs (``bucket0``, ...)."""
        if self.packs is not None:
            return ("cost",)
        return tuple(f"bucket{k}" for k in range(len(self.st.buckets)))

    def _slabs_of(self, name: str) -> List[torch.Tensor]:
        """The tensors behind ``name``, one per group, in group order."""
        if self.packs is not None:
            if name != "cost":
                raise ValueError(
                    f"unknown packed operand {name!r}; expected 'cost'")
            if self.packs.mixed:
                return [torch.cat([g.slabs[f"cost{a}"] for a in
                                   (1, 2, 3, 4)]) for g in self.groups]
            return [g.slabs["cost_rows"] for g in self.groups]
        names = self.operand_names()
        if name not in names:
            raise ValueError(f"unknown operand {name!r}; this engine "
                             f"stages {list(names)}")
        b = int(name[len("bucket"):])
        return [g.tensors[b] for g in self.groups]

    def get_operand(self, name: str) -> torch.Tensor:
        """The staged tensor behind ``name``: the packed cost slab (the
        groups' slabs in group order), or the generic bucket's stacked
        ``[S * Fs, D, ..., D]`` cost slab in shard order."""
        slabs = self._slabs_of(name)
        if self.packs is not None:
            return slabs[0] if len(slabs) == 1 else torch.cat(
                [s.to(self.mesh[0]) for s in slabs])
        b = int(name[len("bucket"):])
        Fs = self.st.buckets[b].factors_per_shard
        pieces = [None] * self.n_shards
        for g, t in zip(self.groups, slabs):
            for k, s in enumerate(g.index):
                pieces[s] = t[k * Fs:(k + 1) * Fs].to(self.mesh[0])
        if len(slabs) == 1 and list(self.groups[0].index) == list(
                range(self.n_shards)):
            return slabs[0]
        return torch.cat(pieces)

    def set_operand(self, name: str, array) -> None:
        """Write ``array`` over the staged operand ``name`` in place (same
        shape as :meth:`get_operand`'s)."""
        old = self.get_operand(name)
        new = torch.as_tensor(np.asarray(array) if not isinstance(
            array, torch.Tensor) else array, dtype=old.dtype)
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"operand {name!r} shape {tuple(new.shape)} "
                             f"!= staged {tuple(old.shape)}")
        slabs = self._slabs_of(name)
        if self.packs is not None:
            off = 0
            for g, s in zip(self.groups, slabs):
                piece = new[off: off + s.numel()].to(s.device)
                if self.packs.mixed:
                    o = 0
                    for a in (1, 2, 3, 4):
                        t = g.slabs[f"cost{a}"]
                        t.copy_(piece[o: o + t.numel()])
                        o += t.numel()
                else:
                    s.copy_(piece)
                off += s.numel()
            return
        b = int(name[len("bucket"):])
        Fs = self.st.buckets[b].factors_per_shard
        for g, t in zip(self.groups, slabs):
            for k, s in enumerate(g.index):
                t[k * Fs:(k + 1) * Fs].copy_(new[s * Fs:(s + 1) * Fs])
        self.st.buckets[b].tensors[...] = new.cpu().numpy()


class ShardedMaxSum(_ShardedEngine):
    """MaxSum with the factors split over the shards of ``mesh`` (a list of
    devices, :func:`build_mesh` by default).

    The packed engine's schedule is the JAX packed engine's, rotated: one
    K7 launch per device per cycle runs cycle n-1's variable side (from the
    combined beliefs) and cycle n's factor side; then ``beliefs = unary +
    Σ_s partial_s`` in shard order.  Its continuation state is ``(r_u,
    beliefs)``: each shard's unmasked factor messages and its beliefs (its
    group's), one entry per shard.  The generic engine's is ``(q, r)``,
    each shard's ``[Es, D]`` messages (``state_to_host`` gives JAX's
    ``[S * Es, D]`` arrays).  Values are the masked argmin of the final
    beliefs, each column's read from its owner in the compact modes.

    ``activation`` < 1 runs amaxsum (the JAX package's emulation of
    asynchronous MaxSum): each cycle only the slots (edges) whose uniform
    draw is below ``activation`` commit their new messages.  On the packed
    engine cycle n's mask is applied at the start of launch n+1, where the
    rotation moved cycle n's variable side, so its state becomes ``(q_m,
    r_m, r_u, beliefs, pending)``.  The uniforms are drawn on the CPU from
    a ``torch.Generator`` seeded with ``run``'s ``seed`` at a fresh start
    (a continuation draws on), one ``[cycles, N_s]`` (packed) or
    ``[cycles, Es]`` (generic) array per shard in shard order
    (:meth:`draw_uniforms`, the hook through which a test feeds the JAX
    package's draws); the JAX package draws its own per (cycle, shard)
    from ``jax.random``, so the mask streams differ (a stated deviation).

    ``assigns`` (one factor → shard array per bucket) overrides the
    locality partition — how an explicit placement drives the sharding.
    """

    def __init__(self, tensors: FactorGraphTensors, mesh=None,
                 damping: float = 0.5,
                 assigns: Optional[List[np.ndarray]] = None,
                 activation: Optional[float] = None,
                 use_packed: Optional[bool] = None,
                 overlap: Optional[str] = None,
                 boundary_threshold: float = 0.5,
                 exchange: Optional[bool] = None,
                 sentinel: bool = False,
                 precision: Optional[str] = None):
        super().__init__(tensors, mesh, assigns, overlap,
                         boundary_threshold, exchange, use_packed,
                         sentinel, precision)
        _announce_comm(self.comm, self.n_shards, engine="maxsum",
                       packed=self.packs is not None)
        self._lrows = None
        if self.st is not None and self.comm.compact:
            self._local_rows()
        self.damping = float(damping)
        self.activation = (None if activation is None or activation >= 1.0
                           else float(activation))
        self.coins = torch.Generator(device="cpu")

    def _local_rows(self) -> None:
        """The compact generic cycle's local-row layout (JAX's
        ``_local_row_layout``, where every shard's fan-in allows it): the
        boundary rows and the exchange's rows per shard in its local rows,
        and the reconcile's index (each variable's owner's local row; a
        variable no factor touches reads the unary argmin, as the dense
        run does)."""
        st, comm = self.st, self.comm
        lr = G.local_row_layout(st, comm.bnd)
        if lr is None:
            return
        self._lrows = [G.local_rows(g, lr) for g in self.groups]
        if comm.collective == "ppermute":
            self._comm_operands(*G.exchange_to_local(
                st, lr, comm.exch.send_idx, comm.exch.recv_idx))
        self._row_bnd = [torch.as_tensor(lr["slab_loc"][s], device=d)
                         for s, d in enumerate(self.mesh)]
        rows, V = lr["rows"], st.n_vars
        loc_of = np.zeros((self.n_shards, V + 1), dtype=np.int64)
        for s in range(self.n_shards):
            loc_of[s, lr["glob_loc"][s]] = np.arange(rows)
        owner = comm.info.owner
        flat = owner * rows + loc_of[owner, np.arange(V)]
        dev = self.mesh[0]
        touched = torch.as_tensor(comm.info.touch_count > 0, device=dev)
        base = self.base
        self._lr_fin = (torch.as_tensor(flat, device=dev), touched,
                        masked_argmin(base.unary_costs.to(dev),
                                      base.domain_mask.to(dev)))

    # -- packed state --------------------------------------------------------

    def _zero_state(self):
        """The zero state, one slab (or beliefs) per group."""
        D, Vp = self.packs.D, self.packs.Vp
        f32 = dict(dtype=torch.float32)
        slots = [torch.zeros(D * g.n_slots, device=g.device, **f32)
                 for g in self.groups]
        bel = [torch.zeros((D, Vp), device=g.device, **f32)
               for g in self.groups]
        if self.activation is None:
            return slots, bel
        # on the zero state the pending mask selects between zeros
        pend = [torch.ones(g.n_slots, device=g.device, **f32)
                for g in self.groups]
        return slots, [s.clone() for s in slots], \
            [s.clone() for s in slots], bel, pend

    def _shard_state(self, state) -> tuple:
        """The groups' state → the per-shard tuples run() hands out."""
        if self.st is not None:
            q, r = state
            Es = self.st.edges_per_shard
            return tuple(tuple(self._shard_views(
                [t.view(g.k, Es, -1) for g, t in zip(self.groups, x)]))
                for x in (q, r))
        D = self.packs.D
        if self.activation is None:
            r_u, bel = state
            return (self._per_shard(r_u, D),
                    self._per_shard(bel, slab=False))
        q_m, r_m, r_u, bel, pend = state
        return (self._per_shard(q_m, D), self._per_shard(r_m, D),
                self._per_shard(r_u, D), self._per_shard(bel, slab=False),
                self._per_shard(pend))

    def _slabs(self, per_shard: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """Per-shard [R, N_s] (or [N_s]) tensors → one slab per group."""
        return [g.slab_of([per_shard[s] for s in g.index])
                for g in self.groups]

    def _group_state(self, state) -> tuple:
        """Per-shard tuples → the groups' state (one copy per group)."""
        if self.st is not None:
            return tuple([torch.cat([x[s] for s in g.index])
                          for g in self.groups] for x in state)
        bel = [state[-1 if self.activation is None else 3][g.index[0]]
               for g in self.groups]
        if self.activation is None:
            return self._slabs(state[0]), bel
        q_m, r_m, r_u, _, pend = state
        return (self._slabs(q_m), self._slabs(r_m), self._slabs(r_u), bel,
                self._slabs(pend))

    def init_messages(self):
        """The zero state, as (q, r): the packed engine's two halves are
        the same opaque state; the generic engine's are the zero q and r
        messages."""
        if self.st is not None:
            D, Es = self.base.max_domain_size, self.st.edges_per_shard
            z = [torch.zeros((g.k * Es, D), device=g.device)
                 for g in self.groups]
            return self._shard_state((z, [t.clone() for t in z]))
        state = self._shard_state(self._zero_state())
        return state, state

    def _state_shapes(self) -> list:
        if self.st is not None:
            shape = (self.st.edges_per_shard, self.base.max_domain_size)
            return [[shape] * self.n_shards]
        sp = self.packs
        slots = [(sp.D, sh.N) for sh in sp.shards]
        bel = [(sp.D, sp.Vp)] * self.n_shards
        return [slots, bel] if self.activation is None else \
            [slots, slots, slots, bel, [(sh.N,) for sh in sp.shards]]

    def _validate_continuation(self, q, r) -> None:
        want = self._state_shapes()
        for name, s in (("q", q), ("r", r)):
            if self.st is not None:
                s = (s,)
            ok = isinstance(s, tuple) and len(s) == len(want) and all(
                isinstance(part, tuple)
                and [tuple(t.shape) for t in part] == w
                for part, w in zip(s, want))
            if not ok:
                raise ValueError(
                    f"continuation state mismatch: {name} must be the "
                    f"state of a prior run() of the same solver "
                    f"configuration")

    # -- host round trip of the continuation state ----------------------------

    def _leaves(self, q, r) -> List[torch.Tensor]:
        if self.st is not None:
            return [torch.cat([t.to(self.mesh[0]) for t in x])
                    for x in (q, r)]
        return [t for half in (q, r) for part in half for t in part]

    def state_to_host(self, q, r) -> dict:
        """The continuation state as a flat dict of host numpy arrays
        (``leaf_0``, ...): on the generic engine JAX's leaves, the q and r
        ``[S * Es, D]`` arrays; on the packed engine each shard's state
        tensors, q's then r's."""
        self._validate_continuation(q, r)
        return {f"leaf_{i}": t.detach().cpu().numpy()
                for i, t in enumerate(self._leaves(q, r))}

    def state_from_host(self, arrays) -> tuple:
        """Inverse of :meth:`state_to_host`: (q, r) on the engine's
        devices."""
        q0, r0 = self.init_messages()
        ref = self._leaves(q0, r0)
        if len(arrays) != len(ref):
            raise ValueError(f"checkpointed mesh state has {len(arrays)} "
                             f"leaves, this engine carries {len(ref)}")
        try:
            host = [np.asarray(arrays[f"leaf_{i}"]) for i in range(len(ref))]
        except KeyError as e:
            raise ValueError(f"checkpointed mesh state is missing leaf {e} "
                             f"— foreign or truncated checkpoint") from e
        for h, t in zip(host, ref):
            if h.shape != tuple(t.shape):
                raise ValueError(
                    f"checkpointed mesh state leaf shape {h.shape} != "
                    f"engine {tuple(t.shape)} — different problem or "
                    f"engine configuration")
        if self.st is not None:
            Es = self.st.edges_per_shard
            per = [[torch.as_tensor(h[s * Es:(s + 1) * Es],
                                    device=self.mesh[s])
                    for s in range(self.n_shards)] for h in host]
            return self._shard_state(tuple(
                [torch.cat([p[s] for s in g.index]) for g in self.groups]
                for p in per))
        it = iter(torch.as_tensor(h, dtype=t.dtype, device=t.device)
                  for h, t in zip(host, ref))
        q, r = (tuple(tuple(next(it) for _ in part) for part in q0)
                for _ in range(2))
        return q, r

    def edit_factor(self, bucket_i: int, factor_i: int, table) -> None:
        """Rewrite one factor's cost table in place (a warm edit of the
        generic engine; its scope and shard are unchanged, and so are the
        boundary and the collective plan).  ``factor_i`` indexes the
        original factor order of sharded bucket ``bucket_i``; ``table`` is
        the full padded, sign-adjusted cost tensor of its arity."""
        if self.packs is not None:
            raise NotImplementedError(
                "edit_factor patches the generic sharded engine; the "
                "uniform packed layout is rebuilt by the repack path "
                "(construct ShardedMaxSum with use_packed=False for "
                "warm sharded edits)")
        st = self.st
        sb = st.buckets[bucket_i]
        row = int(st.factor_rows[bucket_i][factor_i])
        if row < 0:
            raise ValueError(f"factor {factor_i} of bucket {bucket_i} was "
                             f"never placed on a shard")
        t = torch.as_tensor(np.asarray(table, dtype=np.float32))
        if tuple(t.shape) != tuple(sb.tensors.shape[1:]):
            raise ValueError(
                f"edit_factor table shape {tuple(t.shape)} != slab row "
                f"shape {tuple(sb.tensors.shape[1:])} — edits must keep "
                f"the scope")
        Fs = sb.factors_per_shard
        shard = row // Fs
        for g in self.groups:
            if shard in g.index:
                k = g.index.index(shard)
                g.tensors[bucket_i][k * Fs + row % Fs].copy_(t)
        sb.tensors[row] = t.numpy()

    # -- cycles ------------------------------------------------------------

    def cycle(self, r_u: Sequence[torch.Tensor],
              bel: Sequence[torch.Tensor]):
        """One packed sharded cycle over the groups' r_u slabs and
        beliefs: (r_u', beliefs') per group."""
        outs = [K.device_fused_ba(g, b, r, self.damping)
                for g, b, r in zip(self.groups, bel, r_u)]
        return ([o[0] for o in outs],
                self._gathered([o[1] for o in outs]))

    def cycle_act(self, state, active):
        """One packed amaxsum cycle from the groups' ``state`` = (q_m,
        r_m, r_u, beliefs, pending); ``active`` is this cycle's mask per
        group ([n_slots] float32 on the group's device), which becomes
        the next pending mask."""
        q_m, r_m, r_u, bel, pend = state
        outs = [K.device_fused_ba(g, b, r, self.damping, qm, rm, p)
                for g, b, r, qm, rm, p in zip(self.groups, bel, r_u, q_m,
                                              r_m, pend)]
        return ([o[2] for o in outs], [o[3] for o in outs],
                [o[0] for o in outs],
                self._gathered([o[1] for o in outs]), list(active))

    def generic_cycle(self, q: Sequence[torch.Tensor],
                      r: Sequence[torch.Tensor], active=None):
        """One generic sharded cycle over the groups' ``[k*Es, D]`` q and r
        (``_local_cycle``, ``_local_cycle_compact``): (q', r', beliefs
        per group [k, V, D])."""
        r_new = [G.r_new_block(g, qg, rg, self.damping)
                 for g, qg, rg in zip(self.groups, q, r)]
        bel = self._generic_beliefs(r_new)
        acts = [None] * len(self.groups) if active is None else active
        if self._lrows is not None:
            out = [G.local_var_side(g, L, qg, rg, rn, b, a)
                   for g, L, qg, rg, rn, b, a in zip(
                       self.groups, self._lrows, q, r, r_new, bel, acts)]
        else:
            out = [G.var_side(g, qg, rg, rn, b, a) for g, qg, rg, rn, b, a
                   in zip(self.groups, q, r, r_new, bel, acts)]
        return [o[0] for o in out], [o[1] for o in out], bel

    def _generic_beliefs(self, r_new) -> List[torch.Tensor]:
        """Each group's shards' beliefs views from their messages r:
        [k, V, D], or [k, rows, D] on the local rows."""
        if self._lrows is not None:
            parts = self._shard_views([G.local_partial(g, L, rn) for g, L, rn
                                       in zip(self.groups, self._lrows,
                                              r_new)])
            totals = self._group_stack(self._generic_combine(parts))
            return [L.unary + t for L, t in zip(self._lrows, totals)]
        parts = self._shard_views(
            [G.partial_beliefs(g, rn) for g, rn in zip(self.groups, r_new)])
        totals = self._group_stack(self._generic_combine(parts))
        return [G.beliefs_of(g, t) for g, t in zip(self.groups, totals)]

    def _generic_values(self, bel) -> torch.Tensor:
        """The values of the groups' beliefs views: each variable's from
        its owner (in the dense mode every view is whole)."""
        if self._lrows is None:
            vals = self._shard_views([G.values_of(g, b) for g, b in
                                      zip(self.groups, bel)])
            return self._pick_owner(vals, 0) if self.comm.compact \
                else vals[0]
        vals = self._shard_views([masked_argmin(b, L.dmask) for b, L in
                                  zip(bel, self._lrows)])
        flat, touched, unary_best = self._lr_fin
        stacked = torch.cat([v.to(flat.device) for v in vals])
        return torch.where(touched, stacked[flat], unary_best)

    def draw_uniforms(self, n: int) -> List[torch.Tensor]:
        """The activation uniforms of the next ``n`` cycles: one [n, N_s]
        (packed) or [n, Es] (generic) float32 array per shard, in shard
        order, on the CPU."""
        if self.st is not None:
            return [torch.rand((n, self.st.edges_per_shard),
                               generator=self.coins)
                    for _ in range(self.n_shards)]
        return [torch.rand((n, sh.N), generator=self.coins)
                for sh in self.shards]

    def values_of(self, bel: torch.Tensor) -> torch.Tensor:
        """Masked argmin per column (= variable), first index on ties."""
        mask_p = self.packs.common_on(bel.device)[1]
        return torch.argmin(torch.where(mask_p > 0, bel, PAD_COST), dim=0)

    def beliefs(self, q) -> torch.Tensor:
        """The beliefs a packed run() state carries ([D, Vp], each column
        from its owner's group), on the first shard's device."""
        bel = q[-1 if self.activation is None else 3]
        views = [bel[g.index[0]] for g in self.groups]
        if not self.comm.compact or len(views) == 1:
            return views[0].to(self.mesh[0])
        return self._pick_owner(views, 1)

    def run(self, cycles: int = 20, q=None, r=None, seed: int = 0,
            keep_halo: bool = False):
        """Run ``cycles`` sharded cycles; returns (values [V] on the host,
        q, r).  Pass the previous call's (q, r) to continue instead of
        restarting from zero messages (they are validated against this
        solver).  ``seed`` seeds amaxsum's mask draws at a fresh start.

        stale's pending boundary totals start at zero at every call, as
        the JAX package's do; ``keep_halo=True`` on a continuation keeps
        the ones the previous call left, so that a run in chunks equals
        the same run in one call."""
        keep = keep_halo and q is not None and self._pend is not None
        if self.st is not None:
            return self._run_generic(int(cycles), q, r, seed, keep)
        if q is None or r is None:
            state = self._zero_state()
            self.coins.manual_seed(seed)
        else:
            self._validate_continuation(q, r)
            state = self._group_state(q)
        if not keep:
            self._pend = self._packed_pend0()
        cycles = int(cycles)
        if self.activation is None:
            r_u, bel = state
            for _ in range(cycles):
                r_u, bel = self.cycle(r_u, bel)
            state = (r_u, bel)
        else:
            draws = self.draw_uniforms(cycles)
            masks = [(torch.cat([draws[s] for s in g.index], dim=1)
                      < self.activation).float().to(g.device)
                     for g in self.groups]
            for c in range(cycles):
                state = self.cycle_act(state, [m[c] for m in masks])
        bel = state[-1 if self.activation is None else 3]
        values = [self.values_of(b) for b in bel]
        if self.comm.compact and len(values) > 1:
            v = self._pick_owner(values, 0)
        else:
            v = values[0]
        out = self._shard_state(state)
        return v.cpu().numpy().astype(np.int32), out, out

    def _run_generic(self, cycles: int, q, r, seed: int, keep: bool):
        if q is None or r is None:
            q, r = self.init_messages()
            self.coins.manual_seed(seed)
        else:
            self._validate_continuation(q, r)
        qg, rg = self._group_state((q, r))
        if not keep:
            self._pend = self._generic_pend0()
        masks = None
        if self.activation is not None:
            draws = self.draw_uniforms(cycles)
            masks = [(torch.cat([draws[s] for s in g.index], dim=1)
                      < self.activation).to(g.device) for g in self.groups]
        bel = None
        for c in range(cycles):
            act = None if masks is None else [m[c] for m in masks]
            qg, rg, bel = self.generic_cycle(qg, rg, act)
        if bel is None:  # no cycle: the beliefs of the messages given
            bel = self._generic_beliefs(rg)
        v = self._generic_values(bel)
        q, r = self._shard_state((qg, rg))
        return v.cpu().numpy().astype(np.int32), q, r


class ShardedLocalSearch(_ShardedEngine):
    """MGM, DSA, ADSA, DBA or GDBA with the constraints split over the
    shards of ``mesh`` (a list of devices, :func:`build_mesh` by default).

    One packed cycle (mgm, dsa, adsa): K9 once per device, ``tables =
    where(mask, unary + the shards' partial tables in shard order,
    PAD_COST)``, then cur / best / gain (best with the prefer-change nudge
    for dsa and adsa) and the move rule.  DSA: move iff gain > 1e-9 and
    the coin < probability.  ADSA: the variant's want-rule, a wake coin <
    activation and a move coin < probability.  MGM: K8 once per device,
    the whole neighbourhood arbitration inside it when one device holds
    every shard (across devices: the groups' partial maxima, their
    combined max clamped at 0, the partial tie-break indices, their
    combined min, the decision).

    The generic engine (every rule; dba and gdba always) sums each
    shard's partial tables from its factor blocks; the dense mode
    arbitrates on the replicated gains (``neighborhood_winner``), the
    compact modes over each shard's own neighbour pairs with a max / min
    pair at the boundary.  The breakout weights live with their factor
    blocks (dba: one per factor, gdba: one per table entry), updated
    shard by shard; the weight state ``aux`` is per device group, per
    bucket (:meth:`aux_numpy` gives JAX's ``[S * Fs, ...]`` arrays).

    The assignment is an int32 ``[V]`` tensor (column = variable) on the
    first shard's device, or in the compact modes a tuple of per-shard
    views (each right at the columns its shard touches, reconciled by the
    owner in :meth:`state_values`).  Coins are uniforms per variable per
    cycle in variable order, drawn on the CPU from a ``torch.Generator``
    seeded with ``seed`` (adsa: the wake row then the move row of a
    call), or passed in as ``coins``; the JAX package's packed engine
    draws its own in column space, so the coin streams differ (a stated
    deviation, as in the single-device solvers)."""

    def __init__(self, tensors: FactorGraphTensors, mesh=None,
                 rule: str = "mgm", probability: float = 0.7,
                 algo_params: Optional[dict] = None,
                 use_packed: Optional[bool] = None,
                 overlap: Optional[str] = None,
                 boundary_threshold: float = 0.5,
                 exchange: Optional[bool] = None,
                 sentinel: bool = False,
                 precision: Optional[str] = None):
        if rule not in ("mgm", "dsa", "adsa", "dba", "gdba"):
            raise ValueError(f"unknown sharded local-search rule {rule!r}")
        params = dict(algo_params or {})
        if rule == "adsa" and params.get("variant", "B") not in (
                "A", "B", "C"):
            raise ValueError(f"unknown adsa variant {params['variant']!r}")
        if precision is None:
            precision = params.pop("precision", None)
        super().__init__(tensors, mesh, None, overlap, boundary_threshold,
                         exchange, use_packed, sentinel, precision,
                         arb=2 if rule in ("mgm", "dba", "gdba") else 0,
                         packable=rule in ("mgm", "dsa", "adsa"))
        _announce_comm(self.comm, self.n_shards,
                       engine=f"local_search:{rule}",
                       packed=self.packs is not None)
        self.rule = rule
        self.probability = float(probability)
        self.params = params
        if self.st is not None:
            self._generic_statics()

    # -- the generic engine's statics ----------------------------------------

    def _generic_statics(self) -> None:
        """The rule's per-bucket constants beside the factor blocks (dba:
        the violation indicators; gdba: each factor's masked base min and
        max), and the compact arbitration's neighbour-pair blocks."""
        from pydcop_tpu_torch.algorithms.dba import violation_indicator
        from pydcop_tpu_torch.algorithms.gdba import factor_min_max

        base = self.base
        self._nbrs = base  # the directed neighbour pairs of the dense rule
        if getattr(base, "neighbor_src", None) is None:
            from types import SimpleNamespace

            from pydcop_tpu_torch.ops.compile import neighbor_pairs

            src, dst = neighbor_pairs([b.var_idx for b in base.buckets],
                                      base.n_vars)
            dev = self.mesh[0]
            self._nbrs = SimpleNamespace(
                n_vars=base.n_vars,
                neighbor_src=torch.as_tensor(src, dtype=torch.long,
                                             device=dev),
                neighbor_dst=torch.as_tensor(dst, dtype=torch.long,
                                             device=dev))
        self._extras = []
        for g in self.groups:
            if self.rule == "dba":
                self._extras.append([violation_indicator(t)
                                     for t in g.tensors])
            elif self.rule == "gdba":
                self._extras.append([factor_min_max(t, a) for t, a in
                                     zip(g.tensors, g.arity)])
            else:
                self._extras.append([])
        self._pairs = None
        if self.comm.compact and self.rule in ("mgm", "dba", "gdba"):
            src, dst = G.neighbor_pair_blocks(self.st)
            self._pairs = [G.pair_blocks(g, src, dst) for g in self.groups]

    # -- continuation state ------------------------------------------------

    def state_from_values(self, values):
        """[V] value indices → the continuation state: an int32 [V] tensor
        on the first shard's device, or per-shard views in the compact
        modes."""
        x = torch.as_tensor(np.array(values), dtype=torch.int32)
        if not self.comm.compact:
            return x.to(self.mesh[0])
        if self.packs is not None:
            return self._per_shard([x.to(g.device) for g in self.groups],
                                   slab=False)
        return tuple(self._shard_views(
            [x.to(g.device).expand(g.k, -1).clone() for g in self.groups]))

    def _views(self, x) -> List[torch.Tensor]:
        """The compact state's per-group views: the group's [Vp] row
        (packed) or its shards' [k, V] rows (generic)."""
        if self.packs is not None:
            return [x[g.index[0]] for g in self.groups]
        return [torch.stack([x[s] for s in g.index]) for g in self.groups]

    def state_values(self, x) -> np.ndarray:
        """Continuation state → host [V] int32 assignment (the compact
        views reconciled: each variable's value from its owner)."""
        if not self.comm.compact:
            return x.cpu().numpy().astype(np.int32)
        units = (list(self._views(x)) if self.packs is not None
                 else list(x))
        return self._pick_owner(units, 0).cpu().numpy().astype(np.int32)

    def initial_aux(self):
        """The breakout weight state: per device group, per bucket (dba:
        ones per factor row; gdba: one weight per table entry, 0 for
        modifier A, 1 for M); () for mgm/dsa/adsa."""
        if self.rule == "dba":
            return tuple(tuple(torch.ones(t.shape[0], device=g.device)
                               for t in g.tensors) for g in self.groups)
        if self.rule == "gdba":
            init = 0.0 if self.params.get("modifier", "A") == "A" else 1.0
            return tuple(tuple(torch.full(t.shape, init, device=g.device)
                               for t in g.tensors) for g in self.groups)
        return ()

    def aux_numpy(self, aux) -> List[np.ndarray]:
        """The weight state as JAX's arrays: per bucket the ``[S * Fs,
        ...]`` stack in shard order."""
        out = []
        if not aux:
            return out
        for b, sb in enumerate(self.st.buckets):
            Fs = sb.factors_per_shard
            pieces = [None] * self.n_shards
            for g, ws in zip(self.groups, aux):
                w = ws[b].detach().cpu().numpy()
                for k, s in enumerate(g.index):
                    pieces[s] = w[k * Fs:(k + 1) * Fs]
            out.append(np.concatenate(pieces))
        return out

    # -- one packed cycle ----------------------------------------------------

    def _mgm_move(self, gains: List[torch.Tensor]) -> List[torch.Tensor]:
        """The move mask per group from the gains per group: one K8 launch
        when one device holds every shard; across devices each group's
        partial neighbourhood max, combined (:meth:`_arb`), clamped at 0,
        each group's partial tie-break index, combined, then the
        decision."""
        rows = [self.packs.common_on(g.device)[2] for g in self.groups]
        if self.groups[0].whole:
            return [K.device_mgm_move(self.groups[0], gains[0], rows[0])]
        maxed = self._arb([K.device_mgm_move(g, gain, mode="max")
                           for g, gain in zip(self.groups, gains)], "max")
        neigh_max = [torch.clamp_min(m, 0.0) for m in maxed]
        idx_at_max = self._arb(
            [K.device_mgm_move(g, gain, mode="min", neigh_max=nm)
             for g, gain, nm in zip(self.groups, gains, neigh_max)], "min")
        return [K.mgm_decision(gain, row, nm, idx)
                for gain, row, nm, idx in zip(gains, rows, neigh_max,
                                              idx_at_max)]

    def _dsa_moves(self, xs, cbg, coins) -> List[torch.Tensor]:
        """DSA's or ADSA's move rule per unit from (cur, best, gain)."""
        moves = []
        for xg, (cur, best, gain) in zip(xs, cbg):
            c = [u.to(xg.device) for u in coins]
            if self.rule == "dsa":
                moves.append((gain > K.EPS) & (c[0] < self.probability))
                continue
            improving = gain > K.EPS
            lateral = (gain <= K.EPS) & (best != xg)
            variant = self.params.get("variant", "B")
            if variant == "A":
                want = improving
            elif variant == "B":
                want = improving | (lateral & (cur >= K.HARD))
            else:
                want = improving | lateral
            activation = float(self.params.get("activation", 0.5))
            moves.append(want & (c[1] < self.probability)
                         & (c[0] < activation))
        return moves

    def cycle(self, x, coins=None):
        """One sharded cycle from the assignment ``x`` (a tensor, or the
        compact modes' per-shard views); ``coins`` is this cycle's
        uniforms per variable (dsa: the move row; adsa: (wake, move)), or
        None for mgm.  dba and gdba carry their weights through
        :meth:`generic_cycle`."""
        if self.rule in ("dba", "gdba"):
            raise ValueError(f"{self.rule} carries its weights: run "
                             f"generic_cycle(x, aux) or run_chunked")
        if self.st is not None:
            return self.generic_cycle(x, (), coins)[0]
        compact = self.comm.compact
        if compact:
            xs = self._views(x)
        else:
            xs = [x if g.device == x.device else x.to(g.device)
                  for g in self.groups]
        tables = self._gathered(
            [K.device_tables(g, xg) for g, xg in zip(self.groups, xs)],
            PAD_COST)
        prefer = self.rule in ("dsa", "adsa")
        cbg = [K.cur_best_gain(t, xg, prefer) for t, xg in zip(tables, xs)]
        if self.rule == "mgm":
            moves = self._mgm_move([gain for _, _, gain in cbg])
        else:
            moves = self._dsa_moves(xs, cbg, coins)
        if compact:
            return self._per_shard(
                [torch.where(m, best, xg)
                 for m, (_, best, _), xg in zip(moves, cbg, xs)], slab=False)
        _, best, _ = cbg[0]  # group 0 holds shard 0, on x's device
        return torch.where(moves[0], best, xs[0])

    # -- one generic cycle -------------------------------------------------

    def generic_cycle(self, x, aux, coins=None):
        """One generic sharded cycle (``cycle_fn``): per-shard partial
        tables, the combine, then the rule on the replicated tables
        (dense) or on each shard's view (compact).  Returns (x', aux')."""
        compact = self.comm.compact
        rule = self.rule
        if compact:
            xs = self._views(x)
        else:
            xs = [x.to(g.device).expand(g.k, -1) for g in self.groups]
        tensor_blocks = [None] * len(self.groups)
        weights = [None] * len(self.groups)
        if rule == "dba":
            tensor_blocks, weights = self._extras, list(aux)
        elif rule == "gdba":
            from pydcop_tpu_torch.algorithms.gdba import effective_tensor

            modifier = self.params.get("modifier", "A")
            tensor_blocks = [[effective_tensor(t, w, modifier)
                              for t, w in zip(g.tensors, ws)]
                             for g, ws in zip(self.groups, aux)]
        parts = self._shard_views(
            [G.partial_tables(g, xg, tb, w) for g, xg, tb, w in
             zip(self.groups, xs, tensor_blocks, weights)])
        totals = self._generic_combine(parts)
        unary = rule != "dba"
        if compact:
            tot = self._group_stack(totals)
            units = xs
            tables = [G.masked_tables(g, t, unary)
                      for g, t in zip(self.groups, tot)]
        else:
            g0 = self.groups[0]
            units = [x[None]]
            tables = [G.masked_tables(g0, totals[0][None], unary)]
        mask = self.base.domain_mask
        cbg = [G.cur_best_gain(t, xg, mask.to(t.device),
                               rule in ("dsa", "adsa"))
               for t, xg in zip(tables, units)]
        neigh = None
        if rule in ("dsa", "adsa"):
            moves = self._dsa_moves(units, cbg, coins)
        elif not compact:
            from pydcop_tpu_torch.algorithms._local_search import \
                neighborhood_winner

            moves = [neighborhood_winner(self._nbrs, cbg[0][2][0])[None]]
        else:
            gains = [gain for _, _, gain in cbg]
            nm = self._group_stack(self._arb(self._shard_views(
                [G.neighbour_max_part(g, pb, gain) for g, pb, gain in
                 zip(self.groups, self._pairs, gains)]), "max"))
            neigh = [torch.clamp_min(m[:, :g.V], 0.0)
                     for g, m in zip(self.groups, nm)]
            idx = self._group_stack(self._arb(self._shard_views(
                [G.tiebreak_part(g, pb, gain, n) for g, pb, gain, n in
                 zip(self.groups, self._pairs, gains, neigh)]), "min"))
            moves = [G.mgm_move(gain, n, i[:, :g.V])
                     for g, gain, n, i in zip(self.groups, gains, neigh,
                                              idx)]
        new_x = [torch.where(m, best, xg).to(torch.int32)
                 for m, (_, best, _), xg in zip(moves, cbg, units)]
        if rule in ("dba", "gdba"):
            aux = self._breakout_update(units, cbg, neigh, aux)
        if compact:
            return tuple(self._shard_views(new_x)), aux
        return new_x[0][0], aux

    def _breakout_update(self, units, cbg, neigh, aux):
        """dba's or gdba's shard-local weight bump from the cycle's
        (pre-move) assignment and its stuck flags: the quasi-local minimum
        of the replicated gains (dense) or of each view's combined
        neighbourhood max (compact)."""
        from pydcop_tpu_torch.algorithms._local_search import \
            quiet_neighborhood
        from pydcop_tpu_torch.algorithms.gdba import increase_mask, \
            violation_mask

        cur, gain = cbg[0][0], cbg[0][2]
        if neigh is None:
            stuck = quiet_neighborhood(self._nbrs, gain[0])[None]
            flags = [stuck]
            curs = [cur]
        else:
            flags = [torch.maximum(c[2], n) <= 1e-9
                     for c, n in zip(cbg, neigh)]
            curs = [c[0] for c in cbg]
        if self.rule == "dba":
            flags = [f & (c > 1e-9) for f, c in zip(flags, curs)]
        out = []
        for gi, (g, ws) in enumerate(zip(self.groups, aux)):
            xg = units[gi if neigh is not None else 0]
            fl = flags[gi if neigh is not None else 0]
            if xg.device != g.device:
                xg, fl = xg.to(g.device), fl.to(g.device)
            xg = xg.expand(g.k, -1)
            fl = fl.expand(g.k, -1)
            new = []
            for b, (t, w) in enumerate(zip(g.tensors, ws)):
                vals = G.factor_values(g, b, xg)
                idx = tuple(vals[:, p] for p in range(g.arity[b]))
                fidx = torch.arange(t.shape[0], device=g.device)
                hit = G.factor_flags(g, b, fl)
                if self.rule == "dba":
                    viol = self._extras[gi][b][(fidx,) + idx] > 0.5
                    new.append(w + (viol & hit).to(torch.float32))
                    continue
                fmin, fmax = self._extras[gi][b]
                viol = violation_mask(t[(fidx,) + idx], fmin, fmax,
                                      self.params.get("violation", "NZ"))
                do_inc = (viol & hit).to(torch.float32)
                mask = increase_mask(
                    t, vals, self.params.get("increase_mode", "E"))
                new.append(w + mask * do_inc.reshape(
                    [t.shape[0]] + [1] * g.arity[b]))
            out.append(tuple(new))
        return tuple(out)

    # -- runs --------------------------------------------------------------

    def _coins(self, cycles: int, seed: int, coins):
        """The coin rows of ``cycles`` cycles on the first shard's device:
        a tuple of [cycles, V] arrays (dsa: (move,), adsa: (wake, move)),
        or () for the coin-free rules."""
        n_rows = {"dsa": 1, "adsa": 2}.get(self.rule, 0)
        if n_rows == 0:
            return ()
        V = self.base.n_vars
        if coins is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            rows = [torch.rand((cycles, V), generator=gen)
                    for _ in range(n_rows)]
        else:
            rows = [coins] if n_rows == 1 else list(coins)
            if len(rows) != n_rows:
                raise ValueError(f"{self.rule} takes {n_rows} coin arrays")
        out = tuple(torch.as_tensor(np.asarray(r), dtype=torch.float32,
                                    device=self.mesh[0]) for r in rows)
        for r in out:
            if tuple(r.shape) != (cycles, V):
                raise ValueError(
                    f"coins must be [cycles, V] = {(cycles, V)}, got "
                    f"{tuple(r.shape)}")
        return out

    def run_chunked(self, cycles: int, x=None, aux=None, seed: int = 0,
                    coins=None):
        """``cycles`` cycles from the continuation state ``x`` (None: the
        seeded random start, ``random_valid_values(seed + 17)`` as the
        single-device solvers), returning ``(values, x, aux)``.

        ``coins`` replaces the coins drawn from ``seed``: [cycles, V]
        uniforms per variable (adsa: a (wake, move) pair of them) — how
        a test feeds the JAX package's draws.  MGM draws none, so a
        chunked MGM run equals one unchunked run of the same cycles.
        stale's pending boundary slab starts afresh at every call."""
        from pydcop_tpu_torch.algorithms._local_search import \
            random_valid_values

        if x is None:
            x = self.state_from_values(
                random_valid_values(self.base, seed + 17).cpu().numpy())
        if aux is None:
            aux = self.initial_aux()
        rows = self._coins(int(cycles), seed, coins)
        if self.st is not None:
            self._pend = self._generic_pend0()
            for c in range(int(cycles)):
                x, aux = self.generic_cycle(x, aux,
                                            tuple(r[c] for r in rows))
        else:
            self._pend = self._packed_pend0(PAD_COST)
            for c in range(int(cycles)):
                x = self.cycle(x, tuple(r[c] for r in rows))
        return self.state_values(x), x, aux

    def run(self, cycles: int = 20, seed: int = 0) -> np.ndarray:
        """The final value indices [V] after ``cycles`` cycles."""
        values, _x, _aux = self.run_chunked(cycles, seed=seed)
        return values
