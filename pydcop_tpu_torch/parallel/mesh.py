"""Sharded engines in one process: MaxSum and the local-search family with
the factors split over S shards.

The counterpart of the JAX package's ``parallel/mesh.py`` (the packed
paths of ``ShardedMaxSum`` and ``ShardedLocalSearch``, ``build_mesh``,
``CommPlan`` in dense mode).  There one process drives every local device
through ``shard_map``; here one process drives S shards, each a packed
layout of its own factor subset on its own device
(:mod:`pydcop_tpu_torch.parallel.packed_mesh`).  The shards a device
holds form one group, and every cycle launches K7 (MaxSum) or K9 (the
local-search tables) ONCE PER DEVICE over its group
(``ops/packed_sharded.py``).  When one device holds every shard (all of
them on the one H100, or on the CPU) that launch also adds the shards'
partials in shard order — the counterpart of the cycle's ``psum`` — and
writes the combined result; otherwise each launch writes its shards'
partials and the ordered collectives of
:mod:`pydcop_tpu_torch.parallel.collectives` combine them in shard
order.  MGM's arbitration (K8 with its ``pmax``/``pmin`` pair) is one
launch per device as well, the whole arbitration inside it when one
device holds every shard, else two with the ordered max and min between
them.  Variables are replicated: the variable side of a cycle runs once
per group, from the same combined values.  The per-shard state the
engines hand out (the ``run`` state, ``init_messages``) is views of one
allocation per group (``ShardGroup.views``).

Ported: all-binary and mixed-arity (1-4) graphs in the packers' scope
(``parallel/packed_mesh.py``), dense collectives (``overlap`` None,
"auto", "off" or "dense" — JAX states that its compact "exact" mode
equals the dense psum bit for bit), float32, amaxsum's ``activation``,
``mgm``/``dsa``/``adsa``.  Each of these raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`: a graph out of the
packers' scope (arity > 4, D > 8, D > 5 with a ternary or quaternary
factor), ``overlap="exact"|"stale"``, ``exchange=True``, ``precision``
other than f32, ``sentinel=True``, ``use_packed=False`` (the generic
``[E, D]`` sharded engine), ``rule="dba"|"gdba"``, and the operand
editing of the JAX engines (``get_operand``, ``set_operand``,
``edit_factor``, ``state_to_host``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import PAD_COST, FactorGraphTensors
from pydcop_tpu_torch.parallel.boundary import BoundaryInfo
from pydcop_tpu_torch.parallel.collectives import all_max, all_min, all_sum
from pydcop_tpu_torch.parallel.packed_mesh import ShardPacks, \
    build_shard_packs
from pydcop_tpu_torch.runtime.stats import ShardCommCounters


@dataclasses.dataclass
class CommPlan:
    """The collective path of a sharded engine: always the dense one here
    (the whole ``[D, Vp]`` space combined every cycle), with the request
    it resolved kept beside it."""

    requested: str
    threshold: float
    info: BoundaryInfo
    width_dense: int  # collective width, in columns
    rows: int         # rows per column of the main payload
    #: single-row arbitration collectives riding alongside the main one
    #: (MGM's max/min pair)
    extra_dense: int = 0

    def counters(self, n_shards: int) -> ShardCommCounters:
        info = self.info
        nbytes = 4 * self.width_dense * (self.rows + self.extra_dense)
        return ShardCommCounters(
            mode="dense", collective="psum", n_shards=n_shards,
            boundary_columns=info.n_boundary,
            total_columns=self.width_dense,
            cut_fraction=info.cut_fraction,
            boundary_fraction=info.boundary_fraction,
            bytes_per_cycle_dense=nbytes, bytes_per_cycle_compact=nbytes,
            exchange_rounds=0, threshold=self.threshold,
        )


def _plan_comm(requested, threshold, exchange, info: BoundaryInfo,
               width_dense: int, rows: int, extra_dense: int = 0
               ) -> CommPlan:
    """Resolve the overlap request.  None and "auto" resolve to dense (the
    JAX auto-policy picks "exact" on a low cut fraction, which it states
    is bit-identical to the dense psum); "off"/"dense" are dense; the
    compact modes and the neighbour exchange are not ported."""
    req = "auto" if requested in (None, "auto") else str(requested)
    if req not in ("auto", "off", "dense", "exact", "stale"):
        raise ValueError(
            f"unknown shard overlap mode {requested!r}; expected one "
            f"of off/exact/stale (or auto)"
        )
    if req in ("exact", "stale"):
        raise NotPortedError(
            f"shard overlap {req!r} (the boundary-compacted collectives) is "
            f"not ported to the PyTorch package yet; use 'off' or 'auto', "
            f"which combine the whole space every cycle")
    if exchange:
        raise NotPortedError(
            "exchange=True (the neighbour-exchange collective) is not "
            "ported to the PyTorch package yet")
    return CommPlan(requested=req, threshold=float(threshold), info=info,
                    width_dense=int(width_dense), rows=int(rows),
                    extra_dense=int(extra_dense))


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
    """What both engines share: the mesh, the packs, the plan, and the
    per-device copies of the column-space arrays."""

    def __init__(self, tensors: FactorGraphTensors, mesh, assigns, overlap,
                 boundary_threshold, exchange, use_packed, sentinel,
                 precision, extra_dense: int):
        if use_packed is False:
            _refuse("use_packed=False", "the generic [E, D] sharded engine "
                    "waits for a later slice")
        if sentinel:
            _refuse("sentinel=True", "the integrity sentinels come with "
                    "the resilience layer")
        if precision not in (None, "f32"):
            _refuse(f"precision={precision!r}", "only f32 runs")
        self.base = tensors
        self.mesh: List[torch.device] = [
            _canonical(d) for d in (build_mesh() if mesh is None else mesh)]
        self.n_shards = len(self.mesh)
        self.precision = "f32"
        self.packs: ShardPacks = build_shard_packs(tensors, self.mesh,
                                                   assigns)
        self.comm = _plan_comm(overlap, boundary_threshold, exchange,
                               self.packs.boundary, self.packs.Vp,
                               self.packs.D, extra_dense)

    @property
    def shards(self):
        return self.packs.shards

    @property
    def groups(self):
        return self.packs.groups

    def _gathered(self, results, fill=None) -> List[torch.Tensor]:
        """The groups' device-level results → one combined [R, Vp] tensor
        per group.  A whole group's launch combined already; else the
        groups' per-shard partials are added in shard order across the
        devices and the unary row after them (``fill``: where(mask > 0,
        that, fill)), as the launch does for a whole group."""
        if self.groups[0].whole:
            return list(results)
        parts = [None] * self.n_shards
        for g, res in zip(self.groups, results):
            for k, s in enumerate(g.index):
                parts[s] = res[k]
        totals = all_sum(parts, self.mesh)
        out = []
        for g in self.groups:
            tot = g.unary_p + totals[g.index[0]]
            if fill is not None:
                tot = torch.where(g.mask_p > 0, tot, fill)
            out.append(tot)
        return out

    def _slabs(self, per_shard: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        """Per-shard [R, N_s] (or [N_s]) tensors → one slab per group."""
        return [g.slab_of([per_shard[s] for s in g.index])
                for g in self.groups]

    def _per_shard(self, per_group: Sequence[torch.Tensor],
                   rows: Optional[int] = None, slab: bool = True) -> tuple:
        """One slab per group → the shards' views of them (``rows`` as
        :meth:`ShardGroup.views`); ``slab=False``: one replicated tensor
        per group, shared by its shards."""
        out = [None] * self.n_shards
        for g, t in zip(self.groups, per_group):
            pieces = g.views(t, rows) if slab else [t] * len(g.index)
            for s, v in zip(g.index, pieces):
                out[s] = v
        return tuple(out)

    def comm_stats(self) -> dict:
        """The collective path and partition quality as a plain dict
        (``SolveResult.metrics()["shard"]``): the JAX package's fields,
        with ``mode`` "dense" and the resolved ``requested`` overlap
        beside it (a stated difference: JAX's "auto" may run its compact
        "exact" path, which it states equals the dense one)."""
        out = self.comm.counters(self.n_shards).as_dict()
        out["requested"] = self.comm.requested
        return out

    def _refuse_editing(self, name: str):
        _refuse(name, "operand editing comes with the resilience layer")

    def get_operand(self, name: str):
        self._refuse_editing("get_operand")

    def set_operand(self, name: str, array) -> None:
        self._refuse_editing("set_operand")

    def edit_factor(self, bucket_i: int, factor_i: int, table) -> None:
        self._refuse_editing("edit_factor")

    def state_to_host(self, q, r):
        self._refuse_editing("state_to_host")


class ShardedMaxSum(_ShardedEngine):
    """MaxSum with the factors split over the shards of ``mesh`` (a list of
    devices, :func:`build_mesh` by default): one K7 launch per device per
    cycle, the shard-order sum of the partial beliefs inside it when one
    device holds every shard.

    The schedule is the JAX packed engine's, rotated: launch n runs cycle
    n-1's variable side (from the combined beliefs) and cycle n's factor
    side; then ``beliefs = unary + Σ_s partial_s`` in shard order.  The
    continuation state is ``(r_u, beliefs)``: each shard's unmasked factor
    messages and the combined beliefs, one copy per shard (shards on one
    device share it).  Values are the masked argmin of the final beliefs.

    ``activation`` < 1 runs amaxsum (the JAX package's emulation of
    asynchronous MaxSum): each cycle only the slots whose uniform draw is
    below ``activation`` commit their new messages, the others keep the
    previous cycle's.  Cycle n's mask is applied at the start of launch
    n+1, where the rotation moved cycle n's variable side, so the state
    becomes ``(q_m, r_m, r_u, beliefs, pending)``: the committed messages,
    the unmasked ones, the beliefs, and the pending mask per shard.  The
    uniforms are drawn on the CPU from a ``torch.Generator`` seeded with
    ``run``'s ``seed`` at a fresh start (a continuation draws on), one
    ``[cycles, N_s]`` array per shard in shard order
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
                         sentinel, precision, extra_dense=0)
        self.damping = float(damping)
        self.activation = (None if activation is None or activation >= 1.0
                           else float(activation))
        self.coins = torch.Generator(device="cpu")

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
        D = self.packs.D
        if self.activation is None:
            r_u, bel = state
            return (self._per_shard(r_u, D),
                    self._per_shard(bel, slab=False))
        q_m, r_m, r_u, bel, pend = state
        return (self._per_shard(q_m, D), self._per_shard(r_m, D),
                self._per_shard(r_u, D), self._per_shard(bel, slab=False),
                self._per_shard(pend))

    def _group_state(self, state) -> tuple:
        """Per-shard tuples → the groups' state (one copy per group)."""
        bel = [state[-1 if self.activation is None else 3][g.index[0]]
               for g in self.groups]
        if self.activation is None:
            return self._slabs(state[0]), bel
        q_m, r_m, r_u, _, pend = state
        return (self._slabs(q_m), self._slabs(r_m), self._slabs(r_u), bel,
                self._slabs(pend))

    def init_messages(self):
        """The zero state, as (q, r): both are the same opaque state."""
        state = self._shard_state(self._zero_state())
        return state, state

    def _validate_continuation(self, q, r) -> None:
        sp = self.packs
        slots = [(sp.D, sh.N) for sh in sp.shards]
        bel = [(sp.D, sp.Vp)] * self.n_shards
        want = [slots, bel] if self.activation is None else \
            [slots, slots, slots, bel, [(sh.N,) for sh in sp.shards]]
        for name, s in (("q", q), ("r", r)):
            ok = isinstance(s, tuple) and len(s) == len(want) and all(
                isinstance(part, tuple)
                and [tuple(t.shape) for t in part] == w
                for part, w in zip(s, want))
            if not ok:
                raise ValueError(
                    f"continuation state mismatch: {name} must be the "
                    f"state of a prior run() of the same solver "
                    f"configuration")

    def cycle(self, r_u: Sequence[torch.Tensor],
              bel: Sequence[torch.Tensor]):
        """One sharded cycle over the groups' r_u slabs and beliefs:
        (r_u', beliefs') per group."""
        outs = [K.device_fused_ba(g, b, r, self.damping)
                for g, b, r in zip(self.groups, bel, r_u)]
        return ([o[0] for o in outs],
                self._gathered([o[1] for o in outs]))

    def cycle_act(self, state, active):
        """One amaxsum cycle from the groups' ``state`` = (q_m, r_m, r_u,
        beliefs, pending); ``active`` is this cycle's mask per group
        ([n_slots] float32 on the group's device), which becomes the next
        pending mask."""
        q_m, r_m, r_u, bel, pend = state
        outs = [K.device_fused_ba(g, b, r, self.damping, qm, rm, p)
                for g, b, r, qm, rm, p in zip(self.groups, bel, r_u, q_m,
                                              r_m, pend)]
        return ([o[2] for o in outs], [o[3] for o in outs],
                [o[0] for o in outs],
                self._gathered([o[1] for o in outs]), list(active))

    def draw_uniforms(self, n: int) -> List[torch.Tensor]:
        """The activation uniforms of the next ``n`` cycles: one [n, N_s]
        float32 array per shard, in shard order, on the CPU."""
        return [torch.rand((n, sh.N), generator=self.coins)
                for sh in self.shards]

    def values_of(self, bel: torch.Tensor) -> torch.Tensor:
        """Masked argmin per column (= variable), first index on ties."""
        mask_p = self.packs.common_on(bel.device)[1]
        return torch.argmin(torch.where(mask_p > 0, bel, PAD_COST), dim=0)

    def run(self, cycles: int = 20, q=None, r=None, seed: int = 0):
        """Run ``cycles`` sharded cycles; returns (values [V] on the host,
        q, r).  Pass the previous call's (q, r) to continue instead of
        restarting from zero messages (they are one opaque state,
        validated against this solver).  ``seed`` seeds amaxsum's mask
        draws at a fresh start."""
        if q is None or r is None:
            state = self._zero_state()
            self.coins.manual_seed(seed)
        else:
            self._validate_continuation(q, r)
            state = self._group_state(q)
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
        values = self.values_of(bel[0]).cpu().numpy().astype(np.int32)
        out = self._shard_state(state)
        return values, out, out


class ShardedLocalSearch(_ShardedEngine):
    """MGM, DSA or ADSA with the constraints split over the shards of
    ``mesh`` (a list of devices, :func:`build_mesh` by default).

    One cycle: K9 once per device, ``tables = where(mask, unary + the
    shards' partial tables in shard order, PAD_COST)``, then cur / best /
    gain (best with the prefer-change nudge for dsa and adsa) and the move
    rule.  DSA: move iff gain > 1e-9 and the coin < probability.  ADSA:
    the variant's want-rule, a wake coin < activation and a move coin <
    probability.  MGM: K8 once per device, the whole neighbourhood
    arbitration inside it when one device holds every shard (across
    devices: the groups' partial maxima, their ordered max clamped at 0,
    the partial tie-break indices, their ordered min, the decision).

    The assignment is an int32 ``[V]`` tensor (column = variable) on the
    first shard's device.  Coins are uniforms per variable per cycle in
    variable order, drawn on the CPU from a ``torch.Generator`` seeded
    with ``seed`` (adsa: the wake row then the move row of a call), or
    passed in as ``coins``; the JAX package's packed engine draws its own
    in column space, so the coin streams differ (a stated deviation, as
    in the single-device solvers)."""

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
        if rule in ("dba", "gdba"):
            _refuse(f"rule={rule!r}", "the breakout rules run the generic "
                    "sharded engine, which waits for a later slice")
        params = dict(algo_params or {})
        if rule == "adsa" and params.get("variant", "B") not in (
                "A", "B", "C"):
            raise ValueError(f"unknown adsa variant {params['variant']!r}")
        if precision is None:
            precision = params.pop("precision", None)
        super().__init__(tensors, mesh, None, overlap, boundary_threshold,
                         exchange, use_packed, sentinel, precision,
                         extra_dense=2 if rule == "mgm" else 0)
        self.rule = rule
        self.probability = float(probability)
        self.params = params

    # -- continuation state ------------------------------------------------

    def state_from_values(self, values) -> torch.Tensor:
        """[V] value indices → the continuation state (int32 [V] on the
        first shard's device)."""
        return torch.as_tensor(np.array(values), dtype=torch.int32,
                               device=self.mesh[0])

    def state_values(self, x) -> np.ndarray:
        """Continuation state → host [V] int32 assignment."""
        return x.cpu().numpy().astype(np.int32)

    def initial_aux(self):
        """Breakout weight state: none for mgm/dsa/adsa."""
        return ()

    # -- one cycle -----------------------------------------------------------

    def _mgm_move(self, gains: List[torch.Tensor]) -> List[torch.Tensor]:
        """The move mask per group from the gains per group: one K8 launch
        when one device holds every shard; across devices each group's
        partial neighbourhood max, their ordered max clamped at 0, each
        group's partial tie-break index, their ordered min, then the
        decision."""
        rows = [self.packs.common_on(g.device)[2] for g in self.groups]
        if self.groups[0].whole:
            return [K.device_mgm_move(self.groups[0], gains[0], rows[0])]
        devs = [g.device for g in self.groups]
        maxed = all_max([K.device_mgm_move(g, gain, mode="max")
                         for g, gain in zip(self.groups, gains)], devs)
        neigh_max = [torch.clamp_min(m, 0.0) for m in maxed]
        idx_at_max = all_min(
            [K.device_mgm_move(g, gain, mode="min", neigh_max=nm)
             for g, gain, nm in zip(self.groups, gains, neigh_max)], devs)
        return [K.mgm_decision(gain, row, nm, idx)
                for gain, row, nm, idx in zip(gains, rows, neigh_max,
                                              idx_at_max)]

    def cycle(self, x: torch.Tensor, coins=None) -> torch.Tensor:
        """One sharded cycle from the assignment ``x``; ``coins`` is this
        cycle's uniforms per variable (dsa: the move row; adsa: (wake,
        move)), on the first shard's device, or None for mgm."""
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
            moves = []
            for g, xg, (cur, best, gain) in zip(self.groups, xs, cbg):
                c = [u.to(g.device) for u in coins]
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
        _, best, _ = cbg[0]  # group 0 holds shard 0, on x's device
        return torch.where(moves[0], best, xs[0])

    # -- runs --------------------------------------------------------------

    def _coins(self, cycles: int, seed: int, coins):
        """The coin rows of ``cycles`` cycles on the first shard's device:
        a tuple of [cycles, V] arrays (dsa: (move,), adsa: (wake, move)),
        or () for mgm."""
        n_rows = {"mgm": 0, "dsa": 1, "adsa": 2}[self.rule]
        if n_rows == 0:
            return ()
        V = self.packs.Vp
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
        chunked MGM run equals one unchunked run of the same cycles."""
        from pydcop_tpu_torch.algorithms._local_search import \
            random_valid_values

        if x is None:
            x = self.state_from_values(
                random_valid_values(self.base, seed + 17).cpu().numpy())
        if aux is None:
            aux = self.initial_aux()
        rows = self._coins(int(cycles), seed, coins)
        for c in range(int(cycles)):
            x = self.cycle(x, tuple(r[c] for r in rows))
        return self.state_values(x), x, aux

    def run(self, cycles: int = 20, seed: int = 0) -> np.ndarray:
        """The final value indices [V] after ``cycles`` cycles."""
        values, _x, _aux = self.run_chunked(cycles, seed=seed)
        return values
