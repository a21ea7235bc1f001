"""Slot scheduler — continuous batching over the batch engine's buckets.

The port of the JAX package's ``serve/scheduler.py``.  The batch engine
(:mod:`pydcop_tpu_torch.batch`) solves a *static* list of instances:
every bucket is formed once and runs to completion.  A serving workload
is a stream, so this module keeps each bucket *open*:

* a :class:`BucketWorker` owns ONE fixed-shape bucket runner (the
  engine's :class:`~pydcop_tpu_torch.batch.engine.BucketRunner`: the
  union graph of ``B`` padded lanes in buffers that its captured CUDA
  graph reads), handed to it alone by the runner cache
  (:meth:`~pydcop_tpu_torch.batch.cache.CompileCache.checkout`) and
  returned when the worker closes;
* each lane independently carries one job at its own age: the runner's
  per-lane cycle counts let lane *i* advance ``n_i`` cycles per step
  while its neighbours advance a different count;
* when a lane's job converges (or its deadline expires) the lane is
  released at the chunk boundary and the next queued job is written
  into the freed slot, in place (``BucketRunner.load_lane``) — the
  continuous part of the batching;
* deadline-pressured lanes shrink their own per-step cycle count via
  the harness's :func:`~pydcop_tpu_torch.algorithms.base.
  clamp_chunk_to_deadline`.

Bit-identity is the contract: a lane's coin stream is its OWN solver's
generator (the port's stream, drawn at the job's TRUE shape by the
harness's per-chunk policy), its convergence accounting (first-chunk
skip, two stable chunks, the age limit) is the harness's own, and
padding is inert by routing — so a job admitted into a running bucket,
a job that joins a freed lane and a job migrated between same-signature
buckets all produce the SAME bits as a standalone ``solver.run``.  The
one documented exception: deadline-shrunk lanes change their own chunk
boundaries — and with them their own stream — as a standalone solve
under a ``timeout`` does; other lanes are unaffected.

A lane checkpoint stores the lane's state leaves and its generators'
states (``generator_<k>``); one written by the JAX package holds a JAX
PRNG key instead (``prng_key``) and is refused (:func:`restore_lane_state`).
"""
from __future__ import annotations

import dataclasses
from time import monotonic, perf_counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import DEFAULT_INFINITY
from pydcop_tpu_torch.algorithms.base import (
    SolveResult,
    clamp_chunk_to_deadline,
    default_chunk,
)
from pydcop_tpu_torch.batch.bucketing import InstanceDims, bucket_signature
from pydcop_tpu_torch.batch.engine import (
    DEFAULT_MAX_CYCLES,
    WARMUP_CALLS,
    BucketMeta,
    _params_key,
    adapter_for,
    build_bucket_runner,
    runner_cache_key,
)
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime.stats import ServeCounters

#: the runner calls a worker reports (``SolveService.metrics()["runners"]``)
RUNNER_CALLS = ("eager_calls", "captures", "replays", "regrows")


def serve_target(members: Sequence[InstanceDims]) -> InstanceDims:
    """Element-wise max of the members' dims with the dummy-variable
    slot ALWAYS reserved: a serving bucket outlives its founding jobs,
    and any later arrival smaller than the target needs the dummy to
    route its factor/pair padding to (engine.pad_instance)."""
    first = members[0]
    return InstanceDims(
        graph_type=first.graph_type,
        D=max(m.D for m in members),
        arities=first.arities,
        V=max(m.V for m in members) + 1,
        F=tuple(
            max(m.F[i] for m in members)
            for i in range(len(first.arities))
        ),
        M=max(m.M for m in members),
    )


def fits(dims: InstanceDims, target: InstanceDims) -> bool:
    """Can an instance with ``dims`` be padded into ``target``?  The
    arity set must match exactly (a missing arity bucket cannot be
    padded in); everything else pads up, with one variable slot held
    back for the dummy."""
    return (
        dims.graph_type == target.graph_type
        and dims.arities == target.arities
        and dims.D <= target.D
        and dims.V <= target.V - 1
        and all(f <= tf for f, tf in zip(dims.F, target.F))
        and dims.M <= target.M
    )


def dummy_bucket_inputs(algo: str, target: InstanceDims, B: int,
                        chunk: int):
    """``(arrays, leaves, coins)`` of a bucket whose ``B`` lanes are all
    idle, at the exact shapes the runner expects: each lane's padded
    arrays (one valid value a variable, zero costs), the union's state
    leaves (zeros) and a chunk of all-ones coins (``[chunk, B·Vp]``, or
    none for an algorithm that draws none).  Idle lanes are also frozen
    by the done mask; this keeps their cycles finite and gives a
    prewarm concrete buffers to capture against."""
    adapter = adapter_for(algo)
    arrays = [adapter.idle_arrays(target) for _ in range(B)]
    meta = BucketMeta.of(target)
    kinds = adapter.leaf_kinds(meta)
    from pydcop_tpu_torch.batch.engine import _Layout

    layout = _Layout(meta, B, torch.device("cpu"))
    leaves = tuple(layout.stack(kind, [leaf] * B)
                   for kind, leaf in zip(kinds, adapter.idle_leaves(target)))
    coins = adapter.chunk_coins_per_lane([None] * B, [0] * B, target, chunk)
    return arrays, leaves, coins


def lane_depths(arrays: Dict[str, np.ndarray], graph_type: str,
                n_vars: int) -> Dict[Tuple[str, Optional[int]], int]:
    """The rank-table depths one lane's padded arrays need, by
    ``(field, column)``: a variable's largest row count."""
    def deepest(ids):
        ids = np.asarray(ids).reshape(-1)
        return int(np.bincount(ids, minlength=n_vars).max(initial=0))

    if graph_type == "factor_graph":
        return {("edge_var", None): deepest(arrays["edge_var"])}
    out = {}
    i = 0
    while f"bv{i}" in arrays:
        bv = np.asarray(arrays[f"bv{i}"])
        for p in range(bv.shape[1]):
            out[f"bv{i}", p] = deepest(bv[:, p])
        i += 1
    return out


def warm_bucket_runner(adapter, target: InstanceDims,
                       params: Dict[str, Any], B: int, chunk: int,
                       aot: bool = False, device: DeviceLike = None,
                       like: Optional[Sequence[Dict[str, np.ndarray]]]
                       = None):
    """Build one bucket runner AND run it: its warm-up call and, on the
    card, the capture of its chunk (:data:`~pydcop_tpu_torch.batch.
    engine.WARMUP_CALLS` + 1 calls) on dummy inputs with every lane
    idle and done, so a prewarmed signature's first admitted step
    replays.  ``like`` (padded lane arrays of the expected traffic)
    sizes the rank tables for the deepest of them, so admitting such a
    lane regrows nothing.  ``aot=True`` (the JAX package's serialized
    runner artifacts) raises :class:`NotPortedError`."""
    if aot:
        raise NotPortedError(
            "ahead-of-time runner artifacts (warm_bucket_runner(aot=True), "
            "the fleet's artifact store) are not ported to the PyTorch "
            "package: a bucket runner is a CUDA graph held in its process")
    device = resolve_device(device)
    meta = BucketMeta.of(target)
    runner = build_bucket_runner(adapter, meta, B, params, chunk, device)
    depths: Dict[Tuple[str, Optional[int]], int] = {}
    for arrays in like or ():
        for k, d in lane_depths(arrays, target.graph_type, target.V).items():
            depths[k] = max(depths.get(k, 0), d)
    state = runner.load_idle(target, depths)
    _, _, coins = dummy_bucket_inputs(adapter.algo, target, B, chunk)
    for _ in range(WARMUP_CALLS + 1):
        state, _, flags = runner(state, coins, [0] * B)
    flags.cpu()
    return runner


def runner_totals(runner) -> Dict[str, int]:
    """A runner's eager calls, captures, replays and regrows so far."""
    return {**runner.calls(), "regrows": runner.regrows}


@dataclasses.dataclass
class _Lane:
    """One occupied lane: a job plus its private harness accounting."""

    job: Any  # serve.service.ServeJob
    spec: Any  # engine._Spec
    #: the lane's stream: its solver's coin generators (none for mgm,
    #: maxsum, gdba), advanced only by this lane's draws
    key: Tuple[torch.Generator, ...]
    #: the lane's padded arrays (what a merge writes into another union)
    arrays: Dict[str, np.ndarray] = dataclasses.field(repr=False,
                                                      default=None)
    age: int = 0  # cycles this job has run (its stop_cycle when done)
    stable: int = 0  # consecutive stable chunks (2 → converged)
    first_chunk: bool = True  # harness parity: skip the first conv flag
    converged: bool = False


class BucketWorker:
    """One continuously-batched bucket: ``B`` lanes stepping through
    one fixed-shape runner, chunk by chunk, on ``device`` (cuda unless
    the caller asks for the CPU).

    The worker itself is single-threaded by contract (the service's
    scheduler thread is its only caller, and on the card it is the
    thread that captures and replays the runner's graph); cross-thread
    safety lives in the runner cache and the service's queues."""

    def __init__(
        self,
        algo: str,
        params: Optional[Dict[str, Any]],
        target: InstanceDims,
        lanes: int,
        cache,
        counters: Optional[ServeCounters] = None,
        limit: int = DEFAULT_MAX_CYCLES,
        chunk: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.algo = algo
        self.params = dict(params or {})
        self.adapter = adapter_for(algo)
        self.target = target
        self.meta = BucketMeta.of(target)
        self.B = int(lanes)
        self.limit = int(limit)
        # the harness's exact chunk policy: the per-chunk coin stream
        # depends on it, so serve may not choose its own
        self.chunk = (
            chunk if chunk is not None
            else default_chunk(None, False, False, None, self.limit)
        )
        self.counters = counters if counters is not None else ServeCounters()
        self.pkey = _params_key(self.params)
        self.signature = bucket_signature(target, self.B)
        self.cache = cache
        self.key = runner_cache_key(algo, self.pkey, self.signature,
                                    self.chunk, self.device)
        # a miss builds the runner with its buffers deferred to the first
        # step, sized by the lanes admitted by then (no dummy capture)
        self.runner, self.runner_was_warm = cache.checkout(
            self.key,
            lambda: build_bucket_runner(self.adapter, self.meta, self.B,
                                        self.params, self.chunk,
                                        self.device),
        )
        self._calls0 = (runner_totals(self.runner) if self.runner_was_warm
                        else dict.fromkeys(RUNNER_CALLS, 0))
        self.state = self.runner.load_idle(target)
        self.lanes: List[Optional[_Lane]] = [None] * self.B
        self._used = [False] * self.B  # slot hosted a previous job
        self.steps = 0  # chunk boundaries crossed
        self.rate: Optional[float] = None  # measured cycles/sec (EMA)
        #: lanes whose float state went NaN/Inf on the LAST step —
        #: refreshed per step from the runner's finiteness flags; the
        #: service quarantines them before reading results
        self.nonfinite: List[int] = []
        #: quarantine isolation tag: a worker only admits jobs carrying
        #: the SAME tag (None = regular traffic), so bisected suspect
        #: groups cannot re-contaminate healthy buckets
        self.isolate_key: Optional[str] = None
        #: deadline-pressure scaling of the chunk clamp
        #: (SolveService.set_deadline_pressure): < 1 makes deadline lanes
        #: below ``pressure_exempt_priority`` see only that fraction of
        #: their remaining budget
        self.deadline_pressure: float = 1.0
        self.pressure_exempt_priority: Optional[int] = None

    # -- occupancy ----------------------------------------------------------

    @property
    def occupied(self) -> int:
        return sum(1 for ln in self.lanes if ln is not None)

    @property
    def free(self) -> int:
        return self.B - self.occupied

    def matches(self, algo: str, pkey: Tuple) -> bool:
        return self.algo == algo and self.pkey == pkey

    def runner_calls(self) -> Dict[str, int]:
        """The runner calls this worker made (a cold runner's from its
        build on)."""
        now = runner_totals(self.runner)
        return {k: now[k] - self._calls0[k] for k in RUNNER_CALLS}

    def close(self, keep_runner: bool = True) -> None:
        """Hand the runner back to the cache's pool (``keep_runner``) or
        drop it (a worker whose step threw)."""
        if self.runner is not None and keep_runner:
            self.cache.checkin(self.key, self.runner)
        self.runner = None

    # -- admission / release ------------------------------------------------

    def admit(self, job, spec, restore: Optional[Tuple] = None) -> int:
        """Fold one job into a free lane at the current chunk boundary.

        ``restore = (leaves, generator_states, age, stable, first_chunk)``
        re-seats a journal-checkpointed job exactly where it stopped;
        otherwise the lane starts the job's own fresh stream (its
        solver's generators reseeded, as ``solver.run`` restarts them,
        cycle 0)."""
        i = self.lanes.index(None)
        arrays = self.adapter.lane_arrays(spec, self.target, spread=True)
        self.runner.load_lane(i, arrays)
        gens = self.adapter.lane_generators(spec)
        if restore is not None:
            leaves, gen_states, age, stable, first = restore
            for g, st in zip(gens, gen_states):
                g.set_state(torch.as_tensor(np.asarray(st, np.uint8)))
        else:
            leaves = self.adapter.initial_leaves(spec, self.target)
            spec.solver._restart_streams(False)
            age, stable, first = 0, 0, True
        self.runner.write_lane(self.state, i, leaves)
        self.lanes[i] = _Lane(job=job, spec=spec, key=gens, arrays=arrays,
                              age=age, stable=stable, first_chunk=first)
        self.counters.inc("jobs_admitted")
        if self._used[i]:
            self.counters.inc("lanes_reused")
        self._used[i] = True
        if self.steps > 0:
            self.counters.inc("midflight_admissions")
        return i

    def release(self, i: int) -> None:
        self.lanes[i] = None

    def poison_lane(self, i: int) -> bool:
        """Overwrite lane ``i``'s float state leaves with NaN, in place in
        the state buffers — the chaos hook behind the ``nan_lane`` fault,
        so the device-side finiteness check (and everything downstream of
        it) runs exactly as for a real numerical blow-up.  Returns False
        when the state has no float leaf (mgm, dsa, adsa): the caller
        then quarantines the lane directly."""
        hit = False
        for kind, leaf in zip(self.runner.kinds, self.state[0]):
            if leaf.dtype.is_floating_point:
                self.runner.layout.fill(kind, leaf, i, float("nan"))
                hit = True
        return hit

    def migrate_from(self, other: "BucketWorker") -> int:
        """Fold ``other``'s occupied lanes into this worker's free
        lanes — the under-filled-bucket merge.  Only legal between
        workers of the SAME signature: each lane's arrays are written
        into this union (its rows and rank-table columns), its state rows
        copied, and its ``_Lane`` (generators included) moves, so its
        stream continues bit-identically."""
        assert other.signature == self.signature
        assert other.matches(self.algo, self.pkey)
        moved = 0
        for j, lane in enumerate(other.lanes):
            if lane is None:
                continue
            try:
                i = self.lanes.index(None)
            except ValueError:
                break
            self.runner.load_lane(i, lane.arrays)
            self.runner.write_lane(self.state, i,
                                   other.runner.read_lane(other.state, j))
            self.lanes[i] = lane
            if self._used[i]:
                self.counters.inc("lanes_reused")
            self._used[i] = True
            other.lanes[j] = None
            moved += 1
        return moved

    # -- the chunk step -----------------------------------------------------

    def step(self) -> List[Tuple[int, _Lane, str]]:
        """Advance every occupied lane one chunk; returns the lanes
        that finished this boundary as ``(index, lane, status)``.  The
        caller reads results / releases lanes / admits replacements —
        all at this boundary, which is what makes the batching
        continuous."""
        t0 = perf_counter()
        now = monotonic()
        ns: List[int] = []
        specs: List[Optional[Any]] = []
        for lane in self.lanes:
            if lane is None or lane.converged:
                ns.append(0)
                specs.append(None)
                continue
            n = min(self.chunk, self.limit - lane.age)
            if lane.job.deadline_at is not None:
                remaining = lane.job.deadline_at - now
                if self.deadline_pressure < 1.0 and (
                    self.pressure_exempt_priority is None
                    or lane.job.priority < self.pressure_exempt_priority
                ):
                    remaining *= self.deadline_pressure
                n2 = clamp_chunk_to_deadline(n, self.rate, remaining)
                if n2 < n:
                    self.counters.inc("deadline_shrunk_lanes")
                n = n2
            ns.append(n)
            specs.append(lane.spec)
        coins = self.adapter.chunk_coins_per_lane(specs, ns, self.target,
                                                  self.chunk)
        done_mask = np.array(
            [ln is None or ln.converged for ln in self.lanes], bool
        )
        done = torch.as_tensor(done_mask).to(self.device)
        self.state, _, flags = self.runner((self.state[0], done), coins, ns)
        flags_np = flags.cpu().numpy()  # the step's ONE device→host read
        conv_np, finite_np = flags_np[0], flags_np[1]
        self.nonfinite = [
            i for i, ln in enumerate(self.lanes)
            if ln is not None and not ln.converged and ns[i] > 0
            and not finite_np[i]
        ]
        wall = perf_counter() - t0
        self.steps += 1
        advanced = max(ns) if ns else 0
        if wall > 0 and advanced:
            inst = advanced / wall
            self.rate = (
                inst if self.rate is None else 0.5 * self.rate + 0.5 * inst
            )

        finished: List[Tuple[int, _Lane, str]] = []
        deadline_now = monotonic()
        for i, lane in enumerate(self.lanes):
            if lane is None or lane.converged:
                continue
            lane.age += int(ns[i])
            status = None
            if lane.first_chunk:
                # harness parity: the first chunk's flag compares
                # against the initial state and is skipped
                lane.first_chunk = False
            else:
                lane.stable = lane.stable + 1 if conv_np[i] else 0
                if lane.stable >= 2:
                    status = "FINISHED"
                    lane.converged = True
            if status is None and lane.age >= self.limit:
                status = "FINISHED"
            if (
                status is None
                and lane.job.deadline_at is not None
                and deadline_now >= lane.job.deadline_at
            ):
                status = "TIMEOUT"
            if status is not None:
                finished.append((i, lane, status))
        return finished

    # -- results / inspection ----------------------------------------------

    def lane_values(self, i: int, lane: _Lane) -> np.ndarray:
        """Host copy of lane ``i``'s TRUE-shape value indices."""
        leaf = self.state[0][self.adapter.values_leaf]
        vals = self.runner.layout.lane("var", leaf, i)
        return vals[: lane.spec.dims.V].cpu().numpy()

    def lane_result(self, i: int, lane: _Lane, status: str) -> SolveResult:
        assignment = lane.spec.tensors.assignment_from_indices(
            self.lane_values(i, lane)
        )
        violation, cost = lane.job.dcop.solution_cost(
            assignment, DEFAULT_INFINITY
        )
        solver = lane.spec.solver
        n_cyc = int(lane.age)
        return SolveResult(
            status=status,
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=n_cyc,
            msg_count=solver.msgs_per_cycle * n_cyc,
            msg_size=(solver.msgs_per_cycle * n_cyc
                      * solver.msg_size_per_msg),
            time=monotonic() - lane.job.submitted_at,
        )

    def lane_cost(self, i: int, lane: _Lane) -> Tuple[float, int]:
        """(cost, cycle) of the lane's current anytime assignment —
        the per-boundary progress stream."""
        assignment = lane.spec.tensors.assignment_from_indices(
            self.lane_values(i, lane)
        )
        _violation, cost = lane.job.dcop.solution_cost(
            assignment, DEFAULT_INFINITY
        )
        return cost, int(lane.age)

    # -- checkpointing ------------------------------------------------------

    def lane_checkpoint(self, i: int, lane: _Lane):
        """(arrays, meta) snapshot of one lane at the current chunk
        boundary, for :func:`~pydcop_tpu_torch.runtime.checkpoint.
        write_state_npz`.  The graph arrays are NOT stored — they
        recompile deterministically from the job's source file + seed;
        only the lane's state leaves (``leaf_<j>``, its padded layout),
        its generators' states (``generator_<k>``) and its harness
        accounting are."""
        leaves = self.runner.read_lane(self.state, i)
        arrays = {f"leaf_{j}": leaf.cpu().numpy()
                  for j, leaf in enumerate(leaves)}
        for k, g in enumerate(lane.key):
            arrays[f"generator_{k}"] = g.get_state().numpy()
        meta = {
            "jid": lane.job.jid,
            "algo": self.algo,
            "age": int(lane.age),
            "stable": int(lane.stable),
            "first_chunk": bool(lane.first_chunk),
            "n_leaves": len(leaves),
            "n_generators": len(lane.key),
            "target": dataclasses.asdict(self.target),
        }
        return arrays, meta


def restore_lane_state(adapter, spec, target: InstanceDims,
                       arrays: Dict[str, np.ndarray], meta: Dict) -> Tuple:
    """Rebuild a lane's ``(leaves, generator_states, age, stable,
    first_chunk)`` restore tuple from a checkpoint container.  The
    leaf count and shapes come from the adapter's own initial leaves at
    the SAME target the checkpoint was taken at, so a schema drift fails
    loudly instead of mis-seating.  A lane checkpoint written by the JAX
    package (a JAX PRNG key, ``prng_key``) raises ``ValueError``: its
    stream is not the PyTorch package's and is never seated on it."""
    if "prng_key" in arrays:
        raise ValueError(
            f"lane checkpoint for {meta.get('jid')!r} holds a JAX PRNG key "
            f"(prng_key): it was written by the JAX package, whose coin "
            f"stream is not this package's; it cannot be resumed here")
    ref = adapter.initial_leaves(spec, target)
    n = int(meta["n_leaves"])
    if n != len(ref):
        raise ValueError(
            f"checkpoint for {meta.get('jid')!r} has {n} state leaves, "
            f"solver expects {len(ref)}"
        )
    leaves = []
    for j, ref_leaf in enumerate(ref):
        leaf = np.asarray(arrays[f"leaf_{j}"])
        if leaf.shape != np.asarray(ref_leaf).shape:
            raise ValueError(
                f"checkpoint leaf {j} shape {leaf.shape} does not match "
                f"solver state shape {np.asarray(ref_leaf).shape}"
            )
        leaves.append(leaf)
    n_gen = len(adapter.lane_generators(spec))
    if int(meta.get("n_generators", -1)) != n_gen:
        raise ValueError(
            f"checkpoint for {meta.get('jid')!r} has "
            f"{meta.get('n_generators')} generator states, the solver "
            f"draws from {n_gen}"
        )
    gen_states = [np.asarray(arrays[f"generator_{k}"])
                  for k in range(n_gen)]
    return (
        leaves,
        gen_states,
        int(meta["age"]),
        int(meta["stable"]),
        bool(meta["first_chunk"]),
    )


__all__ = ["BucketWorker", "dummy_bucket_inputs", "fits", "lane_depths",
           "restore_lane_state", "serve_target", "warm_bucket_runner"]
