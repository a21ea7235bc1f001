"""SolveService — the streaming front door over the batch engine.

The port of the JAX package's ``serve/service.py``.  A persistent
in-process solve service: callers :meth:`SolveService.submit` jobs
(instance + tenant + priority + optional deadline) from any thread, a
single scheduler thread routes them by shape signature into
continuously-batched :class:`~pydcop_tpu_torch.serve.scheduler.
BucketWorker` buckets, and results stream back three ways —
:meth:`SolveService.result` (blocking future), :meth:`SolveService.stream`
(per-job anytime-assignment iterator) and the ``serve.*`` topics on the
process event bus.  The buckets run on ``device`` (cuda unless the
caller asks for the CPU).

Scheduling policy, in the order the tick applies it:

1. **admission** — pending jobs (highest priority first, FIFO within a
   priority) fold into the free lanes of a running bucket whose target
   shape fits them; what remains opens new buckets, preferring
   prewarmed signatures so admission takes a runner whose graph is
   already captured;
2. **stepping** — every occupied bucket advances one chunk; lanes that
   converge (or expire their deadline — counted as preempted) complete
   their jobs and free their slots at that same boundary;
3. **maintenance** — empty buckets close (their runner goes back to the
   cache's pool), and two under-filled buckets of the same signature
   merge (lane rows copy verbatim, streams continue bit-identically).

On the card every CUDA graph is captured and replayed by the scheduler
thread (or by the caller of :meth:`SolveService.tick` when no thread
runs): a prewarm asked for while the thread runs is queued to it, and
the prep pool that builds the jobs' specs works on the CPU only.

Crash safety: with a ``journal_dir`` every submission is journaled
(``jobs.jsonl``), every completion registers a ``JID:`` line (the batch
command's resume protocol), and every occupied lane snapshots its state
and its generators at periodic chunk boundaries (atomic + CRC,
:mod:`pydcop_tpu_torch.runtime.checkpoint`).  A restarted service
:meth:`SolveService.resume`-s: completed jobs are skipped, in-flight
jobs re-seat at their last checkpointed chunk boundary and continue the
SAME stream — their results stay bit-identical to an uninterrupted
solve.  Journal lines cut short by a crash mid-append are skipped and
counted, never fatal, and done-job records are compacted away (atomic
rewrite) so a long-running service's journal stays bounded.  A lane
checkpoint written by the JAX package (a JAX PRNG key) is refused and
its job restarts from cycle 0 on this package's stream.

Fault isolation is layered the way an OS supervises processes:

* a **bucket step** that throws (a CUDA error, an injected fault) tears
  down only that bucket: its jobs are bisected into isolated suspect
  groups and re-run from cycle 0, so the poison job is cornered while
  its healthy bucket-mates complete bit-identically (a fresh lane IS
  the standalone stream);
* a cornered **poison job** climbs a bounded ladder — retry with
  exponential backoff, then a sequential-fallback solve, then a
  terminal ``ERROR`` — and a lane whose float state goes NaN/Inf
  (device-side check at every chunk boundary) enters the same ladder;
* the **scheduler loop** itself is supervised: a tick that throws is
  relaunched with exponential backoff; if the restart budget is
  exhausted every pending job fails with
  :class:`~pydcop_tpu_torch.serve.errors.ServiceStopped` — ``result()``
  raises, it never hangs;
* **admission control** keeps overload a designed-for state: a bounded
  pending queue with priority-aware shedding, per-tenant quotas and
  deadline-infeasibility rejection, all surfaced as structured
  :class:`~pydcop_tpu_torch.serve.errors.ServiceOverloaded` errors with
  a retry-after hint.

All of it is observable (``serve.fault.*`` events +
:class:`~pydcop_tpu_torch.runtime.stats.ServeCounters`) and
deterministically testable through the seedable serve faults in
:mod:`pydcop_tpu_torch.runtime.faults`.  The solution cache (``memo=``)
and the portfolio prewarm (``prewarm_predicted``) are not ported yet and
raise :class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import tempfile
import threading
from collections import deque
from time import monotonic, sleep
from typing import (
    Any,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

from pydcop_tpu_torch.algorithms.base import SolveResult, default_chunk
from pydcop_tpu_torch.batch.bucketing import InstanceDims, bucket_signature
from pydcop_tpu_torch.batch.cache import CompileCache, global_compile_cache
from pydcop_tpu_torch.batch.engine import (
    DEFAULT_MAX_CYCLES,
    SUPPORTED_ALGOS,
    BatchItem,
    _params_key,
    adapter_for,
    runner_cache_key,
)
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime.events import event_bus, send_serve
from pydcop_tpu_torch.runtime.faults import (
    FaultPlan,
    InjectedFault,
    ServeFaultInjector,
)
from pydcop_tpu_torch.runtime.stats import ServeCounters
from pydcop_tpu_torch.serve.errors import (
    DeadlineInfeasible,
    ServiceOverloaded,
    ServiceStopped,
)
from pydcop_tpu_torch.serve.scheduler import (
    RUNNER_CALLS,
    BucketWorker,
    fits,
    restore_lane_state,
    runner_totals,
    serve_target,
    warm_bucket_runner,
)

#: journal file names inside ``journal_dir``
JOBS_JOURNAL = "jobs.jsonl"
PROGRESS_FILE = "progress_serve"
CKPT_SUBDIR = "ckpt"


def restore_target(meta: Dict[str, Any]) -> InstanceDims:
    """The exact padded target a checkpointed lane must re-seat at —
    its state leaves are target-shaped, so re-seating anywhere else
    would fail loudly in restore_lane_state."""
    t = dict(meta["target"])
    t["arities"] = tuple(t["arities"])
    t["F"] = tuple(t["F"])
    return InstanceDims(**t)


@dataclasses.dataclass
class ServeJob:
    """One submitted job and its runtime bookkeeping."""

    jid: str
    dcop: Any
    algo: str
    algo_params: Dict[str, Any]
    seed: int
    tenant: str
    priority: int
    deadline_s: Optional[float]
    deadline_at: Optional[float]  # monotonic absolute deadline
    label: Optional[str]
    source_file: Optional[str]
    stream: bool
    submitted_at: float
    seq: int
    # scheduler-side state
    spec: Any = None
    spec_future: Any = None  # in-flight background spec build
    restore: Optional[Tuple] = None  # checkpointed lane restore tuple
    resumed: bool = False
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: Optional[SolveResult] = None
    events: "queue.Queue" = dataclasses.field(
        default_factory=lambda: queue.Queue(maxsize=1024)
    )
    # fault-isolation / admission bookkeeping
    counters: Optional[ServeCounters] = None
    in_backlog: bool = False  # counted against the bounded queue
    retries: int = 0  # quarantine re-admissions consumed
    not_before: float = 0.0  # monotonic backoff gate on re-admission
    isolate_key: Optional[str] = None  # quarantine group tag
    lossy_notified: bool = False  # one serve.stream.lossy per job
    service_stopped: bool = False  # failed by a dead scheduler

    def restore_target(self) -> InstanceDims:
        """The exact padded target a checkpointed job must re-seat at
        (its state leaves are target-shaped)."""
        assert self.restore is not None
        return restore_target(self.restore[0])

    def emit(self, event: str, payload: Dict[str, Any]) -> None:
        send_serve(event, payload)
        if self.stream:
            try:
                self.events.put_nowait({"event": event, **payload})
            except queue.Full:
                # slow consumer: drop, never block solve — but COUNT
                # the drop against the TENANT and tell the stream once
                # that it is lossy, so a starved consumer is an alert,
                # not a mystery
                if self.counters is not None:
                    self.counters.drop_event(self.tenant)
                if not self.lossy_notified:
                    self.lossy_notified = True
                    send_serve("stream.lossy", {"jid": self.jid})


class SolveService:
    """Continuous-batching solve service over the batch engine.

    >>> # sketch:
    >>> # svc = SolveService(lanes=8)
    >>> # svc.start()
    >>> # jid = svc.submit(dcop, "mgm", tenant="t1", priority=1)
    >>> # res = svc.result(jid, timeout=30)
    >>> # svc.stop()

    ``lanes`` is the slot count of each bucket the service opens, and
    ``device`` the device its buckets and fallback solves run on (cuda
    unless the caller passes ``device="cpu"``; a missing GPU raises).
    ``cache=None`` shares the process-wide runner cache (so a restart
    in the same process reuses every built runner); pass a fresh
    :class:`CompileCache` to isolate (the tests do).  With
    ``journal_dir`` the service is crash-safe — see the module
    docstring.  ``start()`` spawns the scheduler thread; tests may
    instead drive :meth:`tick` synchronously for deterministic
    schedules.

    Overload knobs: ``max_pending`` bounds the not-yet-admitted queue
    (a submit beyond it sheds — the lowest-priority queued job if the
    arrival outranks it, else the arrival itself, as
    :class:`ServiceOverloaded`); ``tenant_quota`` caps one tenant's
    open (submitted-but-unfinished) jobs.  Fault knobs:
    ``max_job_retries`` bounds the quarantine retry ladder before the
    sequential-fallback escalation, ``max_scheduler_restarts`` bounds
    the supervisor's tick-loop relaunches, and
    ``backoff_base``/``backoff_max`` shape both exponential backoffs
    (the JAX package's watchdog policy).  ``fault_plan`` arms the
    seedable serve-fault injector (runtime/faults.py) for deterministic
    chaos testing.  ``memo`` (the solution cache) is not ported: a
    truthy value raises :class:`NotPortedError`.
    """

    def __init__(
        self,
        lanes: int = 4,
        cache: Optional[CompileCache] = None,
        counters: Optional[ServeCounters] = None,
        max_cycles: int = DEFAULT_MAX_CYCLES,
        journal_dir: Optional[str] = None,
        checkpoint_every: int = 4,
        merge_below: float = 0.5,
        tick_interval: float = 0.02,
        max_buckets: Optional[int] = None,
        max_pending: Optional[int] = None,
        tenant_quota: Optional[int] = None,
        max_job_retries: int = 1,
        max_scheduler_restarts: int = 5,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        journal_compact_bytes: int = 1 << 20,
        fault_plan: Optional[FaultPlan] = None,
        memo=None,
        device: DeviceLike = None,
    ):
        if memo:
            raise NotPortedError(
                "the cross-request solution cache (SolveService(memo=...), "
                "serve --memo) is not ported to the PyTorch package yet")
        self.device = resolve_device(device)
        self.lanes = int(lanes)
        self.max_buckets = max_buckets
        self.cache = cache if cache is not None else global_compile_cache()
        self.counters = counters if counters is not None else ServeCounters()
        self.max_cycles = int(max_cycles)
        self.journal_dir = journal_dir
        self.checkpoint_every = int(checkpoint_every)
        self.merge_below = float(merge_below)
        self.tick_interval = float(tick_interval)
        self.max_pending = max_pending
        self.tenant_quota = tenant_quota
        self.max_job_retries = int(max_job_retries)
        self.max_scheduler_restarts = int(max_scheduler_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.journal_compact_bytes = int(journal_compact_bytes)

        self._jobs: Dict[str, ServeJob] = {}
        self._pending: "deque[ServeJob]" = deque()
        self._workers: List[BucketWorker] = []
        self._prewarmed: Dict[Tuple[str, Tuple], List[InstanceDims]] = {}
        self._lock = threading.RLock()
        self._journal_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._thread_started = False
        self._failure: Optional[BaseException] = None
        self._prep_pool = None  # spec-build executor (started threads)
        self._seq = 0
        self._qseq = 0  # quarantine isolation-group counter
        self._ticks = 0  # scheduler passes (the serve faults' clock)
        self._backlog = 0  # submitted-but-unadmitted jobs
        self._tenant_open: Dict[str, int] = {}
        self._done_rate: Optional[float] = None  # completions/sec EMA
        self._last_done_t: Optional[float] = None
        self._injector = (
            ServeFaultInjector(fault_plan) if fault_plan is not None
            and fault_plan.serve_faults() else None
        )
        self._done_jids: set = set()
        self._stall_until = 0.0  # injected stall gate (stall_replica)
        #: (factor, exempt_priority) applied to every bucket's
        #: deadline-chunk clamp
        self._deadline_pressure: Tuple[float, Optional[int]] = (1.0, None)
        #: prewarm batches queued for the scheduler thread (each runner
        #: is built and captured on the thread that replays it)
        self._prewarm_queue: "deque[Tuple[List, threading.Event]]" = deque()
        #: runner calls of closed workers and of prewarms (the live
        #: workers' are added in metrics())
        self._runner_calls = dict.fromkeys(RUNNER_CALLS, 0)
        if journal_dir:
            os.makedirs(os.path.join(journal_dir, CKPT_SUBDIR),
                        exist_ok=True)
            self._done_jids = self._load_done_jids()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        from concurrent.futures import ThreadPoolExecutor

        self._stop = False
        self._thread_started = True
        # instance compilation (spec building) runs OFF the scheduler
        # thread, on the CPU, so admission prep overlaps bucket
        # stepping; manual tick() driving (tests) stays synchronous —
        # no pool, specs build inline, schedules are deterministic
        self._prep_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="serve-prep"
        )
        self._thread = threading.Thread(
            target=self._loop, name="solve-service", daemon=True
        )
        self._thread.start()

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the scheduler thread.  ``drain=True`` waits until every
        submitted job completed (bounded by ``timeout``);
        ``drain=False`` abandons in-flight work where it stands — with
        a journal this is the crash-with-checkpoints path a later
        :meth:`resume` recovers from."""
        if drain:
            try:
                self.wait_all(timeout=timeout)
            except ServiceStopped:
                pass  # nothing left to drain: the scheduler is dead
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=False)
            self._prep_pool = None

    def halt(self) -> None:
        """Hard-stop: the thread-hosted twin of ``kill -9``.  The
        scheduler exits at the next tick boundary WITHOUT draining,
        completing or journaling anything further; in-flight lanes are
        abandoned where they stand and only the journal — submissions,
        ``JID:`` completion lines, lane checkpoints — survives for a
        restarted service to recover from.  Blocked
        :meth:`result` callers raise :class:`ServiceStopped` through
        the liveness gate instead of hanging."""
        with self._lock:
            self._failure = RuntimeError(
                "replica halted (injected kill)"
            )
        self._stop = True
        self._wake.set()

    def set_deadline_pressure(self, factor: float,
                              exempt_priority: Optional[int] = None
                              ) -> None:
        """Tighten (or relax) the deadline-driven chunk shrinking of
        every bucket: lanes whose job has a deadline see only
        ``factor`` of their remaining budget when
        :func:`~pydcop_tpu_torch.algorithms.base.clamp_chunk_to_deadline`
        sizes their next chunk, so they reach chunk boundaries — the
        service's only admission/completion points — sooner.  Jobs at
        priority >= ``exempt_priority`` are exempt (the SLO ladder
        clamps silver/bronze lanes while gold runs full chunks;
        docs/scenarios.rst "The SLO guardrail ladder").  ``factor=1``
        restores normal behavior.  Applies to current buckets and
        every bucket opened later."""
        with self._lock:
            self._deadline_pressure = (float(factor), exempt_priority)
            for w in self._workers:
                w.deadline_pressure = float(factor)
                w.pressure_exempt_priority = exempt_priority

    def stall_for(self, duration: float) -> None:
        """Wedge the NEXT scheduler tick for ``duration`` seconds (the
        fleet's ``stall_replica`` injection): the sleep happens inside
        :meth:`tick`, on the scheduler thread itself, as a really
        wedged scheduler would hold it."""
        with self._lock:
            self._stall_until = monotonic() + float(duration)

    def __enter__(self) -> "SolveService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def _raise_if_dead(self) -> None:
        """The liveness gate behind every blocking wait: a scheduler
        that died (supervisor exhausted, thread killed) or was stopped
        with work in flight will never complete anything again —
        callers get :class:`ServiceStopped`, not a silent hang."""
        with self._lock:
            failure = self._failure
        if failure is not None:
            raise ServiceStopped(
                f"scheduler thread died: {failure!r}"
            )
        if not self._thread_started:
            return  # synchronous tick() driving: no thread to die
        t = self._thread
        if t is not None and not t.is_alive() and not self._stop:
            raise ServiceStopped(
                "scheduler thread is dead (exited without recording a "
                "failure)"
            )
        if t is None and self._stop:
            raise ServiceStopped("service was stopped")

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job is done; False on timeout.
        Raises :class:`ServiceStopped` instead of blocking forever when
        the scheduler thread is dead."""
        deadline = None if timeout is None else monotonic() + timeout
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            while not job.done.is_set():
                self._raise_if_dead()
                remain = (
                    None if deadline is None else deadline - monotonic()
                )
                if remain is not None and remain <= 0:
                    return False
                job.done.wait(
                    0.1 if remain is None else min(0.1, remain)
                )
        return True

    # -- front door ---------------------------------------------------------

    def submit(
        self,
        dcop,
        algo: str,
        algo_params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        tenant: str = "default",
        priority: int = 0,
        deadline_s: Optional[float] = None,
        label: Optional[str] = None,
        source_file: Optional[str] = None,
        stream: bool = False,
        spec: Any = None,
        _jid: Optional[str] = None,
        _journal: bool = True,
        _restore: Optional[Tuple] = None,
    ) -> str:
        """Enqueue one solve job; returns its job id immediately.

        ``priority`` orders admission (higher first, FIFO within a
        level); ``deadline_s`` is a per-tenant latency budget in
        seconds from now — the scheduler shrinks the job's chunks as
        the budget tightens and completes it as ``TIMEOUT`` (counted
        preempted) when it expires.  ``source_file`` makes the job
        crash-resumable when the service has a journal.  ``spec``
        optionally hands over an already-compiled instance (the batch
        engine's adapter spec) — callers that prepare instances
        themselves skip the service's prep stage entirely.

        Admission control (raises instead of queueing unboundedly):
        :class:`DeadlineInfeasible` for a deadline that is already
        unmeetable, :class:`ServiceOverloaded` when the tenant is over
        quota or the bounded pending queue is full and the arrival
        does not outrank any queued job (a lower-priority queued job
        is shed in its favor otherwise, completed ``ERROR`` and
        counted ``jobs_shed``).  :class:`ServiceStopped` if the
        scheduler thread is already dead.  Resumed jobs bypass the
        checks — they were admitted before the crash."""
        self._raise_if_dead()
        victim: Optional[ServeJob] = None
        if _jid is None:
            if deadline_s is not None and deadline_s <= 0:
                self.counters.inc("jobs_shed")
                send_serve("job.rejected", {
                    "tenant": tenant, "reason": "deadline infeasible",
                    "deadline_s": deadline_s,
                })
                raise DeadlineInfeasible(
                    f"deadline_s={deadline_s} is already expired at "
                    f"submit time"
                )
            with self._lock:
                if (
                    self.tenant_quota is not None
                    and self._tenant_open.get(tenant, 0)
                    >= self.tenant_quota
                ):
                    self.counters.inc("quota_rejections")
                    send_serve("job.rejected", {
                        "tenant": tenant, "reason": "tenant quota",
                        "quota": self.tenant_quota,
                    })
                    raise ServiceOverloaded(
                        f"tenant {tenant!r} at quota "
                        f"({self.tenant_quota} open jobs)",
                        retry_after=self._retry_after(),
                        tenant=tenant,
                    )
                if (
                    self.max_pending is not None
                    and self._backlog >= self.max_pending
                ):
                    victim = self._shed_candidate(int(priority))
                    if victim is None:
                        self.counters.inc("jobs_shed")
                        send_serve("job.rejected", {
                            "tenant": tenant, "reason": "queue full",
                            "max_pending": self.max_pending,
                        })
                        raise ServiceOverloaded(
                            f"pending queue full "
                            f"({self.max_pending} jobs)",
                            retry_after=self._retry_after(),
                            tenant=tenant,
                        )
                    self._pending.remove(victim)
        if victim is not None:
            # priority-aware shedding: the lowest-priority queued job
            # makes room for the higher-priority arrival — completed
            # as a structured ERROR, never dropped silently
            self.counters.inc("jobs_shed")
            victim.emit("job.shed", {
                "jid": victim.jid, "tenant": victim.tenant,
                "priority": victim.priority,
                "displaced_by_priority": int(priority),
            })
            self._complete(victim, SolveResult(
                status="ERROR", assignment={}, cost=None,
                violation=None, cycle=0, msg_count=0, msg_size=0.0,
                time=monotonic() - victim.submitted_at,
            ), error="shed: displaced by a higher-priority arrival "
                     "while the pending queue was full")
        with self._lock:
            self._seq += 1
            if _jid is not None:
                # a resumed job keeps its journaled id; advance the
                # sequence past it so fresh submissions cannot collide
                tail = _jid.rsplit("-", 1)[-1]
                if tail.isdigit():
                    self._seq = max(self._seq, int(tail))
            jid = _jid or f"job-{self._seq:06d}"
            job = ServeJob(
                jid=jid,
                dcop=dcop,
                algo=algo,
                algo_params=dict(algo_params or {}),
                seed=int(seed),
                tenant=tenant,
                priority=int(priority),
                deadline_s=deadline_s,
                deadline_at=(
                    monotonic() + deadline_s
                    if deadline_s is not None else None
                ),
                label=label,
                source_file=source_file,
                stream=stream,
                submitted_at=monotonic(),
                seq=self._seq,
                counters=self.counters,
            )
            job.spec = spec
            # the checkpoint restore tuple rides the SAME lock as the
            # pending append: a running scheduler can never observe the
            # job restore-less and re-run it from cycle 0 by accident
            job.restore = _restore
            self._jobs[jid] = job
            self._pending.append(job)
            job.in_backlog = True
            self._backlog += 1
            self._tenant_open[tenant] = (
                self._tenant_open.get(tenant, 0) + 1
            )
        if (
            job.spec is None
            and self._prep_pool is not None
            and algo in SUPPORTED_ALGOS
        ):
            job.spec_future = self._prep_pool.submit(
                self._build_spec, job
            )
        self.counters.inc("jobs_submitted")
        if _journal:
            self._journal_submit(job)
        job.emit("job.submitted", {
            "jid": jid, "tenant": tenant, "priority": job.priority,
            "algo": algo,
        })
        self._wake.set()
        return jid

    def _shed_candidate(self, priority: int) -> Optional[ServeJob]:
        """The queued job a higher-priority arrival may displace: the
        lowest-priority pending job strictly below ``priority`` (the
        newest among equals — FIFO fairness for the older ones).
        Caller holds the lock."""
        victim = None
        for j in self._pending:
            if j.priority >= priority:
                continue
            if victim is None or (j.priority, -j.seq) < (
                victim.priority, -victim.seq
            ):
                victim = j
        return victim

    def _retry_after(self) -> float:
        """Back-off hint for rejected submits: the backlog drained at
        the observed completion rate, clamped to [tick, 30s]."""
        rate = self._done_rate
        if not rate or rate <= 0:
            return 1.0
        est = self._backlog / rate
        return round(min(30.0, max(self.tick_interval, est)), 3)

    def result(self, jid: str, timeout: Optional[float] = None
               ) -> SolveResult:
        """Block until job ``jid`` completes and return its result.
        Raises :class:`ServiceStopped` — instead of blocking forever —
        when the scheduler thread died or the service was stopped with
        the job still in flight."""
        with self._lock:
            job = self._jobs[jid]
        deadline = None if timeout is None else monotonic() + timeout
        while not job.done.is_set():
            self._raise_if_dead()
            remain = None if deadline is None else deadline - monotonic()
            if remain is not None and remain <= 0:
                raise TimeoutError(
                    f"job {jid} not done within {timeout}s"
                )
            job.done.wait(0.1 if remain is None else min(0.1, remain))
        with self._lock:
            stopped, failure = job.service_stopped, self._failure
            res = job.result
        if stopped:
            raise ServiceStopped(
                f"job {jid} failed: scheduler thread died "
                f"({failure!r})"
            )
        assert res is not None
        return res

    def stream(self, jid: str, timeout: float = 60.0
               ) -> Iterator[Dict[str, Any]]:
        """Iterate job ``jid``'s lifecycle events — admission, anytime
        assignments at chunk boundaries (``job.progress``: cycle +
        current cost), completion — until the job is done.  The job
        must have been submitted with ``stream=True``.  ``timeout``
        bounds the gap between consecutive events; a dead scheduler
        raises :class:`ServiceStopped` instead of a silent stall."""
        with self._lock:
            job = self._jobs[jid]
        deadline = monotonic() + timeout
        while True:
            remain = deadline - monotonic()
            if remain <= 0:
                return
            try:
                evt = job.events.get(timeout=min(0.1, remain))
            except queue.Empty:
                if job.events.empty():
                    self._raise_if_dead()
                continue
            yield evt
            if evt.get("event") == "job.done":
                return
            deadline = monotonic() + timeout

    def metrics(self) -> Dict[str, Any]:
        """The serve counters, the runner cache's stats, the open
        buckets, the pending count and ``runners``: the eager calls,
        captures, replays and rank-table regrows of the bucket runners
        this service drove (its prewarms included), as
        ``BatchEngine.metrics()`` reports them."""
        with self._lock:
            workers = [
                {"algo": w.algo, "signature": list(map(str, w.signature)),
                 "occupied": w.occupied, "lanes": w.B, "steps": w.steps}
                for w in self._workers
            ]
            pending = len(self._pending)
            runners = dict(self._runner_calls)
            for w in self._workers:
                for k, v in w.runner_calls().items():
                    runners[k] += v
        return {
            "serve": self.counters.as_dict(),
            "cache": {**self.cache.stats(), **self.cache.pool_stats()},
            "workers": workers,
            "pending": pending,
            "runners": runners,
        }

    # -- prewarm ------------------------------------------------------------

    def prewarm(
        self,
        items: Sequence[Tuple],
        lanes: Optional[int] = None,
        block: bool = False,
    ) -> None:
        """Build bucket runners for expected traffic ahead of arrival.
        ``items`` is a sequence of ``(dcop, algo)`` or ``(dcop, algo,
        algo_params)`` tuples describing the shapes the service expects;
        one runner builds per (algo, params, shape family) at the pooled
        serve target, its rank tables sized for the deepest item, and
        runs its warm-up call and its capture on idle lanes
        (:func:`~pydcop_tpu_torch.serve.scheduler.warm_bucket_runner`).
        Buckets opened later for fitting traffic take it from the
        cache's pool, so their first step replays.  The builds run on the
        scheduler thread while it runs (else on the caller's, at once
        with ``block=True`` or at the next :meth:`tick`); ``block=True``
        waits for them."""
        lanes = int(lanes or self.lanes)
        groups: Dict[Tuple, Dict[str, Any]] = {}
        for it in items:
            dcop, algo = it[0], it[1]
            params = dict(it[2]) if len(it) > 2 and it[2] else {}
            if algo not in SUPPORTED_ALGOS:
                # no bucket runner to warm (it solves 1-by-1 on the
                # fallback path) — counted so the prewarm keyset stays
                # auditable instead of silently shrinking
                self.counters.inc("prewarm_skipped_exact")
                continue
            adapter = adapter_for(algo)
            spec = adapter.build_spec(
                BatchItem(dcop, algo, algo_params=params)
            )
            g = groups.setdefault(
                (algo, _params_key(params), spec.dims.family_key),
                {"adapter": adapter, "params": params, "specs": []},
            )
            g["specs"].append(spec)
        entries = []
        for (algo, pkey, _fam), g in sorted(
            groups.items(), key=lambda kv: str(kv[0])
        ):
            target = serve_target([sp.dims for sp in g["specs"]])
            self._prewarmed.setdefault((algo, pkey), []).append(target)
            adapter, params = g["adapter"], g["params"]
            like = [adapter.lane_arrays(sp, target, spread=True)
                    for sp in g["specs"]]
            entries.append(self._warm_entry(algo, adapter, params, target,
                                            lanes, like))
        self.counters.inc("prewarmed_runners", len(entries))
        send_serve("prewarm.scheduled", {"runners": len(entries)})
        if entries:
            self._run_prewarm(entries, block)

    def _chunk(self) -> int:
        # the worker's own chunk policy (the coin stream depends on it,
        # so a prewarmed key must use the same)
        return default_chunk(None, False, False, None, self.max_cycles)

    def _warm_entry(self, algo, adapter, params, target, lanes,
                    like=None):
        """The ``(key, builder)`` cache entry of one prewarmed runner."""
        key = runner_cache_key(
            algo, _params_key(params), bucket_signature(target, lanes),
            self._chunk(), self.device,
        )

        def build():
            runner = warm_bucket_runner(adapter, target, params, lanes,
                                        self._chunk(), device=self.device,
                                        like=like)
            with self._lock:
                for k, v in runner_totals(runner).items():
                    self._runner_calls[k] += v
            return runner

        return key, build

    def _run_prewarm(self, entries, block: bool) -> None:
        """Build ``entries`` into the cache's pool on the thread that
        captures and replays: the scheduler thread while it runs (queued,
        ``block`` waits for it), else this thread (now with ``block``,
        else at the next tick)."""
        t = self._thread
        to_scheduler = t is not None and t.is_alive() \
            and threading.current_thread() is not t
        if block and not to_scheduler:
            self.cache.prewarm(entries)
            return
        ev = threading.Event()
        with self._lock:
            self._prewarm_queue.append((list(entries), ev))
        self._wake.set()
        while block and not ev.wait(0.1):
            self._raise_if_dead()

    def _drain_prewarm(self) -> None:
        """Build every queued prewarm (on the tick's thread)."""
        while True:
            with self._lock:
                if not self._prewarm_queue:
                    return
                entries, ev = self._prewarm_queue.popleft()
            try:
                self.cache.prewarm(entries)
            except Exception as e:  # an optimization, never fatal
                send_serve("prewarm.failed", {"error": str(e)})
            finally:
                ev.set()

    def prewarm_predicted(self, dcops: Sequence[Any], model=None,
                          grid=None, block: bool = False):
        """Portfolio-informed prewarm (the JAX package's learned cost
        model picks each instance's config): not ported, raises
        :class:`NotPortedError`."""
        raise NotPortedError(
            "prewarm_predicted (the portfolio cost model) is not ported to "
            "the PyTorch package yet; prewarm() takes (dcop, algo, "
            "params) items")

    def prewarm_targets(
        self,
        items: Sequence[Tuple[str, Optional[Dict[str, Any]],
                              InstanceDims]],
        block: bool = False,
    ) -> int:
        """Build bucket runners at EXACT padded targets — the re-seat
        twin of :meth:`prewarm`.  A journal-checkpointed job must re-seat
        at the very target its state leaves were padded to
        (:func:`restore_target`), so admission-time warmth means warming
        THAT signature, not a freshly pooled one.  ``items`` is a
        sequence of ``(algo, algo_params, target_dims)``; :meth:`resume`
        calls this.  Returns the number of runners scheduled."""
        entries = []
        for algo, params, target in items:
            if algo not in SUPPORTED_ALGOS:
                continue
            params = dict(params or {})
            self._prewarmed.setdefault(
                (algo, _params_key(params)), []).append(target)
            entries.append(self._warm_entry(algo, adapter_for(algo), params,
                                            target, self.lanes))
        if not entries:
            return 0
        self.counters.inc("prewarmed_runners", len(entries))
        send_serve("prewarm.scheduled", {
            "runners": len(entries), "exact": True,
        })
        self._run_prewarm(entries, block)
        return len(entries)

    # -- scheduler ----------------------------------------------------------

    def _loop(self) -> None:
        """The supervised scheduler loop.  A tick that throws — an
        exception the per-bucket isolation inside :meth:`tick` could
        not contain (admission logic, journal I/O, a backend falling
        over) — is relaunched with exponential backoff, the JAX
        package's watchdog policy.  When the restart
        budget is exhausted the scheduler is declared dead: every
        unfinished job fails with a ``ServiceStopped``-marked ERROR so
        blocked ``result()`` calls raise instead of hanging."""
        failures = 0
        while not self._stop:
            try:
                busy = self.tick()
            except Exception as e:
                failures += 1
                if failures > self.max_scheduler_restarts:
                    self._scheduler_died(e)
                    return
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** (failures - 1)))
                self.counters.inc("scheduler_restarts")
                send_serve("fault.scheduler_restart", {
                    "attempt": failures, "backoff": round(delay, 4),
                    "error": str(e),
                })
                if delay > 0:
                    self._wake.wait(delay)
                    self._wake.clear()
                continue
            failures = 0  # a clean tick refills the restart budget
            if not busy:
                self._wake.wait(self.tick_interval)
                self._wake.clear()

    def _scheduler_died(self, exc: BaseException) -> None:
        with self._lock:
            self._failure = exc
        send_serve("fault.scheduler_dead", {
            "error": str(exc),
            "restarts": self.max_scheduler_restarts,
        })
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            if job.done.is_set():
                continue
            with self._lock:
                job.service_stopped = True
            try:
                self._complete(job, SolveResult(
                    status="ERROR", assignment={}, cost=None,
                    violation=None, cycle=0, msg_count=0, msg_size=0.0,
                    time=monotonic() - job.submitted_at,
                ), error=f"scheduler died: {exc}")
            except Exception:  # the done flag must be set, no matter what
                job.done.set()

    def tick(self) -> bool:
        """One synchronous scheduler pass: admissions, one chunk step
        per occupied bucket (completions + slot reuse at each
        boundary), then maintenance.  Returns True while work remains.
        The background thread just calls this in a loop; tests call it
        directly for deterministic schedules.

        A bucket whose step throws is quarantined on the spot
        (:meth:`_quarantine_worker`) — the failure never escapes to
        the other buckets or, in thread mode, past the supervisor."""
        self._ticks += 1
        with self._lock:
            stall = self._stall_until
            self._stall_until = 0.0
        if stall:
            remain = stall - monotonic()
            if remain > 0:
                sleep(remain)  # wedged
        inj = self._injector
        if inj is not None:
            f = inj.due("stall_tick", self._ticks)
            if f is not None:
                self.counters.inc("faults_injected")
                self.counters.inc("ticks_stalled")
                send_serve("fault.injected", {
                    "kind": "stall_tick", "tick": self._ticks,
                    "duration": f.duration,
                })
                sleep(f.duration)
        self._drain_prewarm()
        self._admit_pending()
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            if w.occupied == 0:
                continue
            try:
                self._step_worker(w)
            except Exception as e:
                self._quarantine_worker(w, e)
        # boundary admissions into lanes just freed — this is the
        # continuous part of the batching
        self._admit_pending()
        self._maintain_workers()
        with self._lock:
            now = monotonic()
            return any(w.occupied for w in self._workers) or any(
                j.not_before <= now for j in self._pending
            )

    def _step_worker(self, w: BucketWorker) -> None:
        """Advance one bucket a chunk and settle its boundary:
        non-finite lanes are quarantined, finished lanes complete
        (with a host-side finiteness check on the final cost — the
        int-state families have no float leaf for the device check),
        progress streams and checkpoints follow."""
        inj = self._injector
        if inj is not None:
            jids = {ln.job.jid for ln in w.lanes if ln is not None}
            f = inj.due("raise_in_step", self._ticks, jids=jids)
            if f is not None:
                self.counters.inc("faults_injected")
                send_serve("fault.injected", {
                    "kind": "raise_in_step", "tick": self._ticks,
                    "jid": f.jid,
                })
                raise InjectedFault(
                    f"raise_in_step (fault plan, tick {self._ticks})"
                )
        forced: List[int] = []
        if inj is not None:
            for i, ln in enumerate(w.lanes):
                if ln is None or ln.converged:
                    continue
                f = inj.due("nan_lane", self._ticks, jid=ln.job.jid)
                if f is None:
                    continue
                self.counters.inc("faults_injected")
                send_serve("fault.injected", {
                    "kind": "nan_lane", "tick": self._ticks,
                    "jid": ln.job.jid, "lane": i,
                })
                if not w.poison_lane(i):
                    forced.append(i)  # int-state family: no float leaf
        finished = w.step()
        bad = set(w.nonfinite) | set(forced)
        for i in sorted(bad):
            lane = w.lanes[i]
            if lane is None:
                continue
            self.counters.inc("lanes_nan")
            send_serve("fault.nan_lane", {
                "jid": lane.job.jid, "lane": i,
                "cycle": int(lane.age),
            })
            w.release(i)
            self._requeue_or_escalate(
                lane.job,
                f"non-finite lane state at cycle {lane.age}",
            )
        for i, lane, status in finished:
            if i in bad or w.lanes[i] is None:
                continue  # already quarantined this boundary
            res = w.lane_result(i, lane, status)
            w.release(i)
            if res.cost is not None and not math.isfinite(float(res.cost)):
                self.counters.inc("lanes_nan")
                send_serve("fault.nan_lane", {
                    "jid": lane.job.jid, "lane": i, "cycle": res.cycle,
                })
                self._requeue_or_escalate(
                    lane.job, "non-finite final cost"
                )
                continue
            self._complete(lane.job, res)
        self._progress_events(w)
        self._checkpoint_worker(w)

    # -- quarantine ---------------------------------------------------------

    def _quarantine_worker(self, w: BucketWorker,
                           exc: BaseException) -> None:
        """A bucket step threw.  The failing step cannot identify the
        poison lane, so the bucket is torn down and its jobs bisected
        into two ISOLATED suspect groups, each re-run from cycle 0 in
        its own bucket: the group holding the poison fails again and
        splits further until the poison job is cornered as a
        singleton (and climbs the retry → sequential-fallback →
        ERROR ladder), while every healthy group completes — a fresh
        lane replays the standalone stream, so healthy results stay
        bit-identical to a fault-free run."""
        jobs = [ln.job for ln in w.lanes if ln is not None]
        with self._lock:
            if w in self._workers:
                self._workers.remove(w)
        # a runner whose step threw may be mid-capture: drop it
        self._retire(w, keep_runner=False)
        self.counters.inc("buckets_failed")
        send_serve("fault.bucket_failed", {
            "algo": w.algo, "error": str(exc),
            "jobs": [j.jid for j in jobs],
            "signature": [str(s) for s in w.signature],
        })
        if len(jobs) <= 1:
            for job in jobs:
                self._requeue_or_escalate(
                    job, f"bucket step failed: {exc}"
                )
            return
        mid = (len(jobs) + 1) // 2
        for group in (jobs[:mid], jobs[mid:]):
            if not group:
                continue
            self._qseq += 1
            key = f"quarantine-{self._qseq}"
            for job in group:
                job.isolate_key = key
                job.restore = None
                self._requeue(job)
        send_serve("fault.bisect", {
            "jobs": len(jobs), "groups": 2,
        })

    def _requeue(self, job: ServeJob) -> None:
        with self._lock:
            if not job.in_backlog:
                job.in_backlog = True
                self._backlog += 1
            self._pending.append(job)
        self._wake.set()

    def _requeue_or_escalate(self, job: ServeJob, reason: str) -> None:
        """The poison-candidate ladder: bounded retry with exponential
        backoff in an isolated bucket, then the sequential-fallback
        escalation, then a terminal ERROR — a bad job always ends in a
        terminal status, never a hang, and never takes anyone down
        with it."""
        job.restore = None
        if job.isolate_key is None:
            self._qseq += 1
            job.isolate_key = f"quarantine-{self._qseq}"
        job.retries += 1
        if job.retries <= self.max_job_retries:
            delay = min(self.backoff_max,
                        self.backoff_base * (2 ** (job.retries - 1)))
            with self._lock:
                job.not_before = monotonic() + delay
            self.counters.inc("jobs_retried")
            send_serve("fault.retry", {
                "jid": job.jid, "attempt": job.retries,
                "backoff": round(delay, 4), "reason": reason,
            })
            self._requeue(job)
            return
        self._escalate_sequential(job, reason)

    def _escalate_sequential(self, job: ServeJob, reason: str) -> None:
        """Last rung before ERROR: solve the cornered job alone on the
        scheduler thread, outside every bucket (a problem of the union
        graph cannot follow it there).  A still-poisoned job — the fallback
        throws, its cost is non-finite, or a persistent injected fault
        targets it — completes as a terminal ERROR."""
        from pydcop_tpu_torch.runtime.run import solve_result

        self.counters.inc("jobs_quarantined")
        send_serve("fault.quarantined", {
            "jid": job.jid, "reason": reason,
            "retries": job.retries,
        })
        inj = self._injector
        err: Optional[str] = None
        res: Optional[SolveResult] = None
        if inj is not None and inj.poisoned(job.jid):
            err = "injected poison persists (fault plan)"
        else:
            try:
                res = solve_result(
                    job.dcop, job.algo, algo_params=job.algo_params,
                    seed=job.seed, device=self.device,
                )
            except Exception as e:
                err = str(e)
            else:
                if res.cost is not None and not math.isfinite(
                    float(res.cost)
                ):
                    err = "non-finite cost from sequential fallback"
        if err is not None:
            self._complete(job, SolveResult(
                status="ERROR", assignment={}, cost=None,
                violation=None, cycle=0, msg_count=0, msg_size=0.0,
                time=monotonic() - job.submitted_at,
            ), error=f"quarantined: {reason}; {err}")
            return
        res.time = monotonic() - job.submitted_at
        self._complete(job, res)

    def _admit_pending(self) -> None:
        now = monotonic()
        with self._lock:
            pending = sorted(
                self._pending, key=lambda j: (-j.priority, j.seq)
            )
            self._pending.clear()
        leftover: List[ServeJob] = []
        not_ready: List[ServeJob] = []
        for job in pending:
            with self._lock:
                gated = job.not_before > now
            if gated:  # quarantine backoff gate
                not_ready.append(job)
                continue
            ready = self._prepare(job)
            if ready is False:
                continue
            if ready is None:  # spec still building in the background
                not_ready.append(job)
                continue
            if job.algo not in SUPPORTED_ALGOS:
                self._solve_fallback(job)
                continue
            if not self._try_admit(job):
                leftover.append(job)
        if not_ready:
            with self._lock:
                self._pending.extend(not_ready)
        # open new buckets for whatever could not fold in — bounded by
        # ``max_buckets``: beyond it jobs queue for the next freed lane
        # instead of growing the working set without limit
        while leftover:
            with self._lock:
                full = (
                    self.max_buckets is not None
                    and len(self._workers) >= self.max_buckets
                )
            if full:
                with self._lock:
                    self._pending.extend(leftover)
                break
            leftover = self._open_worker_for(leftover)
        return

    @staticmethod
    def _build_spec(job: ServeJob):
        return adapter_for(job.algo).build_spec(BatchItem(
            job.dcop, job.algo, algo_params=job.algo_params,
            seed=job.seed, label=job.label,
        ))

    def _prepare(self, job: ServeJob) -> Optional[bool]:
        """Resolve the job's compiled spec.  True → ready; None → a
        background build is still in flight (the job stays pending,
        nothing blocks); False → the build failed and the job completed
        as ERROR instead of poisoning the scheduler."""
        if job.spec is not None or job.algo not in SUPPORTED_ALGOS:
            return True
        try:
            if job.spec_future is not None:
                if not job.spec_future.done():
                    return None
                job.spec = job.spec_future.result()
                job.spec_future = None
            else:
                job.spec = self._build_spec(job)
            return True
        except Exception as e:
            self._complete(job, SolveResult(
                status="ERROR", assignment={}, cost=None, violation=None,
                cycle=0, msg_count=0, msg_size=0.0,
                time=monotonic() - job.submitted_at,
            ), error=str(e))
            return False

    def _try_admit(self, job: ServeJob) -> bool:
        pkey = _params_key(job.algo_params)
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            if w.isolate_key != job.isolate_key:
                continue  # quarantine groups never mix
            if not (w.matches(job.algo, pkey) and w.free > 0):
                continue
            if job.restore is not None:
                # a checkpointed job must re-seat at the exact target
                # it was padded at — state shapes are target-shaped
                if w.target != job.restore_target():
                    continue
            elif not fits(job.spec.dims, w.target):
                continue
            self._admit_into(w, job)
            return True
        return False

    def _admit_into(self, w: BucketWorker, job: ServeJob) -> None:
        with self._lock:
            if job.in_backlog:
                job.in_backlog = False
                self._backlog -= 1
        midflight = w.steps > 0
        restore = None
        if job.restore is not None:
            restore = restore_lane_state(
                w.adapter, job.spec, w.target,
                job.restore[1], job.restore[0],
            )
            job.restore = None
            job.resumed = True
            self.counters.inc("jobs_resumed")
        lane = w.admit(job, job.spec, restore=restore)
        job.emit("job.admitted", {
            "jid": job.jid, "lane": lane, "midflight": midflight,
            "resumed": job.resumed,
            "signature": [str(s) for s in w.signature],
        })

    def _open_worker_for(self, jobs: List[ServeJob]) -> List[ServeJob]:
        """Open ONE bucket for the head job's group; admit every
        group-mate that fits; return the jobs still waiting (the
        caller loops)."""
        head = jobs[0]
        pkey = _params_key(head.algo_params)
        if head.restore is not None:
            target = head.restore_target()
        else:
            group_dims = [
                j.spec.dims for j in jobs
                if j.algo == head.algo
                and _params_key(j.algo_params) == pkey
                and j.restore is None
                and j.isolate_key == head.isolate_key
                and j.spec.dims.family_key == head.spec.dims.family_key
            ]
            target = self._pick_target(head.algo, pkey, group_dims)
        try:
            w = BucketWorker(
                head.algo, head.algo_params, target, self.lanes,
                self.cache, counters=self.counters,
                limit=self.max_cycles, device=self.device,
            )
        except Exception as e:
            # a bucket that cannot even build must not wedge admission:
            # the head job climbs the quarantine ladder, the rest
            # re-group behind the next head
            self._requeue_or_escalate(
                head, f"bucket worker build failed: {e}"
            )
            return jobs[1:]
        w.isolate_key = head.isolate_key
        with self._lock:
            w.deadline_pressure, w.pressure_exempt_priority = (
                self._deadline_pressure
            )
            self._workers.append(w)
        self.counters.inc("buckets_opened")
        send_serve("bucket.opened", {
            "algo": w.algo, "lanes": w.B, "warm": w.runner_was_warm,
            "signature": [str(s) for s in w.signature],
        })
        leftover = []
        for job in jobs:
            if (
                w.free > 0
                and w.matches(job.algo, _params_key(job.algo_params))
                and job.isolate_key == w.isolate_key
                and (
                    (job.restore is not None
                     and w.target == job.restore_target())
                    or (job.restore is None
                        and fits(job.spec.dims, w.target))
                )
            ):
                self._admit_into(w, job)
            else:
                leftover.append(job)
        return leftover

    def _pick_target(self, algo: str, pkey: Tuple,
                     dims: List[InstanceDims]) -> InstanceDims:
        """Prefer a prewarmed or already-open signature that fits the
        whole group — admission then takes a warm runner — else the
        group's own pooled target."""
        candidates = list(self._prewarmed.get((algo, pkey), []))
        with self._lock:
            candidates += [
                w.target for w in self._workers
                if w.matches(algo, pkey)
            ]
        for t in candidates:
            if all(fits(d, t) for d in dims):
                return t
        return serve_target(dims)

    def _maintain_workers(self) -> None:
        # merge under-filled same-signature buckets (smaller → larger)
        with self._lock:
            workers = list(self._workers)
        by_sig: Dict[Tuple, List[BucketWorker]] = {}
        for w in workers:
            if 0 < w.occupied <= max(1, int(w.B * self.merge_below)):
                by_sig.setdefault(
                    (w.algo, w.pkey, w.isolate_key) + w.signature, []
                ).append(w)
        for _sig, ws in by_sig.items():
            if len(ws) < 2:
                continue
            ws.sort(key=lambda w: -w.occupied)
            dst = ws[0]
            for src in ws[1:]:
                if dst.free < src.occupied:
                    continue
                moved = dst.migrate_from(src)
                if moved:
                    self.counters.inc("buckets_merged")
                    send_serve("bucket.merged", {
                        "algo": dst.algo, "moved": moved,
                        "signature": [str(s) for s in dst.signature],
                    })
        # close drained buckets (their runner goes back to the pool)
        for w in workers:
            if w.occupied == 0 and w.steps > 0:
                with self._lock:
                    if w not in self._workers:
                        continue
                    self._workers.remove(w)
                self._retire(w)
                self.counters.inc("buckets_closed")
                send_serve("bucket.closed", {
                    "algo": w.algo,
                    "signature": [str(s) for s in w.signature],
                })

    def _progress_events(self, w: BucketWorker) -> None:
        """Anytime assignments at the chunk boundary, for jobs that
        asked to stream (or any bus subscriber).  Gated so a service
        with nobody listening pays zero extra host pulls."""
        for i, lane in enumerate(w.lanes):
            if lane is None:
                continue
            if not (lane.job.stream or event_bus.enabled):
                continue
            cost, cycle = w.lane_cost(i, lane)
            lane.job.emit("job.progress", {
                "jid": lane.job.jid, "cycle": cycle, "cost": cost,
            })

    def _retire(self, w: BucketWorker, keep_runner: bool = True) -> None:
        """Count a closing worker's runner calls and close it."""
        calls = w.runner_calls()
        with self._lock:
            for k, v in calls.items():
                self._runner_calls[k] += v
        w.close(keep_runner)

    def _solve_fallback(self, job: ServeJob) -> None:
        """Algorithms outside the batched set solve sequentially on
        the scheduler thread, on the service's device (mgm2 runs its
        MGM-2 kernel there, dpop its whole-sweep kernel) — counted,
        never silently dropped."""
        from pydcop_tpu_torch.runtime.run import solve_result

        self.counters.inc("jobs_fallback")
        try:
            res = solve_result(
                job.dcop, job.algo, algo_params=job.algo_params,
                seed=job.seed, device=self.device,
            )
        except Exception as e:
            self._complete(job, SolveResult(
                status="ERROR", assignment={}, cost=None, violation=None,
                cycle=0, msg_count=0, msg_size=0.0,
                time=monotonic() - job.submitted_at,
            ), error=str(e))
            return
        res.time = monotonic() - job.submitted_at
        self._complete(job, res)

    def _complete(self, job: ServeJob, res: SolveResult,
                  error: Optional[str] = None) -> None:
        if job.done.is_set():
            return  # already terminal (defensive: double release)
        with self._lock:
            job.result = res
        now = monotonic()
        with self._lock:
            if job.in_backlog:
                job.in_backlog = False
                self._backlog -= 1
            n = self._tenant_open.get(job.tenant, 0)
            if n > 0:
                self._tenant_open[job.tenant] = n - 1
            # completion-rate EMA → the retry-after hint on rejects
            if self._last_done_t is not None:
                dt = now - self._last_done_t
                if dt > 0:
                    inst = 1.0 / dt
                    self._done_rate = (
                        inst if self._done_rate is None
                        else 0.5 * self._done_rate + 0.5 * inst
                    )
            self._last_done_t = now
        self.counters.inc("jobs_completed")
        if res.status == "TIMEOUT" and job.deadline_at is not None:
            self.counters.inc("jobs_preempted")
        self._journal_done(job.jid)
        self._drop_checkpoint(job.jid)
        # serving provenance: which JID served the job (a standalone
        # service is no fleet replica: the JAX package's key, None)
        res.serve = {
            "replica": None,
            "jid": job.jid,
            "resumed": job.resumed,
        }
        payload = {
            "jid": job.jid, "status": res.status, "cycle": res.cycle,
            "cost": res.cost, "latency": round(res.time, 4),
        }
        if error:
            payload["error"] = error
        job.emit("job.done", payload)
        job.done.set()
        self._maybe_compact_journal()

    # -- journal / crash resume --------------------------------------------

    def _journal_submit(self, job: ServeJob) -> None:
        if not self.journal_dir:
            return
        rec = {
            "jid": job.jid, "file": job.source_file, "algo": job.algo,
            "algo_params": job.algo_params, "seed": job.seed,
            "tenant": job.tenant, "priority": job.priority,
            "deadline_s": job.deadline_s, "label": job.label,
        }
        line = json.dumps(rec, sort_keys=True) + "\n"
        inj = self._injector
        if inj is not None:
            # analyze: waive[unlocked-shared-attr] advisory tick stamp for the fault injector; a torn int read is impossible under the GIL
            f_t = inj.due("torn_journal_write", self._ticks,
                          jid=job.jid)
            if f_t is not None:
                self.counters.inc("faults_injected")
                send_serve("fault.injected", {
                    "kind": "torn_journal_write", "jid": job.jid,
                })
                # a crash mid-append: a prefix of the record, no
                # newline — exactly what resume must skip and count
                line = line[: max(1, len(line) // 2)]
        path = os.path.join(self.journal_dir, JOBS_JOURNAL)
        with self._journal_lock:
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def _journal_done(self, jid: str) -> None:
        with self._lock:
            self._done_jids.add(jid)
        if not self.journal_dir:
            return
        # the batch command's JID resume protocol: append + fsync per
        # job, so a kill -9 loses at most the in-flight work
        path = os.path.join(self.journal_dir, PROGRESS_FILE)
        with self._journal_lock:
            with open(path, "a", encoding="utf-8") as f:
                f.write(f"JID: {jid}\n")
                f.flush()
                os.fsync(f.fileno())

    @staticmethod
    def _complete_lines(path: str) -> Tuple[List[str], int]:
        """(complete lines, torn count).  Every journal append is
        newline-terminated, so a final fragment without a newline is a
        write cut short by a crash (or the injected
        ``torn_journal_write``) — skipped and counted, never fatal."""
        with open(path, encoding="utf-8") as f:
            raw = f.read()
        if not raw:
            return [], 0
        lines = raw.split("\n")
        if lines[-1] == "":
            lines.pop()
            return lines, 0
        lines.pop()  # unterminated tail: torn
        return lines, 1

    def _load_done_jids(self) -> set:
        path = os.path.join(self.journal_dir, PROGRESS_FILE)
        if not os.path.exists(path):
            return set()
        lines, torn = self._complete_lines(path)
        out = set()
        for line in lines:
            if line.startswith("JID: ") and line[5:].strip():
                out.add(line[5:].strip())
            elif line.strip():
                torn += 1  # half-written completion line: not trusted
        if torn:
            self.counters.inc("torn_journal_lines", torn)
            send_serve("journal.torn", {
                "file": PROGRESS_FILE, "lines": torn,
            })
        return out

    def _maybe_compact_journal(self) -> None:
        if not self.journal_dir:
            return
        path = os.path.join(self.journal_dir, JOBS_JOURNAL)
        try:
            if os.path.getsize(path) < self.journal_compact_bytes:
                return
        except OSError:
            return
        self.compact_journal()

    def compact_journal(self) -> int:
        """Drop done-job records from ``jobs.jsonl`` — in a
        long-running service the journal otherwise grows without
        bound.  Both files rewrite through the checkpoint writer's
        discipline (same-directory temp file + fsync + atomic rename),
        and the rewrite order is crash-safe: ``jobs.jsonl`` first, so
        a crash between the two renames leaves only harmless stale
        ``JID:`` lines.  Runs on :meth:`resume` and automatically at
        the ``journal_compact_bytes`` size threshold.  Returns the
        number of records kept."""
        if not self.journal_dir:
            return 0
        path = os.path.join(self.journal_dir, JOBS_JOURNAL)
        if not os.path.exists(path):
            return 0
        with self._journal_lock:
            lines, _torn = self._complete_lines(path)
            keep: List[Dict[str, Any]] = []
            for line in lines:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn interleave: already counted on read
                if rec.get("jid") not in self._done_jids:
                    keep.append(rec)
            d = self.journal_dir
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".jobs_tmp_",
                                       suffix=".jsonl")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    for rec in keep:
                        f.write(json.dumps(rec, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            # every record left is NOT done, so the completion file's
            # done-lines are all redundant now — truncate it the same
            # atomic way
            ppath = os.path.join(self.journal_dir, PROGRESS_FILE)
            keep_jids = {rec["jid"] for rec in keep}
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".prog_tmp_")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    for jid in sorted(self._done_jids & keep_jids):
                        f.write(f"JID: {jid}\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, ppath)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        self.counters.inc("journal_compactions")
        send_serve("journal.compacted", {
            "kept": len(keep), "dropped": len(lines) - len(keep),
        })
        return len(keep)

    def _ckpt_path(self, jid: str) -> str:
        return os.path.join(self.journal_dir, CKPT_SUBDIR, f"{jid}.npz")

    def _checkpoint_worker(self, w: BucketWorker) -> None:
        if not self.journal_dir or self.checkpoint_every <= 0:
            return
        if w.steps % self.checkpoint_every != 0:
            return
        from pydcop_tpu_torch.runtime.checkpoint import write_state_npz

        for i, lane in enumerate(w.lanes):
            if lane is None:
                continue
            # a service can only resume jobs it can reload from a
            # source file
            if lane.job.source_file is None:
                continue
            arrays, meta = w.lane_checkpoint(i, lane)
            write_state_npz(self._ckpt_path(lane.job.jid), arrays, meta)
            self.counters.inc("checkpoints_saved")

    def _drop_checkpoint(self, jid: str) -> None:
        if not self.journal_dir:
            return
        try:
            os.unlink(self._ckpt_path(jid))
        except OSError:
            pass

    def resume(self, prewarm: bool = True) -> int:
        """Re-submit every journaled job that never registered its
        ``JID:`` completion line.  Jobs with a valid per-lane
        checkpoint re-seat at their last chunk boundary (their state,
        generator states, age and stability counters restored — the
        continuation is bit-identical to an uninterrupted run); jobs
        without one — or whose checkpoint is corrupt, or was written by
        the JAX package (a JAX PRNG key: never seated on this package's
        stream, a ``serve.checkpoint.refused`` event) — restart from
        cycle 0.  Torn journal lines (an append cut short by the crash)
        are skipped and counted, never fatal, and the journal is
        compacted afterwards.  Returns the number of jobs re-queued.

        With ``prewarm`` (the default) the re-seat signatures are built
        BEFORE the jobs enter the pending queue: checkpointed jobs warm
        their exact padded re-seat target (:meth:`prewarm_targets`),
        restart-from-0 jobs their pooled signature (:meth:`prewarm`) —
        so a resumed job takes a warm runner at admission time."""
        if not self.journal_dir:
            return 0
        from pydcop_tpu_torch.dcop import load_dcop_from_file
        from pydcop_tpu_torch.runtime.checkpoint import read_state_npz

        path = os.path.join(self.journal_dir, JOBS_JOURNAL)
        if not os.path.exists(path):
            return 0
        lines, torn = self._complete_lines(path)
        todo: List[Tuple[Dict[str, Any], str, Any, Optional[Tuple]]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                jid = rec["jid"]
            except (ValueError, KeyError, TypeError):
                # a torn fragment glued to the next append: the merged
                # line parses as neither record — skip it, count it,
                # keep resuming
                torn += 1
                continue
            with self._lock:
                seen = jid in self._done_jids or jid in self._jobs
            if seen:
                continue
            if not rec.get("file"):
                continue  # not resumable without a source
            try:
                dcop = load_dcop_from_file([rec["file"]])
            except Exception:
                continue
            restore = None
            ck = self._ckpt_path(jid)
            if os.path.exists(ck):
                try:
                    meta, arrays = read_state_npz(ck)
                    restore = (meta, arrays)
                except ValueError:
                    restore = None  # corrupt: restart from 0
                if restore is not None and "prng_key" in arrays:
                    # the JAX package's stream: refused, restart from 0
                    restore = None
                    send_serve("checkpoint.refused", {
                        "jid": jid, "reason": "a JAX PRNG key "
                        "(written by the JAX package)",
                    })
            todo.append((rec, jid, dcop, restore))
        if prewarm and todo:
            self.prewarm_targets(
                [(rec["algo"], rec.get("algo_params") or {},
                  restore_target(restore[0]))
                 for rec, _jid, _dcop, restore in todo
                 if restore is not None],
                block=True,
            )
            fresh = [
                (dcop, rec["algo"], rec.get("algo_params") or {})
                for rec, _jid, dcop, restore in todo if restore is None
                and rec["algo"] in SUPPORTED_ALGOS
            ]
            if fresh:
                self.prewarm(fresh, block=True)
        for rec, jid, dcop, restore in todo:
            self.submit(
                dcop, rec["algo"],
                algo_params=rec.get("algo_params") or {},
                seed=int(rec.get("seed", 0)),
                tenant=rec.get("tenant", "default"),
                priority=int(rec.get("priority", 0)),
                deadline_s=rec.get("deadline_s"),
                label=rec.get("label"),
                source_file=rec["file"],
                _jid=jid, _journal=False, _restore=restore,
            )
        if torn:
            self.counters.inc("torn_journal_lines", torn)
            send_serve("journal.torn", {
                "file": JOBS_JOURNAL, "lines": torn,
            })
        self.compact_journal()
        send_serve("resume.done", {"jobs": len(todo), "torn": torn})
        self._wake.set()
        return len(todo)
