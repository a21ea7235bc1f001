"""SolveFleet — N replicated solve services behind one front door.

The port of the JAX package's ``serve/fleet.py``.  A single
:class:`SolveService` is one process: one crash loses the front door
even though the journal/resume protocol can already reconstruct every
in-flight job bit-identically.  This module is the horizontal tier over
those pieces:

* **replicas** — N thread-hosted :class:`SolveService` instances on
  ``device`` (cuda unless the caller passes ``device="cpu"``), each
  with its own scheduler thread (which captures and replays its own
  CUDA graphs), its own runner cache, its own crash-safe journal
  directory (``<journal_dir>/replica-<i>/``) and its own heartbeat file
  touched by the *tick loop* itself (the
  :class:`~pydcop_tpu_torch.runtime.faults.HeartbeatWriter` file
  protocol — a wedged or killed scheduler goes stale, a healthy one
  cannot);
* **routing** — jobs place by runner-cache routing key
  (serve/router.py): the keys ``batch/cache.py`` keys runners by
  double as placement keys, so same-signature traffic lands on
  replicas that are already *warm* (runner built, chunk captured), not
  merely alive.  The JAX package's shared persistent XLA cache
  (``shared_xla_cache=True``) has no counterpart and raises
  :class:`~pydcop_tpu_torch.errors.NotPortedError`;
* **journal streaming** — every placement, re-seat and completion
  streams to a fleet-wide journal (``fleet.jsonl``: fsynced,
  newline-framed, torn-line-tolerant like the per-replica journals),
  alongside each replica's own ``jobs.jsonl`` + ``JID:`` completion
  lines — the post-hoc audit trail of who served what;
* **failover** — a supervisor detects replica death (halted/killed
  scheduler, exhausted tick supervisor) and *re-seats* the dead
  replica's in-flight jobs on peers through the service's resume
  protocol:
  a job with a lane checkpoint re-seats at its EXACT padded target
  (state leaves are target-shaped), a job without one replays from
  cycle 0 — either way the final result is **bit-identical** to an
  unfailed run, and the peer's runner is prewarmed at the re-seat
  signature first so failover pays zero new cache misses;
* **stall != death** — a replica whose heartbeat goes stale is routed
  *around* (and healed when the heartbeat resumes), never re-seated:
  re-seating a stalled-but-alive replica's jobs would race its own
  completions, the classic false-failover bug.  A ``partition_replica``
  similarly only bars NEW placements;
* **admission control** — the per-replica ``max_pending`` bounds
  aggregate into ONE fleet bound (shrinking as replicas die), with
  fleet-level per-tenant quotas and a completion-rate-derived
  ``retry_after`` hint on structured rejections;
* **chaos** — :class:`~pydcop_tpu_torch.runtime.faults.FaultPlan`'s
  ``kill_replica`` / ``stall_replica`` / ``partition_replica`` kinds
  are consumed through the same
  :class:`~pydcop_tpu_torch.runtime.faults.ServeFaultInjector` tick
  consultation as the serve-layer kinds, so the whole failover story
  is deterministically testable;
* **recovery-time objective** — every replica loss opens a recovery
  record: RTO is the wall time from the injected kill (detection) to
  the LAST of the dead replica's jobs completing elsewhere, surfaced
  in :meth:`SolveFleet.metrics` and ``chip_smoke.py``'s ``fleet`` phase.

Lifecycle events ride the bus under ``fleet.*`` (runtime/events.py).
Tests drive :meth:`SolveFleet.tick` synchronously for deterministic
schedules, exactly like the single-service tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from time import monotonic
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from pydcop_tpu_torch.algorithms.base import SolveResult, default_chunk
from pydcop_tpu_torch.batch.bucketing import InstanceDims, bucket_signature
from pydcop_tpu_torch.batch.cache import CompileCache
from pydcop_tpu_torch.batch.engine import (
    DEFAULT_MAX_CYCLES,
    SUPPORTED_ALGOS,
    _params_key,
    runner_cache_key,
)
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime.events import send_fleet
from pydcop_tpu_torch.runtime.faults import (
    FaultPlan,
    ServeFaultInjector,
    stalled_ranks,
)
from pydcop_tpu_torch.runtime.stats import FleetCounters, ServeCounters
from pydcop_tpu_torch.serve.errors import (
    DeadlineInfeasible,
    ServiceOverloaded,
    ServiceStopped,
)
from pydcop_tpu_torch.serve.memo import MEMO_SUBDIR, MemoCache, MemoConfig
from pydcop_tpu_torch.serve.router import FleetRouter, job_routing_key
from pydcop_tpu_torch.serve.service import (
    CKPT_SUBDIR,
    PROGRESS_FILE,
    SolveService,
    restore_target,
)

#: fleet journal file name inside ``journal_dir``
FLEET_JOURNAL = "fleet.jsonl"


class FleetJournal:
    """The fleet-wide journal stream (``fleet.jsonl``).

    Every record is one newline-terminated JSON object, appended with
    flush + fsync (a ``kill -9`` loses at most the in-flight line), and
    reads are torn-line-tolerant: an unterminated tail or a glued
    fragment that parses as no record is skipped and *counted*, never
    fatal — the same discipline as the per-replica journals.

    Record kinds: ``{"kind": "job", ...}`` on placement, ``{"kind":
    "done", "jid", "replica", "status"}`` on completion, ``{"kind":
    "reseat", "jid", "from", "to", "checkpoint"}`` on failover, and
    ``{"kind": "replica", "event": "up"|"down", "name"}`` lifecycle
    markers."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        #: records appended by this process + the most recent one —
        #: read through :meth:`stats` (supervisor thread writes, front
        #: door reads: both sides hold the lock)
        self.appended = 0
        self._tail: Optional[Dict[str, Any]] = None

    def append(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, sort_keys=True) + "\n"
        with self._lock:
            self.appended += 1
            self._tail = rec
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())

    def stats(self) -> Dict[str, Any]:
        """{appended, last record} of this process's journal stream."""
        with self._lock:
            return {"appended": self.appended, "last": self._tail}

    def load(self) -> Tuple[List[Dict[str, Any]], int]:
        """(records, torn line count) — torn/glued lines are skipped
        and counted, mirroring the per-replica journal readers."""
        if not os.path.exists(self.path):
            return [], 0
        with open(self.path, encoding="utf-8") as f:
            raw = f.read()
        if not raw:
            return [], 0
        lines = raw.split("\n")
        torn = 0
        if lines and lines[-1] == "":
            lines.pop()
        elif lines:
            lines.pop()  # unterminated tail: a write cut short
            torn += 1
        records = []
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1  # glued fragment: parses as no record
                continue
            if not isinstance(rec, dict) or "kind" not in rec:
                torn += 1
                continue
            records.append(rec)
        return records, torn


@dataclasses.dataclass
class ReplicaHandle:
    """One fleet replica: the service plus its supervision state."""

    name: str
    index: int
    service: SolveService
    journal_dir: Optional[str]
    hb_path: Optional[str]
    up: bool = True
    killed: bool = False
    stalled: bool = False
    killed_at: Optional[float] = None
    partition_until: Optional[float] = None
    #: device-loss bookkeeping: ``kill_device`` faults with
    #: this replica's index drop devices one by one; the supervisor
    #: advertises the remaining fraction to the router as capacity
    devices_total: int = 1
    devices_lost: int = 0

    def kill(self) -> None:
        """The thread-hosted twin of ``kill -9``: halt the scheduler
        without draining — in-flight lanes are abandoned, only the
        replica's journal survives for the supervisor to re-seat
        from."""
        self.killed = True
        self.killed_at = monotonic()
        self.service.halt()

    @property
    def dead(self) -> bool:
        return self.killed or self.service._failure is not None

    @property
    def down_reason(self) -> str:
        """Why the supervisor is taking this replica down — process
        handles override with the exit-code taxonomy."""
        return "injected kill" if self.killed else "scheduler died"

    def done_jids(self) -> set:
        """``JID:`` completion lines that reached this replica's disk —
        the ground truth a re-seat must respect: a job whose completion
        line survived the crash is DONE, never re-run."""
        if not self.journal_dir:
            return set()
        path = os.path.join(self.journal_dir, PROGRESS_FILE)
        if not os.path.exists(path):
            return set()
        lines, _torn = SolveService._complete_lines(path)
        return {
            line[5:].strip() for line in lines
            if line.startswith("JID: ") and line[5:].strip()
        }

    def checkpoint_path(self, jid: str) -> Optional[str]:
        if not self.journal_dir:
            return None
        return os.path.join(self.journal_dir, CKPT_SUBDIR, f"{jid}.npz")


@dataclasses.dataclass
class FleetJob:
    """One fleet-level job and its placement history."""

    jid: str
    key: Tuple
    dcop: Any
    algo: str
    algo_params: Dict[str, Any]
    seed: int
    tenant: str
    priority: int
    deadline_s: Optional[float]
    label: Optional[str]
    source_file: Optional[str]
    replica: str
    submitted_at: float
    stream: bool = False
    spec: Any = None  # pre-built adapter spec (skips replica prep)
    reseats: int = 0
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: Optional[SolveResult] = None


class SolveFleet:
    """N :class:`SolveService` replicas behind a signature router.

    >>> # sketch:
    >>> # fleet = SolveFleet(replicas=2, lanes=4, journal_dir=jd)
    >>> # fleet.start()
    >>> # jid = fleet.submit(dcop, "mgm", tenant="t1")
    >>> # res = fleet.result(jid, timeout=30)   # res.metrics()["serve"]
    >>> # fleet.stop()                          # names the replica

    ``max_pending`` is the PER-REPLICA pending bound; the fleet
    enforces ``max_pending x routable-replica-count`` as ONE aggregate
    bound (it shrinks as replicas die — a degraded fleet sheds
    earlier).  ``tenant_quota`` caps one tenant's open jobs across the
    whole fleet.  ``fault_plan`` arms the replica-level chaos kinds
    (``kill_replica`` / ``stall_replica`` / ``partition_replica``)
    through the same seeded injector protocol as the serve kinds;
    fault ``cycle`` thresholds count supervisor passes.  ``device`` is
    where every replica's buckets and fallback solves run (cuda unless
    the caller passes ``device="cpu"``; a missing GPU raises).  The
    replicas share the process's one CUDA context: each captures its
    own graphs on its own scheduler thread.

    ``start()`` spawns one scheduler thread per replica plus the
    supervisor thread; tests drive :meth:`tick` synchronously instead
    (one supervisor pass + one tick per live replica) for
    deterministic schedules.
    """

    def __init__(
        self,
        replicas: int = 2,
        lanes: int = 4,
        max_cycles: int = DEFAULT_MAX_CYCLES,
        journal_dir: Optional[str] = None,
        checkpoint_every: int = 4,
        max_buckets: Optional[int] = None,
        max_pending: Optional[int] = None,
        tenant_quota: Optional[int] = None,
        fault_plan: Optional[FaultPlan] = None,
        heartbeat_timeout: float = 1.0,
        supervise_interval: float = 0.05,
        shared_xla_cache: bool = False,
        counters: Optional[FleetCounters] = None,
        devices_per_replica: int = 8,
        memo=None,
        device: DeviceLike = None,
    ):
        if shared_xla_cache:
            raise NotPortedError(
                "SolveFleet(shared_xla_cache=True) is not ported to the "
                "PyTorch package: it names the JAX package's persistent "
                "XLA cache; bucket runners are CUDA graphs held in their "
                "process (a process fleet shares runner recipes through "
                "its artifact store)")
        #: the replicas' device (a process fleet's children resolve it)
        self.device = device
        self.lanes = int(lanes)
        self.max_cycles = int(max_cycles)
        self.journal_dir = journal_dir
        #: per-replica bound on concurrently-open buckets: beyond it
        #: jobs queue for freed lanes instead of growing the working
        #: set — what makes lane occupancy a real contended resource
        #: (the twin's saturation model rides this)
        self.max_buckets = max_buckets
        self.max_pending = max_pending
        self.tenant_quota = tenant_quota
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.supervise_interval = float(supervise_interval)
        #: nominal device count per replica: the denominator of the
        #: reduced-capacity advertisement after kill_device faults
        self.devices_per_replica = max(1, int(devices_per_replica))
        self.counters = counters if counters is not None else FleetCounters()
        #: the full chaos plan: fleet kinds are consumed by the
        #: supervisor below; SERVE kinds (raise_in_step / nan_lane /
        #: torn_journal_write / stall_tick) are handed to every replica
        #: service so one combined plan drives the whole stack — each
        #: replica arms its own injector over the serve subset (the
        #: city-twin scenario's combined chaos plan rides this)
        self._fault_plan = fault_plan
        # spill at one bucket's worth of extra queue: warmth decides
        # placement at the margin, load in the bulk (router docstring)
        self.router = FleetRouter(spill_load=self.lanes)
        #: solution-memo config shared by every replica cache.  Each
        #: replica owns its OWN MemoCache (persisted under its own
        #: journal subdir, rehydrated by its own resume()) — fleet-wide
        #: sharing happens through the insert tap below: a solved
        #: instance memoised on one replica is adopted by every peer,
        #: so a duplicate routed anywhere hits.
        self.memo_cfg: Optional[MemoConfig] = None
        if memo:
            self.memo_cfg = (
                memo if isinstance(memo, MemoConfig) else MemoConfig()
            )

        self._jobs: Dict[str, FleetJob] = {}
        self._handles: Dict[str, ReplicaHandle] = {}
        self._lock = threading.RLock()
        self._seq = 0
        self._ticks = 0  # supervisor passes (the fleet faults' clock)
        self._started = False
        self._stopped = False
        self._supervisor: Optional[threading.Thread] = None
        self._sup_wake = threading.Event()
        self._tenant_open: Dict[str, int] = {}
        self._done_rate: Optional[float] = None
        self._last_done_t: Optional[float] = None
        #: open recovery records; each: {replica, t_detect, jobs,
        #: pending(set), rto_s} — rto_s lands when pending empties
        self.recoveries: List[Dict[str, Any]] = []
        #: heartbeat staleness is normally only judged once start()
        #: arms the replica schedulers (a tick-driven test fleet never
        #: beats its files); process fleets flip this on — their
        #: children beat heartbeats regardless of how the head runs
        self._hb_check_always = False
        armed = self._injector_faults(fault_plan)
        self._injector = (
            ServeFaultInjector(fault_plan, faults=armed)
            if armed else None
        )

        self.journal: Optional[FleetJournal] = None
        if journal_dir:
            os.makedirs(journal_dir, exist_ok=True)
            self.journal = FleetJournal(
                os.path.join(journal_dir, FLEET_JOURNAL)
            )

        for i in range(int(replicas)):
            self._add_replica(i, checkpoint_every)

    def _injector_faults(self, fault_plan: Optional[FaultPlan]):
        """Which of the plan's faults THIS fleet's supervisor consumes
        (the process fleet adds the process kinds)."""
        if fault_plan is None:
            return []
        return fault_plan.fleet_faults()

    #: the fault kinds the supervisor polls each pass, in firing order
    _INJECT_KINDS: Tuple[str, ...] = (
        "kill_replica", "stall_replica", "partition_replica",
        "kill_device",
    )

    # -- replicas -----------------------------------------------------------

    def _add_replica(self, index: int,
                     checkpoint_every: int) -> ReplicaHandle:
        name = f"replica-{index}"
        jd = hb = None
        if self.journal_dir:
            jd = os.path.join(self.journal_dir, name)
            os.makedirs(jd, exist_ok=True)
            hb = os.path.join(self.journal_dir, f"{name}.hb")
        memo = None
        if self.memo_cfg is not None:
            memo = MemoCache(
                self.memo_cfg,
                directory=(
                    os.path.join(jd, MEMO_SUBDIR) if jd else None
                ),
                device=self.device,
            )
        service = SolveService(
            lanes=self.lanes,
            cache=CompileCache(),  # per-replica runners: warmth is local
            counters=ServeCounters(replica=name),
            max_cycles=self.max_cycles,
            journal_dir=jd,
            checkpoint_every=checkpoint_every,
            max_buckets=self.max_buckets,
            # admission control lives at the FLEET front door; the
            # replica-side queue stays unbounded so the aggregate bound
            # is the only one in force
            max_pending=None,
            tenant_quota=None,
            replica=name,
            heartbeat_path=hb,
            fault_plan=self._fault_plan,
            memo=memo,
            device=self.device,
        )
        handle = ReplicaHandle(
            name=name, index=index, service=service,
            journal_dir=jd, hb_path=hb,
            devices_total=self.devices_per_replica,
        )
        service.on_complete = (
            lambda job, res, h=handle: self._on_replica_complete(
                h, job, res
            )
        )
        if memo is not None:
            memo.on_insert = (
                lambda entry, h=handle: self._on_memo_insert(h, entry)
            )
        self._handles[name] = handle
        self.router.add_replica(name, warm_probe=service.cache.has)
        self.counters.inc("replicas_up")
        send_fleet("replica.up", {"name": name})
        if self.journal is not None:
            self.journal.append(
                {"kind": "replica", "event": "up", "name": name}
            )
        return handle

    def handle(self, name_or_index) -> ReplicaHandle:
        if isinstance(name_or_index, int):
            name_or_index = f"replica-{name_or_index}"
        return self._handles[name_or_index]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for h in self._handles.values():
            h.service.start()
        self._supervisor = threading.Thread(
            target=self._supervisor_loop, name="fleet-supervisor",
            daemon=True,
        )
        self._supervisor.start()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        if drain:
            try:
                self.wait_all(timeout=timeout)
            except ServiceStopped:
                pass
        self._stopped = True
        self._sup_wake.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
            self._supervisor = None
        for h in self._handles.values():
            if not h.killed:
                h.service.stop(drain=False)

    def __enter__(self) -> "SolveFleet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    def _supervisor_loop(self) -> None:
        while not self._stopped:
            try:
                self._supervise()
            except Exception as e:  # supervision must never die silent
                send_fleet("supervisor.error", {"error": str(e)})
            self._sup_wake.wait(self.supervise_interval)
            self._sup_wake.clear()

    def _raise_if_dead(self) -> None:
        if self._stopped:
            raise ServiceStopped("fleet was stopped")
        if not self.router.up():
            raise ServiceStopped("every fleet replica is down")

    # -- front door ---------------------------------------------------------

    def set_deadline_pressure(self, factor: float,
                              exempt_priority: Optional[int] = None
                              ) -> None:
        """Fleet-wide deadline-pressure knob (the SLO ladder's rung-2
        lever): every live replica's buckets shrink the chunks of
        deadline lanes below ``exempt_priority`` to ``factor`` of
        their remaining budget — see
        :meth:`SolveService.set_deadline_pressure`."""
        with self._lock:
            live = [h for h in self._handles.values()
                    if h.up and not h.dead]
        for h in live:
            h.service.set_deadline_pressure(
                factor, exempt_priority=exempt_priority
            )

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
        placement: Optional[str] = None,
        stream: bool = False,
        spec: Any = None,
    ) -> str:
        """Admit one job at the fleet front door, route it to a warm
        replica, and return its fleet-wide job id.  Raises the same
        structured admission errors as a single service —
        :class:`DeadlineInfeasible`, :class:`ServiceOverloaded` (with
        the fleet-level completion-rate ``retry_after``),
        :class:`ServiceStopped` — but evaluated against the AGGREGATE
        bound and fleet-wide tenant quotas.

        ``placement="emptiest"`` overrides the warm-first routing for
        THIS job: least-loaded healthy replica, warmth ignored (the
        SLO ladder's rung-3 protection of gold traffic;
        the JAX package's docs/scenarios.rst)."""
        self._raise_if_dead()
        if deadline_s is not None and deadline_s <= 0:
            self.counters.inc("jobs_shed")
            send_fleet("job.rejected", {
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
                and self._tenant_open.get(tenant, 0) >= self.tenant_quota
            ):
                self.counters.inc("quota_rejections")
                send_fleet("job.rejected", {
                    "tenant": tenant, "reason": "tenant quota",
                    "quota": self.tenant_quota,
                })
                raise ServiceOverloaded(
                    f"tenant {tenant!r} at fleet quota "
                    f"({self.tenant_quota} open jobs)",
                    retry_after=self._retry_after(),
                    tenant=tenant,
                )
            if self.max_pending is not None:
                # the aggregate bound: per-replica max_pending summed
                # over the replicas that can actually take traffic — a
                # degraded fleet sheds earlier, by design
                routable = self.router.routable()
                bound = self.max_pending * max(1, len(routable))
                backlog = sum(
                    self._handles[n].service._backlog for n in routable
                )
                if backlog >= bound:
                    self.counters.inc("jobs_shed")
                    send_fleet("job.rejected", {
                        "tenant": tenant, "reason": "queue full",
                        "max_pending": bound,
                    })
                    raise ServiceOverloaded(
                        f"fleet pending queue full ({bound} jobs over "
                        f"{len(routable)} replicas)",
                        retry_after=self._retry_after(),
                        tenant=tenant,
                    )
            self._seq += 1
            jid = f"job-{self._seq:06d}"
            key = job_routing_key(dcop, algo, algo_params)
            placed = self.router.place(
                key, jid=jid,
                prefer_emptiest=(placement == "emptiest"),
            )
            if placed is None:
                raise ServiceStopped("no routable replica")
            name, warm = placed
            fj = FleetJob(
                jid=jid, key=key, dcop=dcop, algo=algo,
                algo_params=dict(algo_params or {}), seed=int(seed),
                tenant=tenant, priority=int(priority),
                deadline_s=deadline_s, label=label,
                source_file=source_file, replica=name,
                submitted_at=monotonic(), stream=stream, spec=spec,
            )
            self._jobs[jid] = fj
            self._tenant_open[tenant] = (
                self._tenant_open.get(tenant, 0) + 1
            )
        self.counters.inc("jobs_routed")
        if warm:
            self.counters.inc("jobs_routed_warm")
        if self.journal is not None:
            self.journal.append({
                "kind": "job", "jid": jid, "replica": name,
                "file": source_file, "algo": algo,
                "algo_params": dict(algo_params or {}),
                "seed": int(seed), "tenant": tenant,
                "priority": int(priority), "label": label,
            })
        self._place_on(fj, name)
        return jid

    def _place_on(self, fj: FleetJob, name: str,
                  restore: Optional[Tuple] = None) -> None:
        """Hand a fleet job to one replica (placement or re-seat); a
        replica that dies in the handoff window re-places once on a
        peer before the supervisor would have to."""
        last_err: Optional[Exception] = None
        for _attempt in range(2):
            h = self._handles[name]
            try:
                h.service.submit(
                    fj.dcop, fj.algo, algo_params=fj.algo_params,
                    seed=fj.seed, tenant=fj.tenant,
                    priority=fj.priority, deadline_s=fj.deadline_s,
                    label=fj.label, source_file=fj.source_file,
                    stream=fj.stream, spec=fj.spec,
                    _jid=fj.jid, _restore=restore,
                )
                return
            except Exception as e:  # replica died mid-handoff
                last_err = e
                self.router.job_finished(name)
                placed = self.router.place(
                    fj.key, jid=fj.jid, exclude=name
                )
                if placed is None:
                    break
                name = placed[0]
                with self._lock:
                    fj.replica = name
        self._fail_job(
            fj, f"no replica could accept the job: {last_err}"
        )

    def _fail_job(self, fj: FleetJob, reason: str) -> None:
        with self._lock:
            if fj.done.is_set():
                return
            fj.result = SolveResult(
                status="ERROR", assignment={}, cost=None,
                violation=None, cycle=0, msg_count=0, msg_size=0.0,
                time=monotonic() - fj.submitted_at,
            )
            fj.result.serve = {
                "replica": None, "jid": fj.jid, "resumed": False,
                "reseats": fj.reseats, "error": reason,
            }
            n = self._tenant_open.get(fj.tenant, 0)
            if n > 0:
                self._tenant_open[fj.tenant] = n - 1
            self._settle_recovery(fj.jid, monotonic())
            fj.done.set()

    def _settle_recovery(self, jid: str, now: float) -> None:
        """Caller holds the lock.  Strike ``jid`` off every open
        recovery record; the record whose pending set empties gets its
        RTO — wall time from kill detection to the LAST of the dead
        replica's jobs completing elsewhere."""
        for rec in self.recoveries:
            pending = rec.get("pending")
            if pending and jid in pending:
                pending.discard(jid)
                if not pending:
                    rec["rto_s"] = round(now - rec["t_detect"], 6)
                    self.counters.inc("recoveries_completed")
                    send_fleet("recovery.done", {
                        "replica": rec["replica"],
                        "jobs": rec["jobs"],
                        "rto_s": rec["rto_s"],
                    })

    def _on_memo_insert(self, handle: ReplicaHandle, entry) -> None:
        """The per-replica memo insert tap: stream a ``memo`` record to
        the fleet journal and ADOPT the freshly-solved entry into every
        peer replica's cache, so a duplicate of an instance first
        solved on ``replica-0`` hits even when the router lands it on
        ``replica-3``.  Adoption clones the entry (peer caches stay
        independently evictable) and does not re-persist it — the
        solving replica's npz is the durable copy; peers that restart
        simply re-adopt on the next insert or rehydrate their own."""
        if self.journal is not None:
            self.journal.append({
                "kind": "memo", "key": entry.key,
                "tenant": entry.tenant, "algo": entry.algo,
                "replica": handle.name,
                "path": entry.path,
            })
        shared = 0
        for peer in list(self._handles.values()):
            if peer.name == handle.name:
                continue
            cache = getattr(peer.service, "memo", None)
            if cache is not None and cache.adopt_entry(entry):
                shared += 1
        if shared:
            self.counters.inc("memo_shared", shared)
            send_fleet("memo.shared", {
                "key": entry.key, "from": handle.name,
                "peers": shared,
            })

    def _on_replica_complete(self, handle: ReplicaHandle, job,
                             res: SolveResult) -> None:
        """The per-replica completion tap: stream the ``JID:`` line to
        the fleet journal, settle routing load / quotas / the
        completion-rate EMA, close recovery records, and wake fleet
        waiters.  First completion wins — a late duplicate (a stalled
        replica finishing a job that was conservatively never
        re-seated cannot happen, but a re-placed handoff racing its
        failed first submit can) is dropped, never double-counted.

        A job failed because its replica's SCHEDULER died
        (``service_stopped``) is NOT a completion: the supervisor will
        see the dead replica and re-seat the job on a peer — settling
        it here would turn a recoverable replica loss into a permanent
        ERROR."""
        if getattr(job, "service_stopped", False):
            return
        if self.journal is not None:
            self.journal.append({
                "kind": "done", "jid": job.jid,
                "replica": handle.name, "status": res.status,
            })
        with self._lock:
            fj = self._jobs.get(job.jid)
            if fj is None or fj.done.is_set():
                return
            if res.serve is not None:
                res.serve["reseats"] = fj.reseats
            fj.result = res
            self.router.job_finished(handle.name)
            n = self._tenant_open.get(fj.tenant, 0)
            if n > 0:
                self._tenant_open[fj.tenant] = n - 1
            now = monotonic()
            if self._last_done_t is not None:
                dt = now - self._last_done_t
                if dt > 0:
                    inst = 1.0 / dt
                    self._done_rate = (
                        inst if self._done_rate is None
                        else 0.5 * self._done_rate + 0.5 * inst
                    )
            self._last_done_t = now
            self._settle_recovery(job.jid, now)
            fj.done.set()

    def _retry_after(self) -> float:
        """Fleet-level back-off hint: the aggregate backlog drained at
        the fleet's observed completion rate, clamped to [20ms, 30s]."""
        rate = self._done_rate
        if not rate or rate <= 0:
            return 1.0
        backlog = sum(
            self._handles[n].service._backlog
            for n in self.router.routable()
        )
        return round(min(30.0, max(0.02, backlog / rate)), 3)

    # -- results ------------------------------------------------------------

    def result(self, jid: str,
               timeout: Optional[float] = None) -> SolveResult:
        """Block until fleet job ``jid`` completes — on WHICHEVER
        replica ends up serving it — and return its result; the
        serving replica is named in ``metrics()["serve"]``.  Raises
        :class:`ServiceStopped` instead of hanging when every replica
        is down."""
        with self._lock:
            fj = self._jobs[jid]
        deadline = None if timeout is None else monotonic() + timeout
        while not fj.done.is_set():
            self._raise_if_dead()
            remain = (
                None if deadline is None else deadline - monotonic()
            )
            if remain is not None and remain <= 0:
                raise TimeoutError(
                    f"job {jid} not done within {timeout}s"
                )
            fj.done.wait(0.1 if remain is None else min(0.1, remain))
        with self._lock:
            res = fj.result
        assert res is not None
        return res

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else monotonic() + timeout
        with self._lock:
            jobs = list(self._jobs.values())
        for fj in jobs:
            while not fj.done.is_set():
                self._raise_if_dead()
                remain = (
                    None if deadline is None else deadline - monotonic()
                )
                if remain is not None and remain <= 0:
                    return False
                fj.done.wait(
                    0.1 if remain is None else min(0.1, remain)
                )
        return True

    # -- prewarm ------------------------------------------------------------

    def prewarm(self, items: Sequence[Tuple],
                block: bool = False) -> Dict[str, int]:
        """Distribute expected traffic's compile work across replicas
        BEFORE arrivals open: items group by routing key, each group is
        assigned one replica (least-loaded round-robin) and prewarmed
        there — so when the trace starts, the router finds every family
        already warm SOMEWHERE and places accordingly.  Returns
        ``{replica: runners}``."""
        groups: Dict[Tuple, List[Tuple]] = {}
        for it in items:
            dcop, algo = it[0], it[1]
            params = dict(it[2]) if len(it) > 2 and it[2] else {}
            groups.setdefault(
                job_routing_key(dcop, algo, params), []
            ).append(it)
        out: Dict[str, int] = {}
        names = self.router.routable()
        if not names:
            return out
        for i, (key, group) in enumerate(
            sorted(groups.items(), key=lambda kv: str(kv[0]))
        ):
            name = names[i % len(names)]
            self.router.note_warm(name, key)
            self._handles[name].service.prewarm(group, block=block)
            out[name] = out.get(name, 0) + 1
        return out

    def prewarm_predicted(self, dcops: Sequence[Any], model=None,
                          grid=None, block: bool = False):
        """Portfolio-informed fleet prewarm (the JAX package's learned
        cost model picks each instance's config): not ported, raises
        :class:`~pydcop_tpu_torch.errors.NotPortedError`."""
        raise NotPortedError(
            "prewarm_predicted (the portfolio cost model) is not ported to "
            "the PyTorch package yet; prewarm() takes (dcop, algo, "
            "params) items")

    # -- supervision / failover ---------------------------------------------

    def tick(self) -> bool:
        """One synchronous fleet pass: supervision (fault injection,
        death detection, failover re-seating) then one scheduler tick
        per live replica.  Tests call this directly for deterministic
        schedules; the threaded mode runs the same supervision on its
        own interval while replicas tick themselves."""
        self._supervise()
        busy = False
        with self._lock:
            live = [h for h in self._handles.values()
                    if h.up and not h.dead]
        for h in live:
            busy = h.service.tick() or busy
        with self._lock:
            undone = any(
                not fj.done.is_set() for fj in self._jobs.values()
            )
        return (busy or undone) and bool(self.router.up())

    def _supervise(self) -> None:
        self._ticks += 1
        now = monotonic()
        inj = self._injector
        if inj is not None:
            for kind in self._INJECT_KINDS:
                while True:
                    f = inj.due(kind, self._ticks)
                    if f is None:
                        break
                    self._inject(kind, f, now)
        # liveness: dead schedulers re-seat, stale heartbeats only
        # route around (stall != death — re-seating a stalled-but-
        # alive replica's jobs would race its own completions)
        for h in list(self._handles.values()):
            with self._lock:
                h_up = h.up
            if not h_up:
                continue
            if h.dead:
                self._replica_down(
                    h,
                    reason=h.down_reason,
                    t_detect=h.killed_at or now,
                )
                continue
            if (self._started or self._hb_check_always) \
                    and h.hb_path and os.path.exists(h.hb_path):
                stale = bool(stalled_ranks(
                    {0: h.hb_path}, self.heartbeat_timeout
                ))
                with self._lock:
                    flipped = (
                        "stale" if stale and not h.stalled
                        else "healed" if not stale and h.stalled
                        else None
                    )
                    if flipped:
                        h.stalled = stale
                if flipped == "stale":
                    self.router.set_stalled(h.name, True)
                    self.counters.inc("replicas_stalled")
                    send_fleet("replica.stalled", {"name": h.name})
                elif flipped == "healed":
                    self.router.set_stalled(h.name, False)
                    self.counters.inc("replicas_healed")
                    send_fleet("replica.healed", {
                        "name": h.name, "was": "stalled",
                    })
            with self._lock:
                heal_partition = (
                    h.partition_until is not None
                    and h.partition_until <= now
                )
                if heal_partition:
                    h.partition_until = None
            if heal_partition:
                self.router.set_partitioned(h.name, False)
                self.counters.inc("replicas_healed")
                send_fleet("replica.healed", {
                    "name": h.name, "was": "partitioned",
                })

    def _inject(self, kind: str, fault, now: float) -> None:
        # analyze: waive[unlocked-shared-attr] fault.replica is the immutable FaultSpec field, not FleetJob.replica — attribute-name collision
        h = self.handle(int(fault.replica))
        self.counters.inc("faults_injected")
        send_fleet("fault.injected", {
            "kind": kind, "replica": h.name, "tick": self._ticks,
        })
        if kind == "kill_replica":
            with self._lock:
                live = h.up and not h.killed
            if live:
                h.kill()
        elif kind == "stall_replica":
            h.service.stall_for(fault.duration)
        elif kind == "partition_replica":
            with self._lock:
                h.partition_until = (
                    now + fault.duration if fault.duration > 0
                    else float("inf")
                )
            self.router.set_partitioned(h.name, True)
            self.counters.inc("replicas_partitioned")
            send_fleet("replica.partitioned", {
                "name": h.name, "duration": fault.duration,
            })
        elif kind == "kill_device":
            # a replica that lost a device keeps serving at reduced
            # capacity: advertise the remaining
            # device fraction to the router so placement drains
            # toward whole peers; losing the LAST device is a death
            with self._lock:
                h.devices_lost = min(h.devices_lost + 1,
                                     h.devices_total)
                remaining = h.devices_total - h.devices_lost
                cap = remaining / h.devices_total
                live = h.up and not h.killed
            self.counters.inc("devices_lost")
            if remaining <= 0:
                send_fleet("replica.device_lost", {
                    "name": h.name, "remaining": 0, "capacity": 0.0,
                })
                if live:
                    h.kill()
                return
            self.router.set_capacity(h.name, cap)
            self.counters.inc("capacity_reduced")
            send_fleet("replica.device_lost", {
                "name": h.name, "remaining": remaining,
                "capacity": cap,
            })

    def _replica_down(self, h: ReplicaHandle, reason: str,
                      t_detect: float) -> None:
        with self._lock:
            h.up = False
        self.router.mark_down(h.name)
        self.counters.inc("replicas_down")
        send_fleet("replica.down", {"name": h.name, "reason": reason})
        if self.journal is not None:
            self.journal.append({
                "kind": "replica", "event": "down", "name": h.name,
                "reason": reason,
            })
        with self._lock:
            orphans = [
                fj for fj in self._jobs.values()
                if not fj.done.is_set() and fj.replica == h.name
            ]
        if orphans:
            self._reseat(h, orphans, t_detect)

    def _reseat(self, dead: ReplicaHandle, jobs: List[FleetJob],
                t_detect: float) -> None:
        """Re-seat a dead replica's in-flight jobs on peers through
        the service's resume protocol.  Ground rules, in order:

        1. a job whose ``JID:`` completion line reached the dead
           replica's disk is DONE — it re-runs nowhere (no
           double-complete; in thread-hosted replicas the completion
           tap already settled it, so this is belt-and-braces for the
           process-hosted future);
        2. a job with a valid lane checkpoint re-seats at its EXACT
           padded target, PRNG key/age/stability restored — the
           continuation is bit-identical to an unfailed run;
        3. a job without one replays from cycle 0 on the peer — the
           full rerun is bit-identical by the serve determinism
           contract;
        4. either way the peer prewarms the re-seat signature FIRST
           (prewarm_targets / prewarm), so failover admissions pay
           zero new cache misses.

        Opens a recovery record whose ``rto_s`` lands when the last
        re-seated job completes — the fleet's recovery-time
        objective."""
        from pydcop_tpu_torch.runtime.checkpoint import read_state_npz

        done_on_disk = dead.done_jids()
        todo = [
            fj for fj in jobs
            if not (fj.jid in done_on_disk and fj.done.is_set())
        ]  # a JID line on disk + a settled fleet job = done, not rerun
        if not todo:
            return
        rec = {
            "replica": dead.name,
            "t_detect": t_detect,
            "detected_at": round(time.time(), 3),
            "jobs": len(todo),
            "pending": {fj.jid for fj in todo},
            "rto_s": None,
        }
        with self._lock:
            # register the record BEFORE any peer gets a job: a fast
            # completion on a threaded peer must find it to settle it
            self.recoveries.append(rec)
        for fj in todo:
            restore = None
            ck = dead.checkpoint_path(fj.jid)
            if ck and os.path.exists(ck):
                try:
                    meta, arrays = read_state_npz(ck)
                    restore = (meta, arrays)
                except ValueError:
                    restore = None  # corrupt snapshot: replay from 0
            with self._lock:
                placed = self.router.place(
                    fj.key, jid=fj.jid, exclude=dead.name
                )
                if placed is not None:
                    # placement bookkeeping in the same critical
                    # section as the routing decision: a concurrent
                    # _replica_down scanning fj.replica for orphans
                    # must see the new seat, never the dead one
                    fj.replica = placed[0]
                    fj.reseats += 1
            if placed is None:
                self._fail_job(
                    fj, "replica lost with no routable peer"
                )
                continue
            peer_name, _warm = placed
            peer = self._handles[peer_name]
            # warm the re-seat signature FIRST: zero new cache misses
            # on failover admission
            if restore is not None:
                peer.service.prewarm_targets(
                    [(fj.algo, fj.algo_params,
                      restore_target(restore[0]))],
                    block=True,
                )
                self.counters.inc("reseat_checkpoint_hits")
            else:
                if fj.algo in SUPPORTED_ALGOS:
                    peer.service.prewarm(
                        [(fj.dcop, fj.algo, fj.algo_params)],
                        block=True,
                    )
                self.counters.inc("reseat_cold_restarts")
            self.counters.inc("jobs_reseated")
            send_fleet("job.reseated", {
                "jid": fj.jid, "from": dead.name, "to": peer_name,
                "checkpoint": restore is not None,
            })
            if self.journal is not None:
                self.journal.append({
                    "kind": "reseat", "jid": fj.jid,
                    "from": dead.name, "to": peer_name,
                    "checkpoint": restore is not None,
                })
            self._place_on(fj, peer_name, restore=restore)

    # -- metrics ------------------------------------------------------------

    def churn_event(self, tenant: Optional[str] = None) -> int:
        """Fleet-wide memo invalidation: broadcast a churn event to
        every replica's solution cache (see
        :meth:`SolveService.churn_event`).  Returns total entries
        dropped across the fleet."""
        dropped = 0
        for h in list(self._handles.values()):
            fn = getattr(h.service, "churn_event", None)
            if fn is not None:
                dropped += fn(tenant)
        return dropped

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            recov = [
                {k: (sorted(v) if isinstance(v, set) else v)
                 for k, v in rec.items() if k != "t_detect"}
                for rec in self.recoveries
            ]
            replicas = {
                name: {
                    "up": h.up,
                    "stalled": h.stalled,
                    "partitioned": h.partition_until is not None,
                    "serve": h.service.counters.as_dict(),
                    "cache": _cache_stats(h.service.cache),
                    # ReplicaProxy (process fleet) has no memo attr:
                    # child memo stats ride the child's own metrics
                    "memo": (
                        h.service.memo.stats()
                        if getattr(h.service, "memo", None)
                        is not None else None
                    ),
                }
                for name, h in self._handles.items()
            }
        return {
            "fleet": self.counters.as_dict(),
            "router": self.router.stats(),
            "replicas": replicas,
            "journal": (
                self.journal.stats() if self.journal is not None
                else None
            ),
            "pending": sum(
                h.service._backlog
                for name, h in self._handles.items()
                if replicas[name]["up"]
            ),
            "recoveries": recov,
        }


def _cache_stats(cache) -> Dict[str, Any]:
    """A replica's runner-cache scorecard: the cache's stats and, for an
    in-process cache, its pool's (prewarmed, pooled)."""
    pool = getattr(cache, "pool_stats", None)
    return {**cache.stats(), **(pool() if pool is not None else {})}


def exact_runner_key(algo: str, algo_params: Optional[Dict[str, Any]],
                     target: InstanceDims, lanes: int,
                     max_cycles: int = DEFAULT_MAX_CYCLES,
                     device: DeviceLike = "cuda") -> Tuple:
    """The full runner-cache key a checkpointed job's re-seat bucket
    resolves to on ``device`` — routing ground truth for 'is this
    replica warm for this exact signature' probes (CompileCache.has)."""
    chunk = default_chunk(None, False, False, None, int(max_cycles))
    return runner_cache_key(
        algo, _params_key(dict(algo_params or {})),
        bucket_signature(target, int(lanes)), chunk, torch.device(device),
    )
