"""Deterministic fault injection + liveness primitives.

The port of the JAX package's ``runtime/faults.py``, the whole module:
the same fault kinds, plan schema (YAML, JSON and the environment
channel, so one plan file drives either package) and consultation
protocol.

* :class:`FaultPlan` — a seedable, YAML-loadable list of
  :class:`Fault` specs (kill rank *r* at cycle *c*, stall a rank,
  kill an agent mid-scenario, corrupt/truncate a checkpoint file, the
  serve, fleet, churn and device kinds).
* :class:`ServeFaultInjector` — the solve service's consumer
  (:mod:`pydcop_tpu_torch.serve.service`): ``raise_in_step``,
  ``nan_lane``, ``torn_journal_write`` and ``stall_tick`` at scheduler
  ticks.
* :class:`RankFaultInjector` — the rank-side consumer: a rank consults
  it at every cycle-chunk boundary and the injector kills
  (``os._exit``) or stalls (``SIGSTOP``) the process exactly once per
  matching fault.
* :class:`HeartbeatWriter` / :func:`stalled_ranks` — the liveness
  channel: a daemon thread (or the service's tick) touches a file; a
  writer whose file goes stale is declared stalled.  ``SIGSTOP``
  freezes the writer thread too, so an injected stall is
  indistinguishable from a real one.
* :func:`corrupt_checkpoint` — deterministic byte-flips / truncation
  for hardening tests of :mod:`pydcop_tpu_torch.runtime.checkpoint`.

The consumers of the fleet, process-fleet, churn and device kinds (the
fleets, the orchestrator's warm repair, the elastic runner) and
:func:`apply_checkpoint_faults` (it needs the solver checkpoints'
``CheckpointManager``) are not ported yet: the plan parses them, and
:func:`apply_checkpoint_faults` raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`.

Every random choice flows from an explicit seed; the same plan + seed
produces the same failure at the same point on every run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: exit code of a fault-injected rank kill — the coordinator watchdog
#: classifies it (like signal deaths) as a retryable crash
KILL_EXIT_CODE = 101

#: env channel coordinator → ranks (a spawned rank cannot take the plan
#: as a Python object); value is ``FaultPlan.to_json()``
ENV_FAULT_PLAN = "PYDCOP_TPU_FAULT_PLAN"
#: env channel for the launch attempt counter (0 on the first launch,
#: +1 per watchdog relaunch) so faults can target one attempt only
ENV_FAULT_ATTEMPT = "PYDCOP_TPU_FAULT_ATTEMPT"

#: serve-layer fault kinds (consumed by ServeFaultInjector /
#: pydcop_tpu_torch.serve.SolveService) — ``raise_in_step`` throws inside a
#: bucket's chunk step, ``nan_lane`` poisons one lane's float state,
#: ``torn_journal_write`` cuts a journal append short mid-line, and
#: ``stall_tick`` wedges one scheduler tick for ``duration`` seconds,
#: and ``corrupt_cache_entry`` flips bytes in a persisted solution-
#: cache entry right after it is written (serve/memo.py) — the CRC
#: check at rehydrate/adopt time must skip-and-count it, never serve it
SERVE_KINDS = ("raise_in_step", "nan_lane", "torn_journal_write",
               "stall_tick", "corrupt_cache_entry")

#: agent-churn / live-mutation fault kinds (consumed by the
#: orchestrator's warm-repair path, runtime/repair.py) —
#: ``remove_agent_burst`` removes ``count`` seeded-chosen agents at one
#: phase boundary (each routed through the replica-repair handshake),
#: ``add_agent_burst`` adds ``count`` fresh agents, and ``edit_factor``
#: hot-swaps a (seeded-chosen or named) constraint's cost table with a
#: seeded perturbation — the live-mutation twin of kill_agent, and the
#: source of the sustained-churn bench leg (bench.py churn_recover)
CHURN_KINDS = ("remove_agent_burst", "add_agent_burst", "edit_factor")

#: fleet-layer fault kinds (consumed by the solve fleet's supervisor —
#: the JAX package's serve/fleet.py, not ported yet — through the same
#: :class:`ServeFaultInjector`) — ``kill_replica`` hard-stops one
#: replica's scheduler mid-trace (the thread-hosted twin of kill -9:
#: in-flight lanes are abandoned where they stand and only the
#: replica's journal survives), ``stall_replica`` wedges a replica's
#: scheduler for ``duration`` seconds (its heartbeat goes stale, the
#: router must route around it WITHOUT re-seating — a stall is not a
#: death), and ``partition_replica`` makes a replica unreachable for
#: new placements for ``duration`` seconds (0 = rest of the run) while
#: its in-flight jobs keep running
FLEET_KINDS = ("kill_replica", "stall_replica", "partition_replica")

#: process-fleet fault kinds (consumed by the process fleet's
#: supervisor — the JAX package's serve/procfleet.py, not ported yet —
#: through the same :class:`ServeFaultInjector`) — ``kill_process`` SIGKILLs an
#: entire replica child process mid-trace (the REAL kill -9: every
#: lane, thread and socket of that process dies at once; detection is
#: heartbeat staleness + waitpid, recovery is the fleet's re-seat),
#: ``partition_socket`` severs a replica's journal socket and refuses
#: its re-dials for ``duration`` seconds (frames buffer client-side
#: and replay-from-offset on heal — in-flight jobs keep running,
#: nothing double-applies), and ``corrupt_artifact`` flips one seeded
#: byte in a replica's exported runner artifact (the next loader must
#: reject it loudly on CRC and recompile)
PROCESS_KINDS = ("kill_process", "partition_socket", "corrupt_artifact")

#: runtime-layer (rank/agent/checkpoint) fault kinds — the original
#: set, consumed by RankFaultInjector and the coordinator watchdog
RUNTIME_KINDS = ("kill_rank", "stall_rank", "kill_agent",
                 "corrupt_checkpoint", "truncate_checkpoint")

#: device-tier fault kinds (consumed by the elastic sharded runner,
#: the JAX package's parallel/elastic.py, not ported yet) —
#: ``kill_device`` drops one mesh device at the next chunk boundary
#: (the solve shrinks onto the survivors; with a ``replica`` it instead
#: targets a fleet replica, which advertises reduced capacity to the
#: router), ``shrink_mesh`` shrinks the mesh to ``devices`` devices in
#: one step, and ``corrupt_slab`` flips one seeded bit in a named
#: staged device operand (``operand``, e.g. ``bucket0``/``q``/``x``/
#: ``local``) at a cycle boundary — the silent-data-corruption probe
#: the integrity sentinels and the shadow scrub must catch
DEVICE_KINDS = ("kill_device", "shrink_mesh", "corrupt_slab")

KINDS = (RUNTIME_KINDS + SERVE_KINDS + CHURN_KINDS + FLEET_KINDS
         + PROCESS_KINDS + DEVICE_KINDS)

#: the one catalog of which OPTIONAL fields each kind may address —
#: the machine-readable half of the fault-kind table in
#: docs/resilience.rst ("Fault-kind catalog"): the docs test pins that
#: every kind here is documented there and vice versa, and
#: :meth:`FaultPlan.validate` rejects a fault addressing a field its
#: kind never reads (the classic silent-no-op plan bug: a
#: ``stall_tick`` with a ``rank``, a ``kill_replica`` with an
#: ``agent``).  ``kind``/``cycle``/``attempt`` are legal on every
#: fault and not listed.
KIND_FIELDS: Dict[str, Tuple[str, ...]] = {
    "kill_rank": ("rank",),
    "stall_rank": ("rank", "duration"),
    "kill_agent": ("agent",),
    "corrupt_checkpoint": ("path",),
    "truncate_checkpoint": ("path",),
    "raise_in_step": ("jid",),
    "nan_lane": ("jid",),
    "torn_journal_write": ("jid",),
    "stall_tick": ("duration",),
    "corrupt_cache_entry": ("jid",),
    "edit_factor": ("constraint",),
    "remove_agent_burst": ("count",),
    "add_agent_burst": ("count",),
    "kill_replica": ("replica",),
    "stall_replica": ("replica", "duration"),
    "partition_replica": ("replica", "duration"),
    "kill_process": ("replica",),
    "partition_socket": ("replica", "duration"),
    "corrupt_artifact": ("replica", "path"),
    "kill_device": ("device", "replica"),
    "shrink_mesh": ("devices",),
    "corrupt_slab": ("operand", "device"),
}


@dataclasses.dataclass
class Fault:
    """One fault spec.  ``cycle`` faults fire at the first cycle-chunk
    boundary >= cycle (rank faults) or phase boundary (agent faults);
    ``attempt`` restricts a fault to one launch attempt (default 0 =
    the first launch only, so a relaunch can demonstrate recovery;
    None = every attempt)."""

    kind: str
    rank: Optional[int] = None  # kill_rank / stall_rank
    cycle: int = 0  # rank faults: cycle-chunk boundary; serve: tick
    duration: float = 0.0  # stall_rank / stall_tick: seconds stopped
    agent: Optional[str] = None  # kill_agent
    path: Optional[str] = None  # checkpoint faults: explicit file
    attempt: Optional[int] = 0
    #: serve faults: target job id.  A serve fault WITHOUT a jid fires
    #: once (a transient glitch the service must absorb); WITH a jid it
    #: keeps firing for that job (a poison job the quarantine must
    #: escalate to a terminal ERROR).
    jid: Optional[str] = None
    #: churn bursts: how many agents the burst removes/adds (default 1)
    count: Optional[int] = None
    #: edit_factor: the constraint to hot-swap (None = seeded choice)
    constraint: Optional[str] = None
    #: fleet faults: target replica index (kill_replica / stall_replica
    #: / partition_replica).  On ``kill_device`` a replica makes the
    #: fault a FLEET fault instead: that replica loses one device and
    #: advertises reduced capacity to the router.
    replica: Optional[int] = None
    #: kill_device: the mesh device index to drop; corrupt_slab: the
    #: shard whose slab block takes the bit-flip (None = anywhere)
    device: Optional[int] = None
    #: shrink_mesh: the target device count after the shrink
    devices: Optional[int] = None
    #: corrupt_slab: the named staged operand to flip a bit in (the
    #: elastic engines publish their addressable operand names via
    #: ``operand_names()`` — e.g. ``bucket0``, ``q``, ``r``, ``x``,
    #: ``local``)
    operand: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{KINDS}"
            )
        if self.kind in ("kill_rank", "stall_rank") and self.rank is None:
            raise ValueError(f"{self.kind} fault needs a 'rank'")
        if self.kind in ("stall_rank", "stall_tick",
                         "stall_replica") and self.duration <= 0:
            raise ValueError(f"{self.kind} fault needs a 'duration' > 0")
        if (self.kind in FLEET_KINDS
                or self.kind in ("kill_process", "partition_socket")) \
                and self.replica is None:
            raise ValueError(f"{self.kind} fault needs a 'replica'")
        if self.kind == "kill_agent" and not self.agent:
            raise ValueError("kill_agent fault needs an 'agent'")
        if self.kind in ("remove_agent_burst", "add_agent_burst") \
                and self.count is not None and self.count < 1:
            raise ValueError(f"{self.kind} fault needs a 'count' >= 1")
        if self.kind == "kill_device" and self.device is None:
            raise ValueError("kill_device fault needs a 'device'")
        if self.kind == "shrink_mesh" and (
                self.devices is None or self.devices < 1):
            raise ValueError("shrink_mesh fault needs 'devices' >= 1")
        if self.kind == "corrupt_slab" and not self.operand:
            raise ValueError("corrupt_slab fault needs an 'operand'")

    def to_dict(self) -> Dict:
        # 'attempt' must survive even as None (None = every attempt —
        # dropping it would deserialize back to the default of 0)
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None or k == "attempt"}


@dataclasses.dataclass
class FaultPlan:
    """An ordered, seedable set of faults.

    YAML schema (see docs/resilience.rst)::

        seed: 7
        faults:
          - kind: kill_rank
            rank: 1
            cycle: 8          # fire at first chunk boundary >= 8
            attempt: 0        # first launch only (default)
          - kind: stall_rank
            rank: 0
            cycle: 4
            duration: 60      # seconds SIGSTOPped
          - kind: kill_agent
            agent: a3
            cycle: 10         # thread-mode phase boundary
          - kind: corrupt_checkpoint   # or truncate_checkpoint
            attempt: 1        # mangle the latest snapshot before
                              # relaunch attempt 1 resumes from it
          - kind: raise_in_step        # serve: throw in a bucket step
            jid: job-000002   # poison job (persists until ERROR);
            cycle: 2          # first scheduler tick >= 2
          - kind: nan_lane             # serve: NaN a lane's state
            jid: job-000002
          - kind: torn_journal_write   # serve: cut an append mid-line
          - kind: stall_tick           # serve: wedge one tick
            duration: 0.5
          - kind: corrupt_cache_entry  # serve: flip bytes in the
            jid: job-000002            # solution-cache npz written for
                                       # this job (omit jid: the next
                                       # insert); rehydrate/adopt must
                                       # skip-and-count it, never serve
          - kind: edit_factor          # churn: hot-swap a constraint's
            cycle: 10                  # table (seeded perturbation);
            constraint: c12            # omit 'constraint' for a seeded
                                       # choice
          - kind: remove_agent_burst   # churn: remove `count` seeded-
            cycle: 20                  # chosen agents at one phase
            count: 3                   # boundary (replica repair x3)
          - kind: add_agent_burst      # churn: add fresh agents
            cycle: 30
            count: 2
          - kind: kill_replica         # fleet: hard-stop one replica's
            replica: 1                 # scheduler mid-trace (thread-
            cycle: 4                   # hosted kill -9; journal only)
          - kind: stall_replica        # fleet: wedge a replica; the
            replica: 0                 # router routes around it, no
            cycle: 2                   # re-seat (a stall != a death)
            duration: 0.5
          - kind: partition_replica    # fleet: unreachable for NEW
            replica: 1                 # placements for `duration`
            cycle: 3                   # seconds (0 = rest of run)
            duration: 1.0
          - kind: kill_process         # process fleet: SIGKILL the
            replica: 1                 # whole replica child process
            cycle: 4                   # (the real kill -9; heartbeat
                                       # staleness + waitpid detect it,
                                       # survivors re-seat its jobs)
          - kind: partition_socket     # process fleet: sever replica
            replica: 0                 # 0's journal socket and refuse
            cycle: 6                   # re-dials for `duration` s
            duration: 1.0              # (0 = rest of run); frames
                                       # buffer + replay on heal
          - kind: corrupt_artifact     # process fleet: flip one seeded
            cycle: 2                   # byte in an exported runner
                                       # artifact (CRC must catch it;
                                       # `replica`/`path` narrow the
                                       # target, omit for seeded pick)
          - kind: kill_device          # device: drop mesh device 7 at
            device: 7                  # the next chunk boundary >= 8;
            cycle: 8                   # with `replica: N` the fleet
                                       # replica N loses a device and
                                       # advertises reduced capacity
          - kind: shrink_mesh          # device: shrink the mesh to 4
            devices: 4                 # devices in one step
            cycle: 16
          - kind: corrupt_slab         # device: flip one seeded bit in
            operand: bucket0           # a named staged operand (SDC
            cycle: 12                  # probe); `device` restricts the
            device: 2                  # flip to that shard's block
    """

    faults: List[Fault] = dataclasses.field(default_factory=list)
    seed: int = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        if not isinstance(d, dict) or "faults" not in d:
            raise ValueError(
                "fault plan must be a mapping with a 'faults' list"
            )
        faults = []
        for i, f in enumerate(d["faults"] or []):
            if not isinstance(f, dict) or "kind" not in f:
                raise ValueError(
                    f"fault #{i} must be a mapping with a 'kind'"
                )
            known = {fl.name for fl in dataclasses.fields(Fault)}
            unknown = set(f) - known
            if unknown:
                raise ValueError(
                    f"fault #{i} has unknown fields {sorted(unknown)}"
                )
            faults.append(Fault(**f))
        return cls(faults=faults, seed=int(d.get("seed", 0)))

    @classmethod
    def from_yaml(cls, path: str) -> "FaultPlan":
        import yaml

        with open(path, encoding="utf-8") as f:
            plan = cls.from_dict(yaml.safe_load(f))
        # a plan from disk is the chaos contract of a whole run: a
        # misaddressed field (a stall_tick with a rank, a kill_replica
        # with an agent) would silently never fire — fail loudly here
        plan.validate()
        return plan

    def validate(self) -> List[str]:
        """Check every fault only addresses fields its kind consumes
        (:data:`KIND_FIELDS` — the catalog docs/resilience.rst's
        fault-kind table documents) and return the sorted kinds the
        plan uses.  ``__post_init__`` already enforces required
        fields; this catches the opposite bug — a field the kind will
        never read, i.e. a fault that cannot mean what its author
        wrote."""
        targeted = ("rank", "agent", "path", "jid", "count",
                    "constraint", "replica", "device", "devices",
                    "operand")
        for i, f in enumerate(self.faults):
            allowed = KIND_FIELDS[f.kind]
            extras = sorted(
                name for name in targeted
                if getattr(f, name) is not None and name not in allowed
            )
            if f.duration and "duration" not in allowed:
                extras.append("duration")
            if extras:
                raise ValueError(
                    f"fault #{i} ({f.kind}) addresses field(s) "
                    f"{extras} that {f.kind!r} never consumes; it "
                    f"accepts only {sorted(allowed)} (see the "
                    f"fault-kind catalog in docs/resilience.rst)"
                )
        return sorted({f.kind for f in self.faults})

    def to_json(self) -> str:
        return json.dumps(
            {"seed": self.seed, "faults": [f.to_dict() for f in self.faults]}
        )

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_FAULT_PLAN)
        return cls.from_json(raw) if raw else None

    # -- queries ------------------------------------------------------------

    def for_rank(self, rank: int) -> List[Fault]:
        return [f for f in self.faults
                if f.kind in ("kill_rank", "stall_rank") and f.rank == rank]

    def agent_kills(self) -> List[Fault]:
        return [f for f in self.faults if f.kind == "kill_agent"]

    def checkpoint_faults(self, attempt: Optional[int] = None) -> List[Fault]:
        out = [f for f in self.faults
               if f.kind in ("corrupt_checkpoint", "truncate_checkpoint")]
        if attempt is not None:
            out = [f for f in out
                   if f.attempt is None or f.attempt == attempt]
        return out

    def serve_faults(self) -> List[Fault]:
        return [f for f in self.faults if f.kind in SERVE_KINDS]

    def fleet_faults(self) -> List[Fault]:
        """Replica-level faults (kill/stall/partition, plus
        replica-scoped ``kill_device``) consumed by the solve fleet's
        supervisor (serve/fleet.py) through the same
        :class:`ServeFaultInjector` consultation protocol."""
        return [f for f in self.faults
                if f.kind in FLEET_KINDS
                or (f.kind == "kill_device" and f.replica is not None)]

    def process_faults(self) -> List[Fault]:
        """Process-fleet faults (kill_process / partition_socket /
        corrupt_artifact) consumed by the process fleet's supervisor
        (serve/procfleet.ProcessFleet) — the OS-level escalation of
        :meth:`fleet_faults`."""
        return [f for f in self.faults if f.kind in PROCESS_KINDS]

    def device_faults(self) -> List[Fault]:
        """Device-tier faults (kill_device/shrink_mesh/corrupt_slab)
        consumed by the elastic sharded runner
        (parallel/elastic.ElasticRunner) at chunk boundaries, ordered
        by cycle.  A ``kill_device`` carrying a ``replica`` belongs to
        the fleet (see :meth:`fleet_faults`) and is excluded here."""
        out = [f for f in self.faults
               if f.kind in DEVICE_KINDS
               and not (f.kind == "kill_device"
                        and f.replica is not None)]
        return sorted(out, key=lambda f: f.cycle)

    def churn_faults(self) -> List[Fault]:
        """Agent-churn / live-mutation faults (kill_agent + the burst
        and edit kinds), ordered by cycle — the seeded churn stream the
        orchestrator replays at phase boundaries."""
        out = [f for f in self.faults
               if f.kind == "kill_agent" or f.kind in CHURN_KINDS]
        return sorted(out, key=lambda f: f.cycle)

    @property
    def has_rank_faults(self) -> bool:
        return any(f.kind in ("kill_rank", "stall_rank")
                   for f in self.faults)


# --------------------------------------------------------------------------
# serve-side injection (pydcop_tpu_torch.serve.SolveService)
# --------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """Raised by :class:`ServeFaultInjector` to simulate a component
    failure (``raise_in_step``) — handled by the same isolation
    machinery (bucket quarantine, supervisor backoff) as a real
    exception, which is the point."""


class ServeFaultInjector:
    """Consulted by the solve service's scheduler at tick boundaries.

    ``due(kind, tick, ...)`` returns the first pending fault of that
    kind whose ``cycle`` (tick threshold) has been reached and whose
    target matches.  One-shot vs persistent semantics follow the
    fault's ``jid``:

    * ``jid=None`` — a *transient* fault: consumed on first fire.  The
      service should absorb it (quarantine retry, supervisor restart)
      and every job should still complete correctly.
    * ``jid`` set — a *poison job*: the fault keeps firing whenever
      that job is in the blast radius, so the retry →
      sequential-fallback escalation must end the job in a terminal
      ``ERROR`` — never take down its bucket-mates, let alone the
      service.  :meth:`poisoned` lets the fallback path honor the
      persistence too.
    """

    def __init__(self, plan: FaultPlan,
                 faults: Optional[List[Fault]] = None):
        """``faults`` overrides the consumed subset: the solve service
        passes nothing (``plan.serve_faults()``); the solve fleet's
        supervisor passes ``plan.fleet_faults()`` so replica-level
        kill/stall/partition kinds flow through the SAME consultation
        protocol (``due`` at tick boundaries, one-shot unless
        jid-targeted)."""
        self.plan = plan
        self._pending: List[Fault] = list(
            plan.serve_faults() if faults is None else faults
        )
        self.fired: List[Fault] = []

    def due(self, kind: str, tick: int,
            jid: Optional[str] = None,
            jids: Optional[Sequence[str]] = None) -> Optional[Fault]:
        for f in list(self._pending):
            if f.kind != kind or f.cycle > tick:
                continue
            if f.jid is not None:
                if jids is not None:
                    if f.jid not in jids:
                        continue
                elif jid is not None:
                    if f.jid != jid:
                        continue
                else:
                    continue  # targeted fault, no target in scope
                # persistent: a poison job stays poisoned
            else:
                self._pending.remove(f)
            self.fired.append(f)
            return f
        return None

    def poisoned(self, jid: str) -> bool:
        """True while a persistent (jid-targeted) fault still targets
        ``jid`` — the sequential-fallback escalation checks this so an
        injected poison job cannot 'recover' by falling back."""
        return any(f.jid == jid for f in self._pending)


# --------------------------------------------------------------------------
# rank-side injection
# --------------------------------------------------------------------------

def _default_stall(duration: float) -> None:
    """Freeze THIS process (all threads, heartbeat writer included) for
    ``duration`` seconds: a helper process sends SIGCONT later, then we
    SIGSTOP ourselves.  From outside this is a genuine stall — exactly
    what a wedged collective or a livelocked rank looks like."""
    pid = os.getpid()
    subprocess.Popen(
        [sys.executable, "-c",
         "import time, os, signal, sys\n"
         f"time.sleep({float(duration)})\n"
         "try:\n"
         f"    os.kill({pid}, signal.SIGCONT)\n"
         "except ProcessLookupError:\n"
         "    pass\n"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    os.kill(pid, signal.SIGSTOP)


class RankFaultInjector:
    """Consulted by a mesh rank at every cycle-chunk boundary.

    ``at_cycle(c)`` fires every not-yet-fired fault addressed to this
    rank whose cycle is <= c and whose attempt matches — a kill
    ``os._exit``\\ s with :data:`KILL_EXIT_CODE`, a stall freezes the
    process.  The exit/stall hooks are injectable for unit tests.
    """

    def __init__(self, plan: FaultPlan, rank: int,
                 attempt: Optional[int] = None,
                 _exit=os._exit, _stall=_default_stall):
        if attempt is None:
            attempt = int(os.environ.get(ENV_FAULT_ATTEMPT, "0"))
        self.rank = rank
        self.attempt = attempt
        self._exit = _exit
        self._stall = _stall
        self._pending = [
            f for f in plan.for_rank(rank)
            if f.attempt is None or f.attempt == attempt
        ]

    @property
    def cycle_faults_pending(self) -> bool:
        return bool(self._pending)

    def next_cycle(self) -> Optional[int]:
        """The earliest pending fault cycle (chunking hint), or None."""
        return min((f.cycle for f in self._pending), default=None)

    def at_cycle(self, cycle: int) -> None:
        due = [f for f in self._pending if f.cycle <= cycle]
        self._pending = [f for f in self._pending if f.cycle > cycle]
        for f in due:
            if f.kind == "stall_rank":
                self._stall(f.duration)
            elif f.kind == "kill_rank":
                self._exit(KILL_EXIT_CODE)


# --------------------------------------------------------------------------
# liveness: heartbeat files + stall detection
# --------------------------------------------------------------------------

class HeartbeatWriter:
    """Daemon thread touching ``path`` every ``interval`` seconds.

    Started before the rank's heavy imports so the watchdog sees a live
    rank from the first second.  A SIGSTOP (injected or real) freezes
    this thread with the rest of the process, so staleness of the file
    is a faithful liveness signal — unlike a heartbeat written only
    from the main solve loop, it does NOT go stale during long compiles.
    """

    def __init__(self, path: str, interval: float = 0.5):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        with open(self.path, "a", encoding="utf-8"):
            os.utime(self.path, None)

    def start(self) -> "HeartbeatWriter":
        self.beat()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"heartbeat-{os.path.basename(self.path)}",
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:  # pragma: no cover - tmpdir vanished
                return

    def stop(self) -> None:
        self._stop.set()


def stalled_ranks(
    hb_paths: Dict[int, str],
    stall_timeout: float,
    now: Optional[float] = None,
) -> List[int]:
    """Ranks whose heartbeat file exists but has not been touched for
    more than ``stall_timeout`` seconds.  A missing file is NOT a stall
    (the rank may still be forking); rank death is detected separately
    through the exit code."""
    now = time.time() if now is None else now
    out = []
    for rank, path in sorted(hb_paths.items()):
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue
        if age > stall_timeout:
            out.append(rank)
    return out


# --------------------------------------------------------------------------
# checkpoint file faults
# --------------------------------------------------------------------------

def corrupt_checkpoint(path: str, seed: int = 0,
                       mode: str = "corrupt") -> None:
    """Deterministically damage a checkpoint file in place.

    ``mode='corrupt'`` flips 16 bytes in the data region (positions
    drawn from ``random.Random(seed)``); ``mode='truncate'`` cuts the
    file to a seed-chosen fraction (30-70%) of its length.  Same seed,
    same file size → same damage, so tests are reproducible.
    """
    import random

    rng = random.Random(seed)
    size = os.path.getsize(path)
    if mode == "truncate":
        keep = max(1, int(size * (0.3 + 0.4 * rng.random())))
        with open(path, "r+b") as f:
            f.truncate(keep)
        return
    if mode != "corrupt":
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "r+b") as f:
        # skip the first 512 bytes: flipping the zip local-file header
        # is indistinguishable from truncation; aim at array data so
        # the CRC check (not the zip layer) is what must catch it
        lo = min(512, size // 2)
        for _ in range(16):
            pos = rng.randrange(lo, size)
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


def apply_checkpoint_faults(plan: FaultPlan, directory: Optional[str],
                            attempt: int) -> List[str]:
    """Host-side: fire the plan's checkpoint faults due at ``attempt``
    against their explicit paths or the newest snapshot in
    ``directory``.  Not ported: the newest snapshot comes from the
    solver checkpoints' ``CheckpointManager``, which the PyTorch package
    does not have yet."""
    from pydcop_tpu_torch.errors import NotPortedError

    raise NotPortedError(
        "apply_checkpoint_faults is not ported to the PyTorch package: "
        "it needs the solver checkpoints (CheckpointManager), which are "
        "not ported yet; corrupt_checkpoint(path) damages a given file"
    )
