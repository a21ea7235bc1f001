"""ProcessFleet — the solve fleet with REAL failure domains.

The port of the JAX package's ``serve/procfleet.py``.
:class:`~pydcop_tpu_torch.serve.fleet.SolveFleet` hosts its N replicas as
threads in one process: one GIL, one address space, one CUDA context,
one way to die.  This module promotes each replica to a child OS
process — its own interpreter and, on the card, its own CUDA context —
and keeps everything else — routing, admission, re-seat, RTO accounting
— by reusing the fleet base class over a process-shaped replica handle:

* **processes** — each replica is ``python -m pydcop_tpu_torch
  serve-replica`` (commands/serve_replica.py), a fresh interpreter
  started with ``subprocess.Popen`` (never a fork of a process that
  touched CUDA; the head itself never needs the card: routing keys come
  from the DCOP's host structure), spawned and supervised with the
  watchdog protocol: a file heartbeat beaten by the child's scheduler
  tick, death detected via heartbeat staleness + ``waitpid``
  (``Popen.poll``), the exit-code taxonomy (signal death /
  ``KILL_EXIT_CODE`` = retryable → exponential-backoff relaunch under a
  fresh incarnation name; nonzero = permanent, not relaunched — a child
  that finds no GPU exits with :data:`NO_DEVICE_EXIT_CODE` and
  :meth:`ProcessFleet.wait_ready` raises, the fleet never moves to the
  CPU), and stderr to a per-replica file, never a blockable pipe;
* **socket journal** — control frames and journal records ride ONE
  length-prefixed, CRC-framed stream per replica (serve/wire.py).
  Completion records are applied exactly once at the head (per-sender
  sequence dedup survives reconnects — a completion sent just before
  a connection loss replays but never double-applies) and fsynced
  into ``fleet.jsonl`` by the head's :class:`FleetJournal`;
* **kill -9 for real** — ``kill_process`` SIGKILLs the whole child:
  every lane, thread, socket and kernel in flight dies at once.  The
  supervisor detects it, re-seats the in-flight jobs on surviving
  processes through the service's resume protocol (the lane checkpoints
  and ``JID:`` completion lines live on the shared filesystem),
  bit-identically and with a finite RTO — the same guarantees the
  thread fleet pins, now across an OS boundary;
* **warm bring-up** — replicas share an
  :class:`~pydcop_tpu_torch.serve.artifacts.ArtifactStore` under the
  journal directory: the first process to build a runner exports its
  recipe keyed by ``runner_cache_key``; a relaunched or cold-joining
  replica rebuilds it (ABI-checked, CRC-verified), warmed and captured
  before its first job — no cache miss, no capture on that job's path.
  The kernels' libraries come prebuilt from ``_build/``: no child runs
  ``nvcc`` once the head has called ``cuda_build.build_all()``;
* **stall vs death vs process-exit** — a stale heartbeat with a live
  process is a STALL (route around, never re-seat: the process may
  finish its work); a dead process is a death (re-seat + maybe
  relaunch); a severed socket (``partition_socket``) is neither —
  in-flight jobs keep running, frames buffer child-side and replay on
  the healed reconnect.

Tick-driven tests drive :meth:`SolveFleet.tick` exactly like the
thread fleet — the hub is pumped inside supervision, so schedules
stay deterministic.  The child side, :class:`ReplicaWorker`, is
importable and loop-drivable so protocol tests can host it on a
thread over a real socket without paying process spawn.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading
import time
from collections import deque
from time import monotonic
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.batch.cache import CompileCache
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.errors import DeviceUnavailableError
from pydcop_tpu_torch.runtime.events import send_fleet
from pydcop_tpu_torch.runtime.faults import (
    ENV_FAULT_ATTEMPT,
    ENV_FAULT_PLAN,
    KILL_EXIT_CODE,
    FaultPlan,
)
from pydcop_tpu_torch.runtime.stats import FleetCounters, ServeCounters
from pydcop_tpu_torch.serve.artifacts import (
    ArtifactStore,
    abi_tag,
    corrupt_artifact_file,
    dims_from_wire,
    dims_to_wire,
)
from pydcop_tpu_torch.serve.errors import ServiceStopped
from pydcop_tpu_torch.serve.fleet import ReplicaHandle, SolveFleet
from pydcop_tpu_torch.serve.wire import JournalClient, JournalHub

#: shared artifact directory under the fleet journal dir
ARTIFACT_SUBDIR = "artifacts"
#: re-seat spill directory: checkpoint state recovered from a dead
#: replica's disk, re-written for the surviving replica to restore
SPILL_SUBDIR = "spill"
#: a replica child's exit code when its device is not there (a cuda
#: child on a machine with no GPU): permanent, never relaunched
NO_DEVICE_EXIT_CODE = 3


def _json_safe(v: Any) -> Any:
    """Numpy scalars → plain Python so result frames round-trip the
    JSON wire exactly (int is exact; float survives as an IEEE-754
    double both ways — bit-identity holds)."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return v


_dims_to_wire = dims_to_wire
_dims_from_wire = dims_from_wire


# --------------------------------------------------------------------------
# head side: the service-shaped proxy + process handle
# --------------------------------------------------------------------------


class _ProxyCounters:
    """Mirror of a child's ServeCounters, refreshed by stats frames."""

    def __init__(self, replica: str):
        self._replica = replica
        self._last: Dict[str, Any] = {"replica": replica}
        self._lock = threading.Lock()

    def update(self, d: Dict[str, Any]) -> None:
        with self._lock:
            self._last = dict(d)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last)


class _ProxyDevice:
    """Mirror of what a child reports of its process and device: its
    ``nvcc`` runs, its kernels' launch counters and, on the card, its
    CUDA memory (``memory_reserved`` and ``mem_get_info``)."""

    def __init__(self):
        self._last: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def update(self, d: Dict[str, Any]) -> None:
        with self._lock:
            self._last = dict(d)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._last)


class _ProxyCache:
    """Mirror of a child's CompileCache: stats from stats frames,
    warmth probed against the key strings the child streamed."""

    def __init__(self):
        self._stats: Dict[str, Any] = {}
        self._warm: set = set()
        self._lock = threading.Lock()

    def update(self, stats: Dict[str, Any],
               keys: Optional[Sequence[str]] = None) -> None:
        with self._lock:
            if stats:
                self._stats = dict(stats)
            if keys:
                self._warm.update(keys)

    def has(self, key: Tuple) -> bool:
        printable = "/".join(str(k) for k in key)
        with self._lock:
            return printable in self._warm

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._stats)


class ReplicaProxy:
    """The slice of the SolveService surface the fleet base class
    touches, re-implemented over the journal socket.  TCP ordering +
    the wire layer's apply-exactly-once contract make the command
    stream behave like in-order method calls on the child: a
    ``prewarm_targets`` frame sent before a ``submit`` frame warms the
    child's cache before that job's admission, exactly like the
    blocking call the thread fleet makes."""

    def __init__(self, fleet: "ProcessFleet", name: str):
        self._fleet = fleet
        self.name = name
        self.handle: Optional["ProcessReplicaHandle"] = None
        self.counters = _ProxyCounters(name)
        self.cache = _ProxyCache()
        self.device = _ProxyDevice()
        self.ready = False
        self._open = 0  # jobs handed over and not yet completed
        self._lock = threading.Lock()
        #: mirrors SolveService._failure for the base class's
        #: ``ReplicaHandle.dead`` — the process fleet detects death
        #: via waitpid/heartbeat instead, so this stays None
        self._failure = None

    # -- bookkeeping called by the fleet on frames ---------------------------

    def job_opened(self) -> None:
        with self._lock:
            self._open += 1

    def job_closed(self) -> None:
        with self._lock:
            self._open = max(0, self._open - 1)

    @property
    def _backlog(self) -> int:
        with self._lock:
            return self._open

    # -- SolveService surface ------------------------------------------------

    def submit(self, dcop, algo: str,
               algo_params: Optional[Dict[str, Any]] = None,
               seed: int = 0, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               label: Optional[str] = None,
               source_file: Optional[str] = None,
               stream: bool = False, spec: Any = None,
               _jid: Optional[str] = None, _journal: bool = True,
               _restore: Optional[Tuple] = None) -> str:
        if self.handle is not None and self.handle.dead:
            raise ServiceStopped(
                f"replica process {self.name} is down"
            )
        if not source_file:
            # no DCOP→YAML dumper exists: jobs cross the process
            # boundary by path, so the front door must have one
            raise ValueError(
                "process-fleet jobs need a source_file: the replica "
                "process re-loads the DCOP from its YAML path"
            )
        restore_path = None
        if _restore is not None:
            # spill the recovered checkpoint state back to disk (the
            # CRC'd npz container) and ship the PATH — the filesystem is
            # the shared medium, the socket carries the pointer
            from pydcop_tpu_torch.runtime.checkpoint import write_state_npz

            meta, arrays = _restore
            restore_path = os.path.join(
                self._fleet.spill_dir, f"{_jid}.npz"
            )
            write_state_npz(restore_path, arrays, dict(meta))
        self._fleet.hub.send(self.name, {
            "cmd": "submit", "jid": _jid, "algo": algo,
            "algo_params": _json_safe(dict(algo_params or {})),
            "seed": int(seed), "tenant": tenant,
            "priority": int(priority), "deadline_s": deadline_s,
            "label": label, "source_file": source_file,
            "stream": bool(stream), "restore": restore_path,
        })
        self.job_opened()
        return _jid or ""

    def prewarm_targets(self, items: Sequence[Tuple], block: bool = False
                        ) -> int:
        entries = [
            [algo, _json_safe(dict(params or {})), _dims_to_wire(dims)]
            for algo, params, dims in items
        ]
        if not entries:
            return 0
        self._fleet.hub.send(self.name, {
            "cmd": "prewarm_targets", "entries": entries,
        })
        return len(entries)

    def prewarm(self, items: Sequence[Tuple], block: bool = False
                ) -> None:
        """Ship a prewarm by source path.  Items whose first element
        is a DCOP object are resolved to the path of a fleet job that
        carries the same object (the re-seat path); unresolvable items
        are skipped — prewarming is an optimization, never fatal."""
        wire_items = []
        for it in items:
            head, algo = it[0], it[1]
            params = dict(it[2]) if len(it) > 2 and it[2] else {}
            path = head if isinstance(head, str) \
                else self._fleet.source_file_for(head)
            if path:
                wire_items.append([path, algo, _json_safe(params)])
        if wire_items:
            self._fleet.hub.send(self.name, {
                "cmd": "prewarm", "items": wire_items,
            })

    def set_deadline_pressure(self, factor: float,
                              exempt_priority: Optional[int] = None
                              ) -> None:
        self._fleet.hub.send(self.name, {
            "cmd": "pressure", "factor": float(factor),
            "exempt_priority": exempt_priority,
        })

    def stall_for(self, duration: float) -> None:
        self._fleet.hub.send(self.name, {
            "cmd": "stall", "duration": float(duration),
        })

    def halt(self) -> None:
        """The real kill -9 lives on the handle (SIGKILL); the proxy
        has nothing to halt locally."""

    def start(self) -> None:  # the child runs its own scheduler
        pass

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        self._fleet.hub.send(self.name, {"cmd": "stop"})

    def tick(self) -> bool:
        return self._backlog > 0


@dataclasses.dataclass
class ProcessReplicaHandle(ReplicaHandle):
    """A replica that is a child OS process.  ``service`` is a
    :class:`ReplicaProxy`; liveness is the process itself."""

    proc: Optional[subprocess.Popen] = None
    attempt: int = 0
    stderr_path: Optional[str] = None

    def kill(self) -> None:
        """The REAL kill -9: SIGKILL the whole child process."""
        self.killed = True
        self.killed_at = monotonic()
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.kill()
            except OSError:
                pass

    @property
    def dead(self) -> bool:
        return self.killed or (
            self.proc is not None and self.proc.poll() is not None
        )

    @property
    def returncode(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    @property
    def retryable(self) -> bool:
        """The exit-code taxonomy: signal death (kill -9, OOM,
        preemption) and the injected-kill exit code are retryable —
        the watchdog relaunches; a clean exit or a nonzero config
        failure (a missing GPU included) is not."""
        rc = self.returncode
        if self.killed:
            return True
        return rc is not None and (rc < 0 or rc == KILL_EXIT_CODE)

    @property
    def down_reason(self) -> str:
        rc = self.returncode
        if self.killed:
            return "injected kill (SIGKILL)"
        if rc is None:
            return "scheduler died"
        if rc < 0:
            return f"process died by signal {-rc}"
        if rc == KILL_EXIT_CODE:
            return "process injected kill"
        if rc == 0:
            return "process exited"
        if rc == NO_DEVICE_EXIT_CODE:
            return f"process found no device (rc={rc})"
        return f"process failed (rc={rc})"

    def stderr_tail(self, n: int = 2000) -> str:
        """The last ``n`` bytes the child wrote to its stderr file."""
        if not self.stderr_path:
            return ""
        try:
            with open(self.stderr_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""


# --------------------------------------------------------------------------
# the process fleet
# --------------------------------------------------------------------------


class ProcessFleet(SolveFleet):
    """N replica child processes behind the fleet front door.

    Reuses the whole SolveFleet contract — admission, warm-first
    routing, re-seat, RTO records, metrics — over process-shaped
    handles.  ``journal_dir`` is REQUIRED: it is the shared medium
    (per-replica journals + checkpoints, the artifact store, re-seat
    spills) and the home of the head-fsynced ``fleet.jsonl``.

    ``relaunch_max`` bounds watchdog relaunches per replica slot;
    relaunched incarnations get a FRESH name (``replica-1r1``) and
    journal directory so a stale incarnation's journal can never be
    mistaken for the live one's, and bootstrap warm from the shared
    artifact store (no cache miss, pinned in tests).  ``device`` is the
    children's (``--device``; cuda unless the caller passes
    ``device="cpu"``): the head resolves nothing, a child that finds no
    GPU exits permanently and :meth:`wait_ready` raises."""

    _INJECT_KINDS = SolveFleet._INJECT_KINDS + (
        "kill_process", "partition_socket", "corrupt_artifact",
    )

    def __init__(
        self,
        replicas: int = 2,
        lanes: int = 4,
        max_cycles: int = 0,
        journal_dir: Optional[str] = None,
        checkpoint_every: int = 4,
        max_buckets: Optional[int] = None,
        max_pending: Optional[int] = None,
        tenant_quota: Optional[int] = None,
        fault_plan: Optional[FaultPlan] = None,
        heartbeat_timeout: float = 2.0,
        supervise_interval: float = 0.05,
        counters: Optional[FleetCounters] = None,
        devices_per_replica: int = 8,
        relaunch: bool = True,
        relaunch_max: int = 2,
        backoff_base: float = 0.25,
        backoff_max: float = 4.0,
        python: Optional[str] = None,
        child_env: Optional[Dict[str, str]] = None,
        memo=None,
        device: DeviceLike = None,
    ):
        if not journal_dir:
            raise ValueError(
                "ProcessFleet requires a journal_dir: it is the "
                "shared filesystem medium of the whole deployment"
            )
        os.makedirs(journal_dir, exist_ok=True)
        # everything the spawning _add_replica override needs must
        # exist BEFORE the base __init__ spawns the initial replicas
        self.artifact_dir = os.path.join(journal_dir, ARTIFACT_SUBDIR)
        os.makedirs(self.artifact_dir, exist_ok=True)
        self.spill_dir = os.path.join(journal_dir, SPILL_SUBDIR)
        os.makedirs(self.spill_dir, exist_ok=True)
        self.relaunch = bool(relaunch)
        self.relaunch_max = int(relaunch_max)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._python = python or sys.executable
        self._child_env = dict(child_env or {})
        self._checkpoint_every = int(checkpoint_every)
        self._pending_relaunch: List[Dict[str, Any]] = []
        self.hub = JournalHub(on_record=self._on_frame)
        if max_cycles <= 0:
            from pydcop_tpu_torch.batch.engine import DEFAULT_MAX_CYCLES

            max_cycles = DEFAULT_MAX_CYCLES
        # the children's device, as a string for their --device flag;
        # resolved (and refused without a GPU) in each child
        self._child_device = str(device or "cuda")
        super().__init__(
            replicas=replicas, lanes=lanes, max_cycles=max_cycles,
            journal_dir=journal_dir,
            checkpoint_every=checkpoint_every,
            max_buckets=max_buckets, max_pending=max_pending,
            tenant_quota=tenant_quota, fault_plan=fault_plan,
            heartbeat_timeout=heartbeat_timeout,
            supervise_interval=supervise_interval,
            shared_xla_cache=False, counters=counters,
            devices_per_replica=devices_per_replica,
            memo=memo, device=device,
        )
        # child heartbeats beat regardless of how the head runs: judge
        # staleness in tick-driven mode too
        self._hb_check_always = True

    def _injector_faults(self, fault_plan: Optional[FaultPlan]):
        if fault_plan is None:
            return []
        return fault_plan.fleet_faults() + fault_plan.process_faults()

    # -- spawning ------------------------------------------------------------

    def _add_replica(self, index: int, checkpoint_every: int,
                     attempt: int = 0) -> ProcessReplicaHandle:
        name = (f"replica-{index}" if attempt == 0
                else f"replica-{index}r{attempt}")
        jd = os.path.join(self.journal_dir, name)
        os.makedirs(jd, exist_ok=True)
        hb = os.path.join(self.journal_dir, f"{name}.hb")
        err_path = os.path.join(self.journal_dir, f"{name}.err")
        proxy = ReplicaProxy(self, name)
        proc = self._spawn(name, jd, hb, err_path, checkpoint_every,
                           attempt)
        handle = ProcessReplicaHandle(
            name=name, index=index, service=proxy,
            journal_dir=jd, hb_path=hb,
            devices_total=self.devices_per_replica,
            proc=proc, attempt=attempt, stderr_path=err_path,
        )
        proxy.handle = handle
        self._handles[name] = handle
        self.router.add_replica(name, warm_probe=proxy.cache.has)
        self.counters.inc("replicas_up")
        send_fleet("replica.up", {
            "name": name, "pid": proc.pid, "attempt": attempt,
        })
        if self.journal is not None:
            self.journal.append({
                "kind": "replica", "event": "up", "name": name,
                "pid": proc.pid, "attempt": attempt,
            })
        return handle

    def _spawn(self, name: str, jd: str, hb: str, err_path: str,
               checkpoint_every: int, attempt: int
               ) -> subprocess.Popen:
        cmd = [
            self._python, "-m", "pydcop_tpu_torch", "serve-replica",
            "--connect", f"127.0.0.1:{self.hub.port}",
            "--name", name,
            "--journal-dir", jd,
            "--heartbeat-file", hb,
            "--artifact-dir", self.artifact_dir,
            "--lanes", str(self.lanes),
            "--max-cycles", str(self.max_cycles),
            "--checkpoint-every", str(checkpoint_every),
            "--device", self._child_device,
        ]
        if self.max_buckets is not None:
            cmd += ["--max-buckets", str(self.max_buckets)]
        if self.memo_cfg is not None:
            cmd += ["--memo"]
        env = {**os.environ, **self._child_env}
        env[ENV_FAULT_ATTEMPT] = str(attempt)
        if self._fault_plan is not None \
                and self._fault_plan.serve_faults():
            env[ENV_FAULT_PLAN] = self._fault_plan.to_json()
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", ""
        )
        # stderr to a FILE (the exit-code taxonomy reads it), never a
        # pipe a busy child could block on
        err_file = open(err_path, "wb")
        try:
            return subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=err_file,
                env=env,
            )
        finally:
            err_file.close()

    def add_replica(self) -> str:
        """Cold-join one more replica process to the running fleet.
        It bootstraps warm from the shared artifact store — a prewarm
        of a family a peer served rebuilds that runner from its recipe,
        with no cache miss (the bring-up pin)."""
        with self._lock:
            index = 1 + max(
                (h.index for h in self._handles.values()), default=-1
            )
        h = self._add_replica(index, self._checkpoint_every)
        return h.name

    def handle(self, name_or_index) -> ReplicaHandle:
        """Index lookups resolve to the NEWEST incarnation of that
        replica slot (relaunches rename), preferring a live one."""
        if isinstance(name_or_index, int):
            cands = [h for h in self._handles.values()
                     if h.index == name_or_index]
            if not cands:
                raise KeyError(f"no replica with index {name_or_index}")
            live = [h for h in cands if h.up]
            return (live or cands)[-1]
        return self._handles[name_or_index]

    def source_file_for(self, dcop) -> Optional[str]:
        """The YAML path of a fleet job carrying this DCOP object —
        how object-shaped prewarm requests cross the process
        boundary."""
        with self._lock:
            for fj in self._jobs.values():
                if fj.dcop is dcop and fj.source_file:
                    return fj.source_file
        return None

    def prewarm(self, items: Sequence[Tuple],
                block: bool = False) -> Dict[str, int]:
        """Path-shaped fleet prewarm: items are ``(yaml_path | dcop,
        algo, params)``.  Routing keys are computed head-side (paths
        load once); the chosen replica receives the PATH over the
        socket, since DCOP objects don't cross the process boundary.
        Unresolvable object-shaped items are skipped — prewarming is
        an optimization, never fatal."""
        from pydcop_tpu_torch.dcop import load_dcop_from_file
        from pydcop_tpu_torch.serve.router import job_routing_key

        loaded: Dict[str, Any] = {}
        groups: Dict[Tuple, List[Tuple]] = {}
        for it in items:
            head, algo = it[0], it[1]
            params = dict(it[2]) if len(it) > 2 and it[2] else {}
            if isinstance(head, str):
                path = head
                if path not in loaded:
                    loaded[path] = load_dcop_from_file([path])
                dcop = loaded[path]
            else:
                dcop, path = head, self.source_file_for(head)
            if not path:
                continue
            groups.setdefault(
                job_routing_key(dcop, algo, params), []
            ).append((path, algo, params))
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

    def wait_ready(self, timeout: float = 60.0) -> bool:
        """Block until every live replica process has connected and
        reported ready (its scheduler is up and beating).  Raises
        :class:`~pydcop_tpu_torch.errors.DeviceUnavailableError` when a
        child exited because its device is not there — the fleet is not
        relaunched on another device."""
        deadline = monotonic() + timeout
        while monotonic() < deadline:
            with self._lock:
                handles = list(self._handles.values())
            for h in handles:
                if isinstance(h, ProcessReplicaHandle) \
                        and h.returncode == NO_DEVICE_EXIT_CODE:
                    raise DeviceUnavailableError(
                        f"replica process {h.name} found no "
                        f"{self._child_device} device: "
                        f"{h.stderr_tail().strip()[-500:]}")
            pending = [
                h for h in handles
                if h.up and not h.dead
                and not getattr(h.service, "ready", True)
            ]
            if not pending:
                return True
            if self._started:
                time.sleep(0.05)
            else:
                self.hub.pump(0.05)
        return False

    # -- the frame tap -------------------------------------------------------

    def _on_frame(self, client: str, body: Dict[str, Any]) -> None:
        """Apply one EXACTLY-ONCE frame from a replica process (the
        wire layer deduplicated replays already)."""
        h = self._handles.get(client)
        if h is None or not isinstance(h.service, ReplicaProxy):
            return
        proxy: ReplicaProxy = h.service
        evt = body.get("evt")
        if evt == "ready":
            proxy.ready = True
            send_fleet("replica.ready", {
                "name": client, "pid": body.get("pid"),
                "abi": body.get("abi"),
            })
            if self.journal is not None:
                self.journal.append({
                    "kind": "replica", "event": "ready",
                    "name": client, "abi": body.get("abi"),
                })
        elif evt == "complete":
            self._on_child_complete(h, proxy, body)
        elif evt == "stats":
            proxy.counters.update(body.get("serve") or {})
            proxy.cache.update(body.get("cache") or {},
                               body.get("cache_keys"))
            proxy.device.update(body.get("device") or {})
        elif evt == "warm":
            # router warmth rides note_warm at placement time; the key
            # set feeds the warm_probe (proxy.cache.has) directly
            proxy.cache.update({}, body.get("keys"))
        elif evt == "reject":
            self._on_child_reject(h, proxy, body)
        elif evt == "memo":
            self._on_child_memo(h, body)
        elif evt == "journal":
            rec = body.get("record")
            if self.journal is not None and isinstance(rec, dict):
                self.journal.append(rec)

    def _on_child_memo(self, h: ProcessReplicaHandle,
                       body: Dict[str, Any]) -> None:
        """A child memoised a freshly-solved instance: journal the
        record and tell every OTHER child to adopt the persisted entry
        off the shared filesystem (``memo_adopt`` command → child-side
        :meth:`MemoCache.adopt_file`, CRC-checked — a corrupt frame is
        skipped-and-counted child-side, never served).  The socket-wire
        twin of the thread fleet's in-memory adoption tap."""
        path = body.get("path")
        if self.journal is not None:
            self.journal.append({
                "kind": "memo", "key": body.get("key"),
                "tenant": body.get("tenant"),
                "algo": body.get("algo"),
                "replica": h.name, "path": path,
            })
        if not path:
            return
        shared = 0
        with self._lock:
            peers = [
                p.name for p in self._handles.values()
                if p.name != h.name and p.up and not p.dead
            ]
        for peer in peers:
            try:
                self.hub.send(peer, {
                    "cmd": "memo_adopt", "path": path,
                })
                shared += 1
            except Exception:
                pass  # a severed peer just misses this adoption
        if shared:
            self.counters.inc("memo_shared", shared)
            send_fleet("memo.shared", {
                "key": body.get("key"), "from": h.name,
                "peers": shared,
            })

    def _on_child_complete(self, h: ProcessReplicaHandle,
                           proxy: ReplicaProxy,
                           body: Dict[str, Any]) -> None:
        r = body.get("result") or {}
        res = SolveResult(
            status=r.get("status", "ERROR"),
            assignment=r.get("assignment") or {},
            cost=r.get("cost"), violation=r.get("violation"),
            cycle=int(r.get("cycle", 0)),
            msg_count=int(r.get("msg_count", 0)),
            msg_size=float(r.get("msg_size", 0.0)),
            time=float(r.get("time", 0.0)),
        )
        res.serve = r.get("serve")
        res.harness = r.get("harness")
        res.config = r.get("config")
        res.memo = r.get("memo")
        proxy.job_closed()
        job = _RemoteJobView(
            jid=body.get("jid", ""), tenant=body.get("tenant", ""),
            service_stopped=bool(body.get("service_stopped", False)),
        )
        self._on_replica_complete(h, job, res)

    def _on_child_reject(self, h: ProcessReplicaHandle,
                         proxy: ReplicaProxy,
                         body: Dict[str, Any]) -> None:
        """A replica refused a handed-over job (bad source file, dead
        admission): the process-mode twin of the _place_on exception
        path — re-place once on a peer, else fail structuredly."""
        jid = body.get("jid")
        with self._lock:
            fj = self._jobs.get(jid)
            if fj is None or fj.done.is_set():
                return
        proxy.job_closed()
        self.router.job_finished(h.name)
        placed = self.router.place(fj.key, jid=fj.jid, exclude=h.name)
        if placed is None:
            self._fail_job(
                fj, f"replica {h.name} rejected the job and no peer "
                f"is routable: {body.get('error')}"
            )
            return
        with self._lock:
            fj.replica = placed[0]
        self._place_on(fj, placed[0])

    # -- supervision ---------------------------------------------------------

    def _supervise(self) -> None:
        self.hub.pump(0)
        super()._supervise()
        self._fire_due_relaunches()

    def _inject(self, kind: str, fault, now: float) -> None:
        if kind == "kill_process":
            h = self.handle(int(fault.replica))
            self.counters.inc("faults_injected")
            send_fleet("fault.injected", {
                "kind": kind, "replica": h.name, "tick": self._ticks,
            })
            with self._lock:
                live = h.up and not h.killed
            if live:
                h.kill()
        elif kind == "partition_socket":
            h = self.handle(int(fault.replica))
            self.counters.inc("faults_injected")
            send_fleet("fault.injected", {
                "kind": kind, "replica": h.name, "tick": self._ticks,
            })
            self.hub.partition(
                h.name,
                fault.duration if fault.duration > 0 else float("inf"),
            )
            with self._lock:
                h.partition_until = (
                    now + fault.duration if fault.duration > 0
                    else float("inf")
                )
            self.router.set_partitioned(h.name, True)
            self.counters.inc("replicas_partitioned")
            self.counters.inc("socket_partitions")
            send_fleet("replica.partitioned", {
                "name": h.name, "duration": fault.duration,
                "socket": True,
            })
        elif kind == "corrupt_artifact":
            self.counters.inc("faults_injected")
            path = fault.path
            if path is None:
                arts = sorted(
                    n for n in os.listdir(self.artifact_dir)
                    if n.endswith(".rnr")
                )
                if not arts:
                    return
                pick = (self._fault_plan.seed + self._ticks) % len(arts)
                path = os.path.join(self.artifact_dir, arts[pick])
            if corrupt_artifact_file(path, seed=self._fault_plan.seed):
                self.counters.inc("artifacts_corrupted")
                send_fleet("fault.injected", {
                    "kind": kind, "path": path, "tick": self._ticks,
                })
                if self.journal is not None:
                    self.journal.append({
                        "kind": "artifact", "event": "corrupted",
                        "path": path,
                    })
        else:
            super()._inject(kind, fault, now)

    def _replica_down(self, h: ReplicaHandle, reason: str,
                      t_detect: float) -> None:
        if isinstance(h, ProcessReplicaHandle) and h.proc is not None:
            try:  # reap the zombie: waitpid is the death ground truth
                h.proc.wait(timeout=5)
            except (subprocess.TimeoutExpired, OSError):
                pass
        super()._replica_down(h, reason, t_detect)
        if (
            isinstance(h, ProcessReplicaHandle)
            and self.relaunch and h.retryable
            and h.attempt < self.relaunch_max
        ):
            delay = min(self.backoff_max,
                        self.backoff_base * (2 ** h.attempt))
            with self._lock:
                self._pending_relaunch.append({
                    "index": h.index, "attempt": h.attempt + 1,
                    "due": monotonic() + delay, "from": h.name,
                })
            send_fleet("replica.relaunch_scheduled", {
                "name": h.name, "attempt": h.attempt + 1,
                "delay_s": round(delay, 3),
            })

    def _fire_due_relaunches(self) -> None:
        now = monotonic()
        with self._lock:
            if self._stopped or not self._pending_relaunch:
                return
            due = [r for r in self._pending_relaunch if r["due"] <= now]
            self._pending_relaunch = [
                r for r in self._pending_relaunch if r["due"] > now
            ]
        for r in due:
            h = self._add_replica(r["index"], self._checkpoint_every,
                                  attempt=r["attempt"])
            self.counters.inc("replicas_relaunched")
            send_fleet("replica.relaunched", {
                "name": h.name, "from": r["from"],
                "attempt": r["attempt"],
            })
            if self.journal is not None:
                self.journal.append({
                    "kind": "replica", "event": "relaunched",
                    "name": h.name, "from": r["from"],
                })

    # -- lifecycle -----------------------------------------------------------

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        super().stop(drain=drain, timeout=timeout)
        for h in self._handles.values():
            if not isinstance(h, ProcessReplicaHandle) \
                    or h.proc is None:
                continue
            try:
                h.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    h.proc.terminate()
                    h.proc.wait(timeout=3)
                except (subprocess.TimeoutExpired, OSError):
                    try:
                        h.proc.kill()
                        h.proc.wait(timeout=3)
                    except (subprocess.TimeoutExpired, OSError):
                        pass
            except OSError:
                pass
        self.hub.stop()

    def metrics(self) -> Dict[str, Any]:
        m = super().metrics()
        m["hub"] = self.hub.stats()
        m["artifacts"] = ArtifactStore(self.artifact_dir).stats() \
            if os.path.isdir(self.artifact_dir) else None
        with self._lock:
            m["pending_relaunches"] = len(self._pending_relaunch)
            handles = list(self._handles.items())
        # what each child last reported of its process and device
        m["processes"] = {
            name: h.service.device.as_dict() for name, h in handles
            if isinstance(h.service, ReplicaProxy)
        }
        return m


@dataclasses.dataclass
class _RemoteJobView:
    """The completion tap's view of a job that lives in another
    process — just the fields _on_replica_complete reads."""

    jid: str
    tenant: str = ""
    service_stopped: bool = False


# --------------------------------------------------------------------------
# child side
# --------------------------------------------------------------------------


class ReplicaWorker:
    """The replica child process body: a REAL :class:`SolveService` on
    ``device`` (own scheduler thread, journal, heartbeat, runner cache
    backed by the shared artifact store) driven by command frames from
    the head's hub.

    The main loop is the socket's single owner: completions produced
    on the scheduler thread queue into an outbox the loop drains, so
    the :class:`JournalClient` never crosses threads.  Importable and
    loop-drivable — protocol tests host it on a thread over a real
    socket without paying a process spawn."""

    def __init__(
        self,
        connect: Tuple[str, int],
        name: str,
        journal_dir: Optional[str] = None,
        heartbeat_path: Optional[str] = None,
        artifact_dir: Optional[str] = None,
        lanes: int = 4,
        max_cycles: int = 0,
        checkpoint_every: int = 4,
        max_buckets: Optional[int] = None,
        fault_plan: Optional[FaultPlan] = None,
        stats_interval: float = 0.25,
        memo: bool = False,
        device: DeviceLike = None,
    ):
        from pydcop_tpu_torch.device import resolve_device
        from pydcop_tpu_torch.serve.service import SolveService

        if max_cycles <= 0:
            from pydcop_tpu_torch.batch.engine import DEFAULT_MAX_CYCLES

            max_cycles = DEFAULT_MAX_CYCLES
        self.name = name
        # a missing GPU raises here, before anything is built
        self.device = resolve_device(device)
        store = (ArtifactStore(artifact_dir, device=self.device)
                 if artifact_dir else None)
        # the artifact store IS this process's cross-process runner
        # cache: a miss first rebuilds a peer's recipe
        self.cache = CompileCache(artifacts=store)
        memo_cache = None
        if memo:
            # persisted under THIS child's journal subdir (the shared
            # filesystem): peers adopt the npz by path on memo_adopt
            from pydcop_tpu_torch.serve.memo import (
                MEMO_SUBDIR,
                MemoCache,
                MemoConfig,
            )

            memo_cache = MemoCache(
                MemoConfig(),
                directory=(
                    os.path.join(journal_dir, MEMO_SUBDIR)
                    if journal_dir else None
                ),
                on_insert=self._queue_memo,
                device=self.device,
            )
        self.service = SolveService(
            lanes=lanes, cache=self.cache,
            counters=ServeCounters(replica=name),
            max_cycles=max_cycles, journal_dir=journal_dir,
            checkpoint_every=checkpoint_every,
            max_buckets=max_buckets, max_pending=None,
            tenant_quota=None, replica=name,
            heartbeat_path=heartbeat_path, fault_plan=fault_plan,
            on_complete=self._queue_complete, memo=memo_cache,
            device=self.device,
        )
        self.client = JournalClient(
            connect, name, on_record=self._on_command,
            max_retries=1,
        )
        self.stats_interval = float(stats_interval)
        self._outbox: deque = deque()
        self._outlock = threading.Lock()
        self._dcops: Dict[str, Any] = {}
        self._stop = False
        self._ppid = os.getppid()

    # -- completion tap (scheduler thread) -----------------------------------

    def _queue_complete(self, job, res: SolveResult) -> None:
        body = {
            "evt": "complete", "jid": job.jid, "tenant": job.tenant,
            "service_stopped": bool(
                getattr(job, "service_stopped", False)
            ),
            "result": {
                "status": res.status,
                "assignment": _json_safe(res.assignment or {}),
                "cost": _json_safe(res.cost),
                "violation": _json_safe(res.violation),
                "cycle": int(res.cycle),
                "msg_count": int(res.msg_count),
                "msg_size": float(res.msg_size),
                "time": float(res.time),
                "serve": _json_safe(res.serve or {}),
                "harness": _json_safe(res.harness),
                "config": _json_safe(res.config),
                "memo": _json_safe(res.memo),
            },
        }
        with self._outlock:
            self._outbox.append(body)

    def _queue_memo(self, entry) -> None:
        """Memo insert tap (scheduler thread): announce the persisted
        entry to the head so peers adopt it.  An unpersisted entry
        (no journal dir) has no shared-filesystem medium — skip."""
        if not entry.path:
            return
        with self._outlock:
            self._outbox.append({
                "evt": "memo", "key": entry.key,
                "tenant": entry.tenant, "algo": entry.algo,
                "path": entry.path,
            })

    # -- command dispatch (main loop) ----------------------------------------

    def _dcop(self, source_file: str):
        dcop = self._dcops.get(source_file)
        if dcop is None:
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

            dcop = load_dcop_from_file([source_file])
            self._dcops[source_file] = dcop
        return dcop

    def _on_command(self, body: Dict[str, Any]) -> None:
        cmd = body.get("cmd")
        if cmd == "submit":
            self._do_submit(body)
        elif cmd == "prewarm_targets":
            items = [
                (algo, dict(params or {}), _dims_from_wire(dims))
                for algo, params, dims in body.get("entries") or []
            ]
            self.service.prewarm_targets(items, block=True)
            self._send_warm()
        elif cmd == "prewarm":
            items = []
            for path, algo, params in body.get("items") or []:
                try:
                    items.append(
                        (self._dcop(path), algo, dict(params or {}))
                    )
                except Exception:
                    pass  # prewarm is an optimization, never fatal
            if items:
                self.service.prewarm(items, block=True)
                self._send_warm()
        elif cmd == "stall":
            self.service.stall_for(float(body.get("duration", 0.0)))
        elif cmd == "pressure":
            self.service.set_deadline_pressure(
                float(body.get("factor", 1.0)),
                exempt_priority=body.get("exempt_priority"),
            )
        elif cmd == "memo_adopt":
            path = body.get("path")
            if path and self.service.memo is not None:
                # CRC-checked load: a corrupt entry is skipped-and-
                # counted inside adopt_file, never served
                self.service.memo.adopt_file(path)
        elif cmd == "stats":
            self._send_stats()
        elif cmd == "stop":
            self._stop = True

    def _do_submit(self, body: Dict[str, Any]) -> None:
        jid = body.get("jid")
        try:
            dcop = self._dcop(body["source_file"])
            restore = None
            if body.get("restore"):
                from pydcop_tpu_torch.runtime.checkpoint import (
                    read_state_npz,
                )

                meta, arrays = read_state_npz(body["restore"])
                restore = (meta, arrays)
            self.service.submit(
                dcop, body["algo"],
                algo_params=dict(body.get("algo_params") or {}),
                seed=int(body.get("seed", 0)),
                tenant=body.get("tenant", "default"),
                priority=int(body.get("priority", 0)),
                deadline_s=body.get("deadline_s"),
                label=body.get("label"),
                source_file=body["source_file"],
                stream=bool(body.get("stream", False)),
                _jid=jid, _restore=restore,
            )
        except Exception as e:
            with self._outlock:
                self._outbox.append({
                    "evt": "reject", "jid": jid, "error": str(e),
                })

    # -- outbound ------------------------------------------------------------

    def _flush_outbox(self) -> None:
        while True:
            with self._outlock:
                if not self._outbox:
                    return
                body = self._outbox.popleft()
            self.client.send(body)

    def _device_stats(self) -> Dict[str, Any]:
        """This process's ``nvcc`` runs and kernel launches so far and,
        on the card, its CUDA memory: the context's reserve and the
        card's free / total bytes."""
        from pydcop_tpu_torch.ops import cuda_build, read_launch_counters

        out: Dict[str, Any] = {
            "pid": os.getpid(),
            "nvcc_runs": len(cuda_build.build_logs),
            "launches": read_launch_counters(),
        }
        if self.device.type == "cuda":
            import torch

            free, total = torch.cuda.mem_get_info(self.device)
            out.update(memory_reserved=torch.cuda.memory_reserved(
                self.device), mem_free=free, mem_total=total)
        return out

    def _send_stats(self) -> None:
        cache = self.cache
        self.client.send({
            "evt": "stats",
            "serve": _json_safe(self.service.counters.as_dict()),
            "cache": _json_safe({**cache.stats(), **cache.pool_stats()}),
            "cache_keys": cache.key_strings(),
            "backlog": self.service._backlog,
            "device": _json_safe(self._device_stats()),
        })

    def _send_warm(self) -> None:
        self.client.send({
            "evt": "warm", "keys": self.cache.key_strings(),
        })

    # -- main loop -----------------------------------------------------------

    def run(self) -> int:
        self.service.start()
        self.client.send({
            "evt": "ready", "pid": os.getpid(),
            "abi": abi_tag(self.device),
        })
        last_stats = 0.0
        try:
            while not self._stop:
                self.client.pump(0.05)
                self._flush_outbox()
                now = monotonic()
                if now - last_stats >= self.stats_interval:
                    self._send_stats()
                    last_stats = now
                if os.getppid() != self._ppid:
                    break  # orphaned: the head died, exit cleanly
        finally:
            self._flush_outbox()
            try:
                self.service.stop(drain=False)
            except Exception:
                pass
            self.client.close()
        return 0
