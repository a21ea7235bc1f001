"""The port's process fleet (``pydcop_tpu_torch/serve/procfleet.py``) on
the CPU, after the JAX package's ``tests/unit/test_procfleet.py``, case
for case.  Three layers, cheapest first:

* pure helpers — JSON-safe wire conversion, dims round-trip, the
  exit-code taxonomy on stub processes (no spawn, no socket);
* a thread-hosted :class:`ReplicaWorker` over a real hub socket — the
  child protocol (ready / submit→complete / reject / stats / stop)
  without paying a process spawn;
* two tests that spawn children: the end-to-end one (``kill -9`` of a
  whole replica process mid-flight → every job completes on the
  survivor bit-identically with a finite RTO, the watchdog relaunches
  the slot, and a cold-joined replica prewarms from the shared artifact
  store with ``misses == 0``, all on ``--device cpu``), and one that
  children without ``--device`` on a machine with no GPU exit
  permanently and the fleet raises, while ``serve --processes --device
  cpu`` runs.

Every wait has its own deadline; every fleet is stopped in ``finally``.
"""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from pydcop_tpu_torch import cli
from pydcop_tpu_torch.batch.bucketing import InstanceDims
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import DeviceUnavailableError
from pydcop_tpu_torch.runtime.faults import KILL_EXIT_CODE, Fault, FaultPlan
from pydcop_tpu_torch.serve.procfleet import (
    NO_DEVICE_EXIT_CODE,
    ProcessFleet,
    ProcessReplicaHandle,
    ReplicaWorker,
    _dims_from_wire,
    _dims_to_wire,
    _json_safe,
)
from pydcop_tpu_torch.serve.wire import JournalHub

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
CSP = os.path.join(ROOT, "tests", "instances", "coloring_csp.yaml")
LIMIT = 63


def _standalone(dcop, algo, seed, params=None, limit=LIMIT):
    spec = adapter_for(algo).build_spec(
        BatchItem(dcop, algo, algo_params=params, seed=seed))
    return spec.solver.run(max_cycles=limit)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# --------------------------------------------------------------------------
# helpers + taxonomy (no spawn, no socket)
# --------------------------------------------------------------------------


class TestWireHelpers:
    def test_json_safe_strips_numpy(self):
        out = _json_safe({
            "i": np.int64(7), "f": np.float64(1.5),
            "nest": [np.int32(1), (np.float32(2.0),)],
        })
        assert out == {"i": 7, "f": 1.5, "nest": [1, [2.0]]}
        assert type(out["i"]) is int
        assert type(out["f"]) is float

    def test_dims_roundtrip(self):
        d = InstanceDims(graph_type="constraints_hypergraph", D=3,
                         arities=(2, 3), V=5, F=(4, 2), M=6)
        assert _dims_from_wire(_dims_to_wire(d)) == d


class _StubProc:
    """Just enough Popen surface for the taxonomy properties."""

    def __init__(self, rc):
        self._rc = rc
        self.pid = 12345

    def poll(self):
        return self._rc

    def kill(self):
        self._rc = -signal.SIGKILL


def _handle(rc):
    return ProcessReplicaHandle(
        name="replica-0", index=0, service=None,
        journal_dir="", hb_path="", proc=_StubProc(rc),
    )


class TestExitTaxonomy:
    def test_signal_death_is_retryable(self):
        h = _handle(-signal.SIGKILL)
        assert h.dead and h.retryable
        assert "signal 9" in h.down_reason

    def test_injected_kill_exit_code_is_retryable(self):
        h = _handle(KILL_EXIT_CODE)
        assert h.dead and h.retryable
        assert "injected kill" in h.down_reason

    def test_clean_exit_is_not_retryable(self):
        h = _handle(0)
        assert h.dead and not h.retryable
        assert h.down_reason == "process exited"

    def test_config_failure_is_not_retryable(self):
        h = _handle(2)
        assert h.dead and not h.retryable
        assert "rc=2" in h.down_reason

    def test_missing_device_is_not_retryable(self):
        h = _handle(NO_DEVICE_EXIT_CODE)
        assert h.dead and not h.retryable
        assert "no device" in h.down_reason

    def test_live_process_is_not_dead(self):
        h = _handle(None)
        assert not h.dead
        h.kill()
        assert h.dead and h.retryable

    def test_process_fault_kinds_registered(self):
        for kind in ("kill_process", "partition_socket",
                     "corrupt_artifact"):
            assert kind in ProcessFleet._INJECT_KINDS
        plan = FaultPlan(faults=[
            Fault(kind="kill_process", replica=0, cycle=1),
            Fault(kind="partition_socket", replica=1, cycle=2,
                  duration=1.0),
            Fault(kind="corrupt_artifact", cycle=3),
        ])
        assert len(plan.process_faults()) == 3
        assert plan.fleet_faults() == []


# --------------------------------------------------------------------------
# thread-hosted ReplicaWorker over a real socket
# --------------------------------------------------------------------------


class _WorkerHost:
    def __init__(self, tmp, **kw):
        self.records = []
        self.hub = JournalHub(on_record=self._tap)
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop,
                                      daemon=True)
        self._pump.start()
        kw.setdefault("lanes", 2)
        kw.setdefault("max_cycles", LIMIT)
        kw.setdefault("stats_interval", 0.1)
        kw.setdefault("device", "cpu")
        self.worker = ReplicaWorker(
            ("127.0.0.1", self.hub.port), "w0",
            journal_dir=os.path.join(str(tmp), "w0"),
            heartbeat_path=os.path.join(str(tmp), "w0.hb"),
            **kw,
        )
        self._wt = threading.Thread(target=self.worker.run,
                                    daemon=True)
        self._wt.start()

    def _tap(self, client, body):
        self.records.append((client, body))

    def _pump_loop(self):
        while not self._stop.is_set():
            self.hub.pump(0.01)

    def events(self, evt):
        return [b for _c, b in list(self.records) if b.get("evt") == evt]

    def close(self):
        self.hub.send("w0", {"cmd": "stop"})
        self._wt.join(timeout=15)
        self._stop.set()
        self._pump.join(timeout=5)
        self.hub.stop()
        assert not self._wt.is_alive() and not self._pump.is_alive()


@pytest.fixture
def host(tmp_path):
    h = _WorkerHost(tmp_path)
    yield h
    h.close()


def _submit_body(jid, seed=0, source_file=TUTO, algo="dsa"):
    return {
        "cmd": "submit", "jid": jid, "algo": algo,
        "algo_params": {}, "seed": seed, "tenant": "default",
        "priority": 0, "deadline_s": None, "label": None,
        "source_file": source_file, "stream": False, "restore": None,
    }


class TestReplicaWorkerProtocol:
    def test_ready_then_complete_bit_identical(self, host):
        assert _wait(lambda: host.events("ready"))
        ready = host.events("ready")[0]
        assert ready["pid"] == os.getpid()  # thread-hosted
        assert set(ready["abi"]) == {"torch", "cuda", "device",
                                     "capability", "kernels"}
        assert ready["abi"]["device"] == "cpu"

        host.hub.send("w0", _submit_body("job-000001", seed=3))
        assert _wait(lambda: host.events("complete"), timeout=60)
        done = host.events("complete")[0]
        assert done["jid"] == "job-000001"
        exp = _standalone(load_dcop_from_file(TUTO), "dsa", 3)
        got = done["result"]
        assert got["status"] == exp.status
        assert got["assignment"] == exp.assignment
        assert got["cost"] == exp.cost
        assert got["cycle"] == exp.cycle
        assert got["serve"]["replica"] == "w0"

    def test_bad_source_file_rejects_structuredly(self, host):
        assert _wait(lambda: host.events("ready"))
        host.hub.send(
            "w0", _submit_body("job-000002",
                               source_file="/nonexistent/x.yaml")
        )
        assert _wait(lambda: host.events("reject"))
        rej = host.events("reject")[0]
        assert rej["jid"] == "job-000002"
        assert rej["error"]

    def test_heartbeat_beats_and_stats_stream(self, host, tmp_path):
        assert _wait(lambda: host.events("ready"))
        hb = os.path.join(str(tmp_path), "w0.hb")
        assert _wait(lambda: os.path.exists(hb))
        assert _wait(lambda: len(host.events("stats")) >= 2)
        st = host.events("stats")[-1]
        assert "serve" in st and "cache" in st
        # the child's process and device report: no nvcc run here, the
        # launch counters by name
        assert st["device"]["nvcc_runs"] == 0
        assert st["device"]["launches"]["mgm2"] == 0

    def test_stop_command_ends_run_loop(self, host):
        assert _wait(lambda: host.events("ready"))
        host.hub.send("w0", {"cmd": "stop"})
        assert _wait(lambda: not host._wt.is_alive(), timeout=15)


# --------------------------------------------------------------------------
# the real thing: child OS processes
# --------------------------------------------------------------------------


def _drain(fleet, max_ticks=6000):
    for i in range(max_ticks):
        if not fleet.tick():
            return i
        time.sleep(0.01)
    raise AssertionError("fleet did not drain")


class TestProcessFleetEndToEnd:
    def test_kill9_reseat_relaunch_and_warm_cold_join(self, tmp_path):
        """One fleet bring-up on --device cpu:

        1. kill -9 of a WHOLE replica process with 4 jobs in flight →
           every job completes bit-identically on the survivor, the RTO
           is recorded finite, the watchdog relaunches the slot;
        2. a cold-joined replica prewarms purely from the shared
           artifact store: ``misses == 0`` and ``artifact_hits ==
           entries``, no nvcc run — and its first job equals its
           standalone solve.
        """
        dcop = load_dcop_from_file(TUTO)
        base = {s: _standalone(dcop, "dsa", s) for s in range(4)}

        fleet = ProcessFleet(
            replicas=2, lanes=4, max_cycles=LIMIT,
            journal_dir=str(tmp_path), backoff_base=0.1, device="cpu",
        )
        try:
            assert fleet.wait_ready(timeout=120), "replicas not ready"

            jids = [
                fleet.submit(dcop, "dsa", seed=s, source_file=TUTO)
                for s in range(4)
            ]
            fleet.tick()
            h0 = fleet.handle(0)
            os.kill(h0.proc.pid, signal.SIGKILL)
            _drain(fleet)

            for s, jid in enumerate(jids):
                res = fleet.result(jid, timeout=30)
                assert res.status == base[s].status
                assert res.assignment == base[s].assignment, \
                    f"seed {s} not bit-identical after kill -9"
                assert res.cost == base[s].cost
                assert res.cycle == base[s].cycle

            m = fleet.metrics()
            fl = m["fleet"]
            assert fl["replicas_down"] >= 1, fl
            assert fl["jobs_reseated"] >= 1, fl
            assert m["recoveries"], "no RTO record for the kill"
            rto = m["recoveries"][-1]["rto_s"]
            assert rto is not None and 0 <= rto < 300
            records, torn = fleet.journal.load()
            assert torn == 0
            assert [r["kind"] for r in records].count("done") == 4

            # the SIGKILL is retryable: the slot relaunches under a
            # fresh incarnation name and comes back ready
            assert _wait(
                lambda: (fleet.tick() or True)
                and fleet.metrics()["fleet"]["replicas_relaunched"]
                >= 1,
                timeout=60,
            ), fleet.metrics()["fleet"]
            assert fleet.wait_ready(timeout=120)

            # cold join: warm purely from the shared artifact store
            name = fleet.add_replica()
            assert fleet.wait_ready(timeout=120)
            hc = fleet.handle(name)
            hc.service.prewarm([(TUTO, "dsa", {})])
            assert _wait(
                lambda: (fleet.tick() or True)
                and hc.service.cache.stats().get("entries", 0) > 0,
                timeout=90,
            ), hc.service.cache.stats()
            stats = hc.service.cache.stats()
            assert stats["misses"] == 0, stats        # no cold build
            assert stats["artifact_hits"] == stats["entries"], stats
            assert _wait(lambda: (fleet.tick() or True) and name in
                         fleet.metrics()["processes"], timeout=30)
            assert fleet.metrics()["processes"][name]["nvcc_runs"] == 0

            for n in fleet.router.routable():
                if n != name:
                    fleet.router.set_partitioned(n, True)
            jid = fleet.submit(dcop, "dsa", seed=9, source_file=TUTO)
            _drain(fleet)
            exp = _standalone(dcop, "dsa", 9)
            res = fleet.result(jid, timeout=30)
            assert res.metrics()["serve"]["replica"] == name
            assert res.assignment == exp.assignment
            assert res.cost == exp.cost
        finally:
            fleet.stop(drain=False)
        assert all(h.proc.poll() is not None
                   for h in fleet._handles.values())


def test_children_run_only_on_the_device_asked_for(tmp_path, capsys):
    """No --device: the children run on cuda — on this GPU-less machine
    each exits with the permanent NO_DEVICE_EXIT_CODE, nothing is
    relaunched, and the fleet raises.  With --device cpu the serve
    command's process fleet runs, every job equal to its standalone
    solve."""
    if not torch.cuda.is_available():
        fleet = ProcessFleet(replicas=2, lanes=2,
                             journal_dir=str(tmp_path / "nodev"),
                             backoff_base=0.05)
        try:
            with pytest.raises(DeviceUnavailableError, match="cuda"):
                fleet.wait_ready(timeout=120)
            assert _wait(lambda: all(
                h.proc.poll() is not None
                for h in fleet._handles.values()), timeout=30)
            for _ in range(5):
                fleet.tick()
            assert all(h.returncode == NO_DEVICE_EXIT_CODE
                       and not h.retryable
                       for h in fleet._handles.values())
            m = fleet.metrics()
            assert m["fleet"]["replicas_relaunched"] == 0
            assert m["pending_relaunches"] == 0
        finally:
            fleet.stop(drain=False)

    rc = cli.main(["serve", "-a", "mgm", TUTO, CSP, "--jobs", "4",
                   "--lanes", "2", "--max-cycles", str(LIMIT),
                   "--processes", "--replicas", "2", "--prewarm",
                   "--journal-dir", str(tmp_path / "cpu"),
                   "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["status"] == "FINISHED", out
    assert "fleet" in out and "serve" not in out
    assert out["fleet"]["fleet"]["jobs_routed"] == 4
    for jid, m in out["results"].items():
        fn, i = m["label"].rsplit(":", 1)
        want = _standalone(load_dcop_from_file(fn), "mgm", int(i))
        assert (m["assignment"], m["cost"], m["cycle"]) == \
            (want.assignment, want.cost, want.cycle), jid
        assert m["serve"]["replica"].startswith("replica-")
