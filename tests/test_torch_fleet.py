"""The port's replicated solve fleet (``pydcop_tpu_torch/serve/fleet.py``)
and the fleet hooks of its ``SolveService`` on the CPU, after the JAX
package's ``tests/unit/test_fleet.py`` (its router cases are in
``tests/test_torch_router.py``), case for case, held to the port's own
standalone solves (the stochastic algorithms' stream is the port's) and
to the JAX package's ``SolveFleet`` where the stream is the same (maxsum
at noise 0):

* **failover re-seating**: with ``kill_replica`` injected mid-trace,
  every in-flight job of the dead replica completes on a peer
  bit-identical to its unfailed standalone solve, the RTO lands finite,
  and the re-seat admissions pay ZERO new cache misses;
* **stall != death**, partitions, the journal handoff edges, provenance,
  fleet admission control, the resume prewarm, the ``fleet.*`` events
  and counters, as in the JAX package;
* maxsum at noise 0 through ``SolveFleet(replicas=2, device="cpu")``
  equals the JAX package's ``SolveFleet`` job for job, with and without a
  ``kill_replica`` mid-trace; the memo's fleet sharing (JAX
  ``tests/unit/test_memo.py::TestFleetSharing``); the refused JAX-only
  options; the cuda default.

Tests drive :meth:`SolveFleet.tick` synchronously (no threads).
"""
import json
import os

import numpy as np
import pytest
import torch

from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.runtime.faults import Fault as JaxFault
from pydcop_tpu.runtime.faults import FaultPlan as JaxFaultPlan
from pydcop_tpu.serve import SolveFleet as JaxSolveFleet
from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import DeviceUnavailableError, NotPortedError
from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan
from pydcop_tpu_torch.serve import (
    FleetJournal,
    ServiceOverloaded,
    ServiceStopped,
    SolveFleet,
    SolveService,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid"]

#: cycle ceiling: a multiple of the harness chunk (7), like the
#: single-service tests
LIMIT = 63


def _load(path=TUTO):
    return load_dcop_from_file(path)


def _fleet(**kw):
    kw.setdefault("max_cycles", LIMIT)
    kw.setdefault("device", "cpu")
    return SolveFleet(**kw)


def _standalone(dcop, algo, seed, params=None):
    spec = adapter_for(algo).build_spec(
        BatchItem(dcop, algo, algo_params=params, seed=seed))
    return spec.solver.run(max_cycles=LIMIT)


def _drain(fleet, max_ticks=400):
    for _ in range(max_ticks):
        if not fleet.tick():
            return
    raise AssertionError("fleet did not drain")


class TestFleetEndToEnd:
    def test_jobs_complete_bit_identical_with_provenance(self):
        """Two replicas, four jobs: every result equals its standalone
        solve exactly, and metrics()['serve'] names the replica + JID
        that served it."""
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=2)
        jids = [fleet.submit(dcop, "mgm", seed=s) for s in range(4)]
        _drain(fleet)
        for s, jid in enumerate(jids):
            res = fleet.result(jid, timeout=1)
            seq = _standalone(dcop, "mgm", s)
            assert res.assignment == seq.assignment
            assert res.cycle == seq.cycle
            assert res.cost == seq.cost
            serve = res.metrics()["serve"]
            assert serve["jid"] == jid
            assert serve["replica"] in ("replica-0", "replica-1")
            assert serve["reseats"] == 0
        m = fleet.metrics()
        assert m["fleet"]["jobs_routed"] == 4
        # the replica label rides each replica's counters summary too
        assert (m["replicas"]["replica-0"]["serve"]["replica"]
                == "replica-0")

    def test_standalone_service_metrics_carry_replica_field(self):
        """The ServeCounters summary always has the replica field —
        None for a standalone service, the name for a fleet replica."""
        dcop = _load()
        svc = SolveService(lanes=1, cache=CompileCache(),
                           max_cycles=LIMIT, device="cpu")
        jid = svc.submit(dcop, "mgm", seed=0)
        for _ in range(80):
            if not svc.tick():
                break
        res = svc.result(jid, timeout=1)
        assert svc.metrics()["serve"]["replica"] is None
        assert res.metrics()["serve"]["replica"] is None
        assert res.metrics()["serve"]["jid"] == jid

    def test_same_family_co_locates(self):
        """Same-signature traffic lands on the replica that is already
        warm for it — all four jobs on one replica, three of the four
        placements warm."""
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=4)
        for s in range(4):
            fleet.submit(dcop, "mgm", seed=s)
        _drain(fleet)
        m = fleet.metrics()
        assert m["fleet"]["jobs_routed_warm"] == 3
        loads = [r["serve"]["jobs_admitted"]
                 for r in m["replicas"].values()]
        assert sorted(loads) == [0, 4]

    def test_prewarm_distributes_families(self):
        """Fleet prewarm assigns each routing-key group to a replica
        round-robin; arrivals then route onto their warm replica."""
        col = _load()  # binary constraints
        tri = _load(os.path.join(INSTANCES, "coloring_intention.yaml"))
        fleet = _fleet(replicas=2, lanes=2)
        spread = fleet.prewarm([(col, "mgm"), (tri, "dsa")], block=True)
        assert sum(spread.values()) == 2  # two families prewarmed
        a = fleet.submit(col, "mgm", seed=0)
        b = fleet.submit(tri, "dsa", seed=0)
        _drain(fleet)
        assert fleet.metrics()["fleet"]["jobs_routed_warm"] == 2
        ra, rb = fleet.result(a, timeout=1), fleet.result(b, timeout=1)
        assert (ra.metrics()["serve"]["replica"]
                != rb.metrics()["serve"]["replica"])


class TestFailover:
    def _run_kill(self, tmp_path, algo="dsa", jobs=4, kill_tick=3):
        dcop = _load()
        jd = str(tmp_path / "fleet")
        plan = FaultPlan(faults=[Fault(
            kind="kill_replica", replica=0, cycle=kill_tick,
        )])
        fleet = _fleet(replicas=2, lanes=2, journal_dir=jd,
                       checkpoint_every=1, fault_plan=plan)
        jids = [fleet.submit(dcop, algo, seed=s) for s in range(jobs)]
        _drain(fleet)
        return dcop, fleet, jids

    def test_kill_replica_reseats_bit_identical(self, tmp_path):
        """Kill one of two replicas while its lanes hold checkpointed
        mid-flight jobs; every job completes on the peer, bit-identical
        to an unfailed standalone run, with a finite recovery-time
        objective and checkpoint re-seats actually used."""
        dcop, fleet, jids = self._run_kill(tmp_path)
        m = fleet.metrics()
        assert m["fleet"]["replicas_down"] == 1
        assert m["fleet"]["faults_injected"] == 1
        assert m["fleet"]["jobs_reseated"] >= 1
        assert m["fleet"]["reseat_checkpoint_hits"] >= 1
        assert m["fleet"]["recoveries_completed"] == 1
        [rec] = m["recoveries"]
        assert rec["rto_s"] is not None and rec["rto_s"] > 0
        assert rec["pending"] == []
        reseated = 0
        for s, jid in enumerate(jids):
            res = fleet.result(jid, timeout=1)
            seq = _standalone(dcop, "dsa", s)
            assert res.status == "FINISHED"
            assert res.assignment == seq.assignment, (jid, s)
            assert res.cycle == seq.cycle, (jid, s)
            assert res.cost == seq.cost, (jid, s)
            serve = res.metrics()["serve"]
            assert serve["replica"] == "replica-1"
            reseated += serve["reseats"]
        assert reseated == m["fleet"]["jobs_reseated"]

    def test_reseat_admission_pays_zero_new_cache_misses(self, tmp_path):
        """The peer prewarms the exact re-seat signature BEFORE the
        orphaned jobs are re-submitted, so every runner-cache miss on
        the peer happened at prewarm time.  Two jobs: both co-locate on
        replica-0, so the peer's cache is UNTOUCHED until the re-seat."""
        _dcop, fleet, _jids = self._run_kill(tmp_path, jobs=2)
        peer = fleet.metrics()["replicas"]["replica-1"]["cache"]
        assert peer["misses"] >= 1
        assert peer["misses"] == peer["prewarmed"]
        assert peer["hits"] >= 1

    def test_fleet_journal_streams_the_handoff(self, tmp_path):
        """The fleet journal records placement, replica lifecycle,
        re-seat and completion for every job — with the JAX package's
        record kinds and fields, and exactly ONE done record per jid."""
        _dcop, fleet, jids = self._run_kill(tmp_path)
        records, torn = fleet.journal.load()
        assert torn == 0
        kinds = [r["kind"] for r in records]
        assert kinds.count("job") == len(jids)
        assert "reseat" in kinds
        fields = {
            "job": {"kind", "jid", "replica", "file", "algo",
                    "algo_params", "seed", "tenant", "priority", "label"},
            "done": {"kind", "jid", "replica", "status"},
            "reseat": {"kind", "jid", "from", "to", "checkpoint"},
        }
        for r in records:
            if r["kind"] in fields:
                assert set(r) == fields[r["kind"]], r
        downs = [r for r in records if r["kind"] == "replica"
                 and r["event"] == "down"]
        assert [d["name"] for d in downs] == ["replica-0"]
        for jid in jids:
            dones = [r for r in records
                     if r["kind"] == "done" and r["jid"] == jid]
            assert len(dones) == 1, jid
            assert dones[0]["replica"] == "replica-1"

    def test_kill_between_checkpoint_and_jid_line_reruns_once(
        self, tmp_path
    ):
        """A kill landing AFTER a lane checkpointed but BEFORE its JID:
        completion line re-runs the job (from the checkpoint) and
        completes it exactly once."""
        dcop = _load()
        jd = str(tmp_path / "fleet")
        fleet = _fleet(replicas=2, lanes=1, journal_dir=jd,
                       checkpoint_every=1)
        jid = fleet.submit(dcop, "dsa", seed=0)
        fleet.tick()
        fleet.tick()  # checkpointed at two chunk boundaries, not done
        h0 = fleet.handle(0)
        assert os.path.exists(h0.checkpoint_path(jid))
        assert jid not in h0.done_jids()  # no JID: line yet
        assert not fleet._jobs[jid].done.is_set()
        h0.kill()
        _drain(fleet)
        res = fleet.result(jid, timeout=1)
        seq = _standalone(dcop, "dsa", 0)
        assert res.assignment == seq.assignment
        assert res.cycle == seq.cycle
        m = fleet.metrics()
        assert m["fleet"]["jobs_reseated"] == 1
        assert m["fleet"]["reseat_checkpoint_hits"] == 1
        records, _ = fleet.journal.load()
        dones = [r for r in records if r["kind"] == "done"]
        assert len(dones) == 1 and dones[0]["jid"] == jid

    def test_job_done_on_disk_is_never_rerun(self, tmp_path):
        """A job whose JID: line reached the dead replica's disk is
        DONE — the re-seat pass skips it even though the replica
        died."""
        dcop = _load()
        jd = str(tmp_path / "fleet")
        fleet = _fleet(replicas=2, lanes=1, journal_dir=jd,
                       checkpoint_every=1)
        a = fleet.submit(dcop, "mgm", seed=0)
        _drain(fleet)  # a completes on replica-0, JID line on disk
        h0 = fleet.handle(0)
        assert a in h0.done_jids()
        b = fleet.submit(dcop, "mgm", seed=1)
        fleet.tick()  # b mid-flight on the warm replica-0
        h0.kill()
        _drain(fleet)
        m = fleet.metrics()
        assert m["fleet"]["jobs_reseated"] == 1  # only b
        assert fleet.result(b, timeout=1).status == "FINISHED"
        records, _ = fleet.journal.load()
        assert len([r for r in records if r["kind"] == "done"
                    and r["jid"] == a]) == 1

    def test_mid_compaction_kill_leaves_harmless_stale_lines(
        self, tmp_path
    ):
        """A replica killed between compaction's two atomic renames
        leaves stale JID: lines; the fleet re-seat re-runs exactly the
        truly unfinished jobs and ignores the stale completions."""
        dcop = _load()
        jd = str(tmp_path / "fleet")
        fleet = _fleet(replicas=2, lanes=1, journal_dir=jd,
                       checkpoint_every=1)
        a = fleet.submit(dcop, "mgm", seed=0)
        _drain(fleet)
        assert fleet.result(a, timeout=1).status == "FINISHED"
        h0 = fleet.handle(0)
        h0.service.compact_journal()
        with open(os.path.join(h0.journal_dir, "progress_serve"),
                  "a", encoding="utf-8") as f:
            f.write(f"JID: {a}\n")  # the stale completion line
        b = fleet.submit(dcop, "dsa", seed=1)
        fleet.tick()
        fleet.tick()
        h0.kill()
        _drain(fleet)
        res = fleet.result(b, timeout=1)
        seq = _standalone(dcop, "dsa", 1)
        assert res.assignment == seq.assignment
        assert res.cycle == seq.cycle
        assert fleet.metrics()["fleet"]["jobs_reseated"] == 1

    def test_scheduler_death_reseats_instead_of_erroring(self):
        """A replica whose SCHEDULER dies is a replica loss, not a job
        failure: the supervisor re-seats the jobs on a peer, which
        completes them bit-identically."""
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=1)
        jid = fleet.submit(dcop, "mgm", seed=0)
        fleet.tick()  # mid-flight on replica-0
        h0 = fleet.handle(0)
        h0.service._scheduler_died(RuntimeError("tick kept throwing"))
        _drain(fleet)
        res = fleet.result(jid, timeout=1)
        seq = _standalone(dcop, "mgm", 0)
        assert res.status == "FINISHED"
        assert res.assignment == seq.assignment
        assert res.cycle == seq.cycle
        m = fleet.metrics()
        assert m["fleet"]["replicas_down"] == 1
        assert m["fleet"]["jobs_reseated"] == 1

    def test_all_replicas_down_fails_loudly(self):
        """Losing every replica ends the job in a terminal structured
        ERROR; NEW submissions are refused loudly."""
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=1)
        jid = fleet.submit(dcop, "mgm", seed=0)
        fleet.handle(0).kill()
        fleet.handle(1).kill()
        for _ in range(10):
            fleet.tick()
        res = fleet.result(jid, timeout=1)
        assert res.status == "ERROR"
        assert res.metrics()["serve"]["error"]  # names the cause
        with pytest.raises(ServiceStopped):
            fleet.submit(dcop, "mgm", seed=1)


class TestStallAndPartition:
    def test_stale_heartbeat_routes_around_then_heals(self, tmp_path):
        """Stall != death: a stale heartbeat makes the replica
        unroutable (nothing re-seats); a fresh heartbeat heals it."""
        import time as _time

        dcop = _load()
        fleet = _fleet(replicas=2, lanes=2, heartbeat_timeout=1.0)
        # heartbeats only arm in threaded mode; fake it tick-driven
        fleet._started = True
        h0 = fleet.handle(0)
        h1 = fleet.handle(1)
        for h in (h0, h1):
            h.hb_path = str(tmp_path / f"{h.name}.hb")
            with open(h.hb_path, "w"):
                pass
        old = _time.time() - 60
        os.utime(h0.hb_path, (old, old))  # h0 wedged
        fleet._supervise()
        assert h0.stalled
        assert fleet.router.routable() == ["replica-1"]
        assert fleet.metrics()["fleet"]["replicas_stalled"] == 1
        assert fleet.metrics()["fleet"]["jobs_reseated"] == 0
        jid = fleet.submit(dcop, "mgm", seed=0)
        os.utime(h0.hb_path, None)  # h0 recovers
        fleet._supervise()
        assert not h0.stalled
        assert fleet.metrics()["fleet"]["replicas_healed"] == 1
        _drain(fleet)
        res = fleet.result(jid, timeout=1)
        assert res.metrics()["serve"]["replica"] == "replica-1"

    def test_partition_bars_new_placements_until_heal(self):
        """partition_replica: no NEW jobs while partitioned, in-flight
        work keeps running; the partition heals after its duration."""
        dcop = _load()
        plan = FaultPlan(faults=[Fault(
            kind="partition_replica", replica=0, cycle=2,
            duration=1e-6,  # heals on the next supervisor pass
        )])
        fleet = _fleet(replicas=2, lanes=2, fault_plan=plan)
        a = fleet.submit(dcop, "mgm", seed=0)  # lands on replica-0
        fleet.tick()  # tick 1: a admitted on replica-0
        fleet.tick()  # tick 2: partition fires
        assert fleet.router.routable() == ["replica-1"]
        b = fleet.submit(dcop, "mgm", seed=1)  # must avoid replica-0
        _drain(fleet)
        m = fleet.metrics()
        assert m["fleet"]["replicas_partitioned"] == 1
        assert m["fleet"]["replicas_healed"] == 1
        ra, rb = fleet.result(a, timeout=1), fleet.result(b, timeout=1)
        assert ra.metrics()["serve"]["replica"] == "replica-0"
        assert rb.metrics()["serve"]["replica"] == "replica-1"
        seq = _standalone(dcop, "mgm", 0)
        assert ra.assignment == seq.assignment

    def test_stall_replica_fault_wedges_one_tick(self):
        """stall_replica wires through the injector: the target
        replica's next tick sleeps ``duration``; jobs still complete
        correctly afterwards."""
        from time import monotonic

        dcop = _load()
        plan = FaultPlan(faults=[Fault(
            kind="stall_replica", replica=0, cycle=2, duration=0.05,
        )])
        fleet = _fleet(replicas=2, lanes=2, fault_plan=plan)
        jid = fleet.submit(dcop, "mgm", seed=0)
        t0 = monotonic()
        _drain(fleet)
        assert monotonic() - t0 >= 0.05  # the wedge really happened
        assert fleet.metrics()["fleet"]["faults_injected"] == 1
        seq = _standalone(dcop, "mgm", 0)
        res = fleet.result(jid, timeout=1)
        assert res.assignment == seq.assignment
        assert res.cycle == seq.cycle

    def test_kill_device_reduces_capacity_then_kills(self):
        """A kill_device fault with a replica advertises its remaining
        device fraction; losing the last device is a death."""
        dcop = _load()
        plan = FaultPlan(faults=[
            Fault(kind="kill_device", replica=0, device=0, cycle=1),
            Fault(kind="kill_device", replica=0, device=1, cycle=2),
        ])
        fleet = _fleet(replicas=2, lanes=2, fault_plan=plan,
                       devices_per_replica=2)
        jid = fleet.submit(dcop, "mgm", seed=0)
        fleet.tick()
        assert fleet.router.capacity("replica-0") == 0.5
        _drain(fleet)
        m = fleet.metrics()["fleet"]
        assert m["devices_lost"] == 2 and m["capacity_reduced"] == 1
        assert m["replicas_down"] == 1
        res = fleet.result(jid, timeout=1)
        assert res.assignment == _standalone(dcop, "mgm", 0).assignment


class TestFleetAdmission:
    def test_aggregate_pending_bound(self):
        """max_pending aggregates across routable replicas into ONE
        fleet bound; a submit past it sheds with a structured
        retry-after-carrying overload error."""
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=1, max_pending=1)
        fleet.submit(dcop, "mgm", seed=0)
        fleet.submit(dcop, "mgm", seed=1)
        with pytest.raises(ServiceOverloaded) as ei:
            fleet.submit(dcop, "mgm", seed=2)
        assert ei.value.retry_after > 0
        assert fleet.metrics()["fleet"]["jobs_shed"] == 1
        _drain(fleet)

    def test_bound_shrinks_when_a_replica_dies(self):
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=1, max_pending=1)
        fleet.handle(1).kill()
        fleet.tick()  # supervisor notices the death
        fleet.submit(dcop, "mgm", seed=0)
        with pytest.raises(ServiceOverloaded):
            fleet.submit(dcop, "mgm", seed=1)
        _drain(fleet)

    def test_fleet_tenant_quota(self):
        dcop = _load()
        fleet = _fleet(replicas=2, lanes=2, tenant_quota=1)
        fleet.submit(dcop, "mgm", seed=0, tenant="t1")
        with pytest.raises(ServiceOverloaded):
            fleet.submit(dcop, "mgm", seed=1, tenant="t1")
        fleet.submit(dcop, "mgm", seed=2, tenant="t2")
        assert fleet.metrics()["fleet"]["quota_rejections"] == 1
        _drain(fleet)


class TestFleetJournalEdges:
    def test_glued_and_unterminated_lines_skipped_and_counted(
        self, tmp_path
    ):
        path = str(tmp_path / "fleet.jsonl")
        j = FleetJournal(path)
        j.append({"kind": "job", "jid": "job-000001"})
        j.append({"kind": "done", "jid": "job-000001"})
        with open(path, "a", encoding="utf-8") as f:
            f.write('{"kind": "job", "ji{"kind": "done", "jid": "x"}\n')
            f.write('{"kind": "job", "jid": "job-0000')
        records, torn = j.load()
        assert [r["kind"] for r in records] == ["job", "done"]
        assert torn == 2

    def test_load_missing_and_empty(self, tmp_path):
        j = FleetJournal(str(tmp_path / "nope.jsonl"))
        assert j.load() == ([], 0)
        open(j.path, "w").close()
        assert j.load() == ([], 0)

    def test_non_record_json_counts_torn(self, tmp_path):
        j = FleetJournal(str(tmp_path / "fleet.jsonl"))
        with open(j.path, "w", encoding="utf-8") as f:
            f.write('[1, 2]\n{"no_kind": true}\n')
        records, torn = j.load()
        assert records == [] and torn == 2


class TestResumePrewarm:
    def test_resume_prewarms_reseat_signatures(self, tmp_path):
        """resume() warms the exact re-seat targets BEFORE re-queueing,
        so the admission path pays zero new cache misses."""
        dcop = _load()
        jd = str(tmp_path / "journal")
        svc1 = SolveService(lanes=2, cache=CompileCache(),
                            max_cycles=LIMIT, journal_dir=jd,
                            checkpoint_every=1, device="cpu")
        a = svc1.submit(dcop, "dsa", seed=0, source_file=TUTO)
        b = svc1.submit(dcop, "dsa", seed=1, source_file=TUTO)
        svc1.tick()
        svc1.tick()  # checkpointed mid-flight
        assert not svc1._jobs[a].done.is_set()
        del svc1  # crash

        cache = CompileCache()
        svc2 = SolveService(lanes=2, cache=cache, max_cycles=LIMIT,
                            journal_dir=jd, checkpoint_every=1,
                            device="cpu")
        assert svc2.resume() == 2
        misses_at_resume = cache.stats()["misses"]
        assert misses_at_resume >= 1
        assert cache.pool_stats()["prewarmed"] == misses_at_resume
        for _ in range(120):
            if not svc2.tick():
                break
        assert cache.stats()["misses"] == misses_at_resume
        for jid, seed in ((a, 0), (b, 1)):
            res = svc2.result(jid, timeout=1)
            seq = _standalone(dcop, "dsa", seed)
            assert res.assignment == seq.assignment
            assert res.cycle == seq.cycle

    def test_resume_prewarm_optional(self, tmp_path):
        dcop = _load()
        jd = str(tmp_path / "journal")
        svc1 = SolveService(lanes=1, cache=CompileCache(),
                            max_cycles=LIMIT, journal_dir=jd,
                            checkpoint_every=1, device="cpu")
        svc1.submit(dcop, "mgm", seed=0, source_file=TUTO)
        svc1.tick()
        del svc1
        cache = CompileCache()
        svc2 = SolveService(lanes=1, cache=cache, max_cycles=LIMIT,
                            journal_dir=jd, device="cpu")
        assert svc2.resume(prewarm=False) == 1
        assert cache.stats()["misses"] == 0  # nothing built yet


class TestFleetEvents:
    def test_fleet_lifecycle_events_emitted(self, tmp_path):
        from pydcop_tpu_torch.runtime.events import event_bus

        dcop = _load()
        seen = []
        cb = lambda topic, evt: seen.append(topic)  # noqa: E731
        event_bus.enabled = True
        event_bus.subscribe("fleet.*", cb)
        try:
            plan = FaultPlan(faults=[Fault(
                kind="kill_replica", replica=0, cycle=3,
            )])
            fleet = _fleet(replicas=2, lanes=2,
                           journal_dir=str(tmp_path / "f"),
                           checkpoint_every=1, fault_plan=plan)
            jid = fleet.submit(dcop, "dsa", seed=0)
            _drain(fleet)
            fleet.result(jid, timeout=1)
        finally:
            event_bus.unsubscribe(cb)
            event_bus.enabled = False
        for expected in ("fleet.replica.up", "fleet.router.placed",
                         "fleet.fault.injected", "fleet.replica.down",
                         "fleet.job.reseated", "fleet.recovery.done"):
            assert expected in seen, (expected, sorted(set(seen)))

    def test_unknown_fleet_counter_rejected(self):
        from pydcop_tpu.runtime.stats import FLEET_COUNTERS as JAX_NAMES
        from pydcop_tpu_torch.runtime.stats import FleetCounters

        with pytest.raises(KeyError):
            FleetCounters().inc("nope")
        assert tuple(FleetCounters().as_dict()) == JAX_NAMES

    def test_fleet_fault_kinds_validate(self):
        with pytest.raises(ValueError, match="needs a 'replica'"):
            Fault(kind="kill_replica")
        with pytest.raises(ValueError, match="duration"):
            Fault(kind="stall_replica", replica=0)
        f = Fault(kind="partition_replica", replica=1, duration=0.5)
        rt = Fault(**{k: v for k, v in f.to_dict().items()})
        assert rt == f
        plan = FaultPlan(faults=[f])
        assert plan.fleet_faults() == [f]
        assert plan.serve_faults() == []
        assert FaultPlan.from_json(plan.to_json()).fleet_faults() == [f]


# ---------------------------------------------------------------------------
# against the JAX package: maxsum at noise 0
# ---------------------------------------------------------------------------


def _maxsum_fleets(tmp_path, kill):
    """The same trace (four instances, one submitted a tick) through the
    port's and the JAX package's two-replica fleets; with ``kill`` a
    ``kill_replica`` of replica-0 at supervisor pass 3."""
    params = {"noise": 0}
    plans = (None, None)
    if kill:
        plans = (FaultPlan(faults=[Fault(kind="kill_replica", replica=0,
                                         cycle=3)]),
                 JaxFaultPlan(faults=[JaxFault(kind="kill_replica",
                                               replica=0, cycle=3)]))
    mine = _fleet(replicas=2, lanes=2, journal_dir=str(tmp_path / "p"),
                  checkpoint_every=1, fault_plan=plans[0])
    theirs = JaxSolveFleet(replicas=2, lanes=2, max_cycles=LIMIT,
                           journal_dir=str(tmp_path / "j"),
                           checkpoint_every=1, fault_plan=plans[1])
    got, want = [], []
    for k, n in enumerate(NAMES):
        path = os.path.join(INSTANCES, n + ".yaml")
        got.append(mine.submit(_load(path), "maxsum", algo_params=params,
                               seed=k))
        want.append(theirs.submit(jax_load([path]), "maxsum",
                                  algo_params=params, seed=k))
        mine.tick()
        theirs.tick()
    _drain(mine)
    _drain(theirs)
    return mine, theirs, got, want


@pytest.mark.parametrize("kill", [False, True], ids=["unfailed", "kill"])
def test_maxsum_noise0_equals_the_jax_fleet(tmp_path, kill):
    mine, theirs, got, want = _maxsum_fleets(tmp_path, kill)
    for n, g, w in zip(NAMES, got, want):
        rg, rw = mine.result(g, timeout=1), theirs.result(w, timeout=1)
        assert rg.assignment == rw.assignment, n
        assert rg.cost == pytest.approx(rw.cost, abs=1e-4), n
        assert (rg.cycle, rg.status) == (rw.cycle, rw.status), n
        assert (rg.metrics()["serve"]["replica"]
                == rw.metrics()["serve"]["replica"]), n
        assert (rg.metrics()["serve"]["reseats"]
                == rw.metrics()["serve"]["reseats"]), n
    fm, fw = mine.metrics()["fleet"], theirs.metrics()["fleet"]
    for k in ("jobs_routed", "jobs_routed_warm", "jobs_reseated",
              "replicas_down", "recoveries_completed"):
        assert fm[k] == fw[k], k
    if kill:
        assert fm["jobs_reseated"] >= 1
        records, _ = mine.journal.load()
        jrecords, _ = theirs.journal.load()
        assert ([r["kind"] for r in records]
                == [r["kind"] for r in jrecords])


def test_memo_insert_adopted_by_peers(tmp_path):
    """The memo's fleet sharing: an instance solved on one replica is
    adopted by its peer, journaled as a ``memo`` record, and a duplicate
    is an exact hit on EVERY replica (JAX ``TestFleetSharing``)."""
    fl = _fleet(replicas=2, lanes=4, journal_dir=str(tmp_path / "fleet"),
                memo=True)
    d = _load()
    j1 = fl.submit(d, "mgm", seed=1)
    _drain(fl)
    r1 = fl.result(j1, timeout=1)
    met = fl.metrics()
    adopted = sum((rep["memo"] or {}).get("adopted", 0)
                  for rep in met["replicas"].values())
    assert adopted == 1
    assert met["fleet"]["memo_shared"] == 1
    with open(os.path.join(str(tmp_path / "fleet"), "fleet.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert any(r.get("kind") == "memo" for r in recs)
    for name in ("replica-0", "replica-1"):
        fl.router.set_partitioned(
            "replica-1" if name == "replica-0" else "replica-0", True)
        fl.router.set_partitioned(name, False)
        j = fl.submit(d, "mgm", seed=1)
        _drain(fl)
        r = fl.result(j, timeout=1)
        assert r.metrics()["serve"]["replica"] == name
        assert r.metrics()["memo"]["hit"] == "exact"
        assert (r.assignment, r.cost) == (r1.assignment, r1.cost)


def test_jax_only_options_are_refused():
    with pytest.raises(NotPortedError, match="shared_xla_cache"):
        SolveFleet(replicas=2, device="cpu", shared_xla_cache=True)
    fleet = _fleet(replicas=2)
    with pytest.raises(NotPortedError, match="prewarm_predicted"):
        fleet.prewarm_predicted([_load()])


def test_fleet_defaults_to_cuda():
    """No device: the replicas run on cuda — on a machine without a GPU
    the fleet raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        fleet = SolveFleet(replicas=2)
        assert fleet.handle(0).service.device.type == "cuda"
        return
    with pytest.raises(DeviceUnavailableError):
        SolveFleet(replicas=2)


def test_replica_service_heartbeat_and_completion_tap(tmp_path):
    """The fleet hooks of SolveService alone: the tick beats the
    heartbeat file, every completion reaches ``on_complete``, every
    lane of a replica checkpoints (no source file needed) and the
    counters carry the replica name."""
    hb = str(tmp_path / "r.hb")
    done = []
    svc = SolveService(lanes=2, cache=CompileCache(), max_cycles=LIMIT,
                       journal_dir=str(tmp_path / "j"), checkpoint_every=1,
                       replica="replica-7", heartbeat_path=hb,
                       on_complete=lambda job, res: done.append(
                           (job.jid, res.serve["replica"])),
                       device="cpu")
    jid = svc.submit(_load(), "dsa", seed=0)
    svc.tick()
    svc.tick()
    assert os.path.exists(hb)
    assert svc.counters.counts["checkpoints_saved"] >= 1
    for _ in range(60):
        if not svc.tick():
            break
    assert done == [(jid, "replica-7")]
    assert svc.metrics()["serve"]["replica"] == "replica-7"
    assert np.isfinite(svc.result(jid, timeout=1).cost)


def test_a_halted_replica_completes_nothing_further():
    """halt() — the thread-hosted kill -9 — ends the replica at its
    next tick boundary: a tick run after it (or waking from a wedge)
    completes and journals nothing; the job is left to a peer."""
    done = []
    svc = SolveService(lanes=2, cache=CompileCache(), max_cycles=LIMIT,
                       replica="replica-0", device="cpu",
                       on_complete=lambda job, res: done.append(job.jid))
    jid = svc.submit(_load(), "dsa", seed=0)
    svc.tick()
    svc.halt()
    for _ in range(20):
        assert svc.tick() is False
    assert done == [] and not svc._jobs[jid].done.is_set()
    with pytest.raises(ServiceStopped):
        svc.result(jid, timeout=1)
