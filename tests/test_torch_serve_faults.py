"""Fault isolation, overload control and the journal of the port's solve
service on the CPU, after the JAX package's
``tests/unit/test_serve_faults.py``, case by case, held to the port's
own sequential solves; and the fault plans, serve counters and state
containers held to the JAX package's:

* **chaos matrix**: for each serve fault kind (``raise_in_step``,
  ``nan_lane``, ``torn_journal_write``, ``stall_tick``) injected via a
  seeded FaultPlan, every healthy job completes bit-identically to its
  standalone solve, the poison job ends in a terminal ``ERROR``, and
  the matching counter is nonzero;
* quarantine and bisect, the supervisor, admission control, journal
  compaction, torn journals, lossy streams, the injector's semantics;
* **against the JAX package**: ``FaultPlan.from_yaml`` of the same plan
  files gives equal fault dicts and JSON; ``ServeCounters().as_dict()``
  has JAX's keys; a container written by either package's
  ``write_state_npz`` reads in the other's ``read_state_npz`` with equal
  arrays and metadata; a lane checkpoint the JAX package wrote (a JAX
  PRNG key) is refused with ``ValueError`` and never seated.

Tests drive :meth:`SolveService.tick` synchronously where determinism
matters; supervisor tests run the real scheduler thread, stopped by the
``services`` fixture, every wait bounded.
"""
import json
import os
import queue

import numpy as np
import pytest
import torch

from pydcop_tpu.runtime import checkpoint as jax_ckpt
from pydcop_tpu.runtime import faults as jax_faults
from pydcop_tpu.runtime.stats import ServeCounters as JaxServeCounters
from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import checkpoint as port_ckpt
from pydcop_tpu_torch.runtime import faults as port_faults
from pydcop_tpu_torch.runtime.faults import (
    Fault,
    FaultPlan,
    ServeFaultInjector,
)
from pydcop_tpu_torch.runtime.stats import SERVE_COUNTERS, ServeCounters
from pydcop_tpu_torch.serve import (
    DeadlineInfeasible,
    ServeJob,
    ServiceOverloaded,
    ServiceStopped,
    SolveService,
)
from pydcop_tpu_torch.serve.scheduler import (
    restore_lane_state,
    serve_target,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
LIMIT = 63


@pytest.fixture
def services():
    made = []

    def make(**kw):
        """A deterministic sync-driven service: zero quarantine backoff
        so tick-driven tests never wait on wall-clock gates."""
        kw.setdefault("lanes", 2)
        kw.setdefault("cache", CompileCache())
        kw.setdefault("max_cycles", LIMIT)
        kw.setdefault("backoff_base", 0.0)
        kw.setdefault("device", "cpu")
        svc = SolveService(**kw)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.stop(drain=False)


def _load():
    return load_dcop_from_file(TUTO)


def _standalone(dcop, algo, seed, params=None):
    spec = adapter_for(algo).build_spec(
        BatchItem(dcop, algo, algo_params=params, seed=seed))
    return spec.solver.run(max_cycles=LIMIT)


def _drain(svc, max_ticks=300):
    for _ in range(max_ticks):
        if not svc.tick() and all(
                j.done.is_set() for j in svc._jobs.values()):
            return
    raise AssertionError("service did not drain")


# ---------------------------------------------------------------------------
# the chaos matrix
# ---------------------------------------------------------------------------

MATRIX = {
    "raise_in_step": dict(
        algo="mgm",
        fault=dict(kind="raise_in_step", jid="job-000002", cycle=2),
        counter="jobs_quarantined", poison="job-000002"),
    "nan_lane": dict(
        algo="maxsum",  # float state: the device-side finiteness check
        fault=dict(kind="nan_lane", jid="job-000002", cycle=2),
        counter="lanes_nan", poison="job-000002"),
    "nan_lane_int_state": dict(
        algo="dsa",  # no float leaf: quarantined directly
        fault=dict(kind="nan_lane", jid="job-000002", cycle=2),
        counter="lanes_nan", poison="job-000002"),
    "torn_journal_write": dict(
        algo="mgm",
        fault=dict(kind="torn_journal_write", jid="job-000002"),
        counter="faults_injected", poison=None),
    "stall_tick": dict(
        algo="mgm",
        fault=dict(kind="stall_tick", duration=0.02, cycle=1),
        counter="ticks_stalled", poison=None),
}


class TestChaosMatrix:
    @pytest.mark.parametrize("kind", sorted(MATRIX))
    def test_injected_fault_is_contained(self, kind, services, tmp_path):
        cfg = MATRIX[kind]
        plan = FaultPlan(faults=[Fault(**cfg["fault"])], seed=7)
        needs_journal = kind == "torn_journal_write"
        jd = str(tmp_path / "journal") if needs_journal else None
        svc = services(fault_plan=plan, journal_dir=jd)
        dcop = _load()
        a = svc.submit(dcop, cfg["algo"], seed=0,
                       source_file=TUTO if needs_journal else None)
        b = svc.submit(dcop, cfg["algo"], seed=1,
                       source_file=TUTO if needs_journal else None)
        assert (a, b) == ("job-000001", "job-000002")
        _drain(svc)
        for jid, seed in ((a, 0), (b, 1)):
            res = svc.result(jid, timeout=1)
            if jid == cfg["poison"]:
                assert res.status == "ERROR", (kind, res.status)
                continue
            seq = _standalone(dcop, cfg["algo"], seed)
            assert (res.status, res.assignment, res.cycle, res.cost) == \
                (seq.status, seq.assignment, seq.cycle, seq.cost), kind
        assert svc.counters.counts[cfg["counter"]] > 0, kind
        assert svc.counters.counts["faults_injected"] > 0, kind

    def test_torn_write_is_skipped_and_counted_on_resume(self, services,
                                                         tmp_path):
        cfg = MATRIX["torn_journal_write"]
        plan = FaultPlan(faults=[Fault(**cfg["fault"])], seed=7)
        jd = str(tmp_path / "journal")
        svc = services(fault_plan=plan, journal_dir=jd,
                       journal_compact_bytes=1 << 30)
        dcop = _load()
        svc.submit(dcop, "mgm", seed=0, source_file=TUTO)
        svc.submit(dcop, "mgm", seed=1, source_file=TUTO)
        svc.tick()
        svc.halt()
        svc2 = services(journal_dir=jd)
        assert svc2.resume() == 1
        assert svc2.counters.counts["torn_journal_lines"] >= 1
        _drain(svc2)
        res = svc2.result("job-000001", timeout=1)
        assert res.assignment == _standalone(dcop, "mgm", 0).assignment


# ---------------------------------------------------------------------------
# quarantine mechanics
# ---------------------------------------------------------------------------

class TestQuarantine:
    def test_transient_step_failure_absorbed(self, services):
        plan = FaultPlan(faults=[Fault(kind="raise_in_step", cycle=2)],
                         seed=3)
        svc = services(fault_plan=plan)
        dcop = _load()
        jids = [svc.submit(dcop, "dsa", seed=s) for s in range(2)]
        _drain(svc)
        assert svc.counters.counts["buckets_failed"] >= 1
        for jid, seed in zip(jids, range(2)):
            res = svc.result(jid, timeout=1)
            seq = _standalone(dcop, "dsa", seed)
            assert res.status == "FINISHED"
            assert (res.assignment, res.cycle) == (seq.assignment,
                                                   seq.cycle)

    def test_bisect_isolates_suspect_groups(self, services):
        plan = FaultPlan(faults=[Fault(kind="raise_in_step", cycle=2)],
                         seed=3)
        svc = services(fault_plan=plan)
        dcop = _load()
        jids = [svc.submit(dcop, "mgm", seed=s) for s in range(2)]
        svc.tick()
        assert svc.counters.counts["buckets_opened"] == 1
        svc.tick()
        keys = {svc._jobs[j].isolate_key for j in jids}
        assert None not in keys and len(keys) == 2
        _drain(svc)
        assert svc.counters.counts["buckets_opened"] >= 3
        # the failed bucket's runner was dropped, not pooled
        assert svc.cache.pool_stats()["pooled"] <= 2

    def test_poison_ladder_retries_then_escalates(self, services):
        plan = FaultPlan(
            faults=[Fault(kind="raise_in_step", jid="job-000001")], seed=3)
        svc = services(lanes=1, fault_plan=plan, max_job_retries=2)
        jid = svc.submit(_load(), "mgm", seed=0)
        _drain(svc)
        assert svc.result(jid, timeout=1).status == "ERROR"
        assert svc.counters.counts["jobs_retried"] == 2
        assert svc.counters.counts["jobs_quarantined"] == 1
        assert svc.counters.counts["buckets_failed"] >= 3

    def test_poisoned_lane_ends_in_error_without_its_neighbour(
            self, services):
        """A persistent nan_lane on one maxsum lane, no retry budget: the
        poisoned job escalates to a terminal ERROR, its bucket-mate
        finishes equal to its standalone solve."""
        plan = FaultPlan(faults=[Fault(kind="nan_lane", jid="job-000001",
                                       cycle=1)], seed=1)
        svc = services(fault_plan=plan, max_job_retries=0)
        dcop = _load()
        a = svc.submit(dcop, "maxsum", seed=0)
        b = svc.submit(dcop, "maxsum", seed=1)
        _drain(svc)
        assert svc.result(a, timeout=1).status == "ERROR"
        seq = _standalone(dcop, "maxsum", 1)
        res = svc.result(b, timeout=1)
        assert (res.assignment, res.cycle) == (seq.assignment, seq.cycle)
        assert svc.counters.counts["lanes_nan"] == 1


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class TestSupervisor:
    def test_transient_tick_failure_restarts_with_backoff(self, services):
        svc = services()
        calls = {"n": 0}
        orig = svc.tick

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("transient scheduler glitch")
            return orig()

        svc.tick = flaky
        svc.start()
        jid = svc.submit(_load(), "mgm", seed=0)
        res = svc.result(jid, timeout=60)
        assert res.status == "FINISHED"
        assert svc.counters.counts["scheduler_restarts"] == 2

    def test_dead_scheduler_raises_service_stopped(self, services):
        svc = services(max_scheduler_restarts=1)

        def always_raise():
            raise RuntimeError("scheduler is toast")

        svc.tick = always_raise
        jid = svc.submit(_load(), "mgm", seed=0)
        svc.start()
        with pytest.raises(ServiceStopped):
            svc.result(jid, timeout=30)
        assert svc._jobs[jid].done.is_set()
        assert svc.wait_all(timeout=10) is True
        with pytest.raises(ServiceStopped):
            svc.submit(_load(), "mgm", seed=1)
        assert svc.counters.counts["scheduler_restarts"] == 1

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_silently_dead_thread_detected(self, services):
        svc = services()

        def die():
            raise SystemExit

        svc.tick = die
        jid = svc.submit(_load(), "mgm", seed=0)
        svc.start()
        with pytest.raises(ServiceStopped):
            svc.result(jid, timeout=30)

    def test_result_after_abandoning_stop_raises(self, services):
        svc = services()
        svc.tick = lambda: False
        jid = svc.submit(_load(), "mgm", seed=0)
        svc.start()
        svc.stop(drain=False)
        with pytest.raises(ServiceStopped):
            svc.result(jid, timeout=5)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class TestAdmissionControl:
    def test_max_pending_rejects_with_retry_after(self, services):
        svc = services(lanes=1, max_pending=1)
        dcop = _load()
        svc.submit(dcop, "mgm", seed=0)
        with pytest.raises(ServiceOverloaded) as ei:
            svc.submit(dcop, "mgm", seed=1)
        assert ei.value.retry_after > 0
        d = ei.value.to_dict()
        assert d["error"] == "overloaded" and "queue" in d["reason"]
        assert svc.counters.counts["jobs_shed"] == 1
        _drain(svc)

    def test_higher_priority_arrival_sheds_lowest_pending(self, services):
        svc = services(lanes=1, max_pending=1)
        dcop = _load()
        lo = svc.submit(dcop, "mgm", seed=0, priority=0)
        hi = svc.submit(dcop, "mgm", seed=1, priority=5)
        assert svc.result(lo, timeout=1).status == "ERROR"
        assert svc.counters.counts["jobs_shed"] == 1
        _drain(svc)
        res = svc.result(hi, timeout=1)
        assert res.status == "FINISHED"
        assert res.assignment == _standalone(dcop, "mgm", 1).assignment

    def test_tenant_quota_rejections(self, services):
        svc = services(tenant_quota=1)
        dcop = _load()
        a = svc.submit(dcop, "mgm", seed=0, tenant="t1")
        with pytest.raises(ServiceOverloaded) as ei:
            svc.submit(dcop, "mgm", seed=1, tenant="t1")
        assert ei.value.tenant == "t1"
        assert svc.counters.counts["quota_rejections"] == 1
        b = svc.submit(dcop, "mgm", seed=2, tenant="t2")
        _drain(svc)
        assert svc.result(a, timeout=1).status == "FINISHED"
        assert svc.result(b, timeout=1).status == "FINISHED"
        c = svc.submit(dcop, "mgm", seed=3, tenant="t1")
        _drain(svc)
        assert svc.result(c, timeout=1).status == "FINISHED"

    def test_infeasible_deadline_rejected_at_submit(self, services):
        svc = services()
        for bad in (0, -1.5):
            with pytest.raises(DeadlineInfeasible):
                svc.submit(_load(), "mgm", seed=0, deadline_s=bad)
        assert svc.counters.counts["jobs_shed"] == 2
        assert not svc._jobs

    def test_resumed_jobs_bypass_admission_control(self, services,
                                                   tmp_path):
        jd = str(tmp_path / "journal")
        svc1 = services(journal_dir=jd, checkpoint_every=1)
        dcop = _load()
        for s in range(3):
            svc1.submit(dcop, "dsa", seed=s, source_file=TUTO)
        svc1.tick()
        svc1.halt()
        svc2 = services(journal_dir=jd, max_pending=1)
        assert svc2.resume() == 3
        _drain(svc2)
        for jid in list(svc2._jobs):
            assert svc2.result(jid, timeout=1).status == "FINISHED"


# ---------------------------------------------------------------------------
# journal hygiene
# ---------------------------------------------------------------------------

class TestJournalCompaction:
    def test_compaction_drops_done_records(self, services, tmp_path):
        jd = str(tmp_path / "journal")
        svc = services(journal_dir=jd, journal_compact_bytes=1 << 30)
        for s in range(3):
            svc.submit(_load(), "mgm", seed=s, source_file=TUTO)
        _drain(svc)
        path = os.path.join(jd, "jobs.jsonl")
        assert len(open(path).read().splitlines()) == 3
        assert svc.compact_journal() == 0
        assert open(path).read() == ""
        assert open(os.path.join(jd, "progress_serve")).read() == ""
        assert svc.counters.counts["journal_compactions"] == 1
        assert services(journal_dir=jd).resume() == 0

    def test_compaction_keeps_inflight_records(self, services, tmp_path):
        jd = str(tmp_path / "journal")
        svc = services(journal_dir=jd, journal_compact_bytes=1 << 30)
        dcop = _load()
        a = svc.submit(dcop, "mgm", seed=0, source_file=TUTO)
        _drain(svc)
        assert svc.result(a, timeout=1).status == "FINISHED"
        b = svc.submit(dcop, "dsa", seed=1, source_file=TUTO)
        svc.tick()
        assert svc.compact_journal() == 1
        recs = [json.loads(ln) for ln in open(
            os.path.join(jd, "jobs.jsonl")).read().splitlines()]
        assert [r["jid"] for r in recs] == [b]
        svc.halt()
        svc2 = services(journal_dir=jd)
        assert svc2.resume() == 1
        _drain(svc2)
        res = svc2.result(b, timeout=1)
        seq = _standalone(dcop, "dsa", 1)
        assert (res.assignment, res.cycle) == (seq.assignment, seq.cycle)

    def test_size_threshold_triggers_compaction(self, services, tmp_path):
        jd = str(tmp_path / "journal")
        svc = services(journal_dir=jd, journal_compact_bytes=1)
        svc.submit(_load(), "mgm", seed=0, source_file=TUTO)
        _drain(svc)
        assert svc.counters.counts["journal_compactions"] >= 1
        assert open(os.path.join(jd, "jobs.jsonl")).read() == ""


def _write_journal(jd, records, torn_fragment=None, progress=()):
    os.makedirs(os.path.join(jd, "ckpt"), exist_ok=True)
    with open(os.path.join(jd, "jobs.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        if torn_fragment is not None:
            f.write(torn_fragment)
    with open(os.path.join(jd, "progress_serve"), "w") as f:
        for line in progress:
            f.write(line)


def _rec(jid, seed=0, algo="mgm"):
    return {"jid": jid, "file": TUTO, "algo": algo, "seed": seed}


class TestTornJournal:
    def test_truncated_final_jobs_line_resumes_cleanly(self, services,
                                                       tmp_path):
        jd = str(tmp_path / "journal")
        _write_journal(jd, [_rec("job-000001")],
                       torn_fragment='{"jid": "job-0000')
        svc = services(journal_dir=jd)
        assert svc.resume() == 1
        assert svc.counters.counts["torn_journal_lines"] == 1
        _drain(svc)
        res = svc.result("job-000001", timeout=1)
        seq = _standalone(_load(), "mgm", 0)
        assert (res.assignment, res.cycle) == (seq.assignment, seq.cycle)

    def test_glued_torn_fragment_skipped(self, services, tmp_path):
        jd = str(tmp_path / "journal")
        os.makedirs(os.path.join(jd, "ckpt"), exist_ok=True)
        with open(os.path.join(jd, "jobs.jsonl"), "w") as f:
            f.write(json.dumps(_rec("job-000001")) + "\n")
            f.write('{"jid": "job-0000' + json.dumps(
                _rec("job-000002", seed=1)) + "\n")
            f.write(json.dumps(_rec("job-000003", seed=2)) + "\n")
        svc = services(journal_dir=jd)
        assert svc.resume() == 2
        assert svc.counters.counts["torn_journal_lines"] == 1

    def test_half_written_jid_line_skipped_and_counted(self, services,
                                                       tmp_path):
        jd = str(tmp_path / "journal")
        _write_journal(jd, [_rec("job-000001"), _rec("job-000002", seed=1)],
                       progress=["JID: job-000001\n", "JID: job-0000"])
        svc = services(journal_dir=jd)
        assert svc.counters.counts["torn_journal_lines"] == 1
        assert svc.resume() == 1
        _drain(svc)
        assert svc.result("job-000002", timeout=1).status == "FINISHED"

    def test_corrupt_checkpoint_still_restarts_from_zero(self, services,
                                                         tmp_path):
        jd = str(tmp_path / "journal")
        svc1 = services(lanes=1, journal_dir=jd, checkpoint_every=1)
        a = svc1.submit(_load(), "mgm", seed=0, source_file=TUTO)
        svc1.tick()
        ck = svc1._ckpt_path(a)
        assert os.path.exists(ck)
        with open(ck, "r+b") as f:
            f.seek(30)
            f.write(b"\xde\xad\xbe\xef")
        svc1.halt()
        svc2 = services(journal_dir=jd)
        assert svc2.resume() == 1
        _drain(svc2)
        res = svc2.result(a, timeout=1)
        assert res.assignment == _standalone(_load(), "mgm", 0).assignment
        assert svc2.counters.counts["jobs_resumed"] == 0

    def test_jax_written_lane_checkpoint_restarts_from_zero(self, services,
                                                            tmp_path):
        """A lane checkpoint with a JAX PRNG key in the journal: resume
        refuses it and restarts the job from cycle 0 on the port's own
        stream (never seated), equal to its standalone solve."""
        jd = str(tmp_path / "journal")
        _write_journal(jd, [_rec("job-000001", seed=4, algo="dsa")])
        jax_ckpt.write_state_npz(
            os.path.join(jd, "ckpt", "job-000001.npz"),
            {"leaf_0": np.zeros(10, np.int32),
             "prng_key": np.array([0, 4], np.uint32)},
            {"jid": "job-000001", "algo": "dsa", "age": 14, "stable": 0,
             "first_chunk": False, "n_leaves": 1,
             "target": {"graph_type": "constraints_hypergraph", "D": 3,
                        "arities": [2], "V": 10, "F": [12], "M": 24}})
        svc = services(journal_dir=jd)
        assert svc.resume() == 1
        _drain(svc)
        assert svc.counters.counts["jobs_resumed"] == 0
        res = svc.result("job-000001", timeout=1)
        seq = _standalone(_load(), "dsa", 4)
        assert (res.assignment, res.cycle) == (seq.assignment, seq.cycle)


# ---------------------------------------------------------------------------
# lossy streams, injector semantics, plan parsing
# ---------------------------------------------------------------------------

class TestLossyStream:
    def test_drops_counted_with_one_notice_per_job(self):
        from pydcop_tpu_torch.runtime.events import event_bus

        counters = ServeCounters()
        job = ServeJob(
            jid="j1", dcop=None, algo="mgm", algo_params={}, seed=0,
            tenant="t", priority=0, deadline_s=None, deadline_at=None,
            label=None, source_file=None, stream=True,
            submitted_at=0.0, seq=1, counters=counters,
        )
        job.events = queue.Queue(maxsize=1)
        seen = []
        cb = lambda t, e: seen.append((t, e))  # noqa: E731
        event_bus.enabled = True
        event_bus.subscribe("serve.stream.lossy", cb)
        try:
            job.emit("job.progress", {"cycle": 1})
            job.emit("job.progress", {"cycle": 2})
            job.emit("job.progress", {"cycle": 3})
        finally:
            event_bus.unsubscribe(cb)
            event_bus.enabled = False
        assert counters.counts["events_dropped"] == 2
        assert counters.events_dropped_by_tenant == {"t": 2}
        assert len(seen) == 1 and seen[0][1] == {"jid": "j1"}


class TestInjectorSemantics:
    def test_one_shot_vs_persistent(self):
        plan = FaultPlan(faults=[
            Fault(kind="raise_in_step", cycle=1),
            Fault(kind="nan_lane", jid="jA", cycle=1),
        ])
        inj = ServeFaultInjector(plan)
        assert inj.due("raise_in_step", 0, jids={"jX"}) is None
        assert inj.due("raise_in_step", 1, jids={"jX"}) is not None
        assert inj.due("raise_in_step", 2, jids={"jX"}) is None
        assert inj.due("nan_lane", 1, jid="jB") is None
        assert inj.due("nan_lane", 1) is None
        for _ in range(3):
            assert inj.due("nan_lane", 1, jid="jA") is not None
        assert inj.poisoned("jA") and not inj.poisoned("jB")

    def test_stall_tick_requires_duration(self):
        with pytest.raises(ValueError):
            Fault(kind="stall_tick")

    def test_checkpoint_faults_need_the_unported_manager(self, tmp_path):
        plan = FaultPlan(faults=[Fault(kind="corrupt_checkpoint")])
        with pytest.raises(NotPortedError, match="CheckpointManager"):
            port_faults.apply_checkpoint_faults(plan, str(tmp_path), 0)

    def test_corrupt_checkpoint_is_caught_by_the_crc(self, tmp_path):
        path = str(tmp_path / "c.npz")
        port_ckpt.write_state_npz(
            path, {"a": np.arange(4096, dtype=np.float32)}, {"k": 1})
        port_faults.corrupt_checkpoint(path, seed=3)
        with pytest.raises(ValueError):
            port_ckpt.read_state_npz(path)


#: plan files: every kind of the catalog, with the fields it reads
PLANS = {
    "serve": ("seed: 7\n"
              "faults:\n"
              "  - kind: raise_in_step\n    jid: job-000002\n    cycle: 2\n"
              "  - kind: nan_lane\n    jid: job-000003\n"
              "  - kind: torn_journal_write\n"
              "  - kind: stall_tick\n    duration: 0.5\n"
              "  - kind: corrupt_cache_entry\n    jid: job-000004\n"),
    "runtime": ("seed: 3\n"
                "faults:\n"
                "  - kind: kill_rank\n    rank: 1\n    cycle: 8\n"
                "  - kind: stall_rank\n    rank: 0\n    cycle: 4\n"
                "    duration: 60\n"
                "  - kind: kill_agent\n    agent: a3\n    cycle: 10\n"
                "  - kind: corrupt_checkpoint\n    attempt: 1\n"
                "  - kind: truncate_checkpoint\n    attempt: null\n"),
    "fleet_churn_device": (
        "faults:\n"
        "  - kind: kill_replica\n    replica: 1\n    cycle: 4\n"
        "  - kind: stall_replica\n    replica: 0\n    duration: 0.5\n"
        "  - kind: partition_replica\n    replica: 1\n    duration: 1.0\n"
        "  - kind: kill_process\n    replica: 1\n"
        "  - kind: partition_socket\n    replica: 0\n    duration: 1.0\n"
        "  - kind: corrupt_artifact\n    cycle: 2\n"
        "  - kind: edit_factor\n    constraint: c12\n"
        "  - kind: remove_agent_burst\n    count: 3\n"
        "  - kind: add_agent_burst\n    count: 2\n"
        "  - kind: kill_device\n    device: 7\n    cycle: 8\n"
        "  - kind: shrink_mesh\n    devices: 4\n"
        "  - kind: corrupt_slab\n    operand: bucket0\n    device: 2\n"),
}


class TestAgainstTheJaxPackage:
    @pytest.mark.parametrize("name", sorted(PLANS))
    def test_plan_files_parse_to_the_jax_packages_plans(self, name,
                                                        tmp_path):
        p = tmp_path / f"{name}.yaml"
        p.write_text(PLANS[name])
        mine = FaultPlan.from_yaml(str(p))
        theirs = jax_faults.FaultPlan.from_yaml(str(p))
        assert [f.to_dict() for f in mine.faults] == \
            [f.to_dict() for f in theirs.faults]
        assert json.loads(mine.to_json()) == json.loads(theirs.to_json())
        assert mine.validate() == theirs.validate()
        assert [f.to_dict() for f in mine.serve_faults()] == \
            [f.to_dict() for f in theirs.serve_faults()]
        again = FaultPlan.from_json(theirs.to_json())
        assert json.loads(again.to_json()) == json.loads(mine.to_json())

    def test_the_fault_catalogs_are_the_jax_packages(self):
        assert port_faults.KINDS == jax_faults.KINDS
        assert port_faults.KIND_FIELDS == jax_faults.KIND_FIELDS
        assert port_faults.ENV_FAULT_PLAN == jax_faults.ENV_FAULT_PLAN

    def test_a_misaddressed_fault_is_refused_like_jax(self, tmp_path):
        p = tmp_path / "bad.yaml"
        p.write_text("faults:\n  - kind: stall_tick\n    duration: 1\n"
                     "    rank: 2\n")
        with pytest.raises(ValueError, match="never consumes"):
            FaultPlan.from_yaml(str(p))
        with pytest.raises(ValueError, match="never consumes"):
            jax_faults.FaultPlan.from_yaml(str(p))

    def test_serve_counters_have_the_jax_keys(self):
        assert set(ServeCounters().as_dict()) == \
            set(JaxServeCounters().as_dict())
        assert tuple(SERVE_COUNTERS) == tuple(
            __import__("pydcop_tpu.runtime.stats", fromlist=["x"])
            .SERVE_COUNTERS)

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_state_containers_read_across_packages(self, direction,
                                                   tmp_path):
        rng = np.random.default_rng(0)
        arrays = {"leaf_0": rng.integers(0, 3, 17).astype(np.int32),
                  "leaf_1": rng.standard_normal((5, 3)).astype(np.float32),
                  "generator_0": rng.integers(0, 255, 40).astype(np.uint8)}
        meta = {"jid": "job-000001", "age": 14, "stable": 1,
                "first_chunk": False, "target": {"V": 18, "F": [4]}}
        path = str(tmp_path / "lane.npz")
        write, read = ((jax_ckpt.write_state_npz, port_ckpt.read_state_npz)
                       if direction == "jax_to_port" else
                       (port_ckpt.write_state_npz, jax_ckpt.read_state_npz))
        write(path, arrays, meta)
        got_meta, got = read(path)
        assert set(got) == set(arrays)
        for k in arrays:
            assert got[k].dtype == arrays[k].dtype
            assert np.array_equal(got[k], arrays[k])
        for k, v in meta.items():
            assert got_meta[k] == v
        assert got_meta["version"] == port_ckpt.CHECKPOINT_VERSION == \
            jax_ckpt.CHECKPOINT_VERSION
        assert got_meta["crc"] == {k: port_ckpt._crc(v)
                                   for k, v in arrays.items()}

    def test_a_jax_lane_checkpoint_is_refused(self, tmp_path):
        """A lane checkpoint written by the JAX package's BucketWorker
        (its JAX PRNG key under ``prng_key``) is never seated on the
        port's stream: restore_lane_state raises ValueError."""
        from pydcop_tpu.batch.cache import CompileCache as JaxCache
        from pydcop_tpu.batch.engine import BatchItem as JaxItem
        from pydcop_tpu.batch.engine import adapter_for as jax_adapter
        from pydcop_tpu.dcop import load_dcop_from_file as jax_load
        from pydcop_tpu.serve.scheduler import BucketWorker as JaxWorker
        from pydcop_tpu.serve.scheduler import serve_target as jax_target

        jd = jax_load([TUTO])
        jspec = jax_adapter("dsa").build_spec(JaxItem(jd, "dsa", seed=2))

        class _Job:
            jid = "job-000001"
            seed = 2
            dcop = jd
            deadline_at = None
            submitted_at = 0.0
            stream = False
            priority = 0

        w = JaxWorker("dsa", {}, jax_target([jspec.dims]), 1, JaxCache(),
                      limit=LIMIT)
        w.admit(_Job(), jspec)
        w.step()
        arrays, meta = w.lane_checkpoint(0, w.lanes[0])
        path = str(tmp_path / "job-000001.npz")
        jax_ckpt.write_state_npz(path, arrays, meta)
        meta, arrays = port_ckpt.read_state_npz(path)
        adapter = adapter_for("dsa")
        spec = adapter.build_spec(BatchItem(_load(), "dsa", seed=2))
        target = serve_target([spec.dims])
        with pytest.raises(ValueError, match="JAX PRNG key"):
            restore_lane_state(adapter, spec, target, arrays, meta)

    def test_the_ports_lane_checkpoint_round_trips(self, services,
                                                   tmp_path):
        """The port's own lane checkpoint: its leaves and generator
        states restore, shapes and counts checked."""
        svc = services(journal_dir=str(tmp_path / "j"), checkpoint_every=1)
        jid = svc.submit(_load(), "adsa", seed=3, source_file=TUTO)
        svc.tick()
        meta, arrays = port_ckpt.read_state_npz(svc._ckpt_path(jid))
        # adsa draws its wake and move coins from one generator
        assert set(arrays) == {"leaf_0", "generator_0"}
        w = svc._workers[0]
        lane = w.lanes[0]
        got = restore_lane_state(w.adapter, lane.spec, w.target, arrays,
                                 meta)
        assert got[2:] == (meta["age"], meta["stable"],
                           meta["first_chunk"])
        assert np.array_equal(got[1][0], lane.key[0].get_state().numpy())
        bad = dict(meta, n_generators=0)
        with pytest.raises(ValueError, match="generator"):
            restore_lane_state(w.adapter, lane.spec, w.target, arrays, bad)
