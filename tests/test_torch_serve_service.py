"""The port's continuous-batching solve service
(``pydcop_tpu_torch/serve/``) on the CPU, after the JAX package's
``tests/unit/test_serve_service.py``, case by case, held to the port's
own sequential solves (the stream is the port's), and to the JAX
package's ``SolveService`` where the stream is the same (maxsum at
noise 0):

* **mid-bucket determinism**: a job admitted into an ALREADY-RUNNING
  bucket gives the assignment, cost, stop cycle and status of its
  standalone solve (the port's solver with ``use_packed=False``, the
  engine the bucket runs, ``solver.run(max_cycles=...)``), for every
  batched algorithm; a smaller instance folds into a running bucket;
  every test instance and two generated colourings, per algorithm;
* **slot reuse, merging, migration, crash resume**: a freed lane is
  reused, two under-filled buckets merge, a dsa lane migrated
  mid-flight keeps its stream, a service killed mid-flight resumes from
  its lane checkpoints — all bit-identical;
* deadlines and pressure, prewarm hits, the background thread end to
  end, the fallback algorithms (mgm2, dpop) on the service's device,
  ``serve.*`` events and the counters, the ``metrics()`` shape, the
  cuda default and the refused option (``prewarm_predicted``).

Tests drive :meth:`SolveService.tick` synchronously (no scheduler
thread) where the schedule matters; every service is stopped by the
``services`` fixture and every blocking call has a timeout.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu.batch.cache import CompileCache as JaxCompileCache
from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.serve import SolveService as JaxSolveService
from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.batch.engine import (
    SUPPORTED_ALGOS,
    BatchItem,
    adapter_for,
)
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import DeviceUnavailableError, NotPortedError
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.serve import SolveService

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]

#: cycle ceiling for the determinism tests: a multiple of the harness
#: chunk (7), small enough that even non-converging algos stay fast
LIMIT = 63


@pytest.fixture
def services():
    made = []

    def make(**kw):
        kw.setdefault("lanes", 2)
        kw.setdefault("cache", CompileCache())
        kw.setdefault("max_cycles", LIMIT)
        kw.setdefault("device", "cpu")
        svc = SolveService(**kw)
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.stop(drain=False)


def _load(name=TUTO):
    return load_dcop_from_file(name)


def _standalone(dcop, algo, seed, params=None, limit=LIMIT):
    """The standalone run the service must bit-match: the SAME solver
    construction the batch adapters use (``use_packed=False``)."""
    spec = adapter_for(algo).build_spec(
        BatchItem(dcop, algo, algo_params=params, seed=seed))
    return spec.solver.run(max_cycles=limit)


def _drain(svc, max_ticks=300):
    for _ in range(max_ticks):
        if not svc.tick() and all(
                j.done.is_set() for j in svc._jobs.values()):
            return
    raise AssertionError("service did not drain")


def _same(res, seq):
    return (res.assignment, res.cost, res.cycle, res.status) == \
        (seq.assignment, seq.cost, seq.cycle, seq.status)


class TestMidflightDeterminism:
    @pytest.mark.parametrize("algo", SUPPORTED_ALGOS)
    def test_job_admitted_midbucket_bit_identical(self, algo, services):
        dcop = _load()
        svc = services()
        a = svc.submit(dcop, algo, seed=0, label="A")
        svc.tick()
        svc.tick()  # A's bucket is now mid-flight (age 14)
        b = svc.submit(dcop, algo, seed=1, label="B")
        _drain(svc)
        assert svc.counters.counts["midflight_admissions"] >= 1
        for jid, seed in ((a, 0), (b, 1)):
            res = svc.result(jid, timeout=1)
            assert _same(res, _standalone(dcop, algo, seed)), (algo, seed)

    def test_smaller_instance_folds_into_running_bucket(self, services):
        big = C.coloring_dcop(20, 40, seed=2)
        small = C.coloring_dcop(10, 20, seed=3)
        svc = services()
        a = svc.submit(big, "mgm", seed=0)
        svc.tick()
        b = svc.submit(small, "mgm", seed=3)
        _drain(svc)
        assert svc.counters.counts["buckets_opened"] == 1
        assert svc.counters.counts["midflight_admissions"] == 1
        for jid, dcop, seed in ((a, big, 0), (b, small, 3)):
            assert _same(svc.result(jid, timeout=1),
                         _standalone(dcop, "mgm", seed))

    @pytest.mark.parametrize("algo,params", [
        ("maxsum", None), ("mgm", None), ("dsa", None),
        ("dsa", {"variant": "C", "probability": 0.8}), ("adsa", None),
        ("gdba", None),
        ("gdba", {"modifier": "M", "violation": "NM", "increase_mode": "R"})])
    def test_every_instance_equals_its_sequential_solve(self, algo, params,
                                                        services):
        """The six test instances and two generated colourings, three
        lanes a bucket, arrivals spread over the first ticks: every job
        equals its standalone solve."""
        dcops = [_load(os.path.join(INSTANCES, n + ".yaml")) for n in NAMES]
        dcops += [C.coloring_dcop(16, 40, seed=7),
                  C.coloring_dcop(9, 20, seed=8)]
        svc = services(lanes=3)
        jids = []
        for k, dcop in enumerate(dcops):
            jids.append(svc.submit(dcop, algo, algo_params=params, seed=k))
            if k % 3 == 2:
                svc.tick()
        _drain(svc)
        for k, (jid, dcop) in enumerate(zip(jids, dcops)):
            res = svc.result(jid, timeout=1)
            assert _same(res, _standalone(dcop, algo, k, params)), \
                (algo, k)


class TestSlotReuse:
    def test_freed_lane_is_reused(self, services):
        dcop = _load()
        svc = services(lanes=1, max_buckets=1)
        a = svc.submit(dcop, "mgm", seed=0)
        b = svc.submit(dcop, "mgm", seed=1)
        _drain(svc)
        assert svc.counters.counts["lanes_reused"] >= 1
        for jid, seed in ((a, 0), (b, 1)):
            assert _same(svc.result(jid, timeout=1),
                         _standalone(dcop, "mgm", seed))

    def test_reused_dsa_lane_restarts_its_own_stream(self, services):
        """A dsa job seated in a lane a previous dsa job freed draws its
        own fresh stream (its solver's generator reseeded)."""
        dcop = _load()
        svc = services(lanes=1, max_buckets=1)
        jids = [svc.submit(dcop, "dsa", seed=s) for s in range(3)]
        _drain(svc)
        assert svc.counters.counts["lanes_reused"] == 2
        for jid, seed in zip(jids, range(3)):
            assert _same(svc.result(jid, timeout=1),
                         _standalone(dcop, "dsa", seed))

    def test_priority_orders_admission(self, services):
        dcop = _load()
        svc = services(lanes=1, max_buckets=1)
        lo = svc.submit(dcop, "mgm", seed=0, priority=0)
        hi = svc.submit(dcop, "mgm", seed=1, priority=5)
        svc.tick()
        res_hi = None
        for _ in range(80):
            if svc._jobs[hi].done.is_set():
                res_hi = svc.result(hi, timeout=1)
                break
            svc.tick()
        assert res_hi is not None
        assert not svc._jobs[lo].done.is_set()
        _drain(svc)
        assert svc.result(lo, timeout=1).status == "FINISHED"


class TestDeadlines:
    def test_expired_deadline_preempts_without_perturbing_others(
            self, services):
        dcop = _load()
        svc = services()
        a = svc.submit(dcop, "mgm", seed=0)
        b = svc.submit(dcop, "mgm", seed=1, deadline_s=1e-4)
        _drain(svc)
        rb = svc.result(b, timeout=1)
        assert rb.status == "TIMEOUT"
        assert rb.cycle < LIMIT
        assert svc.counters.counts["jobs_preempted"] == 1
        assert _same(svc.result(a, timeout=1), _standalone(dcop, "mgm", 0))

    def test_deadline_pressure_shrinks_lane_chunks(self):
        from time import monotonic

        from pydcop_tpu_torch.serve.scheduler import (
            BucketWorker,
            serve_target,
        )

        dcop = _load()
        spec = adapter_for("mgm").build_spec(BatchItem(dcop, "mgm", seed=0))

        class _Job:
            jid = "j0"
            seed = 0
            submitted_at = 0.0
            stream = False
            priority = 0

            def __init__(self):
                self.dcop = dcop
                self.deadline_at = monotonic() + 0.5

        w = BucketWorker("mgm", {}, serve_target([spec.dims]), 1,
                         CompileCache(), limit=2000, device="cpu")
        w.admit(_Job(), spec)
        w.rate = 4.0  # 4 cycles/sec → 0.5 s budget → 2-cycle chunks
        w.step()
        assert w.counters.counts["deadline_shrunk_lanes"] >= 1
        assert w.lanes[0].age < w.chunk

    def test_set_deadline_pressure_reaches_every_bucket(self, services):
        svc = services()
        svc.submit(_load(), "mgm", seed=0)
        svc.tick()
        svc.set_deadline_pressure(0.25, exempt_priority=3)
        w = svc._workers[0]
        assert (w.deadline_pressure, w.pressure_exempt_priority) == (0.25, 3)
        _drain(svc)


class TestPrewarm:
    def test_admission_hits_prewarmed_runner(self, services):
        dcop = _load()
        cache = CompileCache()
        svc = services(cache=cache)
        svc.prewarm([(dcop, "mgm")], block=True)
        assert cache.pool_stats()["prewarmed"] == 1
        assert svc.counters.counts["prewarmed_runners"] == 1
        misses_before = cache.misses
        jid = svc.submit(dcop, "mgm", seed=0)
        _drain(svc)
        assert svc.result(jid, timeout=1).status == "FINISHED"
        assert cache.misses == misses_before
        assert cache.hits >= 1
        assert svc.metrics()["runners"]["regrows"] == 0

    def test_prewarm_without_block_builds_at_the_next_tick(self, services):
        cache = CompileCache()
        svc = services(cache=cache)
        svc.prewarm([(_load(), "mgm")])
        assert cache.pool_stats()["prewarmed"] == 0
        svc.tick()
        assert cache.pool_stats()["prewarmed"] == 1

    def test_prewarm_skips_the_fallback_algorithms(self, services):
        svc = services()
        svc.prewarm([(_load(), "dpop")], block=True)
        assert svc.counters.counts["prewarm_skipped_exact"] == 1
        assert svc.counters.counts["prewarmed_runners"] == 0

    def test_cache_lock_shared_across_threads(self):
        import threading

        cache = CompileCache()
        built = []

        def builder():
            built.append(1)
            return "runner"

        def race():
            cache.get_or_build(("k",), builder)

        ts = [threading.Thread(target=race) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert len(built) == 1
        assert cache.hits == 3 and cache.misses == 1

    def test_predicted_prewarm_and_memo_are_refused(self, services):
        """The portfolio prewarm is still refused; ``memo=`` was refused
        until the solution cache was ported and now builds one
        (``tests/test_torch_memo.py`` holds it to the JAX package)."""
        from pydcop_tpu_torch.serve import MemoCache

        svc = services()
        with pytest.raises(NotPortedError, match="prewarm_predicted"):
            svc.prewarm_predicted([_load()])
        assert isinstance(services(memo=True).memo, MemoCache)


class TestMergeAndEvict:
    def test_underfilled_buckets_merge_bit_identically(self, services):
        """Two same-signature buckets of two lanes; one lane of each
        finishes early (a tight cycle budget on the dsa jobs is not
        possible per job, so mgm at different seeds converging at
        different cycles), and the service folds them."""
        dcops = [C.coloring_dcop(14, 30, seed=s) for s in range(4)]
        svc = services(lanes=2)
        jids = [svc.submit(d, "mgm", seed=s) for s, d in enumerate(dcops)]
        _drain(svc)
        assert svc.counters.counts["buckets_opened"] == 2
        for jid, (s, d) in zip(jids, enumerate(dcops)):
            assert _same(svc.result(jid, timeout=1),
                         _standalone(d, "mgm", s))
        assert svc.counters.counts["buckets_closed"] >= 1

    def test_forced_merge_is_bit_identical(self, services):
        """Four jobs in two buckets; after a step one job of each bucket
        is released by hand so both are under-filled: maintenance merges
        them and the moved lane finishes bit-identically."""
        dcop = _load()
        svc = services(lanes=2)
        jids = [svc.submit(dcop, "dsa", seed=s) for s in range(4)]
        svc.tick()
        assert len(svc._workers) == 2
        # park one job of each bucket back in the queue (fresh restart)
        for w in svc._workers:
            i = next(i for i, ln in enumerate(w.lanes) if ln is not None)
            job = w.lanes[i].job
            w.release(i)
            svc._requeue(job)
        svc.max_buckets = 2
        svc._maintain_workers()
        assert svc.counters.counts["buckets_merged"] == 1
        _drain(svc)
        for jid, seed in zip(jids, range(4)):
            assert _same(svc.result(jid, timeout=1),
                         _standalone(dcop, "dsa", seed))

    def test_worker_migration_preserves_streams(self):
        from time import monotonic

        from pydcop_tpu_torch.serve.scheduler import (
            BucketWorker,
            serve_target,
        )

        dcop = _load()
        adapter = adapter_for("dsa")

        class _Job:
            def __init__(self, seed):
                self.jid = f"j{seed}"
                self.seed = seed
                self.dcop = dcop
                self.deadline_at = None
                self.submitted_at = monotonic()
                self.stream = False
                self.priority = 0

        def run_to_end(w, i):
            for _ in range(40):
                for j, lane, status in w.step():
                    if j == i:
                        return w.lane_result(j, lane, status)
            raise AssertionError("lane did not finish")

        cache = CompileCache()
        spec = adapter.build_spec(BatchItem(dcop, "dsa", seed=5))
        target = serve_target([spec.dims])
        w1 = BucketWorker("dsa", {}, target, 2, cache, limit=LIMIT,
                          device="cpu")
        w1.admit(_Job(5), spec)
        w1.step()
        w1.step()
        w2 = BucketWorker("dsa", {}, target, 2, cache, limit=LIMIT,
                          device="cpu")
        assert w2.runner is not w1.runner  # never share union buffers
        assert w2.migrate_from(w1) == 1
        assert w1.occupied == 0
        i2 = next(i for i, ln in enumerate(w2.lanes) if ln is not None)
        res = run_to_end(w2, i2)
        seq = _standalone(dcop, "dsa", 5)
        assert (res.assignment, res.cycle) == (seq.assignment, seq.cycle)


class TestCrashResume:
    @pytest.mark.parametrize("algo", ["dsa", "maxsum", "gdba"])
    def test_resume_midflight_bit_identical(self, algo, services,
                                            tmp_path):
        dcop = _load()
        jd = str(tmp_path / "journal")
        svc1 = services(journal_dir=jd, checkpoint_every=1)
        a = svc1.submit(dcop, algo, seed=0, source_file=TUTO)
        b = svc1.submit(dcop, algo, seed=1, source_file=TUTO)
        svc1.tick()
        svc1.tick()
        assert svc1.counters.counts["checkpoints_saved"] >= 2
        assert not svc1._jobs[a].done.is_set()
        svc1.halt()  # crash: no drain, no cleanup

        svc2 = services(journal_dir=jd, checkpoint_every=1)
        assert svc2.resume() == 2
        _drain(svc2)
        assert svc2.counters.counts["jobs_resumed"] == 2
        for jid, seed in ((a, 0), (b, 1)):
            assert _same(svc2.result(jid, timeout=1),
                         _standalone(dcop, algo, seed)), (algo, seed)

    def test_completed_jobs_not_rerun_on_resume(self, services, tmp_path):
        dcop = _load()
        jd = str(tmp_path / "journal")
        svc1 = services(journal_dir=jd)
        a = svc1.submit(dcop, "mgm", seed=0, source_file=TUTO)
        _drain(svc1)
        assert svc1.result(a, timeout=1).status == "FINISHED"
        svc2 = services(journal_dir=jd)
        assert svc2.resume() == 0

    def test_corrupt_checkpoint_restarts_from_scratch(self, services,
                                                      tmp_path):
        dcop = _load()
        jd = str(tmp_path / "journal")
        svc1 = services(lanes=1, journal_dir=jd, checkpoint_every=1)
        a = svc1.submit(dcop, "mgm", seed=0, source_file=TUTO)
        svc1.tick()
        ck = svc1._ckpt_path(a)
        assert os.path.exists(ck)
        with open(ck, "r+b") as f:
            f.seek(30)
            f.write(b"\xde\xad\xbe\xef")
        svc1.halt()
        svc2 = services(lanes=1, journal_dir=jd)
        assert svc2.resume() == 1
        _drain(svc2)
        assert _same(svc2.result(a, timeout=1), _standalone(dcop, "mgm", 0))
        assert svc2.counters.counts["jobs_resumed"] == 0


class TestServiceThread:
    def test_background_thread_end_to_end(self, services):
        dcop = _load()
        svc = services()
        svc.start()
        jid = svc.submit(dcop, "mgm", seed=0, stream=True)
        events = list(svc.stream(jid, timeout=30))
        res = svc.result(jid, timeout=30)
        assert _same(res, _standalone(dcop, "mgm", 0))
        kinds = [e["event"] for e in events]
        assert kinds[0] == "job.submitted"
        assert "job.admitted" in kinds and "job.progress" in kinds
        assert kinds[-1] == "job.done"
        cycles = [e["cycle"] for e in events if e["event"] == "job.progress"]
        assert cycles == sorted(cycles) and cycles

    def test_prewarm_while_the_thread_runs_is_built_on_it(self, services):
        import threading

        cache = CompileCache()
        svc = services(cache=cache)
        svc.start()
        seen = []
        orig = cache.prewarm

        def spy(entries):
            seen.append(threading.current_thread() is svc._thread)
            return orig(entries)

        cache.prewarm = spy
        svc.prewarm([(_load(), "mgm")], block=True)
        assert seen == [True]
        assert cache.pool_stats()["prewarmed"] == 1

    @pytest.mark.parametrize("algo,params", [
        ("dpop", {}), ("mgm2", {"favor": "coordinated"})])
    def test_fallback_algo_served(self, algo, params, services):
        dcop = _load()
        svc = services()
        svc.start()
        jid = svc.submit(dcop, algo, algo_params=params, seed=3)
        res = svc.result(jid, timeout=60)
        want = solve_result(dcop, algo, algo_params=params, seed=3,
                            device="cpu")
        assert (res.assignment, res.cost, res.cycle, res.status) == \
            (want.assignment, want.cost, want.cycle, want.status)
        assert svc.counters.counts["jobs_fallback"] == 1
        if algo == "dpop":
            assert res.cost == 12


class TestEventsAndCounters:
    def test_serve_events_emitted(self, services):
        from pydcop_tpu_torch.runtime.events import event_bus

        dcop = _load()
        seen = []
        cb = lambda topic, evt: seen.append((topic, evt))  # noqa: E731
        event_bus.enabled = True
        event_bus.subscribe("serve.*", cb)
        try:
            svc = services()
            jid = svc.submit(dcop, "mgm", seed=0)
            _drain(svc)
            svc.result(jid, timeout=1)
        finally:
            event_bus.unsubscribe(cb)
            event_bus.enabled = False
        topics = [t for t, _ in seen]
        for expected in ("serve.job.submitted", "serve.job.admitted",
                         "serve.bucket.opened", "serve.job.done",
                         "serve.bucket.closed"):
            assert expected in topics, topics

    def test_unknown_counter_rejected(self):
        from pydcop_tpu_torch.runtime.stats import ServeCounters

        with pytest.raises(KeyError):
            ServeCounters().inc("nope")

    def test_metrics_shape(self, services):
        dcop = _load()
        svc = services()
        jid = svc.submit(dcop, "mgm", seed=0)
        _drain(svc)
        svc.result(jid, timeout=1)
        m = svc.metrics()
        assert set(m) == {"serve", "cache", "workers", "pending", "runners"}
        assert set(m["runners"]) == {"eager_calls", "captures", "replays",
                                     "regrows"}
        assert m["serve"]["jobs_completed"] == 1
        assert m["pending"] == 0
        assert svc.result(jid, timeout=1).metrics()["serve"]["jid"] == jid

    def test_service_and_worker_default_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is visible: the default device is usable")
        from pydcop_tpu_torch.serve.scheduler import (
            BucketWorker,
            serve_target,
        )

        with pytest.raises(DeviceUnavailableError):
            SolveService()
        spec = adapter_for("mgm").build_spec(BatchItem(_load(), "mgm"))
        with pytest.raises(DeviceUnavailableError):
            BucketWorker("mgm", {}, serve_target([spec.dims]), 2,
                         CompileCache())


# ---------------------------------------------------------------------------
# against the JAX package: maxsum at noise 0
# ---------------------------------------------------------------------------


def test_maxsum_noise0_equals_the_jax_service(services):
    """The same jobs (four instances, arrivals over the first ticks)
    through JAX's SolveService and the port's: equal assignments, costs
    and stop cycles."""
    params = {"noise": 0}
    names = NAMES[:4]
    svc = services()
    jsvc = JaxSolveService(lanes=2, cache=JaxCompileCache(),
                           max_cycles=LIMIT)
    got, want = [], []
    for k, n in enumerate(names):
        path = os.path.join(INSTANCES, n + ".yaml")
        got.append(svc.submit(_load(path), "maxsum", algo_params=params,
                              seed=k))
        want.append(jsvc.submit(jax_load([path]), "maxsum",
                                algo_params=params, seed=k))
        svc.tick()
        jsvc.tick()
    _drain(svc)
    for _ in range(300):
        if not jsvc.tick():
            break
    assert svc.counters.counts["midflight_admissions"] == \
        jsvc.counters.counts["midflight_admissions"]
    for n, g, w in zip(names, got, want):
        rg, rw = svc.result(g, timeout=1), jsvc.result(w, timeout=1)
        assert rg.assignment == rw.assignment, n
        assert rg.cost == pytest.approx(rw.cost, abs=1e-4), n
        assert (rg.cycle, rg.status) == (rw.cycle, rw.status), n


def test_generated_colourings_equal_the_jax_service_at_noise0(services):
    """Mixed sizes folding into one bucket, maxsum noise 0, against the
    JAX package's service on the same colourings (built by each
    package from the same numpy arrays)."""
    from pydcop_tpu.dcop import (
        DCOP as JDCOP,
        Domain as JDomain,
        NAryMatrixRelation as JRel,
        Variable as JVariable,
    )

    def jax_coloring(V, E, seed):
        ei, ej, mats, _ = C.coloring_arrays(V, E, seed=seed)
        d = JDomain("colors", "color", [0, 1, 2])
        vs = [JVariable(f"v{i:06d}", d) for i in range(V)]
        dcop = JDCOP("coloring")
        for v in vs:
            dcop.add_variable(v)
        for k in range(E):
            dcop.add_constraint(JRel([vs[ei[k]], vs[ej[k]]], mats[k],
                                     name=f"c{k:06d}"))
        return dcop

    shapes = [(20, 40, 1), (10, 20, 2), (20, 40, 3)]
    params = {"noise": 0}
    svc = services(lanes=3)
    jsvc = JaxSolveService(lanes=3, cache=JaxCompileCache(),
                           max_cycles=LIMIT)
    got = [svc.submit(C.coloring_dcop(V, E, seed=s), "maxsum",
                      algo_params=params, seed=s) for V, E, s in shapes]
    want = [jsvc.submit(jax_coloring(V, E, s), "maxsum",
                        algo_params=params, seed=s) for V, E, s in shapes]
    _drain(svc)
    for _ in range(300):
        if not jsvc.tick():
            break
    for g, w in zip(got, want):
        rg, rw = svc.result(g, timeout=1), jsvc.result(w, timeout=1)
        assert rg.assignment == rw.assignment
        assert rg.cost == pytest.approx(rw.cost, abs=1e-4)
        assert rg.cycle == rw.cycle
    assert np.isfinite([svc.result(g, timeout=1).cost for g in got]).all()
