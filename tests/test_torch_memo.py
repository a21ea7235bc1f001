"""The port's cross-request solution cache (``serve/memo.py``) and its
service integration, on the CPU, case by case after the JAX package's
``tests/unit/test_memo.py`` (every class but ``TestFleetSharing``: the
fleets are not ported):

* **hit taxonomy** — a miss, then an exact hit replaying the cached
  result bit-identically; seed, algo, params and tenant are namespaces;
  a one-edit variant is warm-repaired (one edit replayed); the
  feasibility gate refuses a large diff; a non-warm algo never matches a
  variant;
* **never-worse** — per warm algo (mgm, dsa, adsa, maxsum) a served
  variant costs no more than the cold solve of the same variant, and a
  one-cycle budget cannot make the gate serve a regression;
* **invalidation** — TTL expiry, tenant-scoped churn, LRU eviction;
* **persistence** — rehydrate restores exact hits, a corrupt entry is
  skipped and counted and never served, peer adoption by file and by
  entry; and across the packages: a JAX-written entry file rehydrates
  into the port's cache and serves an exact hit equal to JAX's result,
  a port-written file loads in JAX's ``MemoCache``;
* **the warm path's refusals and faults** — ``HeadroomExhausted`` past
  the one repack and a rejected mutation are counted cold fallbacks; a
  device-style error inside the warm repair ends the served job
  ``ERROR``, never solved cold;
* **service integration** (tick-driven) — an exact hit makes no runner
  call, a variant carries its provenance and the guarantee, ``resume()``
  rehydrates the cache, the ``corrupt_cache_entry`` fault is skipped and
  counted, ``churn_event`` invalidates, ``metrics()["memo"]``.

Instances are 10-variable colourings (60 for maxsum's never-worse, as in
the JAX test), made with the JAX package's generator and loaded from the
same YAML by both packages."""
import os
import time

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.runtime.repair import perturbed_constraint as jax_perturbed
from pydcop_tpu.serve.memo import MemoCache as JaxMemoCache
from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.repair import perturbed_constraint
from pydcop_tpu_torch.runtime.stats import MEMO_COUNTERS, MemoCounters
from pydcop_tpu_torch.serve import MemoCache, MemoConfig, SolveService
from pydcop_tpu_torch.serve.memo import _exact_key

torch.set_num_threads(1)

_YAMLS = {}


def _yaml(seed=3, n=10):
    if (seed, n) not in _YAMLS:
        from pydcop_tpu.dcop.yamldcop import dcop_yaml
        from pydcop_tpu.generators import generate_graph_coloring

        _YAMLS[seed, n] = dcop_yaml(generate_graph_coloring(
            n_variables=n, n_colors=3, n_edges=2 * n - 2, soft=True,
            seed=seed))
    return _YAMLS[seed, n]


def _instance(seed=3, n=10):
    return tdc.load_dcop(_yaml(seed, n))


def _variant(seed=3, n=10, edit_seed=9, which=2):
    """The base instance with ONE constraint's table jittered."""
    d = _instance(seed, n)
    name = sorted(d.constraints)[which]
    d.constraints[name] = perturbed_constraint(d.constraints[name],
                                               seed=edit_seed)
    return d


def _cold(dcop, algo, seed=1, cycles=300):
    return solve_result(dcop, algo, seed=seed, cycles=cycles, device="cpu")


def _cache(**kw):
    return MemoCache(MemoConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# cache core: hit taxonomy
# ---------------------------------------------------------------------------


class TestHitTaxonomy:
    def test_miss_then_exact_hit_bit_identical(self):
        cache = _cache()
        d = _instance()
        p1 = cache.probe(d, "mgm", seed=1)
        assert p1.kind == "miss"
        cold = _cold(d, "mgm")
        assert cache.memoize(p1, d, cold) is not None
        p2 = cache.probe(d, "mgm", seed=1)
        assert p2.kind == "exact"
        res = cache.result_from_entry(p2.entry, p2)
        assert res.assignment == cold.assignment
        assert res.cost == cold.cost and res.cycle == cold.cycle
        assert res.memo["hit"] == "exact"
        assert res.metrics()["memo"]["hit"] == "exact"

    def test_seed_algo_params_tenant_are_namespaces(self):
        cache = _cache()
        d = _instance()
        p = cache.probe(d, "mgm", seed=1, tenant="t1")
        cache.memoize(p, d, _cold(d, "mgm"))
        assert cache.probe(d, "mgm", seed=2, tenant="t1").kind != "exact"
        assert cache.probe(d, "dsa", seed=1, tenant="t1").kind != "exact"
        assert cache.probe(d, "mgm", seed=1, tenant="t2").kind != "exact"
        assert cache.probe(d, "mgm", seed=1, tenant="t1",
                           algo_params={"x": 1}).kind != "exact"
        assert cache.probe(d, "mgm", seed=1, tenant="t1").kind == "exact"

    def test_exact_key_equals_jax(self):
        from pydcop_tpu.serve.memo import _exact_key as jax_key

        args = ("t1", "mgm", '{"noise":0.0}', 3, "ab" * 32)
        assert _exact_key(*args) == jax_key(*args)

    def test_variant_hit_replays_factor_diff_warm(self):
        cache = _cache()
        d, v = _instance(), _variant()
        p = cache.probe(d, "mgm", seed=1)
        cold = _cold(d, "mgm")
        cache.memoize(p, d, cold)
        pv = cache.probe(v, "mgm", seed=1)
        assert pv.kind == "variant" and pv.diff.edits == 1
        res = cache.serve_variant(pv, v)
        assert res is not None
        assert res.memo["hit"] == "variant" and res.memo["edits"] == 1
        _viol, c_seed = v.solution_cost(dict(cold.assignment), 1e9)
        assert res.cost <= c_seed + 1e-6
        assert res.memo["seed_cost"] == pytest.approx(c_seed)

    def test_precomputed_artifacts_probe_alike(self):
        """``probe(artifacts=canonicalize(dcop))`` — the serve tier's
        prep-thread path — classifies as the plain probe does."""
        cache = _cache()
        d = _instance()
        cache.memoize(cache.probe(d, "mgm", seed=1), d, _cold(d, "mgm"))
        for sub in (_instance(), _variant(), _instance(seed=5)):
            a = cache.probe(sub, "mgm", seed=1)
            b = cache.probe(sub, "mgm", seed=1,
                            artifacts=cache.canonicalize(sub))
            assert (a.kind, a.key, a.shape_sig, a.digests) == \
                (b.kind, b.key, b.shape_sig, b.digests)
            assert (a.diff is None) == (b.diff is None)
            if a.diff is not None:
                assert vars(a.diff) == vars(b.diff)

    def test_counters_follow_jax_over_a_mixed_bucket(self, monkeypatch):
        """Entries of one shape (two bases, two seeds of one), probed by
        a variant, a stranger and duplicates: every counter equals the
        JAX cache's; a probe no candidate's diff lets through featurizes
        nothing."""
        from pydcop_tpu_torch.portfolio import features as tf

        calls = []
        real = tf.featurize
        monkeypatch.setattr(tf, "featurize",
                            lambda d, *a, **k: calls.append(1) or
                            real(d, *a, **k))
        stats = []
        for pkg, cache, perturb in (
                (tdc, _cache(), perturbed_constraint),
                (jdc, JaxMemoCache(), jax_perturbed)):
            res = _cold(_instance(), "mgm")
            for seed, s in ((3, 1), (3, 2), (4, 1)):
                d = pkg.load_dcop(_yaml(seed))
                cache.memoize(cache.probe(d, "mgm", seed=s), d, res)
            if pkg is tdc:
                n = len(calls)
                stranger = pkg.load_dcop(_yaml(7))
                assert cache.probe(stranger, "mgm", seed=1).kind == "miss"
                assert len(calls) == n  # refused by the gate, unranked
            else:
                cache.probe(pkg.load_dcop(_yaml(7)), "mgm", seed=1)
            v = pkg.load_dcop(_yaml(3))
            name = sorted(v.constraints)[2]
            v.constraints[name] = perturb(v.constraints[name], seed=9)
            pv = cache.probe(v, "mgm", seed=1)
            assert pv.kind == "variant"
            cache.probe(pkg.load_dcop(_yaml(4)), "mgm", seed=1)
            stats.append((cache.stats(), pv.entry.key, pv.distance))
        assert stats[0] == stats[1]

    def test_variant_gate_rejects_large_diffs(self):
        cache = _cache(max_edits=1)
        d = _instance()
        cache.memoize(cache.probe(d, "mgm", seed=1), d, _cold(d, "mgm"))
        v = _instance()
        for which in (1, 2, 3):
            name = sorted(v.constraints)[which]
            v.constraints[name] = perturbed_constraint(
                v.constraints[name], seed=11 + which)
        pv = cache.probe(v, "mgm", seed=1)
        assert pv.kind == "miss"
        assert cache.counters.counts["variant_rejected_gate"] >= 1

    def test_non_warm_algo_never_matches_variants(self):
        cache = _cache()
        d = _instance()
        cache.memoize(cache.probe(d, "gdba", seed=1), d, _cold(d, "gdba"))
        assert cache.probe(d, "gdba", seed=1).kind == "exact"
        assert cache.probe(_variant(), "gdba", seed=1).kind == "miss"

    def test_variant_ranking_by_features(self):
        """Two cached entries in one bucket (the same base under two
        seeds): the variant matches the entry the JAX cache picks — by
        feature distance, then insertion order."""
        out = []
        for pkg, cache in ((tdc, _cache()), (jdc, JaxMemoCache())):
            for s in (4, 3):
                d = pkg.load_dcop(_yaml(3))
                p = cache.probe(d, "mgm", seed=s)
                res = _cold(_instance(3), "mgm")
                cache.memoize(p, d, res)
            v = pkg.load_dcop(_yaml(3))
            name = sorted(v.constraints)[2]
            perturb = perturbed_constraint if pkg is tdc else jax_perturbed
            v.constraints[name] = perturb(v.constraints[name], seed=9)
            pv = cache.probe(v, "mgm", seed=3)
            out.append((pv.kind, pv.entry.key, pv.diff.as_dict(),
                        pv.distance))
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# never-worse guarantee, per warm-capable algo
# ---------------------------------------------------------------------------


class TestNeverWorse:
    @pytest.mark.parametrize("algo", ["mgm", "dsa", "adsa", "maxsum"])
    def test_warm_cost_never_worse_than_cold_same_seed(self, algo):
        n = 60 if algo == "maxsum" else 10
        cache = _cache()
        d, v = _instance(n=n), _variant(n=n)
        cache.memoize(cache.probe(d, algo, seed=1), d, _cold(d, algo))
        pv = cache.probe(v, algo, seed=1)
        assert pv.kind == "variant"
        res = cache.serve_variant(pv, v)
        cold_v = _cold(v, algo)
        if res is None:
            assert cache.counters.counts["variant_cold_fallbacks"] >= 1
        else:
            assert res.cost <= cold_v.cost + 1e-6

    def test_gate_falls_back_instead_of_serving_regression(self):
        cache = _cache(warm_max_cycles=1)
        d, v = _instance(), _variant()
        cache.memoize(cache.probe(d, "mgm", seed=1), d, _cold(d, "mgm"))
        pv = cache.probe(v, "mgm", seed=1)
        res = cache.serve_variant(pv, v)
        if res is not None:
            _viol, c_seed = v.solution_cost(dict(pv.entry.assignment), 1e9)
            assert res.cost <= c_seed + 1e-6


# ---------------------------------------------------------------------------
# the warm path's refusals (cold fallback) and faults (propagate)
# ---------------------------------------------------------------------------


class TestWarmPathRefusalsAndFaults:
    def _variant_probe(self, **cfg):
        cache = _cache(**cfg)
        d, v = _instance(), _variant()
        cache.memoize(cache.probe(d, "mgm", seed=1), d, _cold(d, "mgm"))
        return cache, v, cache.probe(v, "mgm", seed=1)

    def test_exhaustion_past_the_repack_is_a_cold_fallback(
            self, monkeypatch):
        from pydcop_tpu_torch.ops.headroom import HeadroomExhausted
        from pydcop_tpu_torch.runtime import repair

        def exhausted(self, muts, kind, target):
            raise HeadroomExhausted("no free slot, even after the repack")

        monkeypatch.setattr(repair.WarmRepairController, "apply",
                            exhausted)
        cache, v, pv = self._variant_probe()
        assert cache.serve_variant(pv, v) is None
        assert cache.counters.counts["variant_cold_fallbacks"] == 1

    def test_rejected_mutation_is_a_cold_fallback(self):
        cache, v, pv = self._variant_probe()
        # a changed constraint whose scope differs: the warm layer
        # refuses the edit (ValueError)
        name = pv.diff.changed[0]
        c = v.constraints[name]
        others = [x for x in v.variables.values()
                  if x.name not in c.scope_names]
        v.constraints[name] = tdc.constraint_from_str(
            name, f"{others[0].name} + {others[1].name}", others[:2])
        assert cache.serve_variant(pv, v) is None
        assert cache.counters.counts["variant_cold_fallbacks"] == 1

    @pytest.mark.parametrize("exc", [
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        torch.cuda.OutOfMemoryError("CUDA out of memory"),
    ])
    def test_device_fault_propagates(self, exc, monkeypatch):
        from pydcop_tpu_torch.algorithms import warm

        def boom(self, *a, **k):
            raise exc

        monkeypatch.setattr(warm._WarmMixin, "run", boom)
        cache, v, pv = self._variant_probe()
        with pytest.raises(type(exc)):
            cache.serve_variant(pv, v)
        assert cache.counters.counts["variant_cold_fallbacks"] == 0

    @pytest.mark.parametrize("where", ["build", "run"])
    @pytest.mark.parametrize("exc", [ValueError, KeyError])
    def test_error_outside_the_replay_propagates(self, where, exc,
                                                 monkeypatch):
        """Only the factor diff's replay may fall back cold: a ValueError
        or KeyError from building the warm engine or from its run is a
        fault of the warm path, not a refusal."""
        from pydcop_tpu_torch.algorithms import warm
        from pydcop_tpu_torch.runtime import repair

        def boom(self, *a, **k):
            raise exc("a fault inside the warm engine")

        if where == "build":
            monkeypatch.setattr(repair.WarmRepairController, "__init__",
                                boom)
        else:
            monkeypatch.setattr(warm._WarmMixin, "run", boom)
        cache, v, pv = self._variant_probe()
        with pytest.raises(exc):
            cache.serve_variant(pv, v)
        assert cache.counters.counts["variant_cold_fallbacks"] == 0

    def test_value_error_inside_run_ends_the_served_job_error(
            self, monkeypatch):
        from pydcop_tpu_torch.algorithms import warm

        svc = _svc()
        d, v = _instance(), _variant()
        j1 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        svc.result(j1, timeout=5)

        def boom(self, *a, **k):
            raise ValueError("a fault inside the warm engine's run")

        monkeypatch.setattr(warm._WarmMixin, "run", boom)
        calls = svc.metrics()["runners"]
        j2 = svc.submit(v, "mgm", seed=1)
        _drain(svc)
        r2 = svc.result(j2, timeout=5)
        assert r2.status == "ERROR" and r2.assignment == {}
        m = svc.metrics()
        assert m["memo"]["variant_cold_fallbacks"] == 0
        assert m["memo"]["hits_variant"] == 1
        assert m["runners"] == calls
        svc.stop(drain=False)

    def test_device_fault_ends_the_served_job_error(self, monkeypatch):
        from pydcop_tpu_torch.algorithms import warm
        from pydcop_tpu_torch.errors import DeviceUnavailableError

        svc = _svc()
        d, v = _instance(), _variant()
        j1 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        svc.result(j1, timeout=5)

        def boom(self, *a, **k):
            raise DeviceUnavailableError("the card fell off the bus")

        monkeypatch.setattr(warm._WarmMixin, "run", boom)
        calls = svc.metrics()["runners"]
        j2 = svc.submit(v, "mgm", seed=1)
        _drain(svc)
        r2 = svc.result(j2, timeout=5)
        assert r2.status == "ERROR" and r2.assignment == {}
        m = svc.metrics()
        assert m["memo"]["variant_cold_fallbacks"] == 0
        assert m["memo"]["hits_variant"] == 1
        # not solved cold behind the error: no runner ran for it
        assert m["runners"] == calls
        svc.stop(drain=False)


# ---------------------------------------------------------------------------
# invalidation: TTL / churn / LRU
# ---------------------------------------------------------------------------


class TestInvalidation:
    def test_ttl_expiry_drops_entries(self):
        cache = _cache(ttl_s=0.01)
        d = _instance()
        cache.memoize(cache.probe(d, "mgm", seed=1), d, _cold(d, "mgm"))
        time.sleep(0.05)
        assert cache.probe(d, "mgm", seed=1).kind == "miss"
        assert cache.counters.counts["expired_ttl"] == 1
        assert len(cache) == 0

    def test_churn_event_is_tenant_scoped(self):
        cache = _cache()
        d = _instance()
        cold = _cold(d, "mgm")
        for tenant in ("t1", "t2"):
            cache.memoize(cache.probe(d, "mgm", seed=1, tenant=tenant), d,
                          cold)
        assert cache.churn_event("t1") == 1
        assert cache.probe(d, "mgm", seed=1, tenant="t1").kind == "miss"
        assert cache.probe(d, "mgm", seed=1, tenant="t2").kind == "exact"
        assert cache.churn_event() == 1

    def test_lru_eviction_bounds_the_cache(self):
        cache = _cache(max_entries=2)
        cold = _cold(_instance(), "mgm")
        for s in range(4):
            d = _instance(seed=s)
            cache.memoize(cache.probe(d, "mgm", seed=1), d, cold)
        assert len(cache) == 2
        assert cache.counters.counts["evicted_lru"] == 2

    def test_counters_schema_is_closed_and_jax_named(self):
        from pydcop_tpu.runtime.stats import MEMO_COUNTERS as J

        assert MEMO_COUNTERS == J
        with pytest.raises(KeyError):
            MemoCounters().inc("nope")
        assert set(_cache().stats()) == set(J) | {"entries", "tenants"}


# ---------------------------------------------------------------------------
# persistence: rehydrate / corruption / adoption / across the packages
# ---------------------------------------------------------------------------


class TestPersistence:
    def _populated(self, tmp_path):
        cache = MemoCache(directory=str(tmp_path / "memo"), device="cpu")
        d = _instance()
        cold = _cold(d, "mgm")
        entry = cache.memoize(cache.probe(d, "mgm", seed=1), d, cold)
        return cache, d, cold, entry

    def test_rehydrate_restores_exact_hits(self, tmp_path):
        cache, d, cold, entry = self._populated(tmp_path)
        assert entry.path and os.path.exists(entry.path)
        fresh = MemoCache(directory=cache.directory, device="cpu")
        assert fresh.rehydrate() == 1
        p = fresh.probe(d, "mgm", seed=1)
        assert p.kind == "exact"
        res = fresh.result_from_entry(p.entry, p)
        assert res.assignment == cold.assignment and res.cost == cold.cost

    def test_corrupt_entry_skipped_and_counted_never_served(self, tmp_path):
        cache, d, _cold_res, entry = self._populated(tmp_path)
        assert cache.corrupt_entry(entry.key) == entry.path
        fresh = MemoCache(directory=cache.directory, device="cpu")
        assert fresh.rehydrate() == 0
        assert fresh.counters.counts["corrupt_skipped"] == 1
        assert fresh.probe(d, "mgm", seed=1).kind == "miss"

    def test_adopt_file_peer_sharing(self, tmp_path):
        cache, d, cold, entry = self._populated(tmp_path)
        peer = _cache()
        assert peer.adopt_file(entry.path)
        p = peer.probe(d, "mgm", seed=1)
        assert p.kind == "exact"
        assert peer.result_from_entry(p.entry, p).cost == cold.cost
        peer.churn_event()
        assert os.path.exists(entry.path)

    def test_adopt_file_refuses_corrupt_peer_entry(self, tmp_path):
        cache, d, _cold_res, entry = self._populated(tmp_path)
        cache.corrupt_entry(entry.key)
        peer = _cache()
        assert not peer.adopt_file(entry.path)
        assert peer.counters.counts["corrupt_skipped"] == 1
        assert len(peer) == 0

    def test_adopt_entry_dedupes_by_key(self, tmp_path):
        cache, d, _cold_res, entry = self._populated(tmp_path)
        peer = _cache()
        assert peer.adopt_entry(entry)
        assert not peer.adopt_entry(entry)
        assert peer.counters.counts["adopted"] == 1

    def test_jax_written_entry_serves_an_exact_hit(self, tmp_path):
        from pydcop_tpu.runtime.run import solve_result as jax_solve

        jd = jdc.load_dcop(_yaml())
        jcache = JaxMemoCache(directory=str(tmp_path / "memo"))
        jres = jax_solve(jd, "mgm", seed=1, cycles=50)
        jentry = jcache.memoize(jcache.probe(jd, "mgm", seed=1), jd, jres)
        assert jentry is not None and os.path.exists(jentry.path)
        port = MemoCache(directory=jcache.directory, device="cpu")
        assert port.rehydrate() == 1
        p = port.probe(_instance(), "mgm", seed=1)
        assert p.kind == "exact" and p.key == jentry.key
        res = port.result_from_entry(p.entry, p)
        assert res.assignment == jres.assignment
        assert (res.cost, res.cycle, res.status) == \
            (jres.cost, jres.cycle, jres.status)

    def test_port_written_entry_loads_in_jax(self, tmp_path):
        cache, d, cold, entry = self._populated(tmp_path)
        jcache = JaxMemoCache(directory=cache.directory)
        assert jcache.rehydrate() == 1
        p = jcache.probe(jdc.load_dcop(_yaml()), "mgm", seed=1)
        assert p.kind == "exact" and p.key == entry.key
        res = jcache.result_from_entry(p.entry, p)
        assert res.assignment == cold.assignment and res.cost == cold.cost
        # its features are the port's featurizer's, which equals JAX's
        assert np.array_equal(p.entry.features, entry.features)


# ---------------------------------------------------------------------------
# service integration (tick-driven — no scheduler thread)
# ---------------------------------------------------------------------------


def _drain(svc, max_ticks=300):
    for _ in range(max_ticks):
        if not svc.tick():
            return


def _svc(tmp_path=None, **kw):
    jd = str(tmp_path / "journal") if tmp_path is not None else None
    kw.setdefault("memo", True)
    return SolveService(lanes=4, cache=CompileCache(), journal_dir=jd,
                        device="cpu", **kw)


class TestServiceIntegration:
    def test_exact_hit_serves_without_solving(self):
        svc = _svc()
        d = _instance()
        j1 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        r1 = svc.result(j1, timeout=5)
        assert r1.metrics()["memo"]["hit"] == "miss"
        calls = svc.metrics()["runners"]
        j2 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        r2 = svc.result(j2, timeout=5)
        assert r2.metrics()["memo"]["hit"] == "exact"
        assert r2.assignment == r1.assignment and r2.cost == r1.cost
        m = svc.metrics()
        assert m["memo"]["hits_exact"] == 1
        assert m["runners"] == calls  # no runner call for the hit
        assert m["serve"]["jobs_completed"] == 2
        svc.stop(drain=False)

    def test_variant_hit_provenance_and_guarantee(self):
        svc = _svc()
        d, v = _instance(), _variant()
        j1 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        r1 = svc.result(j1, timeout=5)
        j2 = svc.submit(v, "mgm", seed=1)
        _drain(svc)
        r2 = svc.result(j2, timeout=5)
        m = r2.metrics()["memo"]
        assert m["hit"] in ("variant", "miss")
        if m["hit"] == "variant":
            assert m["edits"] == 1
            _viol, c_seed = v.solution_cost(dict(r1.assignment), 1e9)
            assert r2.cost <= c_seed + 1e-6
        else:
            assert m.get("cold_fallback")
        svc.stop(drain=False)

    def test_resume_rehydrates_cache(self, tmp_path):
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        svc = _svc(tmp_path)
        d = _instance()
        yaml_path = tmp_path / "inst.yaml"
        yaml_path.write_text(dcop_yaml(d))
        j1 = svc.submit(d, "mgm", seed=1, source_file=str(yaml_path))
        _drain(svc)
        r1 = svc.result(j1, timeout=5)
        svc.stop(drain=False)

        svc2 = _svc(tmp_path)
        svc2.resume()
        assert svc2.metrics()["memo"]["rehydrated"] == 1
        j2 = svc2.submit(d, "mgm", seed=1)
        _drain(svc2)
        r2 = svc2.result(j2, timeout=5)
        assert r2.metrics()["memo"]["hit"] == "exact"
        assert r2.assignment == r1.assignment and r2.cost == r1.cost
        svc2.stop(drain=False)

    def test_corrupt_cache_entry_fault_plan(self, tmp_path):
        from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan

        plan = FaultPlan(faults=[Fault(kind="corrupt_cache_entry",
                                       jid="job-000001")], seed=7)
        svc = _svc(tmp_path, fault_plan=plan)
        d = _instance()
        j1 = svc.submit(d, "mgm", seed=1)
        _drain(svc)
        svc.result(j1, timeout=5)
        assert svc.counters.counts["faults_injected"] >= 1
        svc.stop(drain=False)
        svc2 = _svc(tmp_path)
        svc2.resume()
        m = svc2.metrics()["memo"]
        assert m["corrupt_skipped"] == 1 and m["rehydrated"] == 0
        j2 = svc2.submit(d, "mgm", seed=1)
        _drain(svc2)
        r2 = svc2.result(j2, timeout=5)
        assert r2.metrics()["memo"]["hit"] == "miss"
        svc2.stop(drain=False)

    def test_churn_event_invalidates_served_results(self):
        svc = _svc()
        d = _instance()
        j1 = svc.submit(d, "mgm", seed=1, tenant="t1")
        _drain(svc)
        svc.result(j1, timeout=5)
        assert svc.churn_event("t1") == 1
        j2 = svc.submit(d, "mgm", seed=1, tenant="t1")
        _drain(svc)
        assert svc.result(j2, timeout=5).metrics()["memo"]["hit"] == "miss"
        assert svc.metrics()["memo"]["invalidated_churn"] == 1
        svc.stop(drain=False)

    def test_memo_forms_and_the_default_off(self):
        for memo in (True, MemoConfig(ttl_s=5.0), _cache()):
            svc = _svc(memo=memo)
            assert isinstance(svc.memo, MemoCache)
            if isinstance(memo, MemoConfig):
                assert svc.memo.config.ttl_s == 5.0
            if isinstance(memo, MemoCache):
                assert svc.memo is memo
            svc.stop(drain=False)
        svc = _svc(memo=None)
        assert svc.memo is None and "memo" not in svc.metrics()
        assert svc.churn_event() == 0
        svc.stop(drain=False)
