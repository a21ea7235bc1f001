"""The port's runner artifacts (``pydcop_tpu_torch/serve/artifacts.py``)
on the CPU, after the JAX package's ``tests/unit/test_artifacts.py``,
case for case, in the port's own terms: an artifact is a bucket runner's
RECIPE (algorithm, params, padded target, lanes, chunk, rank-table
depths), and a load rebuilds, warms and — on the card — captures the
runner.  Its own round trip, not the JAX one:

* a runner built with ``warm_bucket_runner(aot=True)`` round-trips
  through the store into a runner with the same recipe and the same
  buffers, and a service that takes it solves a job bit-identically to
  its standalone solve;
* version/ABI pinning: another format version, torch/CUDA/device or
  kernel build (the hash of ``csrc/`` and the ``nvcc`` flags) is a
  **stale** refusal — never rebuilt;
* corruption (flipped payload byte, truncated file) is a **corrupt**
  refusal caught by the CRC/structure checks — counted, rebuilt,
  overwritten;
* the runner cache counts an artifact load as ``artifact_hits`` (NOT a
  miss) — the cold-join pin ``misses == 0`` reads straight off these
  counters — and a serve worker's fresh runner is exported after its
  first step for the next process.
"""
import json
import os

import pytest
import torch

from pydcop_tpu_torch.batch import CompileCache
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import cuda_build
from pydcop_tpu_torch.serve import SolveService
from pydcop_tpu_torch.serve.artifacts import (
    ARTIFACT_FORMAT,
    ArtifactStore,
    abi_tag,
    artifact_name,
    corrupt_artifact_file,
    kernel_hash,
    runner_from_recipe,
)
from pydcop_tpu_torch.serve.scheduler import serve_target, warm_bucket_runner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
LIMIT = 63
CHUNK = 7
KEY = ("dsa", (), "constraints_hypergraph", (2,), 5, "chunk", 7,
       "device", "cpu")


def _aot_runner(algo="dsa", lanes=2):
    """A warmed bucket runner that carries its recipe."""
    adapter = adapter_for(algo)
    spec = adapter.build_spec(BatchItem(load_dcop_from_file(TUTO), algo))
    target = serve_target([spec.dims])
    like = [adapter.lane_arrays(spec, target, spread=True)]
    return warm_bucket_runner(adapter, target, {}, lanes, CHUNK, aot=True,
                              device="cpu", like=like)


def _store(tmp_path):
    return ArtifactStore(str(tmp_path), device="cpu")


class TestStoreRoundtrip:
    def test_save_load_same_runner(self, tmp_path):
        runner = _aot_runner()
        path = _store(tmp_path).save(KEY, runner)
        assert path and os.path.exists(path)
        loaded = _store(tmp_path).load(KEY)
        assert loaded is not None and loaded is not runner
        assert loaded.recipe == runner.recipe
        assert loaded.union.depths() == runner.union.depths()
        assert (loaded.B, loaded.chunk, loaded.meta) == \
            (runner.B, runner.chunk, runner.meta)
        # warmed like its source: the warm-up call and the (CPU) chunk
        assert loaded.calls() == runner.calls()

    def test_plain_miss_counts_miss(self, tmp_path):
        store = _store(tmp_path)
        assert store.load(KEY) is None
        assert store.stats()["misses"] == 1

    def test_runner_without_recipe_not_exported(self, tmp_path):
        store = _store(tmp_path)
        assert store.save(KEY, lambda *a: None) is None
        assert store.stats()["entries"] == 0

    def test_name_is_stable(self):
        assert artifact_name(KEY) == artifact_name(KEY)
        assert artifact_name(KEY) != artifact_name(KEY[:-1] + ("cuda",))


class TestRejections:
    def _saved(self, tmp_path):
        store = _store(tmp_path)
        return store, store.save(KEY, _aot_runner())

    def _rewrite_header(self, path, **changes):
        raw = open(path, "rb").read()
        nl = raw.find(b"\n")
        header = dict(json.loads(raw[:nl]), **changes)
        with open(path, "wb") as f:
            f.write(json.dumps(header, sort_keys=True).encode()
                    + b"\n" + raw[nl + 1:])

    def test_corrupt_payload_rejected_loudly(self, tmp_path, caplog):
        _store_, path = self._saved(tmp_path)
        assert corrupt_artifact_file(path, seed=3)
        fresh = _store(tmp_path)
        with caplog.at_level("WARNING"):
            assert fresh.load(KEY) is None
        assert fresh.stats()["rejected_corrupt"] == 1
        assert any("CORRUPT" in r.message for r in caplog.records)

    def test_truncated_file_rejected(self, tmp_path):
        _store_, path = self._saved(tmp_path)
        raw = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(raw[: len(raw) // 2])
        fresh = _store(tmp_path)
        assert fresh.load(KEY) is None
        assert fresh.stats()["rejected_corrupt"] == 1

    def test_stale_format_version_refused(self, tmp_path, caplog):
        _store_, path = self._saved(tmp_path)
        self._rewrite_header(path, format=ARTIFACT_FORMAT + 1)
        fresh = _store(tmp_path)
        with caplog.at_level("WARNING"):
            assert fresh.load(KEY) is None
        assert fresh.stats()["rejected_stale"] == 1
        assert any("STALE" in r.message for r in caplog.records)

    @pytest.mark.parametrize("field,value", [
        ("torch", "0.0.1-elsewhere"), ("device", "another card"),
        ("kernels", "0" * 16)])
    def test_stale_abi_refused(self, tmp_path, field, value):
        """An artifact written under another torch, device or kernel
        build is refused before its recipe is read."""
        store, path = self._saved(tmp_path)
        self._rewrite_header(path, abi=dict(store.abi(), **{field: value}))
        fresh = _store(tmp_path)
        assert fresh.load(KEY) is None
        assert fresh.stats()["rejected_stale"] == 1

    def test_rebuild_overwrites_bad_artifact(self, tmp_path):
        _store_, path = self._saved(tmp_path)
        corrupt_artifact_file(path)
        fresh = _store(tmp_path)
        assert fresh.load(KEY) is None
        assert fresh.save(KEY, _aot_runner()) == path
        assert fresh.load(KEY) is not None

    def test_abi_tag_shape(self):
        tag = abi_tag("cpu")
        assert set(tag) == {"torch", "cuda", "device", "capability",
                            "kernels"}
        assert tag["device"] == "cpu" and tag["torch"] == torch.__version__
        assert tag["kernels"] == kernel_hash()

    def test_an_edited_kernel_makes_artifacts_stale(self, tmp_path,
                                                    monkeypatch):
        """The ABI's kernel hash covers every csrc source and the nvcc
        flags: editing either changes it."""
        before = kernel_hash()
        csrc = tmp_path / "pkg" / "csrc"
        csrc.mkdir(parents=True)
        for p in (cuda_build.PKG_DIR / "csrc").iterdir():
            (csrc / p.name).write_bytes(p.read_bytes())
        monkeypatch.setattr(cuda_build, "PKG_DIR", tmp_path / "pkg")
        assert kernel_hash() == before
        with open(csrc / "mgm2.cu", "a") as f:
            f.write("\n// edited\n")
        edited = kernel_hash()
        assert edited != before
        monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                            cuda_build.NVCC_FLAGS + ["-lineinfo"])
        assert kernel_hash() not in (before, edited)


class TestCacheIntegration:
    def test_artifact_hit_is_not_a_miss(self, tmp_path):
        """The cold-join pin's arithmetic: a peer's exported runner
        loads with misses == 0 and artifact_hits == entries."""
        _store(tmp_path).save(KEY, _aot_runner())
        cold = CompileCache(artifacts=_store(tmp_path))
        runner, warm = cold.checkout(
            KEY, lambda: pytest.fail("must not build"))
        assert warm and runner.recipe["algo"] == "dsa"
        cold.checkin(KEY, runner)
        stats = cold.stats()
        assert stats["misses"] == 0
        assert stats["artifact_hits"] == 1
        assert stats["entries"] == 1
        assert cold.has(KEY) and cold.key_strings() == [
            "/".join(map(str, KEY))]

    def test_cold_build_exports_for_the_next_process(self, tmp_path):
        """A service's fresh bucket (a pool miss) exports its runner's
        recipe after its first step; a second cache (a second process)
        prewarms that signature from it with zero misses, and its job
        equals the standalone solve."""
        dcop = load_dcop_from_file(TUTO)
        warm = CompileCache(artifacts=_store(tmp_path))
        svc = SolveService(lanes=2, cache=warm, max_cycles=LIMIT,
                           device="cpu")
        svc.submit(dcop, "dsa", seed=0)
        svc.tick()
        assert warm.stats()["misses"] == 1
        assert warm.stats()["artifacts"]["saved"] == 1
        cold = CompileCache(artifacts=_store(tmp_path))
        svc2 = SolveService(lanes=2, cache=cold, max_cycles=LIMIT,
                            device="cpu")
        svc2.prewarm([(dcop, "dsa")], block=True)
        jid = svc2.submit(dcop, "dsa", seed=4)
        for _ in range(60):
            if not svc2.tick():
                break
        stats = cold.stats()
        assert stats["misses"] == 0 and stats["artifact_hits"] == 1
        spec = adapter_for("dsa").build_spec(BatchItem(dcop, "dsa", seed=4))
        want = spec.solver.run(max_cycles=LIMIT)
        got = svc2.result(jid, timeout=1)
        assert (got.assignment, got.cost, got.cycle) == \
            (want.assignment, want.cost, want.cycle)

    def test_corrupt_artifact_falls_back_to_builder(self, tmp_path):
        path = _store(tmp_path).save(KEY, _aot_runner())
        corrupt_artifact_file(path)
        built = []
        cache = CompileCache(artifacts=_store(tmp_path))
        cache.prewarm([(KEY, lambda: built.append(1) or _aot_runner())])
        assert built == [1]
        stats = cache.stats()
        assert stats["misses"] == 1 and stats["artifact_hits"] == 0
        assert stats["artifacts"]["rejected_corrupt"] == 1
        # the fresh build overwrote the damage
        assert _store(tmp_path).load(KEY) is not None

    def test_recipe_rebuild_sizes_the_rank_tables(self):
        runner = _aot_runner("mgm", lanes=3)
        again = runner_from_recipe(json.loads(json.dumps(runner.recipe)),
                                   "cpu")
        assert again.union.depths() == runner.union.depths()
        assert again.recipe == runner.recipe
