"""The cache of bucket runners.

The port of the JAX package's ``batch/cache.py`` ``CompileCache``, its
in-memory level: bucket runners keyed by the full bucket signature
(algo, params, padded shapes, batch size, chunk length and, in the port,
the device).  A hit returns the SAME runner object, with its buffers and
its captured CUDA graph, so a long-running sweep builds (and captures)
each (bucket, algo) pair once per process.

The JAX package's level 2, the persistent XLA compilation cache
(``enable_persistent_cache``), has no counterpart: nothing persists a
captured CUDA graph across processes.  ``BatchEngine(persistent_cache_dir=)``
and ``--compile-cache-dir`` raise
:class:`~pydcop_tpu_torch.errors.NotPortedError` (see
:func:`refuse_persistent_cache`).  Its cross-process level is the serve
layer's artifact store (``CompileCache(artifacts=)``,
:mod:`pydcop_tpu_torch.serve.artifacts`): a serve worker's pool miss
first rebuilds the runner from a recipe a peer process exported
(warmed and captured, counted as ``artifact_hits``, not ``misses``), and
a fresh build is exported so the NEXT process finds it.

A runner holds one bucket at a time in its buffers, so the serve
scheduler's workers (:mod:`pydcop_tpu_torch.serve.scheduler`) do not
share one: :meth:`CompileCache.checkout` hands a runner of the key to
exactly one worker (a pooled one, or a new build) and
:meth:`CompileCache.checkin` returns it when the worker closes;
:meth:`CompileCache.prewarm` builds runners into that pool ahead of
arrival.  The batch engine's :meth:`CompileCache.get_or_build` keeps its
own runners apart from the pool.

Hits and misses are published as ``batch.compile.hit|miss`` events
(``batch.compile.prewarm`` for a prewarmed build,
:mod:`pydcop_tpu_torch.runtime.events`) and counted in :meth:`stats`.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from pydcop_tpu_torch.errors import NotPortedError


class CompileCache:
    """Bucket runners by key.  Every method holds one re-entrant lock
    around its whole get-or-build, so two threads racing on one key
    neither build it twice nor see a half-built entry."""

    def __init__(self, artifacts: Optional[Any] = None):
        self._fns: Dict[Tuple, Any] = {}
        #: free runners of the serve workers, by key
        self._pool: Dict[Tuple, List[Any]] = {}
        #: every key this cache built or loaded a runner for (pooled,
        #: checked out or shared) — its warmth, for the fleet router
        self._known: set = set()
        #: keys whose runner this process exported
        self._exported: set = set()
        self.hits = 0
        self.misses = 0
        self.prewarmed = 0
        self.artifact_hits = 0
        #: optional cross-process level — a serve.artifacts.ArtifactStore
        #: of runner recipes shared by a process fleet's replicas: a pool
        #: miss here first rebuilds the runner from its recipe (counted
        #: as ``artifact_hits`` not ``misses``), and a fresh runner is
        #: exported so the next process finds it
        self.artifacts = artifacts
        self._lock = threading.RLock()

    @property
    def exports_artifacts(self) -> bool:
        """True when builders should attach their runners' recipes
        (``warm_bucket_runner(aot=True)``) so the store can save them."""
        return self.artifacts is not None

    def _load_artifact(self, key: Tuple):
        """A runner of ``key`` rebuilt from the artifact store, or None.
        Caller holds the lock."""
        if self.artifacts is None:
            return None
        runner = self.artifacts.load(key)
        if runner is not None:
            from pydcop_tpu_torch.runtime.events import send_batch

            # a peer already paid this build: warm and captured here
            self.artifact_hits += 1
            self._known.add(key)
            self._exported.add(key)
            send_batch("compile.artifact_hit", {"key": _printable(key)})
        return runner

    def export(self, key: Tuple, runner: Any) -> None:
        """Save ``runner``'s recipe to the artifact store, once per key
        and process (no-op without a store)."""
        with self._lock:
            if self.artifacts is None or key in self._exported:
                return
            self._exported.add(key)
        self.artifacts.save(key, runner)

    def get_or_build(self, key: Tuple,
                     builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """(runner, was_hit) for ``key``; ``builder`` runs on a miss.  The
        runner stays shared: the batch engine solves one bucket at a
        time."""
        from pydcop_tpu_torch.runtime.events import send_batch

        with self._lock:
            if key in self._fns:
                self.hits += 1
                send_batch("compile.hit", {"key": _printable(key)})
                return self._fns[key], True
            self.misses += 1
            send_batch("compile.miss", {"key": _printable(key)})
            fn = builder()
            self._fns[key] = fn
            self._known.add(key)
            return fn, False

    def checkout(self, key: Tuple,
                 builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """(runner, was_warm) for one serve worker: a free runner of
        ``key`` from the pool (a hit), else one rebuilt from the artifact
        store (an artifact hit, warm), else ``builder()``'s (a miss).
        The runner is the caller's alone until :meth:`checkin`."""
        from pydcop_tpu_torch.runtime.events import send_batch

        with self._lock:
            free = self._pool.get(key)
            if free:
                self.hits += 1
                send_batch("compile.hit", {"key": _printable(key)})
                return free.pop(), True
            runner = self._load_artifact(key)
            if runner is not None:
                return runner, True
            self.misses += 1
            self._known.add(key)
            send_batch("compile.miss", {"key": _printable(key)})
            return builder(), False

    def checkin(self, key: Tuple, runner: Any) -> None:
        """Return a worker's runner to the pool of ``key``."""
        with self._lock:
            self._pool.setdefault(key, []).append(runner)

    def prewarm(self, entries: Iterable[Tuple[Tuple, Callable[[], Any]]]
                ) -> int:
        """Build runners into the pool AHEAD of arrival, on the calling
        thread: ``entries`` are ``(key, builder)`` pairs; a key with a
        free runner already counts a hit, a fresh build a prewarmed miss
        (the JAX package's accounting); with an artifact store a key with
        a recipe there is rebuilt from it (an artifact hit), and a fresh
        build is exported.  Returns the runners built."""
        from pydcop_tpu_torch.runtime.events import send_batch

        built = 0
        with self._lock:
            for key, builder in entries:
                if self._pool.get(key):
                    self.hits += 1
                    send_batch("compile.hit", {"key": _printable(key)})
                    continue
                runner = self._load_artifact(key)
                if runner is None:
                    self.misses += 1
                    self.prewarmed += 1
                    self._known.add(key)
                    send_batch("compile.prewarm", {"key": _printable(key)})
                    runner = builder()
                    self.export(key, runner)
                self._pool.setdefault(key, []).append(runner)
                built += 1
        return built

    def has(self, key: Tuple) -> bool:
        """True when this cache built or loaded a runner for ``key`` —
        the warmth probe behind the fleet router's placement decisions:
        the SAME keys the bucket workers resolve double as routing keys
        (serve/router.py)."""
        with self._lock:
            return key in self._known

    def key_strings(self) -> list:
        """Printable forms of every key :meth:`has` answers for — what a
        replica process streams to the fleet head so the router's
        warmth probe has ground truth without a round-trip."""
        with self._lock:
            return sorted(_printable(k) for k in self._known)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"hits": self.hits, "misses": self.misses,
                   "entries": len(self._fns)
                   + sum(len(p) for p in self._pool.values())}
            if self.artifacts is not None:
                out["artifact_hits"] = self.artifact_hits
                out["artifacts"] = self.artifacts.stats()
            return out

    def pool_stats(self) -> Dict[str, int]:
        """The serve pool's runners: built by :meth:`prewarm`, and free
        now."""
        with self._lock:
            return {"prewarmed": self.prewarmed,
                    "pooled": sum(len(p) for p in self._pool.values())}


#: process-wide default cache: engines share it unless given their own,
#: so a caller making one BatchEngine per request still builds each
#: (bucket, algo) runner once per process
_GLOBAL_CACHE = CompileCache()


def global_compile_cache() -> CompileCache:
    return _GLOBAL_CACHE


def refuse_persistent_cache(cache_dir: Optional[str]) -> None:
    """Raise :class:`NotPortedError` when a persistent cache directory
    is asked for (the JAX package's ``enable_persistent_cache``, its
    persistent XLA cache): a captured CUDA graph lives in its process.
    What crosses processes in the port is the serve layer's artifact
    store of runner recipes (a process fleet's replicas share one), and
    the kernels' libraries in ``_build/``."""
    if cache_dir:
        raise NotPortedError(
            "a persistent compile cache (persistent_cache_dir / "
            "--compile-cache-dir) is not ported to the PyTorch package: "
            "it is the JAX package's persistent XLA cache, and bucket "
            "runners are CUDA graphs held in their process; a process "
            "fleet shares runner recipes through its artifact store")


def _printable(key: Tuple) -> str:
    return "/".join(str(k) for k in key)
