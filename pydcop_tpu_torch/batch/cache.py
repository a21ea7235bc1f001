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
:func:`refuse_persistent_cache`).

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

    def __init__(self):
        self._fns: Dict[Tuple, Any] = {}
        #: free runners of the serve workers, by key
        self._pool: Dict[Tuple, List[Any]] = {}
        self.hits = 0
        self.misses = 0
        self.prewarmed = 0
        self._lock = threading.RLock()

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
            return fn, False

    def checkout(self, key: Tuple,
                 builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """(runner, was_warm) for one serve worker: a free runner of
        ``key`` from the pool (a hit), else ``builder()``'s (a miss).
        The runner is the caller's alone until :meth:`checkin`."""
        from pydcop_tpu_torch.runtime.events import send_batch

        with self._lock:
            free = self._pool.get(key)
            if free:
                self.hits += 1
                send_batch("compile.hit", {"key": _printable(key)})
                return free.pop(), True
            self.misses += 1
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
        (the JAX package's accounting).  Returns the runners built."""
        from pydcop_tpu_torch.runtime.events import send_batch

        built = 0
        with self._lock:
            for key, builder in entries:
                if self._pool.get(key):
                    self.hits += 1
                    send_batch("compile.hit", {"key": _printable(key)})
                    continue
                self.misses += 1
                self.prewarmed += 1
                send_batch("compile.prewarm", {"key": _printable(key)})
                self._pool.setdefault(key, []).append(builder())
                built += 1
        return built

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._fns)
                    + sum(len(p) for p in self._pool.values())}

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
    is asked for (the JAX package's ``enable_persistent_cache``): a
    captured CUDA graph lives in its process, and the prebuilt-kernel
    artifacts that would persist across processes come with the serve
    layer's artifact store (ROADMAP A7)."""
    if cache_dir:
        raise NotPortedError(
            "a persistent compile cache (persistent_cache_dir / "
            "--compile-cache-dir) is not ported to the PyTorch package: "
            "bucket runners are CUDA graphs held in their process; the "
            "cross-process artifact store comes with the serve layer "
            "(ROADMAP A7)")


def _printable(key: Tuple) -> str:
    return "/".join(str(k) for k in key)
