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

Hits and misses are published as ``batch.compile.hit|miss`` events
(:mod:`pydcop_tpu_torch.runtime.events`) and counted in :meth:`stats`.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from pydcop_tpu_torch.errors import NotPortedError


class CompileCache:
    """Bucket runners by key.  :meth:`get_or_build` holds a re-entrant
    lock around the whole get-or-build, so two threads racing on one key
    neither build it twice nor see a half-built entry (a runner itself
    serves one bucket at a time)."""

    def __init__(self):
        self._fns: Dict[Tuple, Any] = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get_or_build(self, key: Tuple,
                     builder: Callable[[], Any]) -> Tuple[Any, bool]:
        """(runner, was_hit) for ``key``; ``builder`` runs on a miss."""
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

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._fns)}


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
