"""Runner artifacts — bucket-runner recipes keyed by ``runner_cache_key``,
so a relaunched or newly joined replica process holds a warm runner
before its first job arrives.

The port of the JAX package's ``serve/artifacts.py``.  The JAX package
serializes a compiled executable (``jax.experimental.serialize_executable``)
and a loading replica deserializes it: zero XLA compiles.  Nothing in
CUDA persists a captured graph across processes, and a bucket runner
launches no hand-written kernel (its cycles are the generic engines'
PyTorch code), so what a process can hand the next one is the runner's
**recipe**: the adapter's algorithm, the padded target
:class:`~pydcop_tpu_torch.batch.bucketing.InstanceDims`, the params, the
lane count, the chunk and the rank-table depths.  A load rebuilds the
runner from it and runs its warm-up call and its capture
(:func:`~pydcop_tpu_torch.serve.scheduler.warm_bucket_runner`) before any
job arrives — counted as an ``artifact_hit`` of the runner cache, not a
``miss`` — so the first job's step replays.  The hand-written kernels'
libraries are shared already, through ``pydcop_tpu_torch/_build/``
(keyed by the hash of their source; ``ops/cuda_build.py``).

* :class:`ArtifactStore` persists a recipe under a filename derived
  from the exact cache key, as a self-describing file: one JSON header
  line (format version, ABI tag, CRC32 + size of the payload, printable
  key) followed by the JSON payload;
* a loading replica verifies format, ABI (:func:`abi_tag`: the torch
  and CUDA versions, the device's name and compute capability, and the
  hash of the kernels' sources and ``nvcc`` flags — an edited kernel
  makes old artifacts stale) and CRC before rebuilding.  A stale
  artifact raises :class:`StaleArtifactError`, a damaged one
  :class:`CorruptArtifactError`; the store logs both loudly, counts
  them, and the cache falls back to a fresh build whose export
  OVERWRITES the bad file — rejection is never silent and never fatal.

Writes are atomic (tmp + fsync + rename), matching the checkpoint
discipline: a kill mid-export can leave a tmp file around but never a
half-written artifact under the real name.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import torch

from pydcop_tpu_torch.batch.bucketing import InstanceDims
from pydcop_tpu_torch.device import DeviceLike

log = logging.getLogger(__name__)

#: bumped when the on-disk layout changes
ARTIFACT_FORMAT = 1


class ArtifactError(RuntimeError):
    """Base for artifact rejections (never raised past the cache)."""


class StaleArtifactError(ArtifactError):
    """ABI/format mismatch: written under another torch, CUDA, device or
    kernel build (or an older store layout) — unusable here."""


class CorruptArtifactError(ArtifactError):
    """Damaged bytes: bad header, CRC mismatch or an unreadable recipe —
    rejected loudly, rebuilt, overwritten."""


def kernel_hash() -> str:
    """Hash of the ``nvcc`` flags and every ``csrc/`` source and header:
    the kernels a runner's process would load."""
    from pydcop_tpu_torch.ops import cuda_build

    h = hashlib.sha256(" ".join(cuda_build.NVCC_FLAGS).encode("utf-8"))
    csrc = cuda_build.PKG_DIR / "csrc"
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode("utf-8"))
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def abi_tag(device: DeviceLike = "cuda") -> Dict[str, str]:
    """The compatibility fingerprint stamped into every artifact: the
    torch and CUDA versions, the device's name and compute capability
    (``cpu`` and empty on the CPU) and :func:`kernel_hash`.  Only a
    process that already runs on ``device`` asks: on cuda the name is
    read from the card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        major, minor = torch.cuda.get_device_capability(dev)
        capability = f"{major}.{minor}"
    else:
        name, capability = "cpu", ""
    return {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": name,
        "capability": capability,
        "kernels": kernel_hash(),
    }


def dims_to_wire(d: InstanceDims) -> Dict[str, Any]:
    return {
        "graph_type": d.graph_type, "D": d.D,
        "arities": list(d.arities), "V": d.V,
        "F": list(d.F), "M": d.M,
    }


def dims_from_wire(d: Dict[str, Any]) -> InstanceDims:
    return InstanceDims(
        graph_type=d["graph_type"], D=int(d["D"]),
        arities=tuple(int(a) for a in d["arities"]), V=int(d["V"]),
        F=tuple(int(f) for f in d["F"]), M=int(d["M"]),
    )


def runner_recipe(algo: str, params: Dict[str, Any], target: InstanceDims,
                  lanes: int, chunk: int,
                  depths: Dict[Tuple[str, Optional[int]], int]
                  ) -> Dict[str, Any]:
    """What a process needs to rebuild a bucket runner: its algorithm,
    params, padded target, lane count, chunk and each rank table's
    depth (by ``(field, column)``)."""
    return {
        "algo": algo,
        "params": dict(params),
        "target": dims_to_wire(target),
        "lanes": int(lanes),
        "chunk": int(chunk),
        "depths": sorted([f, c, int(d)] for (f, c), d in depths.items()),
    }


def runner_from_recipe(recipe: Dict[str, Any], device: DeviceLike):
    """Rebuild a recipe's runner on ``device`` and run its warm-up call
    and its capture (:func:`~pydcop_tpu_torch.serve.scheduler.
    warm_bucket_runner` with the recipe's depths)."""
    from pydcop_tpu_torch.batch.engine import adapter_for
    from pydcop_tpu_torch.serve.scheduler import warm_bucket_runner

    depths = {(f, c): int(d) for f, c, d in recipe["depths"]}
    return warm_bucket_runner(
        adapter_for(recipe["algo"]), dims_from_wire(recipe["target"]),
        dict(recipe["params"]), int(recipe["lanes"]),
        int(recipe["chunk"]), aot=True, device=device, depths=depths)


def artifact_name(key: Tuple) -> str:
    """Stable filename for a runner-cache key (keys are tuples of
    primitives + nested shape tuples — ``repr`` is deterministic)."""
    return hashlib.sha1(repr(key).encode("utf-8")).hexdigest() + ".rnr"


class ArtifactStore:
    """Directory of runner recipes, one per runner-cache key.  Shared by
    every replica process of a fleet (it lives under the fleet's journal
    directory), so one replica's build is every FUTURE replica's warm
    bring-up.  ``device`` is where loaded runners are rebuilt.

    Thread-safe: a lock serializes the read-verify and
    write-fsync-rename sections (the rebuild runs outside it, on the
    caller's thread — the scheduler thread that replays the runner)."""

    def __init__(self, root: str, device: DeviceLike = "cuda"):
        self.root = str(root)
        self.device = device
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._abi: Optional[Dict[str, str]] = None
        self.hits = 0
        self.misses = 0
        self.saved = 0
        self.rejected_stale = 0
        self.rejected_corrupt = 0
        self.save_verify_failed = 0

    def path_for(self, key: Tuple) -> str:
        return os.path.join(self.root, artifact_name(key))

    def abi(self) -> Dict[str, str]:
        """This store's :func:`abi_tag` (read once)."""
        if self._abi is None:
            self._abi = abi_tag(self.device)
        return self._abi

    # -- export --------------------------------------------------------------

    def save(self, key: Tuple, runner: Any) -> Optional[str]:
        """Persist a runner's recipe.  Only runners that carry one
        (``warm_bucket_runner(aot=True)``, or a serve worker's runner
        after its first step) export; anything else is skipped."""
        recipe = getattr(runner, "recipe", None)
        if recipe is None:
            return None
        blob = json.dumps(recipe, sort_keys=True).encode("utf-8")
        # self-verify BEFORE publishing: a recipe that does not read
        # back as itself (a param JSON cannot carry) must never reach
        # the store — a cold replica trusting it would build another
        # runner under this key
        if json.loads(blob.decode("utf-8")) != recipe:
            with self._lock:
                self.save_verify_failed += 1
            log.warning("artifact for %r failed save-time verification "
                        "— NOT exported", key)
            self._send_reject(self.path_for(key), "unverifiable",
                              "the recipe does not round-trip JSON")
            return None
        header = json.dumps({
            "format": ARTIFACT_FORMAT,
            "abi": self.abi(),
            "crc": zlib.crc32(blob) & 0xFFFFFFFF,
            "size": len(blob),
            "key": [str(k) for k in key],
        }, sort_keys=True).encode("utf-8") + b"\n"
        path = self.path_for(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    f.write(header)
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except OSError as e:
                log.warning("artifact write failed for %r: %s", key, e)
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return None
            self.saved += 1
        from pydcop_tpu_torch.runtime.events import send_batch

        send_batch("artifact.saved", {"path": path})
        return path

    # -- import --------------------------------------------------------------

    def load(self, key: Tuple):
        """The runner for ``key`` rebuilt (warmed and, on the card,
        captured) from its recipe, if a usable artifact exists.  Returns
        None on a plain miss; stale/corrupt files are rejected LOUDLY
        (warning log + counter + event) and also return None so the
        caller builds afresh and overwrites."""
        path = self.path_for(key)
        try:
            with self._lock:
                recipe = self._read_verified(path)
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            return None
        except StaleArtifactError as e:
            with self._lock:
                self.rejected_stale += 1
            log.warning("STALE runner artifact rejected (%s): %s "
                        "— rebuilding", path, e)
            self._send_reject(path, "stale", str(e))
            return None
        except CorruptArtifactError as e:
            with self._lock:
                self.rejected_corrupt += 1
            log.warning("CORRUPT runner artifact rejected (%s): %s "
                        "— rebuilding", path, e)
            self._send_reject(path, "corrupt", str(e))
            return None
        try:
            runner = runner_from_recipe(recipe, self.device)
        except (KeyError, TypeError, ValueError) as e:
            with self._lock:
                self.rejected_corrupt += 1
            log.warning("runner artifact failed to rebuild (%s): %s "
                        "— rebuilding", path, e)
            self._send_reject(path, "corrupt", str(e))
            return None
        with self._lock:
            self.hits += 1
        return runner

    def _read_verified(self, path: str) -> Dict[str, Any]:
        with open(path, "rb") as f:
            raw = f.read()
        nl = raw.find(b"\n")
        if nl < 0:
            raise CorruptArtifactError("no header line")
        try:
            header = json.loads(raw[:nl].decode("utf-8"))
        except ValueError as e:
            raise CorruptArtifactError(f"unparseable header: {e}")
        if not isinstance(header, dict):
            raise CorruptArtifactError("header is not an object")
        if header.get("format") != ARTIFACT_FORMAT:
            raise StaleArtifactError(
                f"format {header.get('format')!r} != {ARTIFACT_FORMAT}"
            )
        abi = header.get("abi")
        here = self.abi()
        if abi != here:
            raise StaleArtifactError(f"abi {abi!r} != {here!r}")
        blob = raw[nl + 1:]
        if len(blob) != header.get("size"):
            raise CorruptArtifactError(
                f"size {len(blob)} != declared {header.get('size')}"
            )
        if zlib.crc32(blob) & 0xFFFFFFFF != header.get("crc"):
            raise CorruptArtifactError("payload CRC mismatch")
        try:
            recipe = json.loads(blob.decode("utf-8"))
        except ValueError as e:
            raise CorruptArtifactError(f"unreadable recipe: {e}")
        if not isinstance(recipe, dict) or set(recipe) != {
                "algo", "params", "target", "lanes", "chunk", "depths"}:
            raise CorruptArtifactError("payload is not a runner recipe")
        return recipe

    def _send_reject(self, path: str, why: str, detail: str) -> None:
        from pydcop_tpu_torch.runtime.events import send_batch

        send_batch("artifact.rejected",
                   {"path": path, "why": why, "detail": detail})

    # -- introspection -------------------------------------------------------

    def entries(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.endswith(".rnr"))
        except OSError:
            return 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "saved": self.saved,
                "rejected_stale": self.rejected_stale,
                "rejected_corrupt": self.rejected_corrupt,
                "save_verify_failed": self.save_verify_failed,
                "entries": self.entries(),
            }


def corrupt_artifact_file(path: str, seed: int = 0) -> bool:
    """Flip one byte inside an artifact's payload (the
    ``corrupt_artifact`` fault's hand): a deterministic, seeded bit of
    damage the CRC check must catch.  Returns False when the file is
    missing or too short to damage safely."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return False
    nl = raw.find(b"\n")
    if nl < 0 or len(raw) <= nl + 2:
        return False
    # pick a deterministic offset inside the payload
    span = len(raw) - (nl + 1)
    off = nl + 1 + (seed * 2654435761 + 17) % span
    flipped = raw[:off] + bytes([raw[off] ^ 0xFF]) + raw[off + 1:]
    with open(path, "wb") as f:
        f.write(flipped)
    return True
