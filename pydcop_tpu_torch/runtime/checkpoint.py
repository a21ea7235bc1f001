"""The hardened state container of the checkpoint layer.

The lane-snapshot half of the JAX package's ``runtime/checkpoint.py``:
the ``.npz`` container with a metadata JSON and a CRC32 per array, which
the solve service's per-lane chunk-boundary checkpoints use
(:mod:`pydcop_tpu_torch.serve.service`).  A file written by either
package reads in the other.

* **atomic write**: temp file in the same directory + flush + fsync +
  ``os.replace`` — a crash mid-write leaves the previous snapshot
  intact, never a half-written one under the final name;
* **per-array CRC32** + a **schema version** in the metadata;
  :func:`read_state_npz` rejects truncated, corrupted or
  version-mismatched files with a clear ``ValueError`` instead of
  returning garbage state.

The solver-checkpoint half (``save_checkpoint``, ``load_checkpoint``,
``CheckpointManager``) is not ported yet.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Any, Dict, Tuple

import numpy as np

#: current checkpoint schema version (the JAX package's): v1 = the
#: original unversioned, unchecksummed format (still readable); v2 adds
#: per-array CRC32; v3 the warm-repair headroom metadata of a solver
#: checkpoint.  v1/v2 files remain readable.
CHECKPOINT_VERSION = 3


def _crc(a: np.ndarray) -> int:
    a = np.ascontiguousarray(a)
    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF


def write_state_npz(path: str, arrays: Dict[str, np.ndarray],
                    meta: Dict[str, Any]) -> None:
    """Atomically persist ``arrays`` + ``meta`` to ``path``.

    The metadata is stamped with the schema version and a CRC32 per
    array; the write goes through a same-directory temp file + fsync +
    rename so a crash at any point leaves either the old file or the
    new one — never a torn mix.
    """
    meta = dict(meta)
    meta["version"] = CHECKPOINT_VERSION
    meta["crc"] = {k: _crc(np.asarray(v)) for k, v in arrays.items()}
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ck_tmp_", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta),
                     **{k: np.asarray(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def read_state_npz(path: str) -> Tuple[Dict[str, Any],
                                       Dict[str, np.ndarray]]:
    """Load and VERIFY a checkpoint container.

    Raises ``ValueError`` (with the reason) on: unreadable/truncated
    zip, missing metadata, unsupported schema version, or any array
    whose CRC32 does not match the recorded one.  v1 files (no version
    field, no CRCs) are still accepted — there is nothing to verify.
    """
    import zipfile

    try:
        with np.load(path, allow_pickle=False) as data:
            if "__meta__" not in data:
                raise ValueError(
                    f"checkpoint {path!r} has no __meta__ entry — not a "
                    f"checkpoint container"
                )
            meta = json.loads(str(data["__meta__"]))
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
    except (zipfile.BadZipFile, OSError, EOFError, KeyError) as e:
        raise ValueError(
            f"checkpoint {path!r} is unreadable or truncated: {e}"
        ) from e
    version = int(meta.get("version", 1))
    if version > CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has schema version {version}, this "
            f"build reads <= {CHECKPOINT_VERSION} — refusing to guess"
        )
    crcs = meta.get("crc") or {}
    for name, want in crcs.items():
        if name not in arrays:
            raise ValueError(
                f"checkpoint {path!r} is missing array {name!r} listed "
                f"in its checksum table — truncated or tampered file"
            )
        got = _crc(arrays[name])
        if got != int(want):
            raise ValueError(
                f"checkpoint {path!r}: checksum mismatch on {name!r} "
                f"(recorded {int(want):#010x}, computed {got:#010x}) — "
                f"corrupt file, refusing to load"
            )
    return meta, arrays


__all__ = ["CHECKPOINT_VERSION", "read_state_npz", "write_state_npz"]
