"""Durable checkpoint / resume of solver state.

The port of the JAX package's ``runtime/checkpoint.py``, both halves:

* **the container** (``write_state_npz``, ``read_state_npz``): the
  ``.npz`` file with a metadata JSON and a CRC32 per array, which the
  solve service's lane checkpoints use too.  A file written by either
  package reads in the other.

  - **atomic write**: temp file in the same directory + flush + fsync +
    ``os.replace`` — a crash mid-write leaves the previous snapshot
    intact, never a half-written one under the final name;
  - **per-array CRC32** + a **schema version** in the metadata;
    :func:`read_state_npz` rejects truncated, corrupted or
    version-mismatched files with a clear ``ValueError`` instead of
    returning garbage state.

* **solver checkpoints** (:func:`save_checkpoint`,
  :func:`load_checkpoint`, :class:`CheckpointManager`): a solver's last
  run state, its leaves moved to the host as numpy (so a checkpoint
  written on the card restores on the card or on the CPU), with JAX's
  metadata keys (``kind``, ``algo``, ``params``, ``seed``,
  ``precision``, ``n_leaves``, ``extra``, ``cycle``, and ``headroom``
  for the warm solvers, schema v3).  The leaves are flattened in the
  JAX package's tree order (tuples in order, dicts by sorted key).

The port's own parts:

* the random stream is a CPU ``torch.Generator`` (the solver's
  ``coins``), saved as the array ``generator_0`` where the JAX package
  saves ``__prng_key__``; a restored solver continues it.  A JAX-written
  file that carries ``__prng_key__`` is refused for a solver that draws
  coins (its stream cannot continue in the port), before any state is
  touched;
* ``extra["engine"]`` records the engine whose state layout the leaves
  hold (:func:`state_engine`): a restore into another engine raises
  ``ValueError`` naming both, and a JAX-written file (no record) holds
  the JAX package's generic layout, so it restores only into the port's
  generic engine.  Leaves are never reinterpreted.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

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
    Every exception of the zip and npy layers becomes that
    ``ValueError``: the JAX package lets some escape (a flipped byte can
    read as an unsupported zip version, ``NotImplementedError``), which
    a resume walk does not skip (ROADMAP C-f3).
    """
    try:
        with np.load(path, allow_pickle=False) as data:
            files = set(data.files)
            meta = (json.loads(str(data["__meta__"]))
                    if "__meta__" in files else None)
            arrays = {k: data[k] for k in files if k != "__meta__"}
    except Exception as e:  # noqa: BLE001 — any parse failure of a
        # damaged file (a bad zip directory, an "unsupported" zip version
        # or compression read from flipped bytes, a bad npy header, a
        # broken meta JSON) is a refusal, never a crash of the resume walk
        raise ValueError(
            f"checkpoint {path!r} is unreadable or truncated: "
            f"{type(e).__name__}: {e}"
        ) from e
    if meta is None:
        raise ValueError(
            f"checkpoint {path!r} has no __meta__ entry — not a "
            f"checkpoint container"
        )
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




# --------------------------------------------------------------------------
# solver-level save/load
# --------------------------------------------------------------------------

#: the array holding the solver's CPU coin generator state (the port's
#: stream; the JAX package saves ``__prng_key__``)
GENERATOR_KEY = "generator_0"
#: the JAX package's PRNG key array
JAX_KEY = "__prng_key__"
#: the prefix of the arrays holding a solver's host half
#: (``checkpoint_host_arrays``: the frontier search's stash and bound)
HOST_PREFIX = "host_"


def flatten_state(state) -> List[Any]:
    """The leaves of a state in the JAX package's tree order: tuples and
    lists in order, dicts by sorted key, ``None`` holds no leaf."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for part in state for leaf in flatten_state(part)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state)
                for leaf in flatten_state(state[k])]
    return [state]


def unflatten_state(like, leaves: List[Any]):
    """A state shaped like ``like`` from leaves in
    :func:`flatten_state` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, (tuple, list)):
            return type(node)(build(part) for part in node)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def state_engine(solver) -> str:
    """The engine whose state layout a solver's leaves hold: its
    ``checkpoint_engine()`` where it has one (maxsum's ``packed``,
    ``warm``, ``frontier``), else ``generic``."""
    fn = getattr(solver, "checkpoint_engine", None)
    return fn() if fn is not None else "generic"


def _generator(solver) -> Optional[torch.Generator]:
    gen = getattr(solver, "coins", None)
    return gen if isinstance(gen, torch.Generator) else None


def draws_coins(solver) -> bool:
    """Does the solver draw coins a cycle?  One draw is taken and the
    generator put back where it was."""
    fn = getattr(solver, "draw_chunk_coins", None)
    if fn is None:
        return False
    gen = _generator(solver)
    saved = gen.get_state() if gen is not None else None
    try:
        return len(fn(1)) > 0
    finally:
        if gen is not None:
            gen.set_state(saved)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, solver, extra: Optional[Dict] = None,
                    cycle: Optional[int] = None) -> None:
    """Persist a solver's last run state (moved to the host) +
    metadata."""
    state = getattr(solver, "_last_state", None)
    if state is None:
        raise ValueError("Solver has no state yet — run() it first")
    leaves = flatten_state(state)
    meta = {
        "kind": "solver",
        "algo": solver.algo_def.algo,
        "params": solver.algo_def.params,
        "seed": getattr(solver, "seed", None),
        # the precision tier the leaves were produced under (the port
        # runs f32 only; the key keeps JAX's schema)
        "precision": getattr(solver, "precision", "f32"),
        "n_leaves": len(leaves),
        "extra": {**(extra or {}), "engine": state_engine(solver)},
    }
    if cycle is not None:
        meta["cycle"] = int(cycle)
    # schema v3: warm-repair solvers persist their headroom layout so a
    # resume restores a mutated problem at its exact padded shape (the
    # mutated operands already ride in the state leaves)
    layout = getattr(solver, "layout", None)
    if layout is not None and hasattr(layout, "to_meta"):
        t = solver.tensors
        hmeta = {
            "layout": layout.to_meta(),
            "var_names": list(t.var_names),
            "domain_values": [list(d) for d in t.domain_values],
            "factor_names": list(t.factor_names),
        }
        try:
            json.dumps(hmeta)
        except (TypeError, ValueError):
            logger.warning(
                "headroom metadata is not JSON-serializable (exotic "
                "domain values?); checkpoint saved without it"
            )
        else:
            meta["headroom"] = hmeta
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    # the coin stream travels with the state: a warm run after restore
    # must CONTINUE it, not replay it from the seed
    gen = _generator(solver)
    if gen is not None:
        arrays[GENERATOR_KEY] = gen.get_state().numpy()
    host = getattr(solver, "checkpoint_host_arrays", None)
    if host is not None:
        arrays.update({HOST_PREFIX + k: v for k, v in host().items()})
    write_state_npz(path, arrays, meta)


def load_checkpoint(path: str, solver) -> Dict[str, Any]:
    """Restore a solver's state; returns the checkpoint metadata.

    The solver must have been built for the same problem (leaf shapes
    are validated against a freshly initialized state) and run the
    engine that wrote the file.  Corrupt, truncated, version-mismatched
    or foreign files raise ``ValueError`` before any state is touched.
    """
    meta, arrays = read_state_npz(path)
    try:
        leaves = [arrays[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    except KeyError as e:
        raise ValueError(
            f"checkpoint {path!r} is missing state leaf {e} — truncated "
            f"or foreign file"
        ) from e
    ckpt_tier = meta.get("precision", "f32")
    solver_tier = getattr(solver, "precision", "f32")
    if ckpt_tier != solver_tier:
        raise ValueError(
            f"checkpoint {path!r} was saved at precision={ckpt_tier!r} but "
            f"the restoring solver is staged at precision={solver_tier!r}; "
            f"state leaves are tier-specific"
        )
    engine = state_engine(solver)
    written = (meta.get("extra") or {}).get("engine")
    if written is None:
        # written by the JAX package: its leaves hold JAX's generic
        # layout, which only the port's generic engine shares
        if engine != "generic":
            raise ValueError(
                f"checkpoint {path!r} was written by the JAX package "
                f"(generic engine layout); the restoring {meta.get('algo')!r}"
                f" solver runs the port's {engine!r} engine, whose state "
                f"leaves differ — rebuild it on the generic engine "
                f"(use_packed=False)"
            )
        if JAX_KEY in arrays and draws_coins(solver):
            raise ValueError(
                f"checkpoint {path!r} carries a JAX PRNG key "
                f"({JAX_KEY}); the port's {solver.algo_def.algo!r} solver "
                f"draws its coins from a torch generator, so the stream "
                f"cannot continue — refusing to restore"
            )
    elif written != engine:
        raise ValueError(
            f"checkpoint {path!r} was written by the {written!r} engine; "
            f"the restoring solver runs the {engine!r} engine, whose "
            f"state leaves differ"
        )
    gen = _generator(solver)
    gen_state = arrays.get(GENERATOR_KEY)
    if gen_state is not None and gen is None:
        raise ValueError(
            f"checkpoint {path!r} carries a coin generator state but the "
            f"restoring solver has no generator — different algorithm?"
        )
    if gen_state is not None and gen_state.size != gen.get_state().numel():
        raise ValueError(
            f"checkpoint {path!r}: its coin generator state has "
            f"{gen_state.size} bytes, this build's has "
            f"{gen.get_state().numel()}"
        )
    host = {k[len(HOST_PREFIX):]: v for k, v in arrays.items()
            if k.startswith(HOST_PREFIX)}
    restore_host = getattr(solver, "restore_checkpoint_host", None)
    if restore_host is not None and not host:
        raise ValueError(
            f"checkpoint {path!r} lacks the host half of the "
            f"{engine!r} engine's state (its {HOST_PREFIX}* arrays)")
    if host and restore_host is None:
        raise ValueError(
            f"checkpoint {path!r} carries a host state that the "
            f"restoring {engine!r} engine does not keep")
    ref = solver.initial_state()
    ref_leaves = flatten_state(ref)
    # the leaves a chunk runner reads in place (the warm solvers'
    # operands) are restored INTO their tensors, which keep their identity
    resident = {id(t) for t in getattr(solver, "resident_leaves",
                                       lambda: ())()}
    if len(ref_leaves) != len(leaves):
        raise ValueError(
            f"Checkpoint has {len(leaves)} state leaves, solver expects "
            f"{len(ref_leaves)}"
        )
    restored = []
    for got, want in zip(leaves, ref_leaves):
        if np.shape(got) != tuple(np.shape(want)):
            raise ValueError(
                f"Checkpoint leaf shape {np.shape(got)} != solver "
                f"{tuple(np.shape(want))} — different problem?"
            )
        if not isinstance(want, torch.Tensor):
            restored.append(type(want)(got) if np.ndim(got) == 0 else got)
            continue
        # ascontiguousarray makes a 0-d leaf 1-d: keep its shape
        src = torch.from_numpy(
            np.ascontiguousarray(got).reshape(np.shape(got)))
        if src.dtype.is_floating_point != want.dtype.is_floating_point:
            raise ValueError(
                f"Checkpoint leaf dtype {got.dtype} does not match the "
                f"solver's {want.dtype} — different engine?"
            )
        restored.append(src.to(device=want.device, dtype=want.dtype))
    if restore_host is not None:
        restore_host(host)
    for i, want in enumerate(ref_leaves):
        if id(want) in resident:
            want.copy_(restored[i])
            restored[i] = want
    solver._last_state = unflatten_state(ref, restored)
    if gen_state is not None:
        gen.set_state(torch.from_numpy(np.ascontiguousarray(gen_state)))
    hmeta = meta.get("headroom")
    if hmeta and hasattr(solver, "restore_headroom_meta"):
        # v3: re-adopt the claimed/free slot maps so the restored
        # (possibly mutated) operands are addressable by name again
        solver.restore_headroom_meta(hmeta)
    return meta


# --------------------------------------------------------------------------
# snapshot directories: periodic saves + rotation + resume
# --------------------------------------------------------------------------

class CheckpointManager:
    """Rotating snapshot directory: ``<dir>/ck_<cycle>.npz``.

    ``save*()`` writes a snapshot for a cycle and prunes all but the
    ``keep`` newest; ``latest_valid*()`` walks snapshots newest-first,
    skipping (and logging) any that fail verification — one corrupt
    file costs one snapshot of progress, not the run.
    """

    PREFIX = "ck_"

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = max(1, keep)

    def path_for(self, cycle: int) -> str:
        return os.path.join(self.directory,
                            f"{self.PREFIX}{int(cycle):08d}.npz")

    def snapshots(self) -> List[Tuple[int, str]]:
        """(cycle, path) list, newest (highest cycle) first."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if not (name.startswith(self.PREFIX)
                    and name.endswith(".npz")):
                continue
            try:
                cycle = int(name[len(self.PREFIX):-len(".npz")])
            except ValueError:
                continue
            out.append((cycle, os.path.join(self.directory, name)))
        return sorted(out, reverse=True)

    def latest(self) -> Optional[Tuple[int, str]]:
        snaps = self.snapshots()
        return snaps[0] if snaps else None

    def _rotate(self) -> None:
        for _cycle, path in self.snapshots()[self.keep:]:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- raw state ------------------------------------------------------------

    def save_state(self, cycle: int, arrays: Dict[str, np.ndarray],
                   meta: Dict[str, Any]) -> str:
        os.makedirs(self.directory, exist_ok=True)
        meta = dict(meta)
        meta["cycle"] = int(cycle)
        path = self.path_for(cycle)
        write_state_npz(path, arrays, meta)
        self._rotate()
        return path

    def latest_valid_state(self) -> Optional[
            Tuple[int, Dict[str, Any], Dict[str, np.ndarray]]]:
        for cycle, path in self.snapshots():
            try:
                meta, arrays = read_state_npz(path)
            except ValueError as e:
                logger.warning("skipping damaged checkpoint %s: %s",
                               path, e)
                continue
            return cycle, meta, arrays
        return None

    # -- solver state -----------------------------------------------------------

    def save_solver(self, solver, cycle: int,
                    extra: Optional[Dict] = None) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = self.path_for(cycle)
        save_checkpoint(path, solver, extra=extra, cycle=cycle)
        self._rotate()
        return path

    def load_latest_into(self, solver) -> Optional[Dict[str, Any]]:
        """Restore the newest loadable snapshot into ``solver``; skips
        corrupt files (logged) AND mismatched ones (a different
        problem's directory should not brick the run when resuming is
        best-effort).  Returns its metadata, or None."""
        for _cycle, path in self.snapshots():
            try:
                return load_checkpoint(path, solver)
            except ValueError as e:
                logger.warning("skipping unusable checkpoint %s: %s",
                               path, e)
        return None


__all__ = [
    "CHECKPOINT_VERSION",
    "CheckpointManager",
    "flatten_state",
    "load_checkpoint",
    "read_state_npz",
    "save_checkpoint",
    "state_engine",
    "unflatten_state",
    "write_state_npz",
]
