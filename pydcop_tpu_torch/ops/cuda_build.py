"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The
library lands in ``pydcop_tpu_torch/_build/`` under a name that carries
the hash of its source and of the shared headers (``csrc/*.cuh``), so an
edited source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported: the first launch on a CUDA
tensor builds, or :func:`build_all` does it up front (one ``nvcc``
process per source, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "_build"

#: kernel library name → its source, relative to the package
SOURCES: Dict[str, str] = {
    "packed_maxsum": "csrc/packed_maxsum.cu",
    "local_search": "csrc/local_search.cu",
    "dpop_sweep": "csrc/dpop_sweep.cu",
    "mgm2": "csrc/mgm2.cu",
    "sharded": "csrc/sharded.cu",
    "permute": "csrc/permute.cu",
}

#: ``-fmad=false``: no contraction of a*b + c into one fused multiply-add,
#: so a kernel rounds after every operation exactly as its plain PyTorch
#: version does (and as the JAX package does on the CPU) — on near-tie
#: beliefs that last bit decides the argmin.  The kernels are bound by
#: memory, so the unfused arithmetic costs no time.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) of each library built by this process
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine"
    )


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by the hash of its source and
    of the ``csrc/*.cuh`` headers a source may include."""
    src = PKG_DIR / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PKG_DIR / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path,
            proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or none


def build_all() -> float:
    """Build every kernel library that is not built yet, one ``nvcc``
    per source, all running at once.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not library_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    for n, out, tmp, proc in started:
        _finish(n, out, tmp, proc)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
