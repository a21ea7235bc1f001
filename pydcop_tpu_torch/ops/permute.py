"""Lane permutation: ``out[:, t] = x[:, perm[t]]``.

The counterpart of the JAX package's ``ops/pallas_permute.py::lane_permute``
(K3).  There the permutation is compiled into a Clos plan
(``ops/clos_routing.py::plan_permutation``: within-vreg gathers, tile
transposes and per-lane selects), because a TPU core has no fast
scattered load; the Pallas kernel takes the plan.  On a GPU routing is a
gather, so :func:`lane_permute` takes the permutation itself: its CUDA
kernel (``csrc/permute.cu``) reads each output's source element
directly.

The wrapper launches the kernel on CUDA tensors and counts the launch
(``lane_permute.launches``); on CPU tensors it runs
:func:`lane_permute_plain`.  It checks that ``perm`` is a permutation of
``[0, N)`` (on CUDA with one host read of the check).  A build or launch
failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

_fn = []


def lane_permute_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[:, t] = x[:, perm[t]]`` in torch ops."""
    return x[:, perm.long()]


def _kernel():
    if not _fn:
        from pydcop_tpu_torch.ops.cuda_build import load

        fn = load("permute").lane_permute
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_void_p]
        _fn.append(fn)
    return _fn[0]


def lane_permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x`` [S, N] float32 with its columns permuted: column t of the
    result is column ``perm[t]`` of ``x`` (``perm`` int32 [N], a
    permutation of ``[0, N)``, on ``x``'s device)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 [S, N] tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    N = x.shape[1]
    if perm.dtype != torch.int32 or tuple(perm.shape) != (N,):
        raise TypeError(f"perm must be int32 [{N}], got {perm.dtype} "
                        f"{tuple(perm.shape)}")
    if perm.device != x.device:
        raise ValueError(f"perm is on {perm.device}, x on {x.device}")
    if not torch.equal(torch.sort(perm).values,
                       torch.arange(N, dtype=torch.int32,
                                    device=perm.device)):
        raise ValueError(f"perm is not a permutation of [0, {N})")
    if x.device.type == "cpu":
        return lane_permute_plain(x, perm)
    if x.device.type != "cuda":
        raise ValueError(f"lane_permute runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    perm = perm.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), perm.data_ptr(), out.data_ptr(),
                    x.shape[0], N, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lane_permute launch failed: CUDA error {err}")
    lane_permute.launches += 1
    return out


lane_permute.launches = 0
