"""Device selection for the entry points of the PyTorch package.

Every entry point (``solve_result``/``solve``, ``MaxSumSolver``, the
compile functions, the CLI) runs on ``cuda`` unless the caller asks for
the CPU.  A missing GPU is an error, never a silent move to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from pydcop_tpu_torch.errors import DeviceUnavailableError

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; ``cuda`` without a visible GPU raises
    :class:`DeviceUnavailableError`; anything but cuda/cpu is refused."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is visible; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU"
        )
    return dev
