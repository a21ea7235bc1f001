"""Named-tensor join/projection kernels for tree inference (DPOP).

The device-side form of the relational algebra in
pydcop_tpu_torch.dcop.relations: UTIL tables are dense arrays tagged with
an ordered list of (variable name, size) dims.  ``join`` aligns on the
union of dims and adds (broadcast); ``projection`` min/max-reduces one
axis — the two ops that dominate DPOP's UTIL phase (reference hot loop:
pydcop/dcop/relations.py:1622-1706, driven from
pydcop/algorithms/dpop.py:299).

Hybrid dispatch, as in the JAX package: tables below
:data:`DEVICE_THRESHOLD` entries stay numpy arrays on the host (per-op
dispatch would cost more than the math), larger ones become torch tensors
on the solver's device.  Every operation here is exact in float32 (adds
of two operands, min/max, first-index argmin), so the two array kinds
give the same numbers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Dims = List[Tuple[str, int]]  # ordered (variable name, domain size)

#: tables with at least this many entries migrate to the device; below
#: it, per-op dispatch overhead exceeds the math and numpy on the host
#: wins
DEVICE_THRESHOLD = 1 << 14


def to_device(t, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device)


def to_numpy(t) -> np.ndarray:
    """A host numpy view of a table of either kind."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def align(t, dims: Dims, out_dims: Dims):
    """Transpose/expand t to broadcast over out_dims (superset of dims)."""
    pos = {name: i for i, (name, _) in enumerate(dims)}
    perm = [pos[name] for name, _ in out_dims if name in pos]
    if perm:
        t = (t.permute(*perm) if isinstance(t, torch.Tensor)
             else np.transpose(t, perm))
    shape = [size if name in pos else 1 for name, size in out_dims]
    return t.reshape(shape)


def join_t(t1, dims1: Dims, t2, dims2: Dims, device="cpu"
           ) -> Tuple[object, Dims]:
    """Sum-combine two util tables over the union of their dims; the
    result lives on ``device`` once it reaches the threshold."""
    names1 = {n for n, _ in dims1}
    out_dims = list(dims1) + [d for d in dims2 if d[0] not in names1]
    if table_size(out_dims) >= DEVICE_THRESHOLD:
        t1, t2 = to_device(t1, device), to_device(t2, device)
    elif isinstance(t1, np.ndarray) != isinstance(t2, np.ndarray):
        # mixed host/device operands: the device wins
        dev = t1.device if isinstance(t1, torch.Tensor) else t2.device
        t1, t2 = to_device(t1, dev), to_device(t2, dev)
    return align(t1, dims1, out_dims) + align(t2, dims2, out_dims), out_dims


def project_t(t, dims: Dims, var_name: str, mode: str = "min"
              ) -> Tuple[object, Dims]:
    """Optimize one variable out of a util table."""
    axis = [n for n, _ in dims].index(var_name)
    if isinstance(t, torch.Tensor):
        out = (torch.amin(t, dim=axis) if mode == "min"
               else torch.amax(t, dim=axis))
    else:
        out = np.min(t, axis=axis) if mode == "min" else np.max(t, axis=axis)
    return out, [d for d in dims if d[0] != var_name]


def slice_t(t, dims: Dims, assignment: Dict[str, int]
            ) -> Tuple[object, Dims]:
    """Fix some dims at given value indices."""
    idx = tuple(
        assignment[name] if name in assignment else slice(None)
        for name, _ in dims
    )
    return t[idx], [d for d in dims if d[0] not in assignment]


def argopt_value(t, dims: Dims, var_name: str, mode: str = "min") -> int:
    """Best value index of a 1-D util table over var_name (the first
    index among equal optima)."""
    if len(dims) != 1 or dims[0][0] != var_name:
        raise ValueError(f"expected a 1-D table over {var_name}, got {dims}")
    if isinstance(t, torch.Tensor):
        return int(torch.argmin(t) if mode == "min" else torch.argmax(t))
    return int(np.argmin(t) if mode == "min" else np.argmax(t))


def table_size(dims: Dims) -> int:
    size = 1
    for _, s in dims:
        size *= s
    return size
