"""Tensorization and device kernels.

* ``compile``: a DCOP → padded tensor graph on a torch device;
* ``segments``: segment reductions over graph neighborhoods;
* ``maxsum_kernels``: the generic MaxSum engine (any arity), plain torch;
* ``packed_maxsum``: the packed all-binary MaxSum engine, whose cycle is
  the hand-written CUDA kernel ``csrc/packed_maxsum.cu``;
* ``packed_local_search``: the packed all-binary local-search engine
  (local tables, MGM and DSA cycles), kernels in ``csrc/local_search.cu``;
* ``packed_mgm2``: the packed all-binary MGM-2 engine, kernels in
  ``csrc/mgm2.cu``;
* ``packed_sharded``: the per-shard kernels of the sharded engines,
  ``csrc/sharded.cu``;
* ``permute``: a lane permutation ``out[:, t] = x[:, perm[t]]``,
  ``csrc/permute.cu``;
* ``cuda_build``: builds and loads the CUDA kernels at first use.

:func:`launch_counters` names every kernel wrapper's launch counter.
"""
from typing import Any, Dict, Tuple

from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    FactorBucket,
    ConstraintGraphTensors,
    FactorGraphTensors,
    compile_binary_from_arrays,
    compile_constraint_graph,
    compile_factor_graph,
    tensors_from_numpy,
)



def launch_counters() -> Dict[str, Tuple[Any, str]]:
    """Every kernel launch counter of the package: name -> (wrapper,
    attribute).  A wrapper adds one to its counter where it launches its
    kernel; a captured chunk's replay adds what its capture recorded
    (:mod:`pydcop_tpu_torch.algorithms.capture`)."""
    from pydcop_tpu_torch.ops import packed_dpop, packed_mgm2, permute
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops import packed_maxsum as M
    from pydcop_tpu_torch.ops import packed_sharded as K

    return {
        "packed_maxsum_cycle": (M.packed_cycles, "launches"),
        "ls_tables": (P.ls_tables, "launches"),
        "mgm": (P.packed_mgm_cycles, "launches"),
        "dsa": (P.packed_dsa_cycles, "launches"),
        "packed_maxsum_mixed": (M.packed_cycles, "mixed_launches"),
        "ls_tables_mixed": (P.ls_tables, "mixed_launches"),
        "mgm_mixed": (P.packed_mgm_cycles, "mixed_launches"),
        "dsa_mixed": (P.packed_dsa_cycles, "mixed_launches"),
        "dpop_whole_sweep": (packed_dpop.whole_sweep, "launches"),
        "mgm2": (packed_mgm2.packed_mgm2_cycles, "launches"),
        "mgm2_mixed": (packed_mgm2.packed_mgm2_cycles, "mixed_launches"),
        "device_fused_ba": (K.device_fused_ba, "launches"),
        "device_mgm_move": (K.device_mgm_move, "launches"),
        "device_tables": (K.device_tables, "launches"),
        "device_fused_ba_mixed": (K.device_fused_ba, "mixed_launches"),
        "device_fused_ba_act": (K.device_fused_ba, "act_launches"),
        "device_fused_ba_mixed_act": (K.device_fused_ba,
                                      "mixed_act_launches"),
        "device_mgm_move_mixed": (K.device_mgm_move, "mixed_launches"),
        "device_tables_mixed": (K.device_tables, "mixed_launches"),
        "lane_permute": (permute.lane_permute, "launches"),
    }


def read_launch_counters() -> Dict[str, int]:
    """The value of every launch counter, by name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def reset_launch_counters() -> None:
    """Set every launch counter to 0."""
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


__all__ = [
    "ConstraintGraphTensors",
    "compile_constraint_graph",
    "FactorBucket",
    "FactorGraphTensors",
    "compile_binary_from_arrays",
    "compile_factor_graph",
    "tensors_from_numpy",
    "PAD_COST",
    "launch_counters",
    "read_launch_counters",
    "reset_launch_counters",
]
