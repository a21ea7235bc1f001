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
* ``cuda_build``: builds and loads the CUDA kernels at first use.
"""
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

__all__ = [
    "ConstraintGraphTensors",
    "compile_constraint_graph",
    "FactorBucket",
    "FactorGraphTensors",
    "compile_binary_from_arrays",
    "compile_factor_graph",
    "tensors_from_numpy",
    "PAD_COST",
]
