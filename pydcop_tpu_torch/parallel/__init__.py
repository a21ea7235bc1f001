"""Sharded engines: factors split over S shards in one process, the packed
one with the kernels of ``ops/packed_sharded.py`` (K7 and K9 one launch
per device over its group of shards, K8 after K9 for MGM), the generic
``[E, D]`` one in plain PyTorch, and the dense or boundary-compacted
collectives between them.

The counterpart of the JAX package's in-process ``parallel/`` (its
``shard_map`` engines over a device mesh, ``boundary.py``); see
:mod:`pydcop_tpu_torch.parallel.mesh` for what is ported and what raises
``NotPortedError``.
"""
from pydcop_tpu_torch.parallel.generic_mesh import shard_factor_graph
from pydcop_tpu_torch.parallel.mesh import (
    ShardedLocalSearch,
    ShardedMaxSum,
    build_mesh,
)
from pydcop_tpu_torch.parallel.partition import partition_factors

__all__ = [
    "ShardedLocalSearch",
    "ShardedMaxSum",
    "build_mesh",
    "partition_factors",
    "shard_factor_graph",
]
