"""Sharded engines: factors split over S shards in one process, with the
per-shard kernels of ``ops/packed_sharded.py`` and ordered collectives.

The counterpart of the JAX package's ``parallel/`` (its ``shard_map``
engines over a device mesh), for all-binary graphs; see
:mod:`pydcop_tpu_torch.parallel.mesh` for what is ported and what
raises ``NotPortedError``.
"""
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
]
