"""Batched multi-instance solving.

The port of the JAX package's ``batch/`` package: compiled instances
grouped by shape signature (:mod:`~pydcop_tpu_torch.batch.bucketing`),
padded to a common shape under a bounded padding waste and solved a
bucket at a time as one union graph (:mod:`~pydcop_tpu_torch.batch.engine`),
each bucket's fixed-shape runner kept in a cache
(:mod:`~pydcop_tpu_torch.batch.cache`) and captured as a CUDA graph on
the card, so a sweep builds each (bucket, algo) runner once.  The solve
service (:mod:`pydcop_tpu_torch.serve`) keeps buckets open over the same
runners, lane by lane.
"""
from pydcop_tpu_torch.batch.bucketing import (  # noqa: F401
    BucketPlan,
    InstanceDims,
    StructuredBatchingUnsupported,
    dims_of,
    plan_buckets,
)
from pydcop_tpu_torch.batch.cache import (  # noqa: F401
    CompileCache,
    global_compile_cache,
)
from pydcop_tpu_torch.batch.engine import (  # noqa: F401
    BatchEngine,
    BatchItem,
    SUPPORTED_ALGOS,
)
