"""Continuous-batching solve service — a streaming front door over the
batch engine.

The port of the JAX package's ``serve`` package, its single-service
part: jobs are submitted with a tenant, a priority and an optional
deadline, folded into already-running shape buckets at chunk boundaries
(lane reuse when an instance converges — continuous batching), and
their results stream back as blocking futures, per-job
anytime-assignment iterators and ``serve.*`` events.  The buckets run on
the card (cuda unless the caller asks for the CPU) as CUDA graphs of the
batch engine's bucket runners.

Not ported yet: the solution cache (``memo``), the router, the
replicated and process fleets and the runner artifacts.
"""
from pydcop_tpu_torch.serve.errors import (  # noqa: F401
    DeadlineInfeasible,
    ServeError,
    ServiceOverloaded,
    ServiceStopped,
)
from pydcop_tpu_torch.serve.scheduler import (  # noqa: F401
    BucketWorker,
    dummy_bucket_inputs,
    fits,
    restore_lane_state,
    serve_target,
    warm_bucket_runner,
)
from pydcop_tpu_torch.serve.service import (  # noqa: F401
    ServeJob,
    SolveService,
    restore_target,
)

__all__ = [
    "BucketWorker",
    "DeadlineInfeasible",
    "ServeError",
    "ServeJob",
    "ServiceOverloaded",
    "ServiceStopped",
    "SolveService",
    "dummy_bucket_inputs",
    "fits",
    "restore_lane_state",
    "restore_target",
    "serve_target",
    "warm_bucket_runner",
]
