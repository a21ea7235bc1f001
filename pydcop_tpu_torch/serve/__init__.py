"""Continuous-batching solve service — a streaming front door over the
batch engine.

The port of the JAX package's ``serve`` package: jobs are submitted with
a tenant, a priority and an optional deadline, folded into
already-running shape buckets at chunk boundaries (lane reuse when an
instance converges — continuous batching), and their results stream
back as blocking futures, per-job anytime-assignment iterators and
``serve.*`` events.  The buckets run on the card (cuda unless the caller
asks for the CPU) as CUDA graphs of the batch engine's bucket runners.
:class:`SolveFleet` replicates the service horizontally: N replicas (one
process, one CUDA context) behind a runner-cache-keyed router, with
journal streaming, heartbeat-supervised failover re-seating (results
bit-identical to an unfailed run) and fleet-level admission control.
:class:`ProcessFleet` hardens that into real failure domains: each
replica is a child *process* with its own CUDA context, the journal is a
CRC-framed record stream over a local socket, and a relaunched or
cold-joining replica bootstraps warm from the shared runner recipes of
its :class:`ArtifactStore`.  With ``memo`` a service consults the
cross-request *solution* cache (:class:`MemoCache`): canonical-hash exact
hits are replayed, near-duplicates warm-repaired from the nearest cached
solve.
"""
from pydcop_tpu_torch.serve.artifacts import (  # noqa: F401
    ArtifactStore,
    CorruptArtifactError,
    StaleArtifactError,
    abi_tag,
)
from pydcop_tpu_torch.serve.errors import (  # noqa: F401
    DeadlineInfeasible,
    ServeError,
    ServiceOverloaded,
    ServiceStopped,
)
from pydcop_tpu_torch.serve.fleet import (  # noqa: F401
    FleetJournal,
    ReplicaHandle,
    SolveFleet,
)
from pydcop_tpu_torch.serve.memo import (  # noqa: F401
    MemoCache,
    MemoConfig,
    MemoEntry,
    MemoProbe,
)
from pydcop_tpu_torch.serve.procfleet import (  # noqa: F401
    ProcessFleet,
    ProcessReplicaHandle,
    ReplicaWorker,
)
from pydcop_tpu_torch.serve.router import (  # noqa: F401
    FleetRouter,
    job_routing_key,
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
    "ArtifactStore",
    "BucketWorker",
    "CorruptArtifactError",
    "DeadlineInfeasible",
    "FleetJournal",
    "FleetRouter",
    "MemoCache",
    "MemoConfig",
    "MemoEntry",
    "MemoProbe",
    "ProcessFleet",
    "ProcessReplicaHandle",
    "ReplicaHandle",
    "ReplicaWorker",
    "ServeError",
    "ServeJob",
    "ServiceOverloaded",
    "ServiceStopped",
    "SolveFleet",
    "SolveService",
    "StaleArtifactError",
    "abi_tag",
    "dummy_bucket_inputs",
    "fits",
    "job_routing_key",
    "restore_lane_state",
    "restore_target",
    "serve_target",
    "warm_bucket_runner",
]
