"""Counters and the executed-config record of a solve.

The parts of the JAX package's ``runtime/stats.py`` that the chunked
harness, the sharded engines, the frontier search, the batched solve
engine and the solve service use, with the same names and schemas,
so that ``SolveResult.metrics()`` has the same keys in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: counter names surfaced under ``SolveResult.metrics()["harness"]`` by
#: the chunked solve harness — how often the host blocked on the device
#: and what it paid per chunk.  ``donated_chunks`` counts the replays of
#: a captured chunk, which write the state into the CUDA graph's buffers
#: in place (the JAX package counts a chunk whose state buffers were
#: donated to XLA); 0 on the CPU.
HARNESS_COUNTERS = (
    "chunks_dispatched",        # chunk launches
    "host_sync_count",          # device→host reads in the loop
    "dispatch_wait_s",          # wall seconds blocked on device results
    "donated_chunks",           # chunks that updated the state in place
    "masked_tail_cycles",       # frozen cycles in fixed-shape tail chunks
    "overshoot_cycles",         # cycles run past the stop (pipelined mode)
    "compile_cache_evictions",  # chunk-runner cache evictions
)


class HarnessCounters:
    """Host↔device traffic counters collected by the solve harness and
    merged into its result (``SolveResult.metrics()['harness']``).
    ``dispatch_wait_s`` accumulates float seconds; everything else is an
    integer count."""

    def __init__(self):
        self.counts = {
            k: (0.0 if k == "dispatch_wait_s" else 0)
            for k in HARNESS_COUNTERS
        }

    def add(self, name: str, n=1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown harness counter {name!r}; add it to "
                f"HARNESS_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        out = dict(self.counts)
        out["dispatch_wait_s"] = round(out["dispatch_wait_s"], 6)
        return out


#: counter names surfaced under ``SolveResult.metrics()["search"]`` by
#: the frontier search's chunk loop (search/solver)
SEARCH_COUNTERS = (
    "chunks",            # device chunk dispatches
    "scalar_reads",      # host-read scalars (2 per chunk steady-state)
    "spill_drains",      # annex drains (the counted host fallback)
    "spill_rows",        # rows pulled host-side across all drains
    "reinjected_rows",   # stashed rows returned to the device
)


class SearchCounters:
    """Host-traffic counters of the frontier search chunk loop,
    merged into ``SolveResult.metrics()['search']``."""

    def __init__(self):
        self.counts = {k: 0 for k in SEARCH_COUNTERS}

    def __getitem__(self, name: str) -> int:
        return self.counts[name]

    def __setitem__(self, name: str, value: int) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown search counter {name!r}; add it to "
                f"SEARCH_COUNTERS"
            )
        self.counts[name] = value

    def as_dict(self) -> dict:
        return dict(self.counts)


#: counter names surfaced under ``BatchEngine.metrics()`` by the batched
#: solve engine (``pydcop_tpu_torch/batch/engine.py``) — the JAX
#: package's schema, one for the library API, ``solve --batch`` and the
#: ``batch`` command.  ``compile_misses`` counts bucket-runner builds
#: (the runner captures its chunk as a CUDA graph on the card).
BATCH_COUNTERS = (
    "instances_enqueued",     # items handed to BatchEngine.solve
    "instances_solved",
    "instances_converged",    # converged before the cycle limit
    "buckets_formed",
    "compile_hits",           # bucket-runner cache hits
    "compile_misses",         # bucket runners built in this process
    "fallback_sequential",    # algorithms outside the batched set, 1 by 1
    "padded_cells",           # stacked array cells holding padding
    "stacked_cells",          # total stacked array cells
    "lanes_nonfinite",        # lanes frozen ERROR by the chunk-boundary
                              # NaN/Inf check
)


class BatchCounters:
    """Batched-solve counters collected by the BatchEngine and merged
    into its run summary (``BatchEngine.metrics()``)."""

    def __init__(self):
        self.counts = {k: 0 for k in BATCH_COUNTERS}

    def inc(self, name: str, n: int = 1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown batch counter {name!r}; add it to "
                f"BATCH_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        return dict(self.counts)

    @property
    def padding_waste(self) -> float:
        total = self.counts["stacked_cells"]
        return self.counts["padded_cells"] / total if total else 0.0


#: counter names surfaced under ``metrics()["serve"]`` by the
#: continuous-batching solve service (:mod:`pydcop_tpu_torch.serve`) —
#: the JAX package's ``SERVE_COUNTERS``, name for name: the
#: admission/slot-reuse scorecard of a serving session, alongside the
#: per-sweep BatchCounters
SERVE_COUNTERS = (
    "jobs_submitted",         # jobs accepted by SolveService.submit
    "jobs_admitted",          # jobs placed into a bucket lane
    "jobs_completed",
    "jobs_preempted",         # deadline-expired jobs evicted from lanes
    "jobs_resumed",           # jobs restored from a journal checkpoint
    "jobs_fallback",          # algorithms outside the batched set, 1 by 1
    "lanes_reused",           # admissions into a lane a prior job freed
    "midflight_admissions",   # admissions into an already-running bucket
    "buckets_opened",
    "buckets_merged",         # under-filled same-signature buckets folded
    "buckets_closed",
    "deadline_shrunk_lanes",  # lane-chunks clamped for deadline pressure
    "prewarmed_runners",      # runners scheduled for ahead-of-arrival build
    "prewarm_skipped_exact",  # prewarm items outside the batched set:
                              # nothing to prewarm, solved 1 by 1 later
    "checkpoints_saved",      # per-lane chunk-boundary snapshots written
    # -- fault isolation / overload: the alerting surface of the service
    "scheduler_restarts",     # supervisor relaunches of the tick loop
    "buckets_failed",         # bucket workers torn down by a step exception
    "jobs_retried",           # quarantine retry re-admissions (with backoff)
    "jobs_quarantined",       # poison jobs escalated to sequential fallback
    "lanes_nan",              # non-finite lane detections (state or cost)
    "jobs_shed",              # overload rejections + displaced pending jobs
    "quota_rejections",       # submits rejected by the per-tenant quota
    "ticks_stalled",          # injected stall_tick faults absorbed
    "faults_injected",        # serve fault-plan faults fired (any kind)
    "events_dropped",         # per-job stream events dropped (slow consumer)
    "torn_journal_lines",     # journal lines skipped as torn on resume
    "journal_compactions",    # jobs.jsonl compaction rewrites
)


class ServeCounters:
    """Continuous-batching service counters collected by the
    SolveService scheduler (``SolveService.metrics()['serve']``).

    ``replica`` labels which fleet replica this service is (None for a
    standalone service; the fleets are not ported yet)."""

    def __init__(self, replica: Optional[str] = None):
        self.replica = replica
        self.counts = {k: 0 for k in SERVE_COUNTERS}
        #: per-tenant share of ``events_dropped``
        self.events_dropped_by_tenant: dict = {}

    def inc(self, name: str, n: int = 1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown serve counter {name!r}; add it to "
                f"SERVE_COUNTERS"
            )
        self.counts[name] += n

    def drop_event(self, tenant: Optional[str], n: int = 1) -> None:
        """Count one dropped stream event against its tenant (and the
        flat ``events_dropped`` total)."""
        self.inc("events_dropped", n)
        t = tenant or "default"
        self.events_dropped_by_tenant[t] = (
            self.events_dropped_by_tenant.get(t, 0) + n
        )

    def as_dict(self) -> dict:
        out = dict(self.counts)
        out["replica"] = self.replica
        out["events_dropped_by_tenant"] = dict(
            self.events_dropped_by_tenant
        )
        return out


def resolved_config(
    algo: str,
    engine: str,
    chunk: int = 0,
    overlap: str = "default",
    boundary_threshold: float = 0.5,
    dpop_budget_mb: float = 0.0,
    i_bound: int = 0,
    precision: str = "f32",
) -> dict:
    """The canonical executed-config record surfaced as
    ``SolveResult.metrics()["config"]``, with the JAX package's keys;
    ``None``/0 mean "not applicable on this path" (this package runs
    only the ``harness`` engine at the f32 tier)."""
    return {
        "algo": str(algo),
        "engine": str(engine),
        "chunk": int(chunk),
        "overlap": str(overlap),
        "boundary_threshold": float(boundary_threshold),
        "dpop_budget_mb": float(dpop_budget_mb),
        "i_bound": int(i_bound),
        "precision": str(precision),
    }


#: field names surfaced under ``SolveResult.metrics()["shard"]`` by the
#: sharded engines (``parallel/mesh.py::CommPlan.counters``) — the
#: partition-quality + collective-path scorecard of a sharded solve
SHARD_COMM_FIELDS = (
    "mode",                      # dense (the only mode ported)
    "collective",                # psum: the ordered all-shard sum
    "n_shards",
    "boundary_columns",          # variables touched by 2+ shards
    "total_columns",             # dense collective width
    "cut_fraction",              # boundary / factor-touched variables
    "boundary_fraction",         # boundary / all variables
    "bytes_per_cycle_dense",     # per-shard collective payload, dense
    "bytes_per_cycle_compact",   # per-shard payload on the chosen path
    "exchange_rounds",           # ppermute rounds (0 unless ppermute)
    "threshold",                 # auto-policy cut-fraction threshold
)


@dataclasses.dataclass
class ShardCommCounters:
    """Partition quality + per-cycle collective cost of a sharded
    engine: which collective path it runs and what it pays per cycle.
    Built by ``parallel/mesh.py::CommPlan.counters``; surfaced as
    ``SolveResult.metrics()["shard"]``.  The fields and their order are
    the JAX package's."""

    mode: str
    collective: str
    n_shards: int
    boundary_columns: int
    total_columns: int
    cut_fraction: float
    boundary_fraction: float
    bytes_per_cycle_dense: int
    bytes_per_cycle_compact: int
    exchange_rounds: int = 0
    threshold: float = 0.5

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["cut_fraction"] = round(out["cut_fraction"], 6)
        out["boundary_fraction"] = round(out["boundary_fraction"], 6)
        return out

    @property
    def compact_savings(self) -> float:
        """Fraction of dense collective bytes the chosen path avoids."""
        if not self.bytes_per_cycle_dense:
            return 0.0
        return 1.0 - (
            self.bytes_per_cycle_compact / self.bytes_per_cycle_dense
        )
