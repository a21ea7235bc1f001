"""Counters and the executed-config record of a solve.

The parts of the JAX package's ``runtime/stats.py`` that the chunked
harness, the sharded engines, the frontier search, the batched solve
engine, the solve service and its fleets, the warm-repair layer, the
solution cache and the orchestrator's fault section use, with the same names and schemas,
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
    standalone service)."""

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


#: counter names surfaced under ``SolveFleet.metrics()['fleet']`` by
#: the replicated solve fleet (pydcop_tpu_torch.serve.fleet) — the
#: routing / failover / recovery scorecard of a fleet session, alongside
#: each replica's own ServeCounters; the JAX package's
#: ``FLEET_COUNTERS``, name for name
FLEET_COUNTERS = (
    "jobs_routed",             # jobs placed on a replica by the router
    "jobs_routed_warm",        # placements onto an already-warm replica
    "jobs_reseated",           # failover re-seats onto a peer replica
    "reseat_checkpoint_hits",  # re-seats restored from a lane checkpoint
    "reseat_cold_restarts",    # re-seats replayed from cycle 0
    "replicas_up",             # replicas brought up (initial + later)
    "replicas_down",           # replicas declared dead (kill / crash)
    "replicas_stalled",        # replicas with a stale heartbeat
    "replicas_healed",         # stalled/partitioned replicas recovered
    "replicas_partitioned",    # replicas made unreachable for placement
    "jobs_shed",               # fleet-level admission rejections
    "quota_rejections",        # fleet-level per-tenant quota rejections
    "faults_injected",         # fleet fault-plan faults fired
    "journal_torn_lines",      # torn fleet-journal lines skipped on load
    "recoveries_completed",    # replica losses fully recovered (RTO set)
    "devices_lost",            # devices lost by replicas (kill_device
                               # faults with a replica)
    "capacity_reduced",        # reduced-capacity advertisements pushed
                               # to the router after device loss
    "replicas_relaunched",     # dead replica PROCESSES respawned by the
                               # process fleet's backoff relauncher
    "socket_partitions",       # journal-socket partitions injected
                               # (partition_socket faults)
    "artifacts_corrupted",     # runner artifacts corrupted in place
                               # (corrupt_artifact faults)
    "memo_shared",             # solution-cache entries broadcast to
                               # peer replicas via the journal stream
)


class FleetCounters:
    """Fleet-level counters collected by the SolveFleet supervisor and
    merged into its run summary (``SolveFleet.metrics()['fleet']``)."""

    def __init__(self):
        self.counts = {k: 0 for k in FLEET_COUNTERS}

    def inc(self, name: str, n: int = 1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown fleet counter {name!r}; add it to "
                f"FLEET_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        return dict(self.counts)


#: counter names surfaced under ``SolveResult.metrics()["repair"]`` by
#: the warm-repair layer (runtime/repair.WarmRepairController +
#: algorithms/warm) — the JAX package's ``REPAIR_COUNTERS``, name for
#: name: the fixed-shape mutation scorecard of a live run
REPAIR_COUNTERS = (
    "mutations_applied",          # fixed-shape buffer-write mutations
    "headroom_claimed",           # slots claimed (add variable/factor)
    "headroom_released",          # slots released (remove)
    "headroom_exhausted_repacks",  # ONE counted repack per exhaustion
    "repair_retraces",            # chunk-runner captures caused by
                                  # repairs (0 while headroom holds)
    "time_to_recover_s",          # wall seconds from mutation to the
                                  # re-converged fixed point (float sum)
)


class RepairCounters:
    """Warm-repair counters collected by the repair controller and
    attached to every ``SolveResult`` of a warm engine
    (``metrics()['repair']``).  ``time_to_recover_s`` accumulates float
    seconds; everything else is an integer count."""

    def __init__(self):
        self.counts = {
            k: (0.0 if k == "time_to_recover_s" else 0)
            for k in REPAIR_COUNTERS
        }

    def inc(self, name: str, n=1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown repair counter {name!r}; add it to "
                f"REPAIR_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        out = dict(self.counts)
        out["time_to_recover_s"] = round(out["time_to_recover_s"], 6)
        return out


#: counter names surfaced under ``metrics()["resilience"]`` — the JAX
#: package's ``RESILIENCE_COUNTERS``, name for name: one schema for the
#: thread mode (the orchestrator) and the process mode (not ported), so
#: collectors need no mode-specific parsing
RESILIENCE_COUNTERS = (
    "faults_injected",      # fault-plan faults fired (any kind)
    "rank_crashes",         # ranks seen dead (injected kill or signal)
    "rank_stalls",          # ranks declared stalled by the watchdog
    "retries",              # full-mesh relaunches after a failure
    "resumes",              # runs warm-started from a checkpoint
    "repairs",              # agent-removal repair DCOPs solved
    "checkpoints_saved",
    "checkpoints_rejected",  # snapshots refused (checksum/version)
    "degraded_to_thread",   # process mode fell back to thread mode
)


class FaultCounters:
    """Fault + recovery counters collected by the orchestrator and
    merged into its end metrics (``metrics()['resilience']``)."""

    def __init__(self):
        self.counts = {k: 0 for k in RESILIENCE_COUNTERS}

    def inc(self, name: str, n: int = 1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown resilience counter {name!r}; add it to "
                f"RESILIENCE_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        return dict(self.counts)

    @property
    def any_faults(self) -> bool:
        return any(self.counts.values())


#: counter names surfaced under ``metrics()["memo"]`` by the
#: cross-request solution cache (``serve/memo.py::MemoCache``) — the
#: JAX package's ``MEMO_COUNTERS``, name for name: the hit-taxonomy /
#: invalidation / sharing scorecard of a serving run
MEMO_COUNTERS = (
    "hits_exact",              # content-hash exact-duplicate hits
    "hits_variant",            # embedding-matched warm-start hits
    "misses",                  # lookups that found nothing servable
    "inserts",                 # solved jobs added to the cache
    "evicted_lru",             # entries displaced at max_entries
    "expired_ttl",             # entries dropped past their TTL
    "invalidated_churn",       # entries dropped by a churn event
    "variant_rejected_gate",   # candidates refused by the feasibility
                               # gate (shape mismatch / diff too large)
    "variant_cold_fallbacks",  # warm repairs discarded for converging
                               # worse than their seed, or refused by
                               # the warm path (never-worse guarantee:
                               # the cold result is served)
    "variant_repacks",         # headroom-exhausted repacks during replay
    "corrupt_skipped",         # CRC-failed npz entries skipped-and-
                               # counted on rehydrate/adopt, never served
    "rehydrated",              # entries restored from disk by resume()
    "adopted",                 # entries adopted from peers
)


class MemoCounters:
    """Solution-cache counters collected by the MemoCache and merged
    into the serve summary (``SolveService.metrics()['memo']``)."""

    def __init__(self):
        self.counts = {k: 0 for k in MEMO_COUNTERS}

    def inc(self, name: str, n: int = 1) -> None:
        if name not in self.counts:
            raise KeyError(
                f"unknown memo counter {name!r}; add it to "
                f"MEMO_COUNTERS"
            )
        self.counts[name] += n

    def as_dict(self) -> dict:
        return dict(self.counts)


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
