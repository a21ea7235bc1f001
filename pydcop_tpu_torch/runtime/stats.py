"""Counters and the executed-config record of a solve.

The parts of the JAX package's ``runtime/stats.py`` that the chunked
harness, the sharded engines and the frontier search use, with the same names and schemas,
so that ``SolveResult.metrics()`` has the same keys in both packages.
"""
from __future__ import annotations

import dataclasses

#: counter names surfaced under ``SolveResult.metrics()["harness"]`` by
#: the chunked solve harness — how often the host blocked on the device
#: and what it paid per chunk.  This package runs no fixed-shape,
#: donating or pipelined runner yet, so ``donated_chunks``,
#: ``masked_tail_cycles``, ``overshoot_cycles`` and
#: ``compile_cache_evictions`` stay 0; the keys are kept for the schema.
HARNESS_COUNTERS = (
    "chunks_dispatched",        # chunk launches
    "host_sync_count",          # device→host reads in the loop
    "dispatch_wait_s",          # wall seconds blocked on device results
    "donated_chunks",           # chunks run through a donating runner
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
