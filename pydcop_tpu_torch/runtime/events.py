"""In-process event bus.

The JAX package's ``runtime/events.py`` (itself the reference's
pydcop/infrastructure/Events.py :41-96): topic-based pub/sub with ``*``
wildcard suffix matching, disabled by default, and one ``send_*`` helper
per topic prefix.  The port emits ``harness.run.done`` (the solve
harness, ``algorithms/base.py``), ``search.*`` (the frontier search,
``search/solver.py``), ``dpop.minibucket.bounds`` (``algorithms/dpop.py``),
``shard.comm.selected`` (the sharded engines, ``parallel/mesh.py``) and
``batch.*`` (the batched solve engine, ``batch/engine.py`` and
``batch/cache.py``),
with the JAX package's payload keys.  The other prefixes are kept for the
modules that will emit them when they are ported.
"""
from __future__ import annotations

from typing import Callable, List, Tuple


class EventDispatcher:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._subs: List[Tuple[str, Callable]] = []

    def subscribe(self, topic: str, callback: Callable) -> None:
        self._subs.append((topic, callback))

    def unsubscribe(self, callback: Callable) -> None:
        self._subs = [(t, cb) for t, cb in self._subs if cb != callback]

    def send(self, topic: str, evt) -> None:
        if not self.enabled:
            return
        for pattern, cb in list(self._subs):
            if self._match(pattern, topic):
                cb(topic, evt)

    @staticmethod
    def _match(pattern: str, topic: str) -> bool:
        if pattern == topic or pattern == "*":
            return True
        if pattern.endswith("*"):
            return topic.startswith(pattern[:-1])
        return False


#: process-global bus, disabled unless observability is turned on
event_bus = EventDispatcher()

#: fault/recovery topics (``faults.injected.<kind>``, ...)
FAULT_TOPIC_PREFIX = "faults."
#: batched-solve topics: ``batch.bucket.formed`` (algo, signature, size,
#: waste), ``batch.compile.hit`` / ``batch.compile.miss`` (the runner's
#: cache key), ``batch.instance.converged`` (label, cycle),
#: ``batch.lane.nonfinite`` (label, lane, cycle) and ``batch.run.done``
#: (instances, buckets, wall, cache)
BATCH_TOPIC_PREFIX = "batch."
#: solve-service topics (``serve.job.submitted``, ``serve.job.done``, ...)
SERVE_TOPIC_PREFIX = "serve."
#: solution-cache topics (``memo.hit.exact``, ``memo.miss``, ...)
MEMO_TOPIC_PREFIX = "memo."
#: solve-fleet topics (``fleet.replica.up``, ``fleet.job.reseated``, ...)
FLEET_TOPIC_PREFIX = "fleet."
#: sharded-collective topics: ``shard.comm.selected`` (the engine's
#: collective path and partition scorecard, emitted once at build time)
SHARD_TOPIC_PREFIX = "shard."
#: data-integrity topics (``integrity.sentinel.trip``, ...)
INTEGRITY_TOPIC_PREFIX = "integrity."
#: elastic-mesh topics (``elastic.device.lost``, ``elastic.shrink``, ...)
ELASTIC_TOPIC_PREFIX = "elastic."
#: exact-inference topics: ``dpop.minibucket.bounds`` (i_bound,
#: lower_bound, upper_bound, gap — after a bounded mini-bucket solve);
#: ``dpop.shard.*`` come with the sharded sweep
DPOP_TOPIC_PREFIX = "dpop."
#: warm-repair topics (``repair.mutation.applied``, ...)
REPAIR_TOPIC_PREFIX = "repair."
#: portfolio topics (``portfolio.config.selected``, ...)
PORTFOLIO_TOPIC_PREFIX = "portfolio."
#: SLO guardrail topics (``slo.tier.breach``, ...)
SLO_TOPIC_PREFIX = "slo."
#: anytime exact-search topics: ``search.bounds`` (chunk, incumbent,
#: lower_bound, upper_bound, gap, proved — one a device chunk),
#: ``search.spill.drain`` (chunk, stash_rows) and ``search.done``
#: (status, optimal, chunks, nodes, cost)
SEARCH_TOPIC_PREFIX = "search."
#: solve-harness topics: ``harness.run.done`` (algo, status, cycle and the
#: HarnessCounters scorecard)
HARNESS_TOPIC_PREFIX = "harness."


def _sender(prefix: str) -> Callable[[str, object], None]:
    def send(event: str, payload) -> None:
        event_bus.send(prefix + event, payload)

    send.__doc__ = (f"Publish ``{prefix}<event>`` on the global bus (no-op "
                    f"unless observability is enabled).")
    return send


send_fault = _sender(FAULT_TOPIC_PREFIX)
send_batch = _sender(BATCH_TOPIC_PREFIX)
send_serve = _sender(SERVE_TOPIC_PREFIX)
send_memo = _sender(MEMO_TOPIC_PREFIX)
send_fleet = _sender(FLEET_TOPIC_PREFIX)
send_shard = _sender(SHARD_TOPIC_PREFIX)
send_integrity = _sender(INTEGRITY_TOPIC_PREFIX)
send_elastic = _sender(ELASTIC_TOPIC_PREFIX)
send_dpop = _sender(DPOP_TOPIC_PREFIX)
send_repair = _sender(REPAIR_TOPIC_PREFIX)
send_portfolio = _sender(PORTFOLIO_TOPIC_PREFIX)
send_slo = _sender(SLO_TOPIC_PREFIX)
send_search = _sender(SEARCH_TOPIC_PREFIX)
send_harness = _sender(HARNESS_TOPIC_PREFIX)
