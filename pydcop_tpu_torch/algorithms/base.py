"""Shared solver harness: synchronous rounds run in chunks.

A *cycle* is one synchronous round over the whole tensor graph; a run is
a sequence of chunks of cycles, with the host checking convergence and
timeouts between chunks.  The JAX package's harness
(``pydcop_tpu/algorithms/base.py``), with its semantics: the chunk
policy (:func:`default_chunk`), ``cycles``, ``timeout``, ``max_cycles``,
``chunk``, ``stable_chunks``, ``collect_cycles`` (a per-cycle cost
``history``), ``resume`` and ``pipeline``, in one chunk loop
(:meth:`SynchronousTensorSolver._drive_chunks`) over two kinds of chunk:

* the fixed-shape runner, ONE per ``(chunk, collect)``
  (:class:`~pydcop_tpu_torch.algorithms.capture.ChunkRunner`, captured
  as a CUDA graph on the card, kept in an :class:`LruCache`): a tail
  chunk freezes its surplus cycles, the convergence bool and the
  per-cycle costs are computed inside the chunk, and with ``pipeline``
  the host reads the previous chunk's bool while the next one runs;
* for the engines whose chunk is already one cooperative kernel launch
  (the packed MaxSum, MGM, DSA and MGM-2 engines without ``collect``),
  one ``run_cycles`` call a chunk; with ``collect`` (MaxSum), one cycle
  at a time and its cost (:meth:`SynchronousTensorSolver._host_chunk`).

Convergence is a device bool tensor (:meth:`chunk_converged_device`),
read once per chunk; each read is counted in :class:`HarnessCounters`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from time import perf_counter
from typing import Any, Dict, List, Optional

import torch

from pydcop_tpu_torch.algorithms import DEFAULT_INFINITY, AlgorithmDef
from pydcop_tpu_torch.algorithms.capture import ChunkRunner, clone_state
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.ops.compile import FactorGraphTensors, total_cost


@dataclasses.dataclass
class SolveResult:
    """Result + metrics of a solve, matching the reference's
    global_metrics schema."""

    status: str
    assignment: Dict[str, Any]
    cost: Optional[float]
    violation: Optional[int]
    cycle: int
    msg_count: int
    msg_size: float
    time: float
    #: host↔device traffic scorecard of the chunk loop; None for solvers
    #: that do not run through the chunked harness (dpop)
    harness: Optional[Dict[str, Any]] = None
    #: exact-inference scorecard: for the mini-bucket fallback the
    #: i-bound and the lower/upper-bound sandwich around the (unreached)
    #: optimum; None for every other solver
    dpop: Optional[Dict[str, Any]] = None
    #: canonical fully-resolved executed config (runtime/stats)
    config: Optional[Dict[str, Any]] = None
    #: sharded-collective scorecard (runtime/stats.ShardCommCounters, the
    #: engines' ``comm_stats()``) of a sharded solve; None elsewhere
    shard: Optional[Dict[str, Any]] = None
    #: ``collect_cycles=True``: the harness's per-cycle ``{cycle, cost,
    #: time}`` (cost sign-adjusted), the anytime search's per-chunk
    #: cost, lower/upper bound, gap and time; None elsewhere
    history: Optional[List[Dict[str, Any]]] = None
    #: anytime exact-search scorecard (search/solver and the
    #: runtime/stats.SearchCounters host-traffic counts); None unless
    #: the solve ran the frontier engine
    search: Optional[Dict[str, Any]] = None
    #: which solve-service replica served this job, under which job id,
    #: and whether it resumed from a checkpoint; None unless the job
    #: passed through the serve tier
    serve: Optional[Dict[str, Any]] = None

    def metrics(self) -> Dict[str, Any]:
        out = {
            "status": self.status,
            "assignment": self.assignment,
            "cost": self.cost,
            "violation": self.violation,
            "cycle": self.cycle,
            "msg_count": self.msg_count,
            "msg_size": self.msg_size,
            "time": self.time,
        }
        if self.harness is not None:
            out["harness"] = dict(self.harness)
        if self.shard is not None:
            out["shard"] = dict(self.shard)
        if self.dpop is not None:
            out["dpop"] = dict(self.dpop)
        if self.search is not None:
            out["search"] = dict(self.search)
        if self.config is not None:
            out["config"] = dict(self.config)
        if self.serve is not None:
            out["serve"] = dict(self.serve)
        return out


#: cycle cap of a run without a cycle budget (the JAX harness's default)
MAX_CYCLES = 2000
#: consecutive converged chunks that stop an open-ended run
STABLE_CHUNKS = 2


def default_chunk(
    target: Optional[int],
    collect: bool,
    caller_chunk: bool,
    timeout: Optional[float],
    limit: int,
) -> int:
    """The harness's chunk-size policy, the JAX package's verbatim: the
    per-chunk coin draws follow the chunk boundaries, so a runner that
    wants the same results must reproduce this policy.

    * default 7 — prime, so an oscillation whose period divides the
      chunk size cannot alias to a fixed point;
    * fixed-cycle, no-metrics, no-deadline runs raise the floor to 100
      to amortize per-chunk cost.
    """
    chunk = 7
    if (
        target is not None
        and not collect
        and not caller_chunk
        and timeout is None
    ):
        chunk = min(limit, max(chunk, 100))
    return chunk


def clamp_chunk_to_deadline(
    n: int, rate_cps: Optional[float], remaining_s: Optional[float]
) -> int:
    """The largest cycle count ≤ ``n`` whose projected wall time (at the
    measured ``rate_cps`` cycles/sec) fits the remaining timeout budget;
    at least 1, and ``n`` unchanged until a rate has been measured."""
    if rate_cps is None or rate_cps <= 0 or remaining_s is None:
        return n
    budget = int(remaining_s * rate_cps)
    return max(1, min(n, budget))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LruCache:
    """Small LRU of fixed-shape chunk runners (a captured CUDA graph each
    on the card); counts its evictions (the ``compile_cache_evictions``
    harness counter)."""

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self.evictions = 0
        self._d: "OrderedDict[Any, Any]" = OrderedDict()

    def __contains__(self, key) -> bool:
        return key in self._d

    def __getitem__(self, key):
        value = self._d[key]
        self._d.move_to_end(key)
        return value

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()


class _Pending:
    """A chunk's convergence bool on its way to the host (``pipeline``):
    on CUDA copied without blocking into pinned memory behind an event,
    read by the next chunk's turn; on the CPU the tensor itself."""

    def __init__(self, conv: torch.Tensor):
        if conv.device.type == "cuda":
            self.host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.host.copy_(conv, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = conv, None

    def read(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(self.host)


class SynchronousTensorSolver:
    """Base class for batched synchronous-round solvers.

    Subclasses implement :meth:`initial_state`, :meth:`values_of`,
    :meth:`step` (one cycle from a state and that cycle's coins, without
    modifying the state; the fixed-shape runner's cycle) and, for the
    engines whose chunk is one cooperative launch, :meth:`run_cycles`;
    :meth:`draw_chunk_coins` where they draw coins, and
    :meth:`_supports_fixed_chunk` where a chunk must not go through the
    fixed-shape runner.
    """

    #: messages exchanged per cycle (metric parity with the reference)
    msgs_per_cycle: int = 0
    #: floats per message (metric parity for msg_size)
    msg_size_per_msg: float = 0.0

    def __init__(
        self,
        dcop: DCOP,
        tensors: FactorGraphTensors,
        algo_def: AlgorithmDef,
    ):
        self.dcop = dcop
        self.tensors = tensors
        self.device = tensors.device
        self.algo_def = algo_def
        self.params = algo_def.params
        self.infinity = DEFAULT_INFINITY
        self._runners = LruCache()
        #: builds of each fixed-shape runner (a CUDA graph capture on the
        #: card), evicted runners included
        self._captures: Dict[Any, int] = {}
        self._last_state = None
        #: HarnessCounters of the most recent run (None before any run)
        self.last_counters = None
        #: with True, every replay of a captured chunk runs under
        #: ``torch.cuda.set_sync_debug_mode("error")`` (a check, not a
        #: mode of the solver)
        self.check_chunk_syncs = False

    # -- to implement -------------------------------------------------------

    def initial_state(self) -> Any:
        raise NotImplementedError

    def step(self, state: Any, coins: tuple) -> Any:
        """One cycle from ``state`` (left unchanged) with this cycle's
        coins (one [...] slice of each :meth:`draw_chunk_coins` table, on
        the device)."""
        raise NotImplementedError

    def draw_chunk_coins(self, n: int) -> tuple:
        """The coins of the next ``n`` cycles: a tuple of ``[n, ...]``
        CPU tensors, drawn at the true cycle count.  Default: none."""
        return ()

    def run_cycles(self, state: Any, n: int) -> Any:
        """``n`` cycles from ``state`` (left unchanged), eagerly: the
        coins of one chunk, then :meth:`step` n times."""
        coins = tuple(c.to(self.device) for c in self.draw_chunk_coins(n))
        for i in range(n):
            state = self.step(state, tuple(c[i] for c in coins))
        return state

    def values_of(self, state: Any) -> torch.Tensor:
        """Current value indices [V] for a state."""
        raise NotImplementedError

    def chunk_cost(self, state: Any) -> torch.Tensor:
        """The per-cycle collected cost of a state (a device scalar, not
        sign-adjusted): ``total_cost`` of :meth:`values_of`."""
        return total_cost(self.tensors, self.values_of(state))

    def chunk_converged_device(self, prev_state: Any,
                               state: Any) -> torch.Tensor:
        """Did the solver reach a fixed point between two chunk
        boundaries?  A bool tensor on the device.  Default: the
        assignment did not change."""
        return torch.all(self.values_of(prev_state) == self.values_of(state))

    def _supports_fixed_chunk(self, collect: bool) -> bool:
        """True when a chunk runs the fixed-shape runner over
        :meth:`step`; engines whose chunk is one cooperative launch return
        False where it engages."""
        return True

    def _restart_streams(self, warm: bool) -> None:
        """Called at the start of every run: solvers that draw coins
        reseed their generators unless the run is a warm restart, as the
        JAX harness restarts its key at ``PRNGKey(seed)`` (and continues
        it on ``resume``)."""

    def trace_count(self) -> int:
        """Fixed-shape runners built: a CUDA graph capture each on the
        card, one eager runner each on the CPU.  A tail chunk (remainder
        or deadline) adds none."""
        return sum(self._captures.values())

    # -- harness ------------------------------------------------------------

    def _fixed_runner(self, key) -> ChunkRunner:
        """The runner of ``key = ("masked", chunk, collect)``, built once
        (and again after an eviction); on the CPU a build counts as its
        program's build, on CUDA the capture does."""
        if key not in self._runners:
            self._runners[key] = ChunkRunner(self, *key[1:])
            if self.device.type != "cuda":
                self._captures[key] = self._captures.get(key, 0) + 1
        return self._runners[key]

    def _read_conv(self, conv: torch.Tensor, counters) -> bool:
        tw = perf_counter()
        flag = bool(conv.item())
        counters.add("dispatch_wait_s", perf_counter() - tw)
        counters.add("host_sync_count", 1)
        return flag

    def _append_costs(self, costs: torch.Tensor, n: int, done: int, t0,
                      counters, history) -> None:
        """The chunk's first ``n`` per-cycle costs, sign-adjusted, into
        ``history`` (one host read)."""
        tw = perf_counter()
        vals = costs[:n].cpu().numpy() * self.tensors.sign
        counters.add("dispatch_wait_s", perf_counter() - tw)
        counters.add("host_sync_count", 1)
        for i in range(n):
            history.append({"cycle": done - n + i + 1,
                            "cost": float(vals[i]),
                            "time": perf_counter() - t0})

    def _host_chunk(self, state, n: int, collect: bool):
        """One chunk of the engines whose chunk is one cooperative launch:
        one :meth:`run_cycles` call; with ``collect``, one call a cycle
        and its cost (only engines that draw no coins take this path
        with ``collect``).  Returns (state, costs [n] or None, converged
        bool)."""
        prev = state
        costs = None
        if collect:
            costs = []
            for _ in range(n):
                state = self.run_cycles(state, 1)
                costs.append(self.chunk_cost(state))
            costs = torch.stack(costs)
        else:
            state = self.run_cycles(state, n)
        return state, costs, self.chunk_converged_device(prev, state)

    def _drive_chunks(self, state, t0, target, limit, chunk,
                      stable_chunks, collect, timeout, pipeline, counters,
                      history, run_chunk):
        """The JAX harness's chunk loop (its ``_drive_device_chunks``):
        ``run_chunk(state, n)`` runs a chunk of n live cycles and returns
        (state, costs or None, converged bool), the bool computed on the
        device; the host reads ONE bool a chunk (and the chunk's costs
        with ``collect``), or with ``pipeline`` the previous chunk's bool
        while this one runs."""
        done = 0
        completed = 0  # cycles whose device work is known finished
        stable = 0
        status = "FINISHED"
        rate = None
        pending = None  # (_Pending, counts toward stability, n)
        first = True
        while done < limit:
            n = min(chunk, limit - done)
            if timeout is not None:
                n = clamp_chunk_to_deadline(
                    n, rate, timeout - (perf_counter() - t0))
            state, collected, conv = run_chunk(state, n)
            done += n
            counters.add("chunks_dispatched", 1)
            if collect:
                self._append_costs(collected, n, done, t0, counters,
                                   history)
                completed = done
            if target is None:
                if pipeline and not collect:
                    # one-deep pipeline: this chunk's bool leaves without
                    # blocking; the PREVIOUS chunk's is read now
                    prev, pending = pending, (_Pending(conv), not first, n)
                    if prev is not None:
                        tw = perf_counter()
                        flag = prev[0].read()
                        counters.add("dispatch_wait_s", perf_counter() - tw)
                        counters.add("host_sync_count", 1)
                        completed = done - n
                        if prev[1]:
                            stable = stable + 1 if flag else 0
                            if stable >= stable_chunks:
                                # the chunk launched above runs to its
                                # end: the documented ≤ one chunk of
                                # overshoot
                                counters.add("overshoot_cycles", n)
                                break
                else:
                    flag = self._read_conv(conv, counters)
                    completed = done
                    if not first:
                        stable = stable + 1 if flag else 0
                        if stable >= stable_chunks:
                            break
            first = False
            if completed > 0:
                elapsed = perf_counter() - t0
                if elapsed > 0:
                    rate = completed / elapsed
            if timeout is not None:
                if target is not None and not collect:
                    # fixed-cycle deadline runs have no convergence read
                    # to block on: sync so the deadline (and the rate the
                    # clamp uses) measures completed device work
                    tw = perf_counter()
                    synchronize(self.device)
                    counters.add("dispatch_wait_s", perf_counter() - tw)
                    completed = done
                    elapsed = perf_counter() - t0
                    if elapsed > 0:
                        rate = completed / elapsed
                if perf_counter() - t0 > timeout:
                    status = "TIMEOUT"
                    break
        return state, done, status

    def run(
        self,
        cycles: Optional[int] = None,
        timeout: Optional[float] = None,
        max_cycles: int = MAX_CYCLES,
        chunk: Optional[int] = None,
        stable_chunks: int = STABLE_CHUNKS,
        collect_cycles: bool = False,
        resume: bool = False,
        pipeline: bool = False,
    ) -> SolveResult:
        """Run the solver, with the JAX harness's semantics.

        * ``cycles`` set → run exactly that many cycles (the reference's
          ``stop_cycle``);
        * otherwise → run until the assignment is stable for
          ``stable_chunks`` consecutive chunks, or ``max_cycles``/timeout;
        * ``chunk`` overrides :func:`default_chunk`;
        * ``collect_cycles=True`` keeps each cycle's cost in ``history``;
        * ``resume=True`` continues from the previous run's state and coin
          stream (a warm restart) instead of :meth:`initial_state`;
        * ``pipeline=True`` dispatches chunk k+1 before reading chunk k's
          convergence bool (open-ended runs on the fixed-shape runner):
          the stop comes at most ONE chunk late (``overshoot_cycles``,
          and in the reported ``cycle``), the assignment is the same.
        """
        # imported here: runtime/__init__ imports the solve API, which
        # imports this module
        from pydcop_tpu_torch.runtime.events import send_harness
        from pydcop_tpu_torch.runtime.stats import (
            HarnessCounters,
            resolved_config,
        )

        t0 = perf_counter()
        counters = HarnessCounters()
        target = cycles if cycles else None
        limit = target if target is not None else max_cycles
        if chunk is None:
            chunk = default_chunk(target, collect_cycles, False, timeout,
                                  limit)
        warm = resume and self._last_state is not None
        self._restart_streams(warm)
        state = self._last_state if warm else self.initial_state()
        history: List[Dict[str, Any]] = []
        fixed = self._supports_fixed_chunk(collect_cycles)
        if fixed:
            key = ("masked", chunk, collect_cycles)
            runner = self._fixed_runner(key)
            captures = runner.captures

            def run_chunk(state, n):
                if n < chunk:
                    counters.add("masked_tail_cycles", chunk - n)
                replays = runner.replays
                out = runner(state, self.draw_chunk_coins(n), n)
                # a replay writes the chunk's state into the graph's
                # buffers in place (JAX counts a chunk whose state
                # buffers were donated)
                counters.add("donated_chunks", runner.replays - replays)
                return out
        else:
            def run_chunk(state, n):
                return self._host_chunk(state, n, collect_cycles)

        # as in the JAX package, the engines whose chunk is one
        # cooperative launch read each chunk's bool before the next
        state, done, status = self._drive_chunks(
            state, t0, target, limit, chunk, stable_chunks, collect_cycles,
            timeout, pipeline and fixed, counters, history, run_chunk)
        if fixed:
            self._captures[key] = (self._captures.get(key, 0)
                                   + runner.captures - captures)
            # the runner's state may alias a captured graph's buffers
            state = clone_state(state)
        self._last_state = state
        counters.counts["compile_cache_evictions"] = self._runners.evictions
        self.last_counters = counters
        final_vals = self.values_of(state).cpu().numpy()
        assignment = self.tensors.assignment_from_indices(final_vals)
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
        send_harness("run.done", {
            "algo": self.algo_def.algo,
            "status": status,
            "cycle": done,
            **counters.as_dict(),
        })
        return SolveResult(
            status=status,
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=done,
            msg_count=self.msgs_per_cycle * done,
            msg_size=self.msgs_per_cycle * done * self.msg_size_per_msg,
            time=perf_counter() - t0,
            harness=counters.as_dict(),
            history=history if collect_cycles else None,
            config=resolved_config(self.algo_def.algo, "harness",
                                   chunk=chunk),
        )
