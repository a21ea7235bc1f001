"""Shared solver harness: synchronous rounds run in chunks.

A *cycle* is one synchronous round over the whole tensor graph; a run is
a sequence of chunks of cycles, with the host checking convergence and
timeouts between chunks.  The loop keeps the JAX package's semantics
(``_drive_device_chunks`` there): the prime default chunk of 7, two
stable chunks to stop, the fixed-cycle floor of 100, and the meaning of
``cycles``, ``timeout`` and the 2000-cycle cap of open-ended runs.

Convergence is a device bool tensor (:meth:`chunk_converged_device`),
read once per chunk; each read is counted in :class:`HarnessCounters`.
A chunk is a plain Python loop of launches — there is no capture into a
CUDA graph and no pipelining of chunks yet.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Any, Dict, Optional

import torch

from pydcop_tpu_torch.algorithms import DEFAULT_INFINITY, AlgorithmDef
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.ops.compile import FactorGraphTensors


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
        if self.config is not None:
            out["config"] = dict(self.config)
        return out


#: cycle cap of a run without a cycle budget (the JAX harness's default)
MAX_CYCLES = 2000
#: consecutive converged chunks that stop an open-ended run
STABLE_CHUNKS = 2


def default_chunk(target: Optional[int], timeout: Optional[float],
                  limit: int) -> int:
    """The harness's chunk-size policy, as in the JAX package (which
    also keeps 7 when per-cycle metrics are collected or the caller sets
    the chunk — neither exists here yet):

    * default 7 — prime, so an oscillation whose period divides the
      chunk size cannot alias to a fixed point;
    * fixed-cycle, no-deadline runs raise the floor to 100 to amortize
      per-chunk cost.
    """
    chunk = 7
    if target is not None and timeout is None:
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


class SynchronousTensorSolver:
    """Base class for batched synchronous-round solvers.

    Subclasses implement :meth:`initial_state`, :meth:`run_cycles` (n
    cycles from a state, without modifying it), :meth:`values_of` and
    :meth:`chunk_converged_device`.
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

    # -- to implement -------------------------------------------------------

    def initial_state(self) -> Any:
        raise NotImplementedError

    def run_cycles(self, state: Any, n: int) -> Any:
        raise NotImplementedError

    def values_of(self, state: Any) -> torch.Tensor:
        """Current value indices [V] for a state."""
        raise NotImplementedError

    def chunk_converged_device(self, prev_state: Any,
                               state: Any) -> torch.Tensor:
        """Did the solver reach a fixed point between two chunk
        boundaries?  A bool tensor on the device.  Default: the
        assignment did not change."""
        return torch.all(self.values_of(prev_state) == self.values_of(state))

    # -- harness ------------------------------------------------------------

    def _read_conv(self, conv: torch.Tensor, counters) -> bool:
        tw = perf_counter()
        flag = bool(conv.item())
        counters.add("dispatch_wait_s", perf_counter() - tw)
        counters.add("host_sync_count", 1)
        return flag

    def _drive_chunks(self, state, t0, target, limit, chunk, timeout,
                      counters):
        done = 0
        stable = 0
        status = "FINISHED"
        rate = None
        first = True
        while done < limit:
            n = min(chunk, limit - done)
            if timeout is not None:
                n = clamp_chunk_to_deadline(
                    n, rate, timeout - (perf_counter() - t0)
                )
            prev = state
            state = self.run_cycles(state, n)
            done += n
            counters.add("chunks_dispatched", 1)
            completed = 0
            if target is None:
                flag = self._read_conv(
                    self.chunk_converged_device(prev, state), counters)
                completed = done
                if not first:
                    stable = stable + 1 if flag else 0
                    if stable >= STABLE_CHUNKS:
                        break
            first = False
            if completed > 0:
                elapsed = perf_counter() - t0
                if elapsed > 0:
                    rate = completed / elapsed
            if timeout is not None:
                if target is not None:
                    # fixed-cycle deadline runs have no convergence read
                    # to block on: sync so the deadline (and the rate the
                    # clamp uses) measures completed device work
                    tw = perf_counter()
                    synchronize(self.device)
                    counters.add("dispatch_wait_s", perf_counter() - tw)
                    elapsed = perf_counter() - t0
                    if elapsed > 0:
                        rate = done / elapsed
                if perf_counter() - t0 > timeout:
                    status = "TIMEOUT"
                    break
        return state, done, status

    def run(self, cycles: Optional[int] = None,
            timeout: Optional[float] = None) -> SolveResult:
        """Run the solver.

        * ``cycles`` set → run exactly that many cycles (the reference's
          ``stop_cycle``);
        * otherwise → run until the solver is stable for
          ``STABLE_CHUNKS`` consecutive chunks, or ``MAX_CYCLES``/timeout.
        """
        # imported here: runtime/__init__ imports the solve API, which
        # imports this module
        from pydcop_tpu_torch.runtime.stats import (
            HarnessCounters,
            resolved_config,
        )

        t0 = perf_counter()
        counters = HarnessCounters()
        target = cycles if cycles else None
        limit = target if target is not None else MAX_CYCLES
        chunk = default_chunk(target, timeout, limit)
        state, done, status = self._drive_chunks(
            self.initial_state(), t0, target, limit, chunk, timeout,
            counters,
        )
        final_vals = self.values_of(state).cpu().numpy()
        assignment = self.tensors.assignment_from_indices(final_vals)
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
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
            config=resolved_config(self.algo_def.algo, "harness",
                                   chunk=chunk),
        )
