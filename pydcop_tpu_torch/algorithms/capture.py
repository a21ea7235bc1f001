"""The fixed-shape chunk runner, captured as a CUDA graph on the card.

The port of the JAX harness's ``_masked_chunk_runner``
(``pydcop_tpu/algorithms/base.py:512-558``): ONE runner per ``(chunk,
collect)`` runs ``chunk`` cycles, and a cycle at index ``>= n_active``
passes the state through unchanged, so a tail chunk (a remainder, or a
chunk shrunk to a deadline) reuses the same program.  Inside it the
runner also computes the chunk's convergence bool (the solver's
``chunk_converged_device`` against the chunk's input state) and, with
``collect``, each cycle's cost (the solver's ``chunk_cost``).

* On CUDA the first ``warmup`` calls (:data:`EAGER_CALLS` for a
  solver's runner) run the chunk eagerly, so a run of one or two chunks
  (a 200-cycle solve at the default chunk of 100) pays for no capture
  (the batched engine's bucket runners, reused across solves, warm up
  with one call); they are also the capture's warm-up: they
  build the kernels, the cached index plans and the launch libraries.
  The next call captures the chunk once as a ``torch.cuda.CUDAGraph``
  (``captures`` counts it; a failed capture raises, nothing falls back)
  and replays it, and so does every later call.  The graph reads the
  state, the chunk's coins (``[chunk, ...]``, the true ``n`` rows copied
  in before each replay) and ``n_active`` from static buffers; a frozen
  cycle is a ``torch.where`` on the device ``i < n_active``, as JAX's
  ``lax.cond``; at its end the graph writes the new state back into the
  state buffers in place.  A replay copies a state that is not the
  graph's own into the buffers, the coins and ``n`` in, and replays.
  What a replay returns aliases the graph's buffers and the next replay
  overwrites it, so the harness reads the convergence bool and the costs
  before it replays again, and copies out the state it keeps.
* On the CPU the same cycles run eagerly at every call (the parity
  path); frozen cycles are skipped on the host, which gives the same
  result.

The kernel wrappers count their launches in Python, which a replay does
not run: the capture records each counter's increase inside the graph
(and takes it back, since a capture launches nothing), and every replay
adds it again, so the counters read what the card launched.
``chip_smoke.py``'s harness phase holds the recorded count to the kernel
nodes of the captured graph (``keep_graph``) and to a profiler trace of
the replays.  The
cooperative kernels (K1, K4, K5, K6, K7, K10) are not captured in this
package yet: their engines keep one launch a chunk outside a graph.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, List, Sequence, Tuple

import torch

from pydcop_tpu_torch.ops import launch_counters, read_launch_counters


def flatten(state) -> List[torch.Tensor]:
    """The tensors of a state (nested tuples of tensors), depth first."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in flatten(part)]


def unflatten(like, leaves: Sequence[torch.Tensor]):
    """A state shaped like ``like`` from its tensors in :func:`flatten`
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        return tuple(build(part) for part in node)

    return build(like)


def clone_state(state):
    return unflatten(state, [t.clone() for t in flatten(state)])


#: eager calls of a CUDA runner before it captures its chunk
EAGER_CALLS = 2


@contextlib.contextmanager
def sync_checked(enabled: bool):
    """``torch.cuda.set_sync_debug_mode("error")`` around the block when
    ``enabled``: any host synchronisation inside raises."""
    if not enabled:
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class ChunkRunner:
    """One fixed-shape chunk of ``chunk`` cycles of ``solver`` (its
    ``step``, ``chunk_cost`` and ``chunk_converged_device``).  Calling it
    with ``(state, coins, n)`` — ``coins`` the tuple of ``[n, ...]`` CPU
    tensors of :meth:`~SynchronousTensorSolver.draw_chunk_coins` — runs
    ``n <= chunk`` live cycles and returns ``(state, costs [chunk] or
    None, converged bool)`` on the solver's device."""

    #: keep each captured ``cudaGraph_t`` beside its executable graph, so
    #: that ``self.graph.debug_dump(path)`` can write its nodes
    keep_graph = False

    def __init__(self, solver, chunk: int, collect: bool,
                 warmup: int = EAGER_CALLS):
        self.solver = solver
        #: eager calls before the capture (at least 1, the warm-up)
        self.warmup = max(1, int(warmup))
        self.chunk = int(chunk)
        self.collect = bool(collect)
        self.device = solver.device
        self.graph = None
        #: eager calls on CUDA (the first ``warmup`` calls)
        self.eager_calls = 0
        #: CUDA graph captures of this runner (0 or 1)
        self.captures = 0
        #: replays of the captured graph
        self.replays = 0

    # -- the chunk ------------------------------------------------------

    def _cycles(self, state, coins, active: Callable[[int], Any]):
        """The chunk's cycles.  ``active(i)`` is a Python bool (eager:
        a frozen cycle is skipped) or a device bool (captured: a frozen
        cycle's result is dropped by ``torch.where``)."""
        solver = self.solver
        prev = state
        costs = []
        for i in range(self.chunk):
            a = active(i)
            if a is False:
                if self.collect:
                    costs.append(torch.zeros((), dtype=torch.float32,
                                             device=self.device))
                continue
            new = solver.step(state, tuple(c[i] for c in coins))
            if a is not True:
                new = unflatten(state, [
                    torch.where(a, n, o)
                    for n, o in zip(flatten(new), flatten(state))])
            state = new
            if self.collect:
                cost = solver.chunk_cost(state)
                costs.append(cost if a is True else torch.where(a, cost, 0.0))
        conv = solver.chunk_converged_device(prev, state)
        return state, (torch.stack(costs) if self.collect else None), conv

    # -- calls ------------------------------------------------------------

    def __call__(self, state, coins: Tuple[torch.Tensor, ...], n: int):
        if not 1 <= n <= self.chunk:
            raise ValueError(f"n={n} live cycles in a chunk of {self.chunk}")
        if self.device.type != "cuda":
            coins = tuple(c.to(self.device) for c in coins)
            return self._cycles(state, coins, lambda i: i < n)
        if self.graph is None and self.eager_calls < self.warmup:
            # the first call is the warm-up, with its builds and plans;
            # the solver's check covers the later eager calls
            with sync_checked(self.solver.check_chunk_syncs
                              and self.eager_calls > 0):
                coins = tuple(c.to(self.device, non_blocking=True)
                              for c in coins)
                out = self._cycles(state, coins, lambda i: i < n)
            self.eager_calls += 1
            return out
        if self.graph is None:
            self._capture(state, coins)
        return self._replay(state, coins, n)

    def _capture(self, like, coins) -> None:
        dev = self.device
        self._state = [torch.empty_like(t) for t in flatten(like)]
        self._like = like
        self._coins = tuple(
            torch.zeros((self.chunk,) + tuple(c.shape[1:]), dtype=c.dtype,
                        device=dev) for c in coins)
        self._n = torch.full((), self.chunk, dtype=torch.int64, device=dev)
        idx = torch.arange(self.chunk, device=dev)
        state = unflatten(like, self._state)
        before = read_launch_counters()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        # "thread_local": only this thread's unsafe CUDA calls invalidate
        # the capture, not another thread's (a profiler's, say); and no
        # garbage collection runs inside it (a collected CUDA graph's
        # destructor would call into CUDA mid-capture)
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                new, costs, conv = self._cycles(
                    state, self._coins, lambda i: idx[i] < self._n)
                for buf, t in zip(self._state, flatten(new)):
                    buf.copy_(t)
        finally:
            if gc_was:
                gc.enable()
            # the capture launched nothing: restore each counter, and
            # keep what the graph holds for the replays to add
            #: launches of each counter (by name) the graph holds
            self.recorded = {}
            self._bumps = []
            for name, (fn, attr) in launch_counters().items():
                inc = getattr(fn, attr) - before[name]
                setattr(fn, attr, before[name])
                if inc:
                    self.recorded[name] = inc
                    self._bumps.append((fn, attr, inc))
        if self.keep_graph:
            graph.instantiate()
        self._out = (costs, conv)
        self._idx = idx
        self.graph = graph
        self.captures += 1

    def _replay(self, state, coins, n: int):
        # the solver's check: each replay, its coin staging included,
        # under torch.cuda.set_sync_debug_mode("error")
        with sync_checked(self.solver.check_chunk_syncs):
            for buf, t in zip(self._state, flatten(state)):
                if t is not buf:
                    buf.copy_(t)
            for buf, c in zip(self._coins, coins):
                buf[:n].copy_(c, non_blocking=True)
            self._n.fill_(n)
            self.graph.replay()
        self.replays += 1
        for fn, attr, inc in self._bumps:
            setattr(fn, attr, getattr(fn, attr) + inc)
        return (unflatten(self._like, self._state), *self._out)
