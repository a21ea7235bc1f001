"""SyncBB — Synchronous Branch & Bound on an ordered variable chain.

Equivalent capability to the reference's pydcop/algorithms/syncbb.py
(SyncBBComputation :176, GRAPH_TYPE ordered_graph :160): a Current Partial
Assignment token walks the chain; each variable extends it with its next
value whose bound stays under the best known cost, or backtracks.

Complete algorithm — returns the optimum.  The token is inherently
sequential, so the host drives the walk (correctness over device
parallelism, as planned in SURVEY.md §7.7); the per-node cost increments for
all candidate values are evaluated as one vectorized pass per entry.
Message accounting mirrors the token protocol: one message per forward /
backward move.

The host loop is the JAX package's, line for line (numpy, float64), so
the two packages return the same cost and assignment bit for bit.  Like
every entry point of this package it runs for ``device="cuda"`` unless
the caller passes ``device="cpu"``: the walk itself is host code either
way, and the device matters only to ``engine=frontier``
(:mod:`pydcop_tpu_torch.search`).
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.algorithms import (
    AlgoParameterDef,
    AlgorithmDef,
    DEFAULT_INFINITY,
)
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.graph import ordered_graph as og_module

GRAPH_TYPE = "ordered_graph"

#: problems at/above this many variables route ``engine=auto`` to the
#: frontier engine (below it the host token walk finishes in
#: microseconds anyway and stays bit-compatible with the reference)
AUTO_FRONTIER_MIN_VARS = 16

# reference: no parameters.  The ``engine`` family is the JAX package's
# addition: "host" keeps the reference-parity CPA token
# walk; "frontier" runs the device-resident frontier-batched anytime
# B&B (pydcop_tpu_torch.search — anytime bound sandwich on ws/SSE,
# optimality proof when the bound meets the incumbent); "auto" takes
# the frontier engine at AUTO_FRONTIER_MIN_VARS+ variables.
# ``frontier_width`` is the slab's row count B (0 = auto),
# ``ring`` the device spill buffer (0 = 8*B), ``search_chunk`` the
# expand steps per device chunk (0 = 8), ``i_bound`` the mini-bucket
# bound-table width (0 = auto from budget_mb; >= induced width =
# DPOP-exact bounds), ``budget_mb`` the bound-table byte budget,
# ``seed_incumbent`` toggles the beam-dive incumbent seeding of a
# fresh frontier run (a real leaf before the first chunk).
algo_params = [
    AlgoParameterDef("engine", "str", ["host", "frontier", "auto"],
                     "host"),
    AlgoParameterDef("frontier_width", "int", None, 0),
    AlgoParameterDef("ring", "int", None, 0),
    AlgoParameterDef("search_chunk", "int", None, 0),
    AlgoParameterDef("i_bound", "int", None, 0),
    AlgoParameterDef("budget_mb", "float", None, 0.0),
    AlgoParameterDef("seed_incumbent", "bool", None, True),
]


def _resolve_engine(dcop: DCOP, algo_def) -> str:
    params = (
        algo_def.params if algo_def is not None and algo_def.params
        else {}
    )
    engine = params.get("engine", "host")
    if engine == "auto":
        engine = (
            "frontier"
            if len(dcop.variables) >= AUTO_FRONTIER_MIN_VARS
            else "host"
        )
    return engine


class SyncBBSolver:
    def __init__(self, dcop: DCOP, graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dcop = dcop
        self.mode = dcop.objective
        self.graph = (
            graph
            if graph is not None and hasattr(graph, "order")
            else og_module.build_computation_graph(dcop)
        )
        self.infinity = DEFAULT_INFINITY
        self._suffix_lb = self._compute_suffix_bounds()

    def _compute_suffix_bounds(self) -> np.ndarray:
        """Admissible heuristic: suffix_lb[k] = sum of the best possible
        costs of everything assigned after position k (each constraint
        counted at the position of the LAST variable of its scope).  Keeps
        pruning sound when costs can be negative (e.g. negative variable
        cost functions)."""
        from pydcop_tpu_torch.dcop.relations import find_optimum

        order = self.graph.order
        n = len(order)
        sign = 1.0 if self.mode == "min" else -1.0
        pos = {name: i for i, name in enumerate(order)}
        at_pos = np.zeros(n + 1, dtype=np.float64)
        seen = set()
        for name in order:
            node = self.graph.computation(name)
            k = pos[name]
            at_pos[k] += float(np.min(sign * node.variable.cost_vector()))
            for c in node.constraints:
                if c.name in seen:
                    continue
                seen.add(c.name)
                last = max(pos[v] for v in c.scope_names if v in pos)
                opt = find_optimum(c, "min" if sign > 0 else "max")
                at_pos[last] += sign * opt
        # suffix_lb[k] = sum of at_pos[k+1:]
        suffix = np.zeros(n + 1, dtype=np.float64)
        for k in range(n - 1, -1, -1):
            suffix[k] = suffix[k + 1] + at_pos[k + 1] if k + 1 <= n else 0.0
        return suffix

    def _increment_vector(
        self, k: int, order: List[str], values: List, partial: Dict
    ) -> np.ndarray:
        """Cost added by each candidate value of variable k given the
        already-assigned prefix (one vectorized pass)."""
        name = order[k]
        node = self.graph.computation(name)
        var = node.variable
        inc = var.cost_vector().astype(np.float64)
        prefix = set(order[:k])
        for c in node.constraints:
            others = [n for n in c.scope_names if n != name]
            # evaluate when this variable is the LAST of the scope to be
            # assigned (all others already in the prefix)
            if not all(n in prefix for n in others):
                continue
            fixed = {n: partial[n] for n in others}
            sliced = c.slice(fixed)
            inc += np.asarray(
                [sliced.get_value_for_assignment({name: v}) for v in
                 var.domain],
                dtype=np.float64,
            )
        return inc

    def run(self, cycles=None, timeout=None, collect_cycles=False,
            **_kwargs) -> SolveResult:
        t0 = perf_counter()
        order = self.graph.order
        n = len(order)
        sign = 1.0 if self.mode == "min" else -1.0
        domains = [
            list(self.graph.computation(name).variable.domain)
            for name in order
        ]
        msg_count = 0
        best_cost = np.inf
        best: Optional[Dict] = None
        if n == 0:
            return SolveResult("FINISHED", {}, 0.0, 0, 0, 0, 0.0,
                               perf_counter() - t0)

        partial: Dict = {}
        costs = [0.0] * n  # cumulative cost up to position k included
        value_pos = [0] * n  # next candidate index per position
        inc_vectors: List[Optional[np.ndarray]] = [None] * n
        k = 0
        inc_vectors[0] = sign * self._increment_vector(0, order, domains[0],
                                                       partial)
        status = "FINISHED"
        while k >= 0:
            if timeout is not None and perf_counter() - t0 > timeout:
                status = "TIMEOUT"
                break
            if value_pos[k] >= len(domains[k]):
                # exhausted: backtrack
                value_pos[k] = 0
                partial.pop(order[k], None)
                k -= 1
                if k >= 0:
                    value_pos[k] += 1
                    msg_count += 1  # backtrack token
                continue
            i = value_pos[k]
            prev = costs[k - 1] if k > 0 else 0.0
            cand = prev + float(inc_vectors[k][i])
            if cand + self._suffix_lb[k] >= best_cost:
                value_pos[k] += 1
                continue
            partial[order[k]] = domains[k][i]
            costs[k] = cand
            if k == n - 1:
                best_cost = cand
                best = dict(partial)
                value_pos[k] += 1
            else:
                k += 1
                msg_count += 1  # forward token
                value_pos[k] = 0
                inc_vectors[k] = sign * self._increment_vector(
                    k, order, domains[k], partial
                )

        assignment = best if best is not None else {
            name: domains[i][0] for i, name in enumerate(order)
        }
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
        return SolveResult(
            status=status,
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=0,
            msg_count=msg_count,
            msg_size=float(msg_count * n),
            time=perf_counter() - t0,
        )


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None):
    if _resolve_engine(dcop, algo_def) == "frontier":
        from pydcop_tpu_torch.search.solver import build_frontier_solver

        return build_frontier_solver(
            dcop, computation_graph, algo_def, seed=seed, algo="syncbb",
            device=device,
        )
    return SyncBBSolver(dcop, computation_graph, algo_def, seed, device)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    # the CPA token carries the whole partial assignment
    return float(len(node.neighbors)) + 1
