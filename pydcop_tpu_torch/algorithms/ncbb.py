"""NCBB — No-Commitment Branch and Bound (complete, polynomial-space search
on a pseudo-tree).

Equivalent capability to the reference's pydcop/algorithms/ncbb.py
(NcbbAlgo :139): top-down VALUE proposals with bottom-up COST bounds over a
pseudo-tree; subtrees rooted at siblings are independent given the ancestor
context, so their searches compose additively.

Host-driven implementation with vectorized per-node cost rows and
budget-based pruning (an admissible upper bound passed down, tightened by
accumulated sibling costs) — complete and optimal, with the pseudo-tree
decomposition giving the exponential savings over chain B&B.  Binary or
n-ary constraints both work (a constraint is evaluated at its lowest node,
where its whole scope is in the ancestor context).

The search is the JAX package's, line for line (numpy, float64), on the
same pseudo-tree, so the two packages return the same cost and
assignment bit for bit.  It runs for ``device="cuda"`` unless the caller
passes ``device="cpu"``; the recursion is host code either way.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.algorithms import (
    AlgoParameterDef,
    AlgorithmDef,
    DEFAULT_INFINITY,
)
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.graph import pseudotree as pt_module
from pydcop_tpu_torch.graph.pseudotree import ComputationPseudoTree

GRAPH_TYPE = "pseudotree"

# reference: no parameters.  Same ``engine`` family as syncbb (the
# JAX package's addition): "host" keeps the recursive pseudo-tree search,
# "frontier" the device-resident frontier-batched anytime B&B, "auto"
# routes by problem size (syncbb.AUTO_FRONTIER_MIN_VARS).
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


class NcbbSolver:
    def __init__(self, dcop: DCOP, tree: Optional[ComputationPseudoTree] =
                 None, algo_def=None, seed=0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dcop = dcop
        self.mode = dcop.objective
        self.tree = (
            tree
            if isinstance(tree, ComputationPseudoTree)
            else pt_module.build_computation_graph(dcop)
        )
        self.infinity = DEFAULT_INFINITY
        self.msg_count = 0
        self._sub_lb = self._subtree_bounds()

    def _subtree_bounds(self) -> Dict[str, float]:
        """Admissible lower bound of each subtree's total cost (own variable
        + constraints attached in the subtree at their unconditioned
        optimum) — keeps pruning sound with negative costs."""
        from pydcop_tpu_torch.dcop.relations import find_optimum

        sign = 1.0 if self.mode == "min" else -1.0
        lb: Dict[str, float] = {}
        for level in reversed(self.tree.nodes_by_depth()):
            for node in level:
                b = float(np.min(sign * node.variable.cost_vector()))
                for c in node.constraints:
                    b += sign * find_optimum(
                        c, "min" if sign > 0 else "max"
                    )
                for child in node.children:
                    b += lb[child]
                lb[node.name] = b
        return lb

    def _local_costs(self, node, context: Dict) -> np.ndarray:
        """Cost row over the node's domain: own variable cost + constraints
        attached at this node (whole scope = node + ancestors in context)."""
        var = node.variable
        sign = 1.0 if self.mode == "min" else -1.0
        row = sign * var.cost_vector().astype(np.float64)
        ext = {
            ev.name: ev.value for ev in self.dcop.external_variables.values()
        }
        for c in node.constraints:
            fixed = {
                n: context[n] if n in context else ext[n]
                for n in c.scope_names
                if n != var.name
            }
            sliced = c.slice(fixed)
            row += sign * np.asarray(
                [
                    sliced.get_value_for_assignment({var.name: v})
                    for v in var.domain
                ],
                dtype=np.float64,
            )
        return row

    def _search(
        self, name: str, context: Dict, budget: float
    ) -> Tuple[float, Optional[Dict]]:
        """Optimal (cost, assignment) of the subtree rooted at `name` given
        the ancestor context; prunes branches reaching `budget`."""
        node = self.tree.computation(name)
        var = node.variable
        row = self._local_costs(node, context)
        children_lb = [self._sub_lb[c] for c in node.children]
        rest_lb = float(sum(children_lb))
        best_cost, best_assign = np.inf, None
        # explore values in bound order: cheapest local cost first
        for i in np.argsort(row, kind="stable"):
            local = float(row[i])
            if local + rest_lb >= min(budget, best_cost):
                break  # sorted: the rest are worse
            value = var.domain[int(i)]
            ctx = {**context, name: value}
            total = local
            assign = {name: value}
            feasible = True
            for ci, child in enumerate(node.children):
                self.msg_count += 2  # VALUE down + COST up
                remaining_lb = float(sum(children_lb[ci + 1:]))
                c_cost, c_assign = self._search(
                    child, ctx, min(budget, best_cost) - total - remaining_lb
                )
                if c_assign is None:
                    feasible = False
                    break
                total += c_cost
                assign.update(c_assign)
            if feasible and total < min(budget, best_cost):
                best_cost, best_assign = total, assign
        return best_cost, best_assign

    def run(self, cycles=None, timeout=None, collect_cycles=False,
            **_kwargs) -> SolveResult:
        t0 = perf_counter()
        self.msg_count = 0
        assignment: Dict = {}
        for root in self.tree.roots:
            _, a = self._search(root, {}, np.inf)
            if a:
                assignment.update(a)
        for name, v in self.dcop.variables.items():
            if name not in assignment:
                costs = v.cost_vector()
                idx = int(
                    np.argmin(costs) if self.mode == "min" else
                    np.argmax(costs)
                )
                assignment[name] = v.domain[idx]
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
        return SolveResult(
            status="FINISHED",
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=self.tree.height + 1,
            msg_count=self.msg_count,
            msg_size=float(self.msg_count),
            time=perf_counter() - t0,
        )


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None):
    from pydcop_tpu_torch.algorithms.syncbb import _resolve_engine

    if _resolve_engine(dcop, algo_def) == "frontier":
        from pydcop_tpu_torch.search.solver import build_frontier_solver

        return build_frontier_solver(
            dcop, computation_graph, algo_def, seed=seed, algo="ncbb",
            device=device,
        )
    return NcbbSolver(dcop, computation_graph, algo_def, seed, device)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
