"""DSA — Distributed Stochastic Algorithm (synchronous variants A/B/C).

Equivalent capability to the reference's pydcop/algorithms/dsa.py
(DsaComputation :213, params :130-134): each cycle every variable computes
its best local move given its neighbours' values and applies it with
probability p:

* A: move only on strict improvement;
* B: also move laterally (equal cost) when in conflict;
* C: also move laterally even without conflict.

"Conflict" = the current local cost crosses the hard-constraint threshold
(soft-only problems never trigger the lateral-move rule of B).
"""
from __future__ import annotations

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    StochasticSolver,
    conflicted,
    dsa_move,
    gains_and_best,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import compile_constraint_graph
from pydcop_tpu_torch.ops.packed_local_search import packed_dsa_cycles

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def dsa_cycle(tensors, x, u, probability, variant, tables=None):
    """One generic DSA cycle: ``u`` is the [V] activation uniform; the
    local cost tables are computed here when None."""
    _, best_val, gain, tables = gains_and_best(
        tensors, x, tables=tables, prefer_change=variant in ("B", "C"))
    in_conflict = conflicted(tensors, x, tables)
    activate = u < probability
    return dsa_move(x, best_val, gain, in_conflict, activate, variant)


class DsaSolver(StochasticSolver):
    """State = (x,)."""

    def __init__(self, dcop, tensors, algo_def, seed=0, use_packed=None):
        super().__init__(dcop, tensors, algo_def, seed, use_packed)
        self.probability = float(self.params.get("probability", 0.7))
        self.variant = self.params.get("variant", "B")

    def cycle(self, x, coins):
        return dsa_cycle(self.tensors, x, coins[0], self.probability,
                         self.variant, tables=self.local_tables(x))

    def packed_run(self, x_col, n, coins):
        return packed_dsa_cycles(self.packed, x_col, coins[0],
                                 self.probability, self.variant)


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> DsaSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "dsa", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return DsaSolver(dcop, tensors, algo_def, seed, use_packed)


def computation_memory(node) -> float:
    """One value per neighbour (reference: dsa.py computation_memory)."""
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    """DSA sends single values."""
    return 1.0
