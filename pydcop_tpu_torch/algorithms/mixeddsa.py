"""Mixed-DSA — DSA over mixed hard/soft constraint problems.

Equivalent capability to the reference's pydcop/algorithms/mixeddsa.py
(MixedDsaComputation :154, params :119-124): the move probability depends
on whether the variable currently violates a hard constraint
(``proba_hard``) or only soft costs are at stake (``proba_soft``).
"""
from __future__ import annotations

import torch

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
    AlgoParameterDef("proba_hard", "float", None, 0.7),
    AlgoParameterDef("proba_soft", "float", None, 0.5),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


class MixedDsaSolver(StochasticSolver):
    def __init__(self, dcop, tensors, algo_def, seed=0, use_packed=None):
        super().__init__(dcop, tensors, algo_def, seed, use_packed)
        self.proba_hard = float(self.params.get("proba_hard", 0.7))
        self.proba_soft = float(self.params.get("proba_soft", 0.5))
        self.variant = self.params.get("variant", "B")

    def cycle(self, x, coins):
        (u,) = coins
        _, best_val, gain, tables = gains_and_best(
            self.tensors, x, tables=self.local_tables(x),
            prefer_change=self.variant in ("B", "C"))
        in_hard_conflict = conflicted(self.tensors, x, tables)
        proba = torch.where(in_hard_conflict, self.proba_hard,
                            self.proba_soft)
        return dsa_move(x, best_val, gain, in_hard_conflict, u < proba,
                        self.variant)

    def packed_run(self, x_col, n, coins):
        return packed_dsa_cycles(
            self.packed, x_col, coins[0], self.proba_soft, self.variant,
            probability_hard=self.proba_hard)


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> MixedDsaSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "mixeddsa", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return MixedDsaSolver(dcop, tensors, algo_def, seed, use_packed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
