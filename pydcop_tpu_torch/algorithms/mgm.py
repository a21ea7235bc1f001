"""MGM — Maximum Gain Message (monotone local search).

Equivalent capability to the reference's pydcop/algorithms/mgm.py
(MgmComputation :213, value phase :317, gain phase :384, break_mode
:80-83): each cycle has a value round and a gain round; the variable with
the strictly largest gain in its neighbourhood (ties broken lexically,
i.e. by variable index in sorted-name order) moves.  Monotone: total cost
never increases.  MGM draws no coins.
"""
from __future__ import annotations

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    LocalSearchSolver,
    gains_and_best,
    neighborhood_winner,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import compile_constraint_graph
from pydcop_tpu_torch.ops.packed_local_search import packed_mgm_cycles

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("break_mode", "str", ["lexic", "random"], "lexic"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def mgm_cycle(tensors, x):
    """One generic MGM cycle as a function of (tensors, x)."""
    _, best_val, gain, _ = gains_and_best(tensors, x)
    move = neighborhood_winner(tensors, gain)
    return torch.where(move, best_val, x).to(torch.int32)


class MgmSolver(LocalSearchSolver):
    """State = (x,).  One cycle = the reference's value + gain rounds."""

    def __init__(self, dcop, tensors, algo_def, seed=0, use_packed=None):
        super().__init__(dcop, tensors, algo_def, seed, use_packed)
        # 2 rounds (value + gain) of one message per directed pair
        self.msgs_per_cycle = 2 * tensors.n_pairs

    def cycle(self, x, coins):
        return mgm_cycle(self.tensors, x)

    def packed_run(self, x_col, n, coins):
        return packed_mgm_cycles(self.packed, x_col, n)


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> MgmSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "mgm", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return MgmSolver(dcop, tensors, algo_def, seed, use_packed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
