"""A-DSA — asynchronous DSA.

Equivalent capability to the reference's pydcop/algorithms/adsa.py
(ADsaComputation :126): in the reference each variable re-evaluates on a
wall-clock ``period`` timer, asynchronously.  As in the JAX package,
asynchrony is modelled by a random activation mask per round: each
variable wakes with probability ``activation`` (a wake coin drawn before
the move coin), so only a random subset re-evaluates each round.  The
``period`` parameter is kept for CLI parity only.
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
    AlgoParameterDef("period", "float", None, 0.5),
    AlgoParameterDef("probability", "float", None, 0.7),
    AlgoParameterDef("variant", "str", ["A", "B", "C"], "B"),
    AlgoParameterDef("activation", "float", None, 0.5),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def adsa_cycle(tensors, x, wake_u, move_u, probability, variant,
               activation):
    """One generic A-DSA cycle from this cycle's [V] wake and move
    uniforms."""
    awake = wake_u < wake_u.new_tensor(activation)
    _, best_val, gain, tables = gains_and_best(
        tensors, x, prefer_change=variant in ("B", "C"))
    in_conflict = conflicted(tensors, x, tables)
    activate = (move_u < move_u.new_tensor(probability)) & awake
    return dsa_move(x, best_val, gain, in_conflict, activate, variant)


class ADsaSolver(StochasticSolver):
    wake_coins = True

    def __init__(self, dcop, tensors, algo_def, seed=0, use_packed=None):
        super().__init__(dcop, tensors, algo_def, seed, use_packed)
        self.probability = float(self.params.get("probability", 0.7))
        self.variant = self.params.get("variant", "B")
        self.activation = float(self.params.get("activation", 0.5))

    def cycle(self, x, coins):
        wake_u, move_u = coins
        return adsa_cycle(self.tensors, x, wake_u, move_u, self.probability,
                          self.variant, self.activation)

    def packed_run(self, x_col, n, coins):
        wake_u, move_u = coins
        return packed_dsa_cycles(
            self.packed, x_col, move_u, self.probability, self.variant,
            awake_uniforms=wake_u, activation=self.activation)


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> ADsaSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "adsa", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return ADsaSolver(dcop, tensors, algo_def, seed, use_packed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
