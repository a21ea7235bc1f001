"""DBA — Distributed Breakout Algorithm (for constraint *satisfaction*).

Equivalent capability to the reference's pydcop/algorithms/dba.py
(DbaComputation :272, Ok/Improve/End messages :180-247, params :265-268):
hill-climb on the number of (weighted) violated constraints; when a
neighbourhood is stuck at a quasi-local minimum with violations
remaining, increase the weights of the violated constraints ("breakout")
so the landscape changes.

Tensor form, as the JAX package's ``algorithms/dba.py``: per-constraint
weights are an ``[n_factors]`` vector; a cycle is a weighted
local-cost-table evaluation (0/1 violation indicators, no unary costs) +
MGM-style arbitration + an add on the weights of the violated
constraints that hold a stuck variable.  It runs the generic engine on
every device (plain PyTorch on the card, as the JAX package runs it in
XLA): the weighted tables have no packed kernel, and the solver takes no
``use_packed``.  The initial values are the local-search family's
(:func:`~pydcop_tpu_torch.algorithms._local_search.random_valid_values`
at ``seed + 17``), the port's stated deviation from ``jax.random``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    BreakoutSolver,
    gains_and_best,
    neighborhood_winner,
    quiet_neighborhood,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    bucket_factor_ids,
    bucket_index,
    compile_constraint_graph,
    local_cost_tables,
)

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("infinity", "int", None, 10000),
    AlgoParameterDef("max_distance", "int", None, 50),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def violation_indicator(t: torch.Tensor) -> torch.Tensor:
    """0/1 violation indicator per constraint entry of one stacked cost
    tensor (padding stays PAD_COST)."""
    return torch.where(t >= PAD_COST / 2, PAD_COST,
                       (t > 0).to(torch.float32))


class DbaSolver(BreakoutSolver):
    """State = (x [V] int32, weights [n_factors] float32)."""

    def __init__(self, dcop, tensors, algo_def, seed=0):
        super().__init__(dcop, tensors, algo_def, seed)
        self.indicators: List[torch.Tensor] = [
            violation_indicator(b.tensors) for b in tensors.buckets]

    def initial_weights(self):
        return torch.ones(self.tensors.n_factors, dtype=torch.float32,
                          device=self.device)

    def cycle(self, state):
        x, w = state
        t = self.tensors
        dev = x.device
        tables = local_cost_tables(
            t, x, bucket_tensors=self.indicators, factor_weights=w,
            include_unary=False)
        cur, best_val, gain, _ = gains_and_best(t, x, tables=tables)
        move = neighborhood_winner(t, gain)
        x2 = torch.where(move, best_val, x).to(torch.int32)

        # quasi-local minimum: nobody in the neighbourhood can improve
        # but violations remain -> breakout (weight increase)
        qlm = quiet_neighborhood(t, gain) & (cur > 1e-9)
        w2 = w
        xl = x.long()
        for bi, b in enumerate(t.buckets):
            if b.n_factors == 0:
                continue
            var_idx, _ = bucket_index(b, dev)
            vals = xl[var_idx]
            idx = tuple(vals[:, p] for p in range(b.arity))
            fidx = torch.arange(b.n_factors, device=dev)
            viol = self.indicators[bi][(fidx,) + idx] > 0.5
            inc = (viol & qlm[var_idx].any(dim=1)).to(torch.float32)
            w2 = w2.index_add(0, bucket_factor_ids(b, dev), inc)
        return (x2, w2)

    def state_from_numpy(self, x, w):
        """A state from x [V] and the weights [n_factors] as numpy arrays
        (the JAX solver's layout), on the solver's device."""
        return (torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                device=self.device),
                torch.as_tensor(np.asarray(w), dtype=torch.float32,
                                device=self.device))

    @staticmethod
    def state_to_numpy(state):
        """(x [V] int32, weights [n_factors] float32) as numpy arrays."""
        x, w = state
        return x.cpu().numpy(), w.cpu().numpy()


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None) -> DbaSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "dba", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return DbaSolver(dcop, tensors, algo_def, seed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
