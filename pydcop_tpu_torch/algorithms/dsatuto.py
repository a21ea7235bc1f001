"""DSA tutorial version — the minimal DSA-B used in the reference's docs
(pydcop/algorithms/dsatuto.py:66): probability 0.5, no parameters.  It
runs as ``dsa`` (its executed config reads ``algo: dsa``, as in the JAX
package).
"""
from __future__ import annotations

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.dsa import DsaSolver
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import compile_constraint_graph

GRAPH_TYPE = "constraints_hypergraph"

algo_params = []


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> DsaSolver:
    inner = AlgorithmDef(
        "dsa", {"probability": 0.5, "variant": "B", "stop_cycle": 0},
        mode=dcop.objective,
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return DsaSolver(dcop, tensors, inner, seed, use_packed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
