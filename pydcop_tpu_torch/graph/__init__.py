"""Computation-graph models: how a DCOP maps to communicating computations.

Equivalent capability to the reference's pydcop/computations_graph/ package:
four graph models (factor graph, constraints hypergraph, pseudo-tree, ordered
chain), each with a ``build_computation_graph(dcop)`` entry point.

In the TPU design the graph model is *also* the tensorization recipe: each
model knows how to emit padded index arrays for the kernels
(see pydcop_tpu_torch.ops.compile).
"""
from pydcop_tpu_torch.graph.objects import ComputationGraph, ComputationNode, Link

#: graph models ported so far (the JAX package also has pseudotree and
#: ordered_graph)
GRAPH_MODULES = [
    "factor_graph",
    "constraints_hypergraph",
]


def load_graph_module(graph_type: str):
    import importlib

    if graph_type not in GRAPH_MODULES:
        raise ValueError(
            f"Unknown graph model {graph_type!r}; available: {GRAPH_MODULES}"
        )
    return importlib.import_module(f"pydcop_tpu_torch.graph.{graph_type}")


__all__ = ["ComputationGraph", "ComputationNode", "Link", "GRAPH_MODULES",
           "load_graph_module"]
