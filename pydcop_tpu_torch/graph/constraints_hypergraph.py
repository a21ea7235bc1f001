"""Constraints-hypergraph model: one node per variable, constraints as
hyper-edges (the classic "one agent = one variable" DCOP view).

Equivalent capability to the reference's
pydcop/computations_graph/constraints_hypergraph.py
(VariableComputationNode :49, ConstraintLink :113, build_computation_graph
:176).  Used by dsa / adsa / dsatuto / mgm / mixeddsa.

The nodes and each node's constraints come in the JAX package's order
(variables as given, each variable's constraints in constraint order),
from one pass over the constraints keyed by variable name instead of a
scan of every constraint for every variable.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.graph.objects import ComputationGraph, ComputationNode, Link

GRAPH_TYPE = "constraints_hypergraph"


class ConstraintLink(Link):
    """Hyper-edge over all variables of one constraint."""

    def __init__(self, constraint_name: str, variable_names: List[str]):
        super().__init__(variable_names, "constraint_link")
        self._constraint_name = constraint_name

    @property
    def constraint_name(self) -> str:
        return self._constraint_name


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable, constraints: List[Constraint]):
        links = [
            ConstraintLink(c.name, [v.name for v in c.dimensions])
            for c in constraints
        ]
        super().__init__(variable.name, "VariableComputation", links)
        self._variable = variable
        self._constraints = list(constraints)

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        return list(self._constraints)


class ConstraintHyperGraph(ComputationGraph):
    pass


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[List[Variable]] = None,
    constraints: Optional[List[Constraint]] = None,
) -> ConstraintHyperGraph:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    variables = variables or []
    constraints = constraints or []
    of_var: Dict[str, List[Constraint]] = {v.name: [] for v in variables}
    for c in constraints:
        for name in dict.fromkeys(c.scope_names):
            if name in of_var:
                of_var[name].append(c)
    nodes = [VariableComputationNode(v, of_var[v.name]) for v in variables]
    return ConstraintHyperGraph(GRAPH_TYPE, nodes)
