"""Factor-graph computation model: one node per variable AND per constraint.

Equivalent capability to the reference's
pydcop/computations_graph/factor_graph.py (FactorComputationNode :45,
VariableComputationNode :104, ComputationsFactorGraph :210,
build_computation_graph :245).  Used by maxsum / amaxsum / maxsum_dynamic.
"""
from __future__ import annotations

from typing import List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.graph.objects import ComputationGraph, ComputationNode, Link

GRAPH_TYPE = "factor_graph"


class FactorGraphLink(Link):
    """A var↔factor edge."""

    def __init__(self, variable_node: str, factor_node: str):
        super().__init__([variable_node, factor_node], "var_factor")


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable, factor_names: List[str]):
        links = [FactorGraphLink(variable.name, f) for f in factor_names]
        super().__init__(variable.name, "VariableComputation", links)
        self._variable = variable

    @property
    def variable(self) -> Variable:
        return self._variable


class FactorComputationNode(ComputationNode):
    def __init__(self, factor: Constraint):
        links = [FactorGraphLink(v.name, factor.name)
                 for v in factor.dimensions]
        super().__init__(factor.name, "FactorComputation", links)
        self._factor = factor

    @property
    def factor(self) -> Constraint:
        return self._factor

    @property
    def variables(self) -> List[Variable]:
        return self._factor.dimensions


class ComputationsFactorGraph(ComputationGraph):
    def __init__(self, var_nodes, factor_nodes):
        super().__init__(GRAPH_TYPE, list(var_nodes) + list(factor_nodes))
        self.var_nodes: List[VariableComputationNode] = list(var_nodes)
        self.factor_nodes: List[FactorComputationNode] = list(factor_nodes)


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[List[Variable]] = None,
    constraints: Optional[List[Constraint]] = None,
) -> ComputationsFactorGraph:
    """Build the bipartite factor graph for a DCOP (or explicit lists)."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    variables = variables or []
    constraints = constraints or []
    factors_for_var = {v.name: [] for v in variables}
    for c in constraints:
        for v in c.dimensions:
            if v.name in factors_for_var:
                factors_for_var[v.name].append(c.name)
    var_nodes = [
        VariableComputationNode(v, factors_for_var[v.name]) for v in variables
    ]
    factor_nodes = [FactorComputationNode(c) for c in constraints]
    return ComputationsFactorGraph(var_nodes, factor_nodes)
