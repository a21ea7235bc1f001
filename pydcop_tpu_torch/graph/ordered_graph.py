"""Ordered constraint graph: the constraint graph plus a total order (chain)
over variables, used by SyncBB.

Equivalent capability to the reference's
pydcop/computations_graph/ordered_graph.py (OrderLink :119,
OrderedConstraintGraph :168, build_computation_graph :182).  A copy of
the JAX package's module: the two chain the variables in the same order.
"""
from __future__ import annotations

from typing import List, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.graph.objects import ComputationGraph, ComputationNode, Link

GRAPH_TYPE = "ordered_graph"


class OrderLink(Link):
    def __init__(self, link_type: str, source: str, target: str):
        if link_type not in ("next", "previous"):
            raise ValueError(f"Invalid order link type {link_type!r}")
        self._source = source
        self._target = target
        super().__init__([source, target], link_type)

    @property
    def source(self) -> str:
        return self._source

    @property
    def target(self) -> str:
        return self._target


class OrderedVarNode(ComputationNode):
    def __init__(self, variable: Variable, constraints: List[Constraint],
                 links: List[OrderLink], position: int):
        super().__init__(variable.name, "OrderedComputation", links)
        self._variable = variable
        self._constraints = list(constraints)
        self._position = position

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        return list(self._constraints)

    @property
    def position(self) -> int:
        return self._position

    @property
    def next_node(self) -> Optional[str]:
        for l in self._links:
            if l.type == "next" and l.source == self.name:
                return l.target
        return None

    @property
    def previous_node(self) -> Optional[str]:
        for l in self._links:
            if l.type == "previous" and l.source == self.name:
                return l.target
        return None


class OrderedConstraintGraph(ComputationGraph):
    def __init__(self, nodes: List[OrderedVarNode]):
        super().__init__(GRAPH_TYPE, nodes)
        self._order = [n.name for n in
                       sorted(nodes, key=lambda n: n.position)]

    @property
    def order(self) -> List[str]:
        return list(self._order)


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[List[Variable]] = None,
    constraints: Optional[List[Constraint]] = None,
) -> OrderedConstraintGraph:
    """Chain the variables in lexical order (deterministic, like the
    reference's default ordering)."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    variables = sorted(variables or [], key=lambda v: v.name)
    constraints = constraints or []
    nodes = []
    for i, v in enumerate(variables):
        links: List[OrderLink] = []
        if i > 0:
            links.append(OrderLink("previous", v.name, variables[i - 1].name))
        if i < len(variables) - 1:
            links.append(OrderLink("next", v.name, variables[i + 1].name))
        v_constraints = [c for c in constraints if v.name in c.scope_names]
        nodes.append(OrderedVarNode(v, v_constraints, links, i))
    return OrderedConstraintGraph(nodes)
