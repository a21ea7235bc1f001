"""Base objects for computation graphs.

Equivalent capability to the reference's pydcop/computations_graph/objects.py
(ComputationNode :37, Link :136, ComputationGraph :197).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from pydcop_tpu_torch.utils.serialization import SimpleRepr


class Link(SimpleRepr):
    """A (hyper-)edge between computation nodes, identified by name."""

    def __init__(self, nodes: Iterable[str], link_type: str = "link"):
        self._nodes = tuple(sorted(nodes))
        self._link_type = link_type

    @property
    def nodes(self) -> tuple:
        return self._nodes

    @property
    def type(self) -> str:
        return self._link_type

    def has_node(self, name: str) -> bool:
        return name in self._nodes

    def __eq__(self, other):
        return (
            isinstance(other, Link)
            and self._nodes == other._nodes
            and self._link_type == other._link_type
        )

    def __hash__(self):
        return hash((self._nodes, self._link_type))

    def __repr__(self):
        return f"Link({self._link_type!r}, {self._nodes})"


class ComputationNode(SimpleRepr):
    """A node of a computation graph: one message-passing computation.

    Subclasses attach model data (the variable, the constraint, tree links…).
    """

    def __init__(
        self,
        name: str,
        node_type: str = "node",
        links: Optional[Iterable[Link]] = None,
    ):
        self._name = name
        self._node_type = node_type
        self._links = list(links) if links else []

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._node_type

    @property
    def links(self) -> List[Link]:
        return list(self._links)

    @property
    def neighbors(self) -> List[str]:
        ns: List[str] = []
        for l in self._links:
            for n in l.nodes:
                if n != self._name and n not in ns:
                    ns.append(n)
        return ns

    def add_link(self, link: Link):
        self._links.append(link)

    def __eq__(self, other):
        return (
            isinstance(other, ComputationNode)
            and self._name == other._name
            and self._node_type == other._node_type
        )

    def __hash__(self):
        return hash((self._name, self._node_type))

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r})"


class ComputationGraph:
    """A set of computation nodes + links; the unit handed to algorithms and
    to the distribution layer."""

    def __init__(
        self,
        graph_type: str,
        nodes: Optional[Iterable[ComputationNode]] = None,
    ):
        self._graph_type = graph_type
        self._nodes: Dict[str, ComputationNode] = {}
        for n in nodes or []:
            self.add_node(n)

    @property
    def graph_type(self) -> str:
        return self._graph_type

    @property
    def nodes(self) -> List[ComputationNode]:
        return list(self._nodes.values())

    def add_node(self, node: ComputationNode):
        self._nodes[node.name] = node

    def computation(self, name: str) -> ComputationNode:
        return self._nodes[name]

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    @property
    def links(self) -> List[Link]:
        seen: Set[Link] = set()
        out: List[Link] = []
        for n in self._nodes.values():
            for l in n.links:
                if l not in seen:
                    seen.add(l)
                    out.append(l)
        return out

    def neighbors(self, name: str) -> List[str]:
        return self._nodes[name].neighbors

    def node_count(self) -> int:
        return len(self._nodes)

    def link_count(self) -> int:
        return len(self.links)

    def density(self) -> float:
        n = self.node_count()
        if n < 2:
            return 0.0
        return 2 * self.link_count() / (n * (n - 1))

    def __repr__(self):
        return (
            f"ComputationGraph({self._graph_type!r}, {self.node_count()} nodes,"
            f" {self.link_count()} links)"
        )
