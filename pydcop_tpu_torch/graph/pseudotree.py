"""Pseudo-tree computation model (for DPOP / NCBB).

Equivalent capability to the reference's
pydcop/computations_graph/pseudotree.py (PseudoTreeLink :51, PseudoTreeNode
:122, _generate_dfs_tree :325, build_computation_graph :468,
_filter_relation_to_lowest_node :448).

A DFS traversal of the variables' constraint graph yields a spanning tree
where every non-tree constraint edge connects a node to one of its ancestors
(a *pseudo* parent).  Each constraint is attached to the **lowest** (deepest)
of its variables, so it is evaluated exactly once during the UTIL sweep.

Unlike the reference's token-passing distributed DFS, the tree is built
centrally on the host (the reference's DFS is deterministic given the same
heuristic, so results match); the device-side work is the level-batched
UTIL/VALUE sweeps of pydcop_tpu_torch.algorithms.dpop.  This module is a
copy of the JAX package's: the two must build the same tree node for node
(same roots, level order, links and separators), so that the sweep plans
of the two packages are equal.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.graph.objects import ComputationGraph, ComputationNode, Link

GRAPH_TYPE = "pseudotree"


class PseudoTreeLink(Link):
    """Directed, typed tree link: parent / children / pseudo_parent /
    pseudo_children."""

    def __init__(self, link_type: str, source: str, target: str):
        if link_type not in (
            "parent", "children", "pseudo_parent", "pseudo_children"
        ):
            raise ValueError(f"Invalid pseudo-tree link type {link_type!r}")
        self._source = source
        self._target = target
        # note: Link sorts nodes; source/target keep direction
        super().__init__([source, target], link_type)

    @property
    def source(self) -> str:
        return self._source

    @property
    def target(self) -> str:
        return self._target

    def __repr__(self):
        return f"PseudoTreeLink({self.type}, {self._source} -> {self._target})"


class PseudoTreeNode(ComputationNode):
    def __init__(
        self,
        variable: Variable,
        constraints: List[Constraint],
        links: List[PseudoTreeLink],
    ):
        super().__init__(variable.name, "PseudoTreeComputation", links)
        self._variable = variable
        self._constraints = list(constraints)

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        """Constraints attached to this node (lowest-node rule)."""
        return list(self._constraints)

    def _links_of(self, link_type: str) -> List[str]:
        return [
            l.target for l in self._links
            if l.type == link_type and l.source == self.name
        ]

    @property
    def parent(self) -> Optional[str]:
        ps = self._links_of("parent")
        return ps[0] if ps else None

    @property
    def children(self) -> List[str]:
        return self._links_of("children")

    @property
    def pseudo_parents(self) -> List[str]:
        return self._links_of("pseudo_parent")

    @property
    def pseudo_children(self) -> List[str]:
        return self._links_of("pseudo_children")


class ComputationPseudoTree(ComputationGraph):
    def __init__(self, nodes: List[PseudoTreeNode], roots: List[str],
                 depths: Dict[str, int]):
        super().__init__(GRAPH_TYPE, nodes)
        self._roots = list(roots)
        self._depths = dict(depths)

    @property
    def roots(self) -> List[str]:
        return list(self._roots)

    @property
    def root(self) -> str:
        return self._roots[0]

    def depth(self, name: str) -> int:
        return self._depths[name]

    @property
    def height(self) -> int:
        return max(self._depths.values(), default=0)

    def nodes_by_depth(self) -> List[List[PseudoTreeNode]]:
        """Nodes grouped by tree depth — the level schedule for batched
        UTIL/VALUE sweeps."""
        levels: List[List[PseudoTreeNode]] = [[] for _ in range(self.height + 1)]
        for n in self.nodes:
            levels[self._depths[n.name]].append(n)
        return levels

    def separators(self) -> Dict[str, Set[str]]:
        """Bottom-up separator sets: ``sep(n) = (scope of n's own
        constraints ∪ children's separators) - {n}``; every member is an
        ancestor of ``n``.  This is the shape oracle of the whole DPOP
        engine family — ``|sep(n)|`` is the UTIL-table width at ``n``,
        and the sweep compilers (ops/dpop_sweep), the separator-tiling
        planner (ops/dpop_shard) and the byte estimators all derive
        their layouts from it."""
        sep: Dict[str, Set[str]] = {}
        for lv in reversed(self.nodes_by_depth()):
            for node in lv:
                s: Set[str] = set()
                for c in node.constraints:
                    s.update(
                        v.name for v in c.dimensions
                        if v.name in self._depths
                    )
                for ch in node.children:
                    s.update(sep[ch])
                s.discard(node.name)
                sep[node.name] = s
        return sep

    @property
    def induced_width(self) -> int:
        """Max separator size over the tree — DPOP's table exponent
        (tables hold ``D^(induced_width+1)`` entries at the widest
        node)."""
        return max(
            (len(s) for s in self.separators().values()), default=0
        )


def _adjacency(
    variables: List[Variable], constraints: List[Constraint]
) -> Dict[str, Set[str]]:
    adj: Dict[str, Set[str]] = {v.name: set() for v in variables}
    for c in constraints:
        names = [v.name for v in c.dimensions if v.name in adj]
        for a in names:
            for b in names:
                if a != b:
                    adj[a].add(b)
    return adj


def build_computation_graph(
    dcop: Optional[DCOP] = None,
    variables: Optional[List[Variable]] = None,
    constraints: Optional[List[Constraint]] = None,
) -> ComputationPseudoTree:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    variables = variables or []
    constraints = constraints or []
    var_map = {v.name: v for v in variables}
    adj = _adjacency(variables, constraints)

    # deterministic heuristics, as in the reference: root = most-connected
    # node (ties: lexical); DFS visits most-connected neighbors first.
    def heur(name: str) -> Tuple[int, str]:
        return (-len(adj[name]), name)

    visited: Set[str] = set()
    parent: Dict[str, Optional[str]] = {}
    children: Dict[str, List[str]] = {v: [] for v in adj}
    pseudo_parents: Dict[str, List[str]] = {v: [] for v in adj}
    pseudo_children: Dict[str, List[str]] = {v: [] for v in adj}
    depth: Dict[str, int] = {}
    roots: List[str] = []

    for start in sorted(adj, key=heur):
        if start in visited:
            continue
        roots.append(start)
        parent[start] = None
        depth[start] = 0
        # iterative DFS with ancestor tracking
        stack: List[Tuple[str, iter]] = []
        visited.add(start)
        on_path: Set[str] = {start}
        stack.append((start, iter(sorted(adj[start], key=heur))))
        while stack:
            node, it = stack[-1]
            advanced = False
            for nb in it:
                if nb not in visited:
                    visited.add(nb)
                    parent[nb] = node
                    children[node].append(nb)
                    depth[nb] = depth[node] + 1
                    on_path.add(nb)
                    stack.append((nb, iter(sorted(adj[nb], key=heur))))
                    advanced = True
                    break
                elif nb in on_path and nb != parent[node]:
                    # back edge to an ancestor → pseudo relationship
                    if nb not in pseudo_parents[node]:
                        pseudo_parents[node].append(nb)
                        pseudo_children[nb].append(node)
                # forward/cross edges within the DFS cannot occur in an
                # undirected DFS traversal
            if not advanced:
                stack.pop()
                on_path.discard(node)

    # attach each constraint to its lowest variable
    # (reference: _filter_relation_to_lowest_node, pseudotree.py:448)
    constraints_for: Dict[str, List[Constraint]] = {v: [] for v in adj}
    for c in constraints:
        names = [v.name for v in c.dimensions if v.name in adj]
        if not names:
            continue
        lowest = max(names, key=lambda n: (depth[n], n))
        constraints_for[lowest].append(c)

    nodes = []
    for name, v in var_map.items():
        links: List[PseudoTreeLink] = []
        if parent.get(name):
            links.append(PseudoTreeLink("parent", name, parent[name]))
            links.append(PseudoTreeLink("children", parent[name], name))
        for ch in children[name]:
            links.append(PseudoTreeLink("children", name, ch))
        for pp in pseudo_parents[name]:
            links.append(PseudoTreeLink("pseudo_parent", name, pp))
        for pc in pseudo_children[name]:
            links.append(PseudoTreeLink("pseudo_children", name, pc))
        nodes.append(PseudoTreeNode(v, constraints_for[name], links))

    return ComputationPseudoTree(nodes, roots, depth)


def get_dfs_relations(node: PseudoTreeNode):
    """Split a node's view of the tree for DPOP: (parent, pseudo_parents,
    children, pseudo_children, constraints) — reference pseudotree.py:178."""
    return (
        node.parent,
        node.pseudo_parents,
        node.children,
        node.pseudo_children,
        node.constraints,
    )
