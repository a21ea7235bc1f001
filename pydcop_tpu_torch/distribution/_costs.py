"""Shared placement cost model.

A copy of the JAX package's ``distribution/_costs.py`` (the reference's
per-module distribution_cost implementations): total cost = hosting
costs + route-weighted communication load over computation-graph edges
(pydcop/distribution/ilp_compref.py objective, AAMAS-18).
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

from pydcop_tpu_torch.distribution.objects import Distribution

# reference balance between communication and hosting terms
# (pydcop/distribution/ilp_compref.py RATIO_HOST_COMM)
RATIO_HOST_COMM = 0.8


def edge_loads(
    computation_graph, communication_load: Callable
) -> List[Tuple[str, str, float]]:
    """(comp1, comp2, load) for every computation-graph link."""
    out = []
    for link in computation_graph.links:
        nodes = list(link.nodes)
        for i, n1 in enumerate(nodes):
            for n2 in nodes[i + 1:]:
                if n1 == n2 or n1 not in computation_graph or \
                        n2 not in computation_graph:
                    continue
                load = communication_load(
                    computation_graph.computation(n1), n2
                )
                out.append((n1, n2, float(load)))
    return out


def distribution_cost(
    distribution: Distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Callable = None,
    communication_load: Callable = None,
) -> Tuple[float, float, float]:
    """(total, communication, hosting) costs of a placement."""
    agents = {a.name: a for a in agentsdef}
    comm = 0.0
    if communication_load is not None:
        for c1, c2, load in edge_loads(computation_graph,
                                       communication_load):
            a1 = distribution.agent_for(c1)
            a2 = distribution.agent_for(c2)
            comm += agents[a1].route(a2) * load
    hosting = 0.0
    for a_name in distribution.agents:
        agent = agents[a_name]
        for comp in distribution.computations_hosted(a_name):
            hosting += agent.hosting_cost(comp)
    total = RATIO_HOST_COMM * comm + (1 - RATIO_HOST_COMM) * hosting
    return total, comm, hosting


def check_capacity(
    distribution: Distribution,
    agentsdef: Iterable,
    computation_memory: Callable,
    computation_graph,
) -> bool:
    agents = {a.name: a for a in agentsdef}
    for a_name in distribution.agents:
        used = sum(
            computation_memory(computation_graph.computation(c))
            for c in distribution.computations_hosted(a_name)
        )
        if agents[a_name].capacity is not None and \
                used > agents[a_name].capacity:
            return False
    return True
