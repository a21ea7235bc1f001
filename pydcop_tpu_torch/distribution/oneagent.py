"""oneagent distribution: one computation per agent (the classic DCOP
hypothesis).

A copy of the JAX package's ``distribution/oneagent.py`` (the
reference's pydcop/distribution/oneagent.py:66, doc :31-44): each agent
hosts exactly one computation; requires at least as many agents as
computations.  Cost is identically 0.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    ImpossibleDistributionException,
)


def distribute(
    computation_graph,
    agentsdef: Iterable,
    hints=None,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> Distribution:
    agents = list(agentsdef)
    nodes = computation_graph.nodes
    if len(agents) < len(nodes):
        raise ImpossibleDistributionException(
            f"oneagent needs at least as many agents ({len(agents)}) as "
            f"computations ({len(nodes)})"
        )
    mapping = {a.name: [] for a in agents}
    for agent, node in zip(agents, nodes):
        mapping[agent.name].append(node.name)
    return Distribution(mapping)


def distribution_cost(
    distribution: Distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> float:
    return 0.0
