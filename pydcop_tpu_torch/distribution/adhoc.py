"""adhoc distribution: fast greedy placement honoring capacity and
must_host hints.

A copy of the JAX package's ``distribution/adhoc.py`` (the reference's
pydcop/distribution/adhoc.py:57, doc :46-55, IJCAI-16): hinted
computations go to their pinned agents;
remaining computations are placed one by one on the least-loaded agent with
enough remaining capacity, preferring agents already hosting a neighbor.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

from pydcop_tpu_torch.distribution._costs import distribution_cost as _dist_cost
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
    if not agents:
        raise ImpossibleDistributionException("No agents")
    mem = computation_memory or (lambda n: 0.0)
    remaining = {a.name: (a.capacity if a.capacity is not None else
                          float("inf")) for a in agents}
    mapping: Dict[str, List[str]] = {a.name: [] for a in agents}
    hosted_by: Dict[str, str] = {}

    nodes = {n.name: n for n in computation_graph.nodes}
    todo = list(nodes)

    # 1. pinned computations first
    if hints is not None and hasattr(hints, "must_host_map"):
        for a_name, comps in hints.must_host_map.items():
            if a_name not in mapping:
                continue
            for c in comps:
                if c not in nodes:
                    continue
                footprint = mem(nodes[c])
                if footprint > remaining[a_name]:
                    raise ImpossibleDistributionException(
                        f"must_host hint overflows capacity of {a_name}"
                    )
                mapping[a_name].append(c)
                hosted_by[c] = a_name
                remaining[a_name] -= footprint
                todo.remove(c)

    # 2. greedy: prefer an agent hosting a neighbor, else least loaded
    for c in sorted(todo, key=lambda c: -mem(nodes[c])):
        footprint = mem(nodes[c])
        neighbor_agents = {
            hosted_by[nb] for nb in nodes[c].neighbors if nb in hosted_by
        }
        candidates = [
            a for a in agents
            if remaining[a.name] >= footprint
        ]
        if not candidates:
            raise ImpossibleDistributionException(
                f"No agent has capacity for computation {c}"
            )
        candidates.sort(
            key=lambda a: (
                0 if a.name in neighbor_agents else 1,
                len(mapping[a.name]),
                a.name,
            )
        )
        chosen = candidates[0]
        mapping[chosen.name].append(c)
        hosted_by[c] = chosen.name
        remaining[chosen.name] -= footprint
    return Distribution(mapping)


def distribution_cost(
    distribution: Distribution,
    computation_graph,
    agentsdef: Iterable,
    computation_memory: Optional[Callable] = None,
    communication_load: Optional[Callable] = None,
) -> float:
    return _dist_cost(
        distribution, computation_graph, agentsdef, computation_memory,
        communication_load,
    )[0]
