"""Replica placement for k-resiliency.

The port of the JAX package's ``replication/__init__.py`` (the
reference's pydcop/replication/dist_ucs_hostingcosts.py :52-74,
build_replication_computation): place k replicas of every active
computation on distinct other agents, minimizing route-distance +
hosting cost, under agent capacities.

The reference runs a distributed uniform-cost search among agents; the
placement objective is identical here but solved centrally: shortest
route distances by Dijkstra over the agents' route graph (the UCS cost),
then per-computation greedy assignment of the k cheapest feasible
agents.  Determinism: ties break on agent name.

The same results as the JAX package's functions, computed over arrays:
:func:`route_distances` runs each source's Dijkstra on the dense route
matrix (settle the nearest unsettled agent, relax its row — the same
``cost + step`` sums the heap version forms), and :func:`place_replicas`
orders one computation's candidates with one ``lexsort`` on (cost, agent
name) instead of a sort of Python tuples.  Host arithmetic only: the
placement is metadata of the orchestrator, not device work.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from pydcop_tpu_torch.dcop.objects import AgentDef
from pydcop_tpu_torch.distribution.objects import Distribution


class ReplicaDistribution:
    """computation → list of replica-holder agents."""

    def __init__(self, mapping: Dict[str, List[str]]):
        self._mapping = {c: list(agents) for c, agents in mapping.items()}

    def replicas(self, computation: str) -> List[str]:
        return list(self._mapping.get(computation, []))

    def mapping(self) -> Dict[str, List[str]]:
        return {c: list(a) for c, a in self._mapping.items()}

    def agents_holding(self, agent: str) -> List[str]:
        return [c for c, agents in self._mapping.items() if agent in agents]

    def __repr__(self):
        return f"ReplicaDistribution({self._mapping})"


def _route_matrix(agents: List[AgentDef]) -> np.ndarray:
    names = [a.name for a in agents]
    return np.array([[a.route(b) if b != a.name else 0.0 for b in names]
                     for a in agents], dtype=np.float64)


def _shortest(routes: np.ndarray) -> np.ndarray:
    """All-pairs shortest route costs, one dense Dijkstra per source
    (``inf`` where unreachable)."""
    n = routes.shape[0]
    out = np.full((n, n), np.inf)
    for src in range(n):
        d = np.full(n, np.inf)
        d[src] = 0.0
        open_ = np.ones(n, dtype=bool)
        for _ in range(n):
            masked = np.where(open_, d, np.inf)
            cur = int(np.argmin(masked))
            if not np.isfinite(masked[cur]):
                break
            open_[cur] = False
            nd = d[cur] + routes[cur]
            better = open_ & (nd < d)
            d[better] = nd[better]
        out[src] = d
    return out


def route_distances(agents: List[AgentDef]) -> Dict[str, Dict[str, float]]:
    """All-pairs shortest route costs (Dijkstra per agent) — the UCS metric
    of the reference (replication/path_utils.py cheapest_path_to)."""
    agents = list(agents)
    names = [a.name for a in agents]
    dist = _shortest(_route_matrix(agents))
    return {
        src: {names[j]: float(dist[i, j]) for j in range(len(names))
              if np.isfinite(dist[i, j])}
        for i, src in enumerate(names)
    }


def place_replicas(
    computations: Iterable[str],
    distribution: Distribution,
    agents: Iterable[AgentDef],
    k: int,
    computation_memory: Optional[Callable[[str], float]] = None,
    hosting_weight: float = 1.0,
    route_weight: float = 1.0,
) -> ReplicaDistribution:
    """Place k replicas of each computation on distinct agents ≠ its host,
    minimizing route(host→candidate) + hosting cost, respecting remaining
    capacities."""
    agents = list(agents)
    names = [a.name for a in agents]
    index = {n: i for i, n in enumerate(names)}
    dist = _shortest(_route_matrix(agents))
    mem = computation_memory or (lambda c: 0.0)
    # ties on cost break on the agent's name, as a sort of (cost, name)
    name_rank = np.empty(len(names), dtype=np.int64)
    name_rank[np.argsort(np.array(names, dtype=object), kind="stable")] = \
        np.arange(len(names))
    default_hosting = np.array([a.default_hosting_cost for a in agents],
                               dtype=np.float64)
    hosting_overrides: Dict[str, List] = {}
    for i, a in enumerate(agents):
        for comp, cost in a.hosting_costs.items():
            hosting_overrides.setdefault(comp, []).append((i, cost))

    remaining = np.empty(len(agents), dtype=np.float64)
    for i, a in enumerate(agents):
        used = sum(
            mem(c) for c in distribution.computations_hosted(a.name)
        ) if distribution else 0.0
        cap = a.capacity if a.capacity is not None else float("inf")
        remaining[i] = cap - used

    # each computation's host: the first agent hosting it, as
    # Distribution.agent_for answers (one pass instead of a scan a call)
    hosts: Dict[str, str] = {}
    if distribution:
        for a_name, comps in distribution.mapping().items():
            for c in comps:
                hosts.setdefault(c, a_name)
    mapping: Dict[str, List[str]] = {}
    for comp in sorted(computations):
        host = hosts.get(comp)
        if not host:
            route = np.zeros(len(agents))
        elif host in index:
            route = dist[index[host]]
            if not np.isfinite(route).all():
                # unreachable pairs fall back to the agent's own route,
                # as the JAX package's dict lookup does
                route = np.where(np.isfinite(route), route,
                                 [a.route(host) for a in agents])
        else:
            route = np.array([a.route(host) for a in agents],
                             dtype=np.float64)
        hosting = default_hosting.copy()
        for i, cost in hosting_overrides.get(comp, ()):
            hosting[i] = cost
        cost = route_weight * route + hosting_weight * hosting
        order = np.lexsort((name_rank, cost))
        need = mem(comp)
        chosen: List[str] = []
        for i in order:
            if len(chosen) >= k:
                break
            if names[i] == host:
                continue
            if remaining[i] >= need:
                chosen.append(names[i])
                remaining[i] -= need
        mapping[comp] = chosen
    return ReplicaDistribution(mapping)


__all__ = ["ReplicaDistribution", "place_replicas", "route_distances"]
