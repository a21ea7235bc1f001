"""Distribution (placement) objects.

A copy of the JAX package's ``distribution/objects.py`` (the reference's
pydcop/distribution/objects.py: Distribution, DistributionHints,
ImpossibleDistributionException).

A Distribution doubles as a **sharding assignment**: the mapping
computation→agent becomes computation→shard when a solve runs on the
sharded engines (see :mod:`pydcop_tpu_torch.parallel`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from pydcop_tpu_torch.dcop.yamldcop import DistributionHints  # re-export

__all__ = ["Distribution", "DistributionHints",
           "ImpossibleDistributionException"]


class ImpossibleDistributionException(Exception):
    pass


class Distribution:
    """A bidirectional mapping agent ↔ hosted computations."""

    def __init__(self, mapping: Dict[str, List[str]]):
        self._mapping: Dict[str, List[str]] = {
            a: list(comps) for a, comps in mapping.items()
        }

    @property
    def agents(self) -> List[str]:
        return list(self._mapping)

    @property
    def computations(self) -> List[str]:
        return [c for comps in self._mapping.values() for c in comps]

    def mapping(self) -> Dict[str, List[str]]:
        return {a: list(c) for a, c in self._mapping.items()}

    def computations_hosted(self, agent: str) -> List[str]:
        return list(self._mapping.get(agent, []))

    def agent_for(self, computation: str) -> str:
        for a, comps in self._mapping.items():
            if computation in comps:
                return a
        raise KeyError(f"No agent hosts computation {computation!r}")

    def has_computation(self, computation: str) -> bool:
        return any(computation in comps for comps in self._mapping.values())

    def host_on_agent(self, agent: str, computations: Iterable[str]):
        self._mapping.setdefault(agent, []).extend(computations)

    def remove_computation(self, computation: str):
        for comps in self._mapping.values():
            if computation in comps:
                comps.remove(computation)
                return
        raise KeyError(computation)

    def remove_agent(self, agent: str) -> List[str]:
        """Remove an agent, returning its orphaned computations."""
        return self._mapping.pop(agent, [])

    def is_hosted(self, computations: Iterable[str]) -> bool:
        hosted = set(self.computations)
        return all(c in hosted for c in computations)

    def __eq__(self, other):
        return (
            isinstance(other, Distribution)
            and {a: sorted(c) for a, c in self._mapping.items()}
            == {a: sorted(c) for a, c in other._mapping.items()}
        )

    def __repr__(self):
        return f"Distribution({self._mapping})"
