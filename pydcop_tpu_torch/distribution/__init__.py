"""Distribution (computation→agent placement) objects, their YAML format
and the placement strategies.

A distribution FILE drives the sharded solve (``solve -d
placement.yaml``); a strategy NAME places the computations of a
computation graph on the DCOP's agents (the orchestrator, ``run -d``,
``replica_dist -d``).  Every strategy module exposes ``distribute(
computation_graph, agentsdef, hints, computation_memory,
communication_load) -> Distribution`` and ``distribution_cost(...)``.

Ported: ``oneagent``, ``adhoc`` and their shared cost model
(``_costs``), copies of the JAX package's.  The other strategies of the
JAX package (:data:`UNPORTED_STRATEGIES`) raise
:class:`~pydcop_tpu_torch.errors.NotPortedError` when asked for by name.
"""
from __future__ import annotations

import importlib
import pkgutil

from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    DistributionHints,
    ImpossibleDistributionException,
)
from pydcop_tpu_torch.distribution.yamlformat import (
    load_dist,
    load_dist_from_file,
    yaml_dist,
)

#: the JAX package's strategies this package does not have: the greedy
#: heuristics and the (o)ilp ones (which need ``pulp``)
UNPORTED_STRATEGIES = (
    "gh_cgdp", "gh_secp_cgdp", "gh_secp_fgdp", "heur_comhost",
    "ilp_compref", "ilp_compref_fg", "ilp_fgdp", "oilp_cgdp",
    "oilp_secp_cgdp", "oilp_secp_fgdp",
)


def list_available_distributions():
    """The strategy names this package ports."""
    import pydcop_tpu_torch.distribution as pkg

    exclude = {"objects", "yamlformat"}
    return sorted(
        m.name
        for m in pkgutil.iter_modules(pkg.__path__)
        if not m.ispkg and m.name not in exclude
        and not m.name.startswith("_")
    )


def load_distribution_module(name: str):
    if name in UNPORTED_STRATEGIES:
        from pydcop_tpu_torch.errors import NotPortedError

        raise NotPortedError(
            f"distribution strategy {name!r} is not ported to the PyTorch "
            f"package yet (ported: {list_available_distributions()})"
        )
    if name not in list_available_distributions():
        raise ImportError(
            f"Could not find distribution module {name!r} (available: "
            f"{list_available_distributions()})"
        )
    return importlib.import_module(f"pydcop_tpu_torch.distribution.{name}")


__all__ = [
    "Distribution",
    "DistributionHints",
    "ImpossibleDistributionException",
    "UNPORTED_STRATEGIES",
    "list_available_distributions",
    "load_dist",
    "load_dist_from_file",
    "load_distribution_module",
    "yaml_dist",
]
