"""Replica-distribution YAML (de)serialization.

A copy of the JAX package's ``replication/yamlformat.py`` (the
reference's pydcop/replication/yamlformat.py :44-58, and the
``replica_dist`` command's result envelope, commands/replica_dist.py
:219-233): the file holds a ``replica_dist`` mapping computation → list
of replica-holder agents, optionally alongside an ``inputs`` block
recording how it was produced.
"""
from __future__ import annotations

from typing import Dict, Optional

import yaml

from pydcop_tpu_torch.replication import ReplicaDistribution


def yaml_replica_dist(
    replicas: ReplicaDistribution, inputs: Optional[Dict] = None
) -> str:
    """Serialize a replica distribution (with an optional ``inputs``
    provenance block, like the reference command output)."""
    result: Dict = {}
    if inputs is not None:
        result["inputs"] = inputs
    result["replica_dist"] = replicas.mapping()
    return yaml.safe_dump(result, default_flow_style=False)


def load_replica_dist(dist_str: str) -> ReplicaDistribution:
    """Parse a replica distribution (reference yamlformat.py:50-58)."""
    loaded = yaml.safe_load(dist_str)
    if not isinstance(loaded, dict) or "replica_dist" not in loaded:
        raise ValueError("Invalid replica distribution file")
    mapping = loaded["replica_dist"]
    if not isinstance(mapping, dict):
        raise ValueError("Invalid replica distribution file")
    clean: Dict[str, list] = {}
    for c, agents in mapping.items():
        if not isinstance(agents, list):
            raise ValueError(
                f"Invalid replica distribution file: replicas of "
                f"'{c}' must be a list, got {type(agents).__name__}"
            )
        clean[str(c)] = [str(a) for a in agents]
    return ReplicaDistribution(clean)


def load_replica_dist_from_file(filename: str) -> ReplicaDistribution:
    with open(filename, mode="r", encoding="utf-8") as f:
        return load_replica_dist(f.read())
