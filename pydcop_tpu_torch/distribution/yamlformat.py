"""Load/save a Distribution as YAML.

A copy of the JAX package's ``distribution/yamlformat.py`` (the
reference's pydcop/distribution/yamlformat.py): the format is
``distribution: {agent: [computations...]}``, so a file written by
either package loads in the other.
"""
from __future__ import annotations

import os

import yaml

from pydcop_tpu_torch.distribution.objects import Distribution


def load_dist_from_file(filename: str) -> Distribution:
    with open(os.path.expanduser(filename), encoding="utf-8") as f:
        return load_dist(f.read())


def load_dist(dist_str: str) -> Distribution:
    loaded = yaml.safe_load(dist_str)
    mapping = loaded.get("distribution", {})
    return Distribution(
        {a: list(comps) if comps else [] for a, comps in mapping.items()}
    )


def yaml_dist(distribution: Distribution) -> str:
    return yaml.dump(
        {"distribution": distribution.mapping()},
        default_flow_style=False,
        sort_keys=True,
    )
