"""Distribution (computation→agent placement) objects and their YAML
format.

Only the objects and the YAML loader are ported: a distribution FILE
drives the sharded solve (``solve -d placement.yaml``).  The placement
strategies of the JAX package (``adhoc``, ``ilp_*``, ``gh_*``, ...) are
not ported; asking for one by name raises
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
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

__all__ = [
    "Distribution",
    "DistributionHints",
    "ImpossibleDistributionException",
    "load_dist",
    "load_dist_from_file",
    "yaml_dist",
]
