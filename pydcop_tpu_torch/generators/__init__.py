"""Problem generators, as functions returning DCOP objects.

Only the generators a ported path needs are here: :func:`generate_secp`
(smart-lighting SECPs, the mixed-arity instances of ``chip_smoke.py``).
"""
from pydcop_tpu_torch.generators.secp import generate_secp

__all__ = ["generate_secp"]
