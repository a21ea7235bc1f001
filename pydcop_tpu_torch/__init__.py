"""pydcop_tpu_torch — the PyTorch/CUDA port of pydcop_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It keeps
the JAX package's problem model, YAML format, tensor layouts and solve
semantics, imports nothing of JAX or of the JAX package, and replaces
each Pallas TPU kernel on its path with a kernel written by hand for
``sm_90a`` (``csrc/``).  Entry points run on ``cuda`` unless the caller
asks for ``device="cpu"``.

Ported so far: ``solve -a
maxsum|mgm|mgm2|dsa|dsatuto|mixeddsa|adsa|dpop|dba|gdba`` on one device
— model (`pydcop_tpu_torch.dcop`), factor graph, constraints hypergraph
and pseudo-tree (`pydcop_tpu_torch.graph`), compile
(`pydcop_tpu_torch.ops.compile`), the generic and packed engines, the
chunked harness, `solve_result`/`solve` and the CLI — and the sharded
MaxSum and local-search engines in one process
(`pydcop_tpu_torch.parallel`), which a distribution file drives
(``solve -d``).
"""

from pydcop_tpu_torch.version import __version__

__all__ = ["__version__"]
