"""Device-resident anytime branch and bound.

SyncBB's token walk and NCBB's recursive subtree search have a frontier-
batched exact engine beside their host loops: a fixed-shape ``[B, n]``
slab of partial assignments along a pseudo-tree DFS order, expanded one
level per step on the device, with static mini-bucket lower bounds (the
Kask–Dechter heuristic, exact when the i-bound covers the induced width)
evaluated as batched gathers, best-first selection and incumbent updates
on the device, and the host reading ONE ``[2]`` stats vector —
incumbent + global bound — per chunk.  Overflowing frontier rows spill
to a device-side ring buffer, then to a small annex the host drains at
chunk boundaries (the counted spill fallback).

* :mod:`pydcop_tpu_torch.search.plan` — host-side compile: DFS order,
  per-depth constraint gather specs, mini-bucket bound tables;
* :mod:`pydcop_tpu_torch.search.frontier` — the expand/bound/select step
  and the chunk runner, PyTorch tensor code on one device;
* :mod:`pydcop_tpu_torch.search.solver` — the anytime driver behind
  ``solve --anytime-exact``, ``engine=frontier`` on syncbb/ncbb and
  DPOP's ``engine=frontier``.

The JAX package's ``search/`` package, ported.
"""
from pydcop_tpu_torch.search.plan import (  # noqa: F401
    SearchPlan,
    compile_search_plan,
    estimate_search_bytes,
    suggest_search_i_bound,
)
from pydcop_tpu_torch.search.solver import (  # noqa: F401
    FrontierSearchSolver,
    build_frontier_solver,
)
