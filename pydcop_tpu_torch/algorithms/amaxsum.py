"""A-MaxSum — asynchronous MaxSum.

Equivalent capability to the reference's pydcop/algorithms/amaxsum.py
(MaxSumFactorComputation, MaxSumVariableComputation): factors and
variables fire on every message receipt instead of waiting for a cycle
barrier.

The JAX package's emulation (``pydcop_tpu/algorithms/amaxsum.py``), on
the generic ``[E, D]`` engine: each cycle computes every message, then
only a random subset of edges commits its new messages (a per-edge
activation mask, ``uniform < activation``), the rest keep the previous
cycle's.  The packed layouts carry no such mask, so this solver always
runs the generic engine (``use_packed=False``, as the JAX solver), in
plain PyTorch: no kernel of the port.  Its chunks run through the
harness's fixed-shape runner, captured as a CUDA graph on the card, the
chunk's masks copied into the graph's buffer before each replay.  Under
a placement (``solve -d``) amaxsum runs the sharded engine's activation
branch instead
(``ShardedMaxSum(activation=...)``, K7's activation kernel).

Stated deviation from the JAX package: the per-cycle ``[E]`` uniforms
are drawn on the CPU from a ``torch.Generator`` seeded with the solver's
seed at the start of every run (:meth:`AMaxSumSolver.draw_uniforms`, the
hook through which a test feeds shared masks), not from ``jax.random``.
"""
from __future__ import annotations

from typing import Optional

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms.maxsum import (  # noqa: F401 (re-export)
    MaxSumSolver,
    communication_load,
    computation_memory,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import compile_factor_graph
from pydcop_tpu_torch.ops.maxsum_kernels import maxsum_cycle

GRAPH_TYPE = "factor_graph"

#: default per-edge activation probability, for every amaxsum entry point
#: (the solver and the placement-driven run)
DEFAULT_ACTIVATION = 0.7

algo_params = [
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef("stability", "float", None, 0.1),
    AlgoParameterDef("noise", "float", None, 0.01),
    AlgoParameterDef("activation", "float", None, DEFAULT_ACTIVATION),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


class AMaxSumSolver(MaxSumSolver):
    """MaxSum on the generic engine whose edges commit their new messages
    only where this cycle's uniform is below ``activation``.  State =
    (q, r, values), as MaxSum's."""

    def __init__(self, dcop, tensors, algo_def, seed: int = 0):
        super().__init__(dcop, tensors, algo_def, seed, use_packed=False)
        self.activation = float(
            self.params.get("activation", DEFAULT_ACTIVATION))
        self.seed = seed
        self.coins = torch.Generator(device="cpu")

    def _restart_streams(self, warm):
        # every fresh run replays the same masks, as the JAX package
        # restarts its key at PRNGKey(seed); a warm restart continues
        if not warm:
            self.coins.manual_seed(self.seed)

    def draw_uniforms(self, n: int) -> torch.Tensor:
        """[n, E] float32 activation uniforms for the next n cycles, on
        the CPU."""
        return torch.rand((n, self.tensors.n_edges), generator=self.coins)

    def draw_chunk_coins(self, n: int):
        return (self.draw_uniforms(n),)

    def step(self, state, coins):
        q, r, _ = state
        active = (coins[0] < self.activation)[:, None]
        q2, r2, _, values = maxsum_cycle(self.tensors, q, r,
                                         damping=self.damping)
        return torch.where(active, q2, q), torch.where(active, r2, r), values


def build_solver(
    dcop: DCOP,
    computation_graph=None,
    algo_def: Optional[AlgorithmDef] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> AMaxSumSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "amaxsum", parameters_definitions=algo_params
    )
    tensors = compile_factor_graph(dcop, device=device)
    return AMaxSumSolver(dcop, tensors, algo_def, seed)
