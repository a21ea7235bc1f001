"""Synchronous MaxSum (min-sum belief propagation on a factor graph).

Equivalent capability to the reference's pydcop/algorithms/maxsum.py
(MaxSumFactorComputation, MaxSumVariableComputation,
factor_costs_for_var, costs_for_factor, select_value, damping/stability).

Two engines:

* packed (all-binary graphs with D ≤ 8; mixed arity 1-4 with D ≤ 8, or
  D ≤ 5 with a ternary or quaternary factor): the var-grouped slot
  layouts of :mod:`pydcop_tpu_torch.ops.packed_maxsum`, one launch of the
  hand-written CUDA kernel per cycle on a GPU, the kernel's plain
  version on the CPU;
* generic (any arity/domain): ``[E, D]`` messages and a batched
  broadcast-min per arity bucket (:mod:`pydcop_tpu_torch.ops.maxsum_kernels`).

``use_packed`` has the JAX solver's meaning
(:func:`~pydcop_tpu_torch.ops.packed_maxsum.solver_layout`): by default
an all-binary graph packs on every device and a mixed-arity graph on
CUDA only, as the JAX package packs only on its accelerator — so on the
CPU both packages run the generic engine for mixed graphs, and their
packed engines (which add in another order: on ``secp_small`` at noise 0
the generic engine stops at cycle 35 with cost 3.713333, the packed one
at cycle 42 with 4.223333, in both packages) meet only with
``use_packed=True``.  ``True`` packs whatever packs, on any device;
``False`` forces the generic engine.

Under the harness (:mod:`pydcop_tpu_torch.algorithms.base`) a chunk of
the packed engine is one ``packed_cycles`` call (one cooperative launch
on the binary layout, one a cycle on the mixed one); with
``collect_cycles`` it is one call a cycle, each followed by the cycle's
cost, outside a CUDA graph.  The generic engine's chunks run through the
fixed-shape runner, captured as a CUDA graph on the card.

Stated deviation from the JAX package: the symmetry-breaking noise added
to the unary costs is drawn from a ``torch.Generator`` seeded with
``seed + 1`` ON THE CPU and then moved to the device — so a CPU run and a
GPU run of this package get the same noise, but not the numbers of the
JAX package's ``jax.random`` stream.  Runs compared with the JAX package
set ``noise`` to 0 on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms.base import SynchronousTensorSolver
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import FactorGraphTensors, \
    compile_factor_graph
from pydcop_tpu_torch.ops.maxsum_kernels import init_messages, maxsum_cycle
from pydcop_tpu_torch.ops.packed_maxsum import (
    packed_cycles,
    packed_init_state,
    solver_layout,
)
from pydcop_tpu_torch.ops.segments import masked_argmin

GRAPH_TYPE = "factor_graph"

HEADER_SIZE = 0
UNIT_SIZE = 1

algo_params = [
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef("stability", "float", None, 0.1),
    AlgoParameterDef("noise", "float", None, 0.01),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def messages_stable(r_prev: torch.Tensor, r_cur: torch.Tensor,
                    stability: float) -> torch.Tensor:
    """Elementwise reference approx_match: equal values match; otherwise
    the symmetric relative difference ``2|a-b| / |a+b|`` must be below
    the coefficient (written as a multiplication so a zero denominator
    needs no special-casing)."""
    delta = torch.abs(r_cur - r_prev)
    denom = torch.abs(r_cur + r_prev)
    return (delta == 0) | (2 * delta < stability * denom)


class MaxSumSolver(SynchronousTensorSolver):
    """State = (q var→factor msgs, r factor→var msgs, values [V]).

    The packed engine runs where :func:`solver_layout` gives a layout
    (see the module docstring); other graphs take the generic engine."""

    def __init__(self, dcop, tensors: FactorGraphTensors, algo_def,
                 seed: int = 0, use_packed: Optional[bool] = None):
        super().__init__(dcop, tensors, algo_def)
        self.seed = seed
        precision = self.params.get("precision") or "f32"
        if precision != "f32":
            raise NotPortedError(
                f"maxsum precision={precision!r} is not ported to the "
                f"PyTorch package yet; run precision=f32"
            )
        self.damping = float(self.params.get("damping", 0.5))
        # message-stability convergence coefficient (the reference's
        # approx_match STABILITY_COEFF)
        self.stability = float(self.params.get("stability", 0.1))
        # Symmetry breaking: seeded uniform noise on the unary costs, drawn
        # on the CPU so every device gets the same numbers (see the module
        # docstring for how this differs from the JAX package)
        noise_level = float(self.params.get("noise", 0.01))
        if noise_level > 0:
            gen = torch.Generator(device="cpu").manual_seed(seed + 1)
            mask = tensors.domain_mask.cpu()
            noise = torch.rand(mask.shape, generator=gen) * noise_level * mask
            self.tensors = dataclasses.replace(
                tensors,
                unary_costs=tensors.unary_costs + noise.to(self.device),
            )
        # 2 messages per edge per cycle (var→factor and factor→var), D
        # costs each — the reference's message accounting
        self.msgs_per_cycle = 2 * tensors.n_edges
        self.msg_size_per_msg = float(tensors.max_domain_size)
        self.packed = solver_layout(self.tensors, use_packed)

    def initial_state(self):
        if self.packed is not None:
            q, r = packed_init_state(self.packed)
        else:
            q, r = init_messages(self.tensors)
        values = masked_argmin(self.tensors.unary_costs,
                               self.tensors.domain_mask)
        return q, r, values

    def checkpoint_engine(self) -> str:
        """The layout of the state leaves (``runtime/checkpoint.py``):
        the packed engine's q and r are in its slot order."""
        return "packed" if self.packed is not None else "generic"

    def _supports_fixed_chunk(self, collect):
        # the packed engine's cooperative launches are not captured
        return self.packed is None

    def step(self, state, coins):
        q, r, _ = state
        q, r, _, values = maxsum_cycle(self.tensors, q, r,
                                       damping=self.damping)
        return q, r, values

    def run_cycles(self, state, n: int):
        if self.packed is None:
            return super().run_cycles(state, n)
        q, r, _ = state
        q, r, _, values = packed_cycles(self.packed, q, r, n,
                                        damping=self.damping)
        return q, r, values

    def values_of(self, state):
        return state[2]

    def chunk_converged_device(self, prev_state, state):
        """Assignment unchanged OR every factor→variable message stable
        within the ``stability`` coefficient — the reference's own
        convergence test, applied at chunk boundaries (the harness uses a
        prime chunk and two stable chunks, so only an oscillation with a
        period equal to the chunk can alias to "stable")."""
        return super().chunk_converged_device(prev_state, state) | torch.all(
            messages_stable(prev_state[1], state[1], self.stability)
        )


def build_solver(
    dcop: DCOP,
    computation_graph=None,
    algo_def: Optional[AlgorithmDef] = None,
    seed: int = 0,
    device: DeviceLike = None,
    use_packed: Optional[bool] = None,
) -> MaxSumSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "maxsum", parameters_definitions=algo_params
    )
    tensors = compile_factor_graph(dcop, device=device)
    return MaxSumSolver(dcop, tensors, algo_def, seed, use_packed)


# -- distribution cost callbacks (reference: maxsum.py computation_memory /
#    communication_load) -----------------------------------------------------


def computation_memory(node) -> float:
    """Memory footprint of one factor-graph computation: factors hold one
    cost entry per assignment of their scope; variables hold one cost per
    (neighbor, value)."""
    if hasattr(node, "factor"):
        size = 1
        for v in node.factor.dimensions:
            size *= len(v.domain)
        return float(size) * UNIT_SIZE
    if hasattr(node, "variable"):
        return len(node.variable.domain) * max(1, len(node.neighbors)) * UNIT_SIZE
    return 0.0


def communication_load(node, target: str = None) -> float:
    """Cost of one edge: one message of D costs per cycle."""
    if hasattr(node, "variable"):
        return float(len(node.variable.domain)) + HEADER_SIZE
    if hasattr(node, "factor"):
        # message to a variable: that variable's domain size
        for v in node.factor.dimensions:
            if target is None or v.name == target:
                return float(len(v.domain)) + HEADER_SIZE
    return 1.0
