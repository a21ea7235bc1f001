"""Factor-graph belief-propagation (max-sum) — the generic engine.

The math of the reference's MaxSum computations (factor_costs_for_var —
min over all assignments of the factor's other variables — and
costs_for_factor — sum of other factors' marginals, normalized), as
batched tensor ops on the ``[E, D]`` edge layout of
:mod:`pydcop_tpu_torch.ops.compile`:

* factor→var: for each scope position p, broadcast-add every other
  position's incoming message onto the factor cost tensor and min-reduce
  all axes except p, per arity bucket;
* var→factor: beliefs = unary + segment-sum of incoming messages over the
  edge list; outgoing = beliefs − own incoming, normalized by the masked
  mean.

This engine takes any arity and domain size.  It is plain PyTorch (the
JAX package's counterpart is XLA code, not a Pallas kernel); all-binary
graphs with D ≤ 8 take the packed engine of
:mod:`pydcop_tpu_torch.ops.packed_maxsum` instead.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from pydcop_tpu_torch.ops.compile import (
    FactorBucket,
    FactorGraphTensors,
    edge_plan,
)
from pydcop_tpu_torch.ops.segments import masked_argmin, masked_mean


def _broadcast_to_axis(msg: torch.Tensor, axis: int,
                       arity: int) -> torch.Tensor:
    """Reshape [F, D] messages to broadcast along value-axis `axis` of a
    [F, D, ..., D] factor tensor."""
    F, D = msg.shape
    shape = [F] + [1] * arity
    shape[1 + axis] = D
    return msg.reshape(shape)


def factor_to_var_messages(bucket: FactorBucket,
                           q_bucket: torch.Tensor) -> torch.Tensor:
    """factor→variable messages for one arity bucket.

    q_bucket: [F, a, D] incoming var→factor messages.  Returns [F, a, D]:
    r[f, p, d] = min over assignments of the other variables of
    (cost + sum of their incoming messages)."""
    a = bucket.arity
    outs = []
    for p in range(a):
        s = bucket.tensors
        for q in range(a):
            if q != p:
                s = s + _broadcast_to_axis(q_bucket[:, q, :], q, a)
        reduce_axes = tuple(1 + q for q in range(a) if q != p)
        outs.append(torch.amin(s, dim=reduce_axes) if reduce_axes else s)
    return torch.stack(outs, dim=1)


def all_factor_messages(tensors: FactorGraphTensors,
                        q_flat: torch.Tensor) -> torch.Tensor:
    """factor→var messages for every bucket, as a flat [E, D] edge array."""
    parts: List[torch.Tensor] = []
    for b in tensors.buckets:
        F, a = b.n_factors, b.arity
        q_bucket = q_flat[b.edge_offset: b.edge_offset + F * a].reshape(
            F, a, -1)
        parts.append(factor_to_var_messages(b, q_bucket).reshape(F * a, -1))
    if not parts:
        return torch.zeros_like(q_flat)
    return torch.cat(parts, dim=0)


def var_beliefs_and_messages(
    tensors: FactorGraphTensors, r_flat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variable beliefs [V, D] and outgoing var→factor messages [E, D].

    beliefs[v] = unary[v] + Σ_{incoming edges} r, the sum in edge order
    (deterministic on the card too);
    q[e] = beliefs[var(e)] − r[e], normalized to zero masked mean."""
    beliefs = tensors.unary_costs + edge_plan(tensors).sum(r_flat)
    vmask = tensors.domain_mask[tensors.edge_var]  # [E, D]
    q = beliefs[tensors.edge_var] - r_flat
    q = (q - masked_mean(q, vmask)) * vmask
    return beliefs, q


def select_values(tensors: FactorGraphTensors,
                  beliefs: torch.Tensor) -> torch.Tensor:
    """Current value choice per variable: masked argmin of beliefs."""
    return masked_argmin(beliefs, tensors.domain_mask)


def maxsum_cycle(
    tensors: FactorGraphTensors,
    q_flat: torch.Tensor,
    r_flat: torch.Tensor,
    damping: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One synchronous MaxSum cycle: every factor and variable
    computation fires once.  Returns (q', r', beliefs, values)."""
    vmask = tensors.domain_mask[tensors.edge_var]
    r_new = all_factor_messages(tensors, q_flat) * vmask
    if damping:
        r_new = damping * r_flat + (1.0 - damping) * r_new
    beliefs, q_new = var_beliefs_and_messages(tensors, r_new)
    values = select_values(tensors, beliefs)
    return q_new, r_new, beliefs, values


def init_messages(tensors: FactorGraphTensors,
                  dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-initialized message arrays (the reference starts by sending
    zero costs)."""
    E, D = tensors.n_edges, tensors.max_domain_size
    z = torch.zeros((E, D), dtype=dtype, device=tensors.device)
    return z, z.clone()
