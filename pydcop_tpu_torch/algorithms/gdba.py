"""GDBA — Generalized Distributed Breakout for DCOPs.

Equivalent capability to the reference's pydcop/algorithms/gdba.py
(GdbaComputation :186, modes :177-182): breakout generalised to weighted
problems with three knobs (Okamoto, Zivan & Nahon):

* ``modifier``: A (additive, effective = base + W) or M (multiplicative,
  effective = base × W);
* ``violation``: when a constraint is "violated" under the current
  assignment — NZ (cost non-zero), NM (cost non-minimal), MX (cost
  maximal);
* ``increase_mode``: which entries of the violated constraint's cost
  tensor get their weight bumped — E (the current entry), R (the "row":
  every entry that keeps the *other* variables at their current values),
  C (the "column": every entry keeping one variable's value), T (the
  whole tensor).

Tensor form, as the JAX package's ``algorithms/gdba.py``: W has exactly
the shape of the stacked constraint tensors, so the modifier is one
elementwise op and every increase mode is a masked add.  It runs the
generic engine on every device (plain PyTorch on the card, as the JAX
package runs it in XLA) and takes no ``use_packed``.  The initial values
are the local-search family's
(:func:`~pydcop_tpu_torch.algorithms._local_search.random_valid_values`
at ``seed + 17``), the port's stated deviation from ``jax.random``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    BreakoutSolver,
    gains_and_best,
    neighborhood_winner,
    quiet_neighborhood,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    bucket_index,
    compile_constraint_graph,
    local_cost_tables,
)

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("modifier", "str", ["A", "M"], "A"),
    AlgoParameterDef("violation", "str", ["NZ", "NM", "MX"], "NZ"),
    AlgoParameterDef("increase_mode", "str", ["E", "R", "C", "T"], "E"),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


def factor_min_max(t: torch.Tensor, arity: int):
    """(fmin, fmax) per factor of one stacked cost tensor, ignoring
    padding (for the NM / MX violation modes)."""
    valid = t < PAD_COST / 2
    dims = tuple(range(1, arity + 1))
    fmin = torch.amin(torch.where(valid, t, PAD_COST), dim=dims)
    fmax = torch.amax(torch.where(valid, t, -PAD_COST), dim=dims)
    return fmin, fmax


def effective_tensor(t: torch.Tensor, w: torch.Tensor,
                     modifier: str) -> torch.Tensor:
    """base ∘ weight with the A/M modifier; padding stays PAD_COST."""
    e = t + w if modifier == "A" else t * w
    return torch.where(t >= PAD_COST / 2, PAD_COST, e)


def violation_mask(base_cur: torch.Tensor, fmin: torch.Tensor,
                   fmax: torch.Tensor, violation: str) -> torch.Tensor:
    """Per-factor violation test under the current assignment
    (NZ: non-zero, NM: non-minimal, MX: maximal)."""
    eps = 1e-9
    if violation == "NZ":
        viol = base_cur > eps
    elif violation == "NM":
        viol = base_cur > fmin + eps
    else:  # MX
        viol = base_cur >= fmax - eps
    return viol & (base_cur < PAD_COST / 2)


def increase_mask(t: torch.Tensor, vals: torch.Tensor,
                  increase_mode: str) -> torch.Tensor:
    """Which entries of each factor tensor get their weight bumped
    (E: current entry, R: one-deviation slices, C: own-value slices,
    T: whole tensor).  ``vals`` is [F, arity] current value indices."""
    F, a = vals.shape
    onehots = [torch.nn.functional.one_hot(
        vals[:, p].long(), t.shape[1 + p]).to(torch.float32)
        for p in range(a)]

    def bcast(m, p):
        shape = [F] + [1] * a
        shape[1 + p] = t.shape[1 + p]
        return m.reshape(shape)

    if increase_mode == "E":
        mask = torch.ones_like(t)
        for p in range(a):
            mask = mask * bcast(onehots[p], p)
    elif increase_mode == "R":
        # entries reachable by deviating ONE variable: for each p, the
        # other axes fixed at their current values
        mask = torch.zeros_like(t)
        for p in range(a):
            m = torch.ones_like(t)
            for q in range(a):
                if q != p:
                    m = m * bcast(onehots[q], q)
            mask = torch.maximum(mask, m)
    elif increase_mode == "C":
        # entries keeping this factor's current value on ONE axis
        mask = torch.zeros_like(t)
        for p in range(a):
            mask = torch.maximum(mask, bcast(onehots[p], p))
    else:  # T: the whole tensor
        mask = torch.ones_like(t)
    return mask


def gdba_cycle(tensors, x, ws, fmins, fmaxs, modifier, violation,
               increase_mode):
    """One GDBA cycle as a function of the compiled graph, the current
    assignment ``x`` and the breakout weights ``ws`` (one tensor per
    arity bucket); ``fmins``/``fmaxs`` are the per-bucket masked factor
    min/max of the base costs.  Returns (x', ws')."""
    t = tensors
    dev = x.device
    eff = [effective_tensor(b.tensors, w, modifier)
           for b, w in zip(t.buckets, ws)]
    tables = local_cost_tables(t, x, bucket_tensors=eff)
    _, best_val, gain, _ = gains_and_best(t, x, tables=tables)
    move = neighborhood_winner(t, gain)
    x2 = torch.where(move, best_val, x).to(torch.int32)
    stuck = quiet_neighborhood(t, gain)

    ws2 = []
    xl = x.long()
    for bi, b in enumerate(t.buckets):
        w = ws[bi]
        if b.n_factors == 0:
            ws2.append(w)
            continue
        F, a = b.n_factors, b.arity
        var_idx, _ = bucket_index(b, dev)
        vals = xl[var_idx]  # [F, a]
        idx = tuple(vals[:, p] for p in range(a))
        base_cur = b.tensors[(torch.arange(F, device=dev),) + idx]  # [F]
        viol = violation_mask(base_cur, fmins[bi], fmaxs[bi], violation)
        do_inc = (viol & stuck[var_idx].any(dim=1)).to(torch.float32)
        mask = increase_mask(b.tensors, vals, increase_mode)
        ws2.append(w + mask * do_inc.reshape([F] + [1] * a))
    return x2, tuple(ws2)


class GdbaSolver(BreakoutSolver):
    """State = (x [V] int32, (W_b per bucket, the shape of its cost
    tensor))."""

    def __init__(self, dcop, tensors, algo_def, seed=0):
        super().__init__(dcop, tensors, algo_def, seed)
        self.modifier = self.params.get("modifier", "A")
        self.violation = self.params.get("violation", "NZ")
        self.increase_mode = self.params.get("increase_mode", "E")
        # masked per-factor min/max of the base costs (NM / MX)
        self._fmin: List[torch.Tensor] = []
        self._fmax: List[torch.Tensor] = []
        for b in tensors.buckets:
            fmin, fmax = factor_min_max(b.tensors, b.arity)
            self._fmin.append(fmin)
            self._fmax.append(fmax)

    def initial_weights(self):
        init = 0.0 if self.modifier == "A" else 1.0
        return tuple(torch.full(b.tensors.shape, init, dtype=torch.float32,
                                device=self.device)
                     for b in self.tensors.buckets)

    def cycle(self, state):
        x, ws = state
        return gdba_cycle(self.tensors, x, ws, self._fmin, self._fmax,
                          self.modifier, self.violation, self.increase_mode)

    def state_from_numpy(self, x, ws: Sequence):
        """A state from x [V] and one weight array per bucket as numpy
        arrays (the JAX solver's layout), on the solver's device."""
        return (torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                device=self.device),
                tuple(torch.as_tensor(np.asarray(w), dtype=torch.float32,
                                      device=self.device) for w in ws))

    @staticmethod
    def state_to_numpy(state):
        """(x [V] int32, [W_b float32 per bucket]) as numpy arrays."""
        x, ws = state
        return x.cpu().numpy(), [w.cpu().numpy() for w in ws]


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None) -> GdbaSolver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "gdba", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return GdbaSolver(dcop, tensors, algo_def, seed)


def computation_memory(node) -> float:
    return float(len(node.neighbors))


def communication_load(node, target: str = None) -> float:
    return 1.0
