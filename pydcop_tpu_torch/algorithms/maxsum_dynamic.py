"""Dynamic MaxSum — factor functions and external (read-only) variables can
change while the solver runs.

Equivalent capability to the reference's pydcop/algorithms/maxsum_dynamic.py
(DynamicFunctionFactorComputation :40, FactorWithReadOnlyVariableComputation
:113, DynamicFactorComputation :188, DynamicFactorVariableComputation :352).

A factor change is a **tensor hot-swap**: the affected constraint is
re-materialized into its bucket slot and the solve continues from the
current message state (``run(resume=True)``, a warm restart).  External
variable changes re-slice every constraint that reads them.  On the
all-binary packed layout the swap writes the factor's two ``cost_rows``
columns in place (:func:`~pydcop_tpu_torch.ops.packed_maxsum.swap_factor`),
so the next ``packed_cycles`` call — one cooperative launch of the
hand-written kernel on CUDA — runs on the swapped table; a mixed-arity
layout is re-packed (:func:`~pydcop_tpu_torch.ops.packed_maxsum.solver_layout`),
as the JAX package re-packs.  A swap lands between two calls, never
inside one.  The JAX package's module, ported, with its warm engine
(``build_solver(headroom=)``, ``algorithms/warm.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms.maxsum import MaxSumSolver
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.relations import Constraint
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import PAD_COST, compile_factor_graph
from pydcop_tpu_torch.ops.packed_maxsum import solver_layout, swap_factor

GRAPH_TYPE = "factor_graph"

algo_params = [
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("damping", "float", None, 0.5),
    AlgoParameterDef("noise", "float", None, 0.01),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


class DynamicMaxSumSolver(MaxSumSolver):
    """MaxSum whose factor tensors can be swapped between runs (resume
    with ``run(cycles, resume=True)``)."""

    def __init__(self, dcop, tensors, algo_def, seed: int = 0,
                 use_packed: Optional[bool] = None):
        super().__init__(dcop, tensors, algo_def, seed,
                         use_packed=use_packed)
        self.use_packed = use_packed

    def change_factor_function(self, new_constraint: Constraint):
        """Replace the cost function of an existing factor (same name, same
        scope) — reference: DynamicFactorComputation.change_factor_function."""
        name = new_constraint.name
        if name not in self.tensors.factor_names:
            raise ValueError(f"Unknown factor {name!r}")
        gi = self.tensors.factor_names.index(name)
        ext = {
            ev.name: ev.value for ev in self.dcop.external_variables.values()
        }
        sliced = (
            new_constraint.slice(ext)
            if any(n in ext for n in new_constraint.scope_names)
            else new_constraint
        )
        # swap first: _swap_tensor validates arity/scope, and a rejected
        # change must leave the DCOP untouched (host model and device
        # tensors would otherwise diverge)
        self._swap_tensor(gi, sliced)
        self.dcop.constraints[name] = new_constraint

    def on_external_change(self, ext_name: str, value):
        """Re-slice every factor reading an external variable — reference:
        FactorWithReadOnlyVariableComputation."""
        self.dcop.external_variables[ext_name].value = value
        ext = {
            ev.name: ev.value for ev in self.dcop.external_variables.values()
        }
        for gi, fname in enumerate(self.tensors.factor_names):
            c = self.dcop.constraints[fname]
            if ext_name in c.scope_names:
                self._swap_tensor(gi, c.slice(ext))

    def _swap_tensor(self, gi: int, sliced: Constraint):
        for b in self.tensors.buckets:
            where = np.flatnonzero(b.factor_ids == gi)
            if where.size == 0:
                continue
            k = int(where[0])
            if sliced.arity != b.arity:
                raise ValueError(
                    f"Dynamic factor change must keep the scope: factor "
                    f"{sliced.name!r} has arity {sliced.arity}, bucket "
                    f"expects {b.arity}"
                )
            # align the new tensor's axes to the bucket slot's variable
            # order (the new constraint may list the same scope in a
            # different order, e.g. constraint_from_str sorts by name)
            slot_names = [
                self.tensors.var_names[int(v)] for v in b.var_idx[k]
            ]
            new_names = [d.name for d in sliced.dimensions]
            if set(slot_names) != set(new_names):
                raise ValueError(
                    f"Dynamic factor change must keep the scope: factor "
                    f"{sliced.name!r} covers {new_names}, bucket slot "
                    f"expects {slot_names}"
                )
            t = self.tensors.sign * sliced.to_tensor()
            if new_names != slot_names:
                t = np.transpose(
                    t, [new_names.index(n) for n in slot_names]
                )
            D = self.tensors.max_domain_size
            padded = np.full((D,) * b.arity, PAD_COST, dtype=np.float32)
            padded[tuple(slice(0, s) for s in t.shape)] = t
            # the bucket slot, in place: the generic engine reads it at
            # its next cycle, a re-pack packs it
            b.tensors[k] = torch.as_tensor(padded, device=b.tensors.device)
            if self.packed is not None:
                if self.packed.mixed is None:
                    swap_factor(self.packed, k, padded)
                else:  # mixed-arity layout: re-pack
                    self.packed = solver_layout(self.tensors,
                                                self.use_packed)
            return
        raise ValueError(f"Factor index {gi} not found in any bucket")


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None,
                 seed: int = 0, device: DeviceLike = None,
                 use_packed: Optional[bool] = None, headroom=None):
    """The cold solver with hot-swap semantics.  ``headroom`` (a float
    fraction, e.g. 0.25) builds the WARM engine instead
    (``algorithms/warm.py``): a swap is a fixed-shape write in place,
    with no re-capture of the chunk; the warm engine is the generic one,
    so ``use_packed=True`` does not combine with it."""
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "maxsum_dynamic", parameters_definitions=algo_params
    )
    if headroom is not None:
        from pydcop_tpu_torch.algorithms.warm import build_warm_solver

        if use_packed:
            raise ValueError(
                "maxsum_dynamic headroom= runs the generic warm engine; "
                "use_packed=True does not combine with it")
        return build_warm_solver(
            dcop, algo="maxsum_dynamic", algo_def=algo_def, seed=seed,
            headroom=headroom, device=device,
        )
    tensors = compile_factor_graph(dcop, device=device)
    return DynamicMaxSumSolver(dcop, tensors, algo_def, seed, use_packed)


from pydcop_tpu_torch.algorithms.maxsum import (  # noqa: E402  (re-export)
    communication_load,
    computation_memory,
)
