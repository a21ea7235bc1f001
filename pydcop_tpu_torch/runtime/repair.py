"""Warm-repair control plane: one mechanism for agent churn and live
mutations.

The port of the JAX package's ``runtime/repair.py``.  The controller
owns a warm solver (``algorithms/warm.py``) and turns every mutation —
a scenario action (``change_factor``, ``set_external``,
``add_constraint`` / ``remove_constraint`` / ``add_variable`` /
``remove_variable``), a seeded ``edit_factor`` churn fault, a memo
variant's factor diff — into fixed-shape writes in place on the solver's
operands: no re-capture of its chunk.  When the seeded headroom runs out
it performs exactly ONE counted repack that re-reserves headroom
(``repair.repack`` event, one more capture — never an exception
mid-run).

The controller owns the :class:`~pydcop_tpu_torch.runtime.stats.
RepairCounters` scorecard (``SolveResult.metrics()["repair"]``,
forwarded as ``repair.*`` events), including the capture audit: every
chunk-runner capture (``trace_count()``) beyond the first phase's is
charged to ``repair_retraces`` — 0 while headroom holds.  The agent-churn
half of the JAX orchestrator (``reparation/``, the fault plan's churn
kinds) waits for ROADMAP A6/A11; :meth:`edit_factor_fault` takes any
object with the fault's ``cycle`` and ``constraint`` fields.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.algorithms.warm import (
    WARM_ALGOS,
    build_warm_solver,
    repack_solver,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.headroom import (
    AddFactor,
    AddVariable,
    EditFactor,
    HeadroomExhausted,
    RemoveFactor,
    RemoveVariable,
)
from pydcop_tpu_torch.runtime.events import send_repair
from pydcop_tpu_torch.runtime.stats import RepairCounters


def perturbed_constraint(c, seed: int, scale: float = 0.25):
    """A seeded perturbation of a constraint's cost table (the
    ``edit_factor`` churn fault): same scope, every entry jittered by
    uniform(-scale, scale) · (1 + |table|) — deterministic per (seed,
    constraint name) within a process (the name enters through Python's
    ``hash``, as in the JAX package), so the same plan replays the same
    mutation."""
    t = np.asarray(c.to_tensor(), dtype=np.float64)
    rng = np.random.default_rng(
        (int(seed) * 1_000_003 + hash(c.name) % 1_000_003) % (2 ** 32)
    )
    jitter = rng.uniform(-scale, scale, size=t.shape) * (1.0 + np.abs(t))
    return NAryMatrixRelation(list(c.dimensions), t + jitter, name=c.name)


class WarmRepairController:
    """Owns a warm solver and turns repairs/mutations into fixed-shape
    writes; repacks once when headroom is exhausted."""

    def __init__(
        self,
        dcop: DCOP,
        algo,
        algo_def: Optional[AlgorithmDef] = None,
        seed: int = 0,
        headroom: float = 0.25,
        min_free: int = 4,
        chunk: int = 16,
        tensors=None,
        device: DeviceLike = None,
    ):
        algo_name = algo if isinstance(algo, str) else algo.algo
        if algo_name not in WARM_ALGOS:
            raise ValueError(
                f"--warm-repair supports {WARM_ALGOS}; {algo_name!r} "
                f"falls back to the cold repack path (drop the flag)"
            )
        self.dcop = dcop
        self.seed = seed
        self.headroom = headroom
        self.min_free = min_free
        #: ONE chunk size for every phase: the fixed-shape runner is
        #: built (captured on the card) once and every later phase (any
        #: cycle budget, any deadline shrink) reuses it
        self.chunk = int(chunk)
        self.counters = RepairCounters()
        self.solver = build_warm_solver(
            dcop, algo=algo_name, algo_def=algo_def, seed=seed,
            headroom=headroom, min_free=min_free, tensors=tensors,
            device=device,
        )
        self.solver.repair_counters = self.counters
        #: captures of retired (pre-repack) solvers
        self._trace_base = 0
        #: capture floor after the first phase — anything above it is
        #: charged to repair_retraces
        self._baseline: Optional[int] = None
        self._recover_t0: Optional[float] = None

    # -- capture audit -------------------------------------------------------

    def total_traces(self) -> int:
        return self._trace_base + self.solver.trace_count()

    def phase_done(self, res: SolveResult) -> None:
        """Called after every solving phase: settles the capture audit
        and, when a mutation was pending, records its time-to-recover."""
        cur = self.total_traces()
        if self._baseline is None:
            self._baseline = cur
        elif cur > self._baseline:
            self.counters.inc("repair_retraces", cur - self._baseline)
            self._baseline = cur
        if self._recover_t0 is not None:
            dt = perf_counter() - self._recover_t0
            self._recover_t0 = None
            self.counters.inc("time_to_recover_s", dt)
            send_repair("recovered", {
                "time_to_recover_s": round(dt, 6),
                "cycle": res.cycle,
                "cost": res.cost,
            })

    def mark_recovery(self) -> None:
        """Start the time-to-recover clock without a tensor mutation —
        the agent-churn repair handshake (re-hosting keeps the device
        state, but the run still re-converges)."""
        self._recover_t0 = perf_counter()

    # -- mutation entry points ----------------------------------------------

    def _claims_of(self, muts: Sequence) -> Dict[str, int]:
        claimed = sum(
            1 for m in muts if isinstance(m, (AddFactor, AddVariable))
        )
        released = sum(
            1 for m in muts if isinstance(m, (RemoveFactor, RemoveVariable))
        )
        return {"claimed": claimed, "released": released}

    def apply(self, muts: Sequence, kind: str, target: str) -> None:
        """Apply mutations warm; on exhaustion repack ONCE and retry —
        callers never see HeadroomExhausted (unless the fresh capacity
        cannot hold them either)."""
        self._recover_t0 = perf_counter()
        try:
            self.solver.apply_mutations(muts)
        except HeadroomExhausted as e:
            self.repack(str(e))
            self.solver.apply_mutations(muts)
        c = self._claims_of(muts)
        self.counters.inc("mutations_applied", len(muts))
        if c["claimed"]:
            self.counters.inc("headroom_claimed", c["claimed"])
        if c["released"]:
            self.counters.inc("headroom_released", c["released"])
        send_repair("mutation.applied", {
            "kind": kind,
            "target": target,
            "mutations": len(muts),
            "free_var_slots": self.solver.layout.n_free_var_slots(),
        })

    def repack(self, reason: str) -> None:
        """The graceful-degradation path: one repack that re-reserves
        headroom, state carried by name (algorithms/warm.repack_solver).
        Costs exactly one more capture — counted, evented, never an
        exception mid-run."""
        self._trace_base += self.solver.trace_count()
        self.solver = repack_solver(
            self.solver, headroom=self.headroom, min_free=self.min_free,
        )
        self.counters.inc("headroom_exhausted_repacks")
        send_repair("repack", {
            "reason": reason,
            "capacity_vars": self.solver.layout.n_vars_cap,
        })

    # -- scenario-action translation -----------------------------------------

    def edit_factor(self, new_constraint) -> None:
        name = new_constraint.name
        if name not in self.dcop.constraints:
            raise ValueError(f"change_factor: unknown constraint {name!r}")
        ext = {
            ev.name: ev.value
            for ev in self.dcop.external_variables.values()
        }
        sliced = (
            new_constraint.slice(ext)
            if any(n in ext for n in new_constraint.scope_names)
            else new_constraint
        )
        self.apply([EditFactor(sliced)], "edit_factor", name)
        self.dcop.constraints[name] = new_constraint

    def add_constraint(self, constraint) -> None:
        if constraint.name in self.dcop.constraints:
            raise ValueError(
                f"add_constraint: {constraint.name!r} already exists"
            )
        self.apply([AddFactor(constraint)], "add_factor", constraint.name)
        self.dcop.constraints[constraint.name] = constraint

    def remove_constraint(self, name: str) -> None:
        if name not in self.dcop.constraints:
            raise ValueError(f"remove_constraint: unknown {name!r}")
        self.apply([RemoveFactor(name)], "remove_factor", name)
        del self.dcop.constraints[name]

    def add_variable(self, variable) -> None:
        if variable.name in self.dcop.variables:
            raise ValueError(
                f"add_variable: {variable.name!r} already exists"
            )
        self.apply([AddVariable(variable)], "add_variable", variable.name)
        self.dcop.add_variable(variable)

    def remove_variable(self, name: str) -> None:
        if name not in self.dcop.variables:
            raise ValueError(f"remove_variable: unknown {name!r}")
        incident = [
            c.name for c in self.dcop.constraints.values()
            if name in c.scope_names
        ]
        muts: List = [RemoveFactor(c) for c in incident]
        muts.append(RemoveVariable(name))
        self.apply(muts, "remove_variable", name)
        for c in incident:
            del self.dcop.constraints[c]
        del self.dcop.variables[name]

    def external_change(self, ext_name: str, value) -> None:
        self.dcop.external_variables[ext_name].value = value
        ext = {
            ev.name: ev.value
            for ev in self.dcop.external_variables.values()
        }
        muts = [
            EditFactor(c.slice(ext))
            for n, c in self.dcop.constraints.items()
            if ext_name in c.scope_names
            and self.solver.layout.has_factor(n)
        ]
        if muts:
            self.apply(muts, "set_external", ext_name)

    # -- churn faults --------------------------------------------------------

    def edit_factor_fault(self, fault, plan_seed: int) -> str:
        """Fire one ``edit_factor`` churn fault: seeded constraint
        choice (unless named) + seeded table perturbation."""
        names = sorted(self.dcop.constraints)
        if not names:
            raise ValueError("edit_factor fault: DCOP has no constraints")
        if fault.constraint is not None:
            if fault.constraint not in self.dcop.constraints:
                raise ValueError(
                    f"edit_factor fault: unknown constraint "
                    f"{fault.constraint!r}"
                )
            name = fault.constraint
        else:
            rng = np.random.default_rng(
                (int(plan_seed) * 7919 + int(fault.cycle)) % (2 ** 32)
            )
            name = names[int(rng.integers(len(names)))]
        new_c = perturbed_constraint(
            self.dcop.constraints[name],
            seed=plan_seed + fault.cycle,
        )
        self.edit_factor(new_c)
        return name
