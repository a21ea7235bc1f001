"""Virtual orchestrator: the host-side control plane.

The port of the JAX package's ``runtime/orchestrator.py`` (the
reference's pydcop/infrastructure/orchestrator.py: Orchestrator :62,
AgentsMgt :531, deploy :203, start_replication :223, run(scenario) :245,
scenario pump :336, agent-removal repair handshake :943-1125) — with the
actor plumbing removed: deploy/run/pause/stop are host control flow over
one tensor solver on ``device`` (cuda unless the caller passes
``device="cpu"``), scenario events mutate the placement metadata, and the
repair handshake becomes build-repair-DCOP → ``solve_result(repair,
"mgm")`` on the same device → update Distribution.

The solver state lives on the device across events (warm restart),
matching the reference's behavior where computations keep their state
when re-hosted from replicas.

A scenario delay is seconds of solver activity: the first phase measures
the device's rate and each delay converts to that many cycles (capped at
``MAX_PHASE_CYCLES``); ``run(cycles=)`` fixes every phase's cycles
instead (the parity tests' form).  ``phase_log`` records each phase's
cycles and wall seconds and ``repair_log`` each repair's size and time
(the port's own bookkeeping; ``end_metrics()`` has the JAX package's
keys).  A fault plan's churn kinds fire at phase boundaries, its
checkpoint kinds on the snapshot directory before an auto-resume; the
device and rank kinds raise
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

from time import perf_counter
from typing import Any, Callable, Dict, List, Optional, Union

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.scenario import Scenario
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.distribution import load_distribution_module
from pydcop_tpu_torch.distribution.objects import Distribution
from pydcop_tpu_torch.graph import load_graph_module
from pydcop_tpu_torch.replication import ReplicaDistribution, place_replicas
from pydcop_tpu_torch.reparation import (
    build_repair_dcop,
    repair_shape,
    solve_repair_dcop,
)
from pydcop_tpu_torch.runtime.events import event_bus, send_fault
from pydcop_tpu_torch.runtime.faults import (
    CHECKPOINT_KINDS,
    CHURN_KINDS,
    FaultPlan,
    apply_checkpoint_faults,
    check_consumed,
)
from pydcop_tpu_torch.runtime.stats import FaultCounters


class VirtualOrchestrator:
    def __init__(
        self,
        dcop: DCOP,
        algo: Union[str, AlgorithmDef],
        distribution: Union[str, Distribution] = "oneagent",
        graph: Optional[str] = None,
        collect_on: str = "value_change",
        period: Optional[float] = None,
        collector: Optional[Callable[[float, Dict], None]] = None,
        seed: int = 0,
        fault_plan: Optional[FaultPlan] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        auto_resume: bool = False,
        warm_repair: bool = False,
        headroom: float = 0.25,
        device: DeviceLike = None,
    ):
        self.dcop = dcop
        self.device = resolve_device(device)
        if fault_plan is not None:
            # churn kinds at phase boundaries, checkpoint kinds before an
            # auto-resume
            check_consumed(fault_plan,
                           CHURN_KINDS + ("kill_agent",) + CHECKPOINT_KINDS,
                           "the orchestrator")
        self.algo_def = (
            algo
            if isinstance(algo, AlgorithmDef)
            else AlgorithmDef.build_with_default_params(
                algo, mode=dcop.objective
            )
        )
        self.algo_module = load_algorithm_module(self.algo_def.algo)
        graph_type = graph or self.algo_module.GRAPH_TYPE
        self.graph_module = load_graph_module(graph_type)
        self.cg = self.graph_module.build_computation_graph(dcop)

        if isinstance(distribution, Distribution):
            self.distribution = distribution
        else:
            dist_module = load_distribution_module(distribution)
            self.distribution = dist_module.distribute(
                self.cg,
                dcop.agents.values(),
                hints=getattr(dcop, "dist_hints", None),
                computation_memory=self.algo_module.computation_memory,
                communication_load=self.algo_module.communication_load,
            )

        # warm repair: scenario mutations and agent churn
        # become fixed-shape buffer writes on a headroom-padded solver
        # instead of cold restarts — runtime/repair.WarmRepairController
        self.warm = None
        if warm_repair:
            from pydcop_tpu_torch.runtime.repair import WarmRepairController

            self.warm = WarmRepairController(
                dcop, self.algo_def.algo, algo_def=self.algo_def,
                seed=seed, headroom=headroom, device=self.device,
            )
            self.solver = self.warm.solver
        else:
            self.solver = self.algo_module.build_solver(
                dcop, self.cg, self.algo_def, seed=seed, device=self.device
            )
        self.replicas: Optional[ReplicaDistribution] = None
        self.seed = seed
        self.status = "INITIAL"
        self.collect_on = collect_on
        self.period = period
        self.collector = collector
        self.run_metrics_log: List[Dict] = []
        self.events_log: List[Dict] = []
        #: one record a solving phase: its cycles, its wall seconds and
        #: the delay it converted (None for an explicit cycle count)
        self.phase_log: List[Dict] = []
        #: one record a repair: orphans, the repair DCOP's size, the
        #: build and solve seconds
        self.repair_log: List[Dict] = []
        self._resume_next = False
        self._pre_pause_status = "INITIAL"
        self._last_result: Optional[SolveResult] = None
        self._cycles_done = 0
        self.start_time: Optional[float] = None
        #: measured device rate (cycles/s) for scenario delay budgets
        self._cycle_rate: Optional[float] = None
        #: the scenario delay the running phase converts (phase_log)
        self._phase_delay: Optional[float] = None
        # -- resilience: fault injection + checkpoint/auto-resume ----------
        self.fault_plan = fault_plan
        self.fault_counters = FaultCounters()
        # kill_agent + the seeded churn kinds (remove/add_agent_burst,
        # edit_factor) all fire at phase boundaries through one pending
        # list — the churn stream and the fault story share a path
        self._pending_agent_kills = list(
            fault_plan.churn_faults()) if fault_plan else []
        self.checkpoint_every = max(1, checkpoint_every)
        self.auto_resume = auto_resume
        self._ckpt_mgr = None
        self._last_ckpt_cycle = 0
        self._resume_done = False
        if checkpoint_dir:
            from pydcop_tpu_torch.runtime.checkpoint import CheckpointManager

            self._ckpt_mgr = CheckpointManager(checkpoint_dir)

    # -- lifecycle (reference: deploy/run/pause/stop broadcasts) ------------

    def deploy_computations(self) -> None:
        # one pass over the placement (has_computation scans it a call)
        hosted = {c for comps in self.distribution.mapping().values()
                  for c in comps}
        missing = [n.name for n in self.cg.nodes if n.name not in hosted]
        if missing:
            raise ValueError(
                f"Distribution does not host computations: {missing}"
            )
        self.status = "DEPLOYED"
        for a in self.distribution.agents:
            for c in self.distribution.computations_hosted(a):
                event_bus.send(f"agents.add_computation.{a}", c)

    def pause_computations(self) -> None:
        """Reference parity (PauseMessage broadcast, orchestrator.py
        :1127): between phases every computation is naturally paused —
        device state is retained and nothing advances until the next
        run; this marks the status and blocks further phases until
        :meth:`resume_computations`."""
        if self.status == "INITIAL":
            raise RuntimeError(
                "nothing to pause: deploy_computations() first"
            )
        if self.status == "STOPPED":
            raise RuntimeError("orchestrator was stopped; cannot pause")
        if self.status == "PAUSED":
            return  # idempotent: keep the original pre-pause status
        self._pre_pause_status = self.status
        self.status = "PAUSED"

    def resume_computations(self) -> None:
        """Reference parity (ResumeMessage broadcast): continue from the
        retained solver state — the next run() warm-restarts from
        exactly where pause left off."""
        if self.status == "PAUSED":
            self.status = self._pre_pause_status
            self._resume_next = True

    def stop_agents(self, timeout: Optional[float] = None) -> None:
        """Reference parity (StopMessage broadcast, orchestrator.py
        :290): no agent threads exist to join; marks the run stopped."""
        self.status = "STOPPED"

    def start_replication(self, k: int) -> ReplicaDistribution:
        """Place k replicas of every computation (reference:
        orchestrator.py:223 → distributed UCS)."""
        self.replicas = place_replicas(
            [n.name for n in self.cg.nodes],
            self.distribution,
            self.dcop.agents.values(),
            k,
            computation_memory=lambda c: self.algo_module.computation_memory(
                self.cg.computation(c)
            ),
        )
        self.status = "REPLICATING" if self.status == "INITIAL" \
            else self.status
        return self.replicas

    # -- solving ------------------------------------------------------------

    def _run_phase(
        self, cycles: Optional[int], timeout: Optional[float], resume: bool
    ) -> SolveResult:
        if self.warm is not None:
            # a repack may have swapped the solver; one PINNED chunk
            # size so every phase reuses the same runner (one capture on
            # the card)
            self.solver = self.warm.solver
        t0 = perf_counter()
        res = self.solver.run(
            cycles=cycles,
            timeout=timeout,
            collect_cycles=self.collect_on == "cycle_change"
            or self.collector is not None,
            resume=resume,
            chunk=self.warm.chunk if self.warm is not None else None,
        )
        if self.warm is not None:
            self.warm.phase_done(res)
        self.phase_log.append({"cycles": res.cycle, "budget": cycles,
                               "s": perf_counter() - t0,
                               "delay": self._phase_delay})
        self._cycles_done += res.cycle
        self._last_result = res
        if self.collector is not None and res.history:
            for h in res.history:
                m = {**res.metrics(), **h, "status": "RUNNING"}
                self.collector(h["time"], m)
                self.run_metrics_log.append(m)
        event_bus.send("computations.cycle.*", self._cycles_done)
        self._fire_due_agent_kills()
        self._maybe_checkpoint()
        return res

    # -- resilience hooks (phase boundaries) --------------------------------

    def _fire_due_agent_kills(self) -> None:
        """Fault-plan churn faults fire at the first phase boundary past
        their cycle — kill_agent (the fault-injection twin of a
        scenario's remove_agent event) plus the seeded churn kinds
        (remove_agent_burst / add_agent_burst / edit_factor), all
        routed through the same replica-repair / warm-repair
        handshake."""
        due = [f for f in self._pending_agent_kills
               if f.cycle <= self._cycles_done]
        self._pending_agent_kills = [
            f for f in self._pending_agent_kills
            if f.cycle > self._cycles_done
        ]
        for f in due:
            self._fire_churn_fault(f)

    def _fire_churn_fault(self, f) -> None:
        seed = self.fault_plan.seed if self.fault_plan else 0
        if f.kind == "kill_agent":
            if f.agent not in self.dcop.agents:
                return  # already removed (scenario or earlier fault)
            targets = [f.agent]
        elif f.kind == "remove_agent_burst":
            import numpy as _np

            alive = sorted(self.dcop.agents)
            rng = _np.random.default_rng(
                (int(seed) * 6151 + int(f.cycle)) % (2 ** 32))
            n = min(f.count or 1, max(0, len(alive) - 1))
            if n <= 0:
                return
            targets = sorted(
                rng.choice(len(alive), size=n, replace=False).tolist()
            )
            targets = [alive[i] for i in targets]
        elif f.kind == "add_agent_burst":
            from pydcop_tpu_torch.dcop.objects import AgentDef

            for i in range(f.count or 1):
                name = f"churn_a{f.cycle}_{i}"
                if name not in self.dcop.agents:
                    self.dcop.agents[name] = AgentDef(name)
                    self.distribution.host_on_agent(name, [])
            self.fault_counters.inc("faults_injected")
            send_fault("injected.add_agent_burst", {
                "count": f.count or 1, "cycle": self._cycles_done,
            })
            self.events_log.append(
                {"fault": "add_agent_burst", "count": f.count or 1,
                 "cycle": self._cycles_done}
            )
            return
        elif f.kind == "edit_factor":
            name = self._edit_factor_fault(f, seed)
            self.fault_counters.inc("faults_injected")
            send_fault("injected.edit_factor", {
                "constraint": name, "cycle": self._cycles_done,
            })
            self.events_log.append(
                {"fault": "edit_factor", "constraint": name,
                 "cycle": self._cycles_done}
            )
            return
        else:  # pragma: no cover - churn_faults() filters the kinds
            return
        self.fault_counters.inc("faults_injected")
        send_fault(f"injected.{f.kind}", {
            "agents": targets, "cycle": self._cycles_done,
        })
        self._agents_removal(targets)
        self.events_log.append(
            {"fault": f.kind, "agents": targets,
             "cycle": self._cycles_done}
        )

    def _edit_factor_fault(self, f, seed: int) -> str:
        """An edit_factor churn fault: warm path mutates in place; the
        cold path requires a hot-swap capable solver (maxsum_dynamic)
        and pays its re-pack — exactly the gap the warm layer closes."""
        if self.warm is not None:
            return self.warm.edit_factor_fault(f, seed)
        from pydcop_tpu_torch.runtime.repair import perturbed_constraint

        if not hasattr(self.solver, "change_factor_function"):
            raise ValueError(
                f"algorithm {self.algo_def.algo!r} cannot hot-swap "
                "factors; use --warm-repair (or maxsum_dynamic) for "
                "edit_factor fault plans"
            )
        names = sorted(self.dcop.constraints)
        name = f.constraint
        if name is None:
            import numpy as _np

            rng = _np.random.default_rng(
                (int(seed) * 7919 + int(f.cycle)) % (2 ** 32))
            name = names[int(rng.integers(len(names)))]
        elif name not in self.dcop.constraints:
            raise ValueError(
                f"edit_factor fault: unknown constraint {name!r}")
        new_c = perturbed_constraint(
            self.dcop.constraints[name], seed=seed + f.cycle)
        self.solver.change_factor_function(new_c)
        return name

    def _maybe_checkpoint(self) -> None:
        if self._ckpt_mgr is None:
            return
        if self._cycles_done - self._last_ckpt_cycle < self.checkpoint_every:
            return
        if getattr(self.solver, "_last_state", None) is None:
            return  # host-driven solver without retained device state
        try:
            self._ckpt_mgr.save_solver(self.solver, self._cycles_done)
        except ValueError:
            return
        self._last_ckpt_cycle = self._cycles_done
        self.fault_counters.inc("checkpoints_saved")

    def _maybe_resume(self) -> None:
        """Auto-resume: warm-start from the newest valid snapshot once,
        before the first phase (corrupt snapshots are skipped by the
        manager with a warning — one bad file must not cost the run)."""
        if not (self.auto_resume and self._ckpt_mgr) or self._resume_done:
            return
        self._resume_done = True
        if self.fault_plan is not None:
            # the checkpoint kinds damage the newest snapshot first; the
            # manager must skip it and resume from the one before
            for _path in apply_checkpoint_faults(
                    self.fault_plan, self._ckpt_mgr.directory, attempt=0):
                self.fault_counters.inc("faults_injected")
        n_snaps = len(self._ckpt_mgr.snapshots())
        meta = self._ckpt_mgr.load_latest_into(self.solver)
        if meta is None:
            if n_snaps:
                self.fault_counters.inc("checkpoints_rejected", n_snaps)
            return
        self._resume_next = True
        cycle = int(meta.get("cycle", 0) or 0)
        self._cycles_done = cycle
        self._last_ckpt_cycle = cycle
        self.fault_counters.inc("resumes")
        send_fault("recovered.resume", {"cycle": cycle})
        self.events_log.append({"resumed_from": cycle})

    def run(
        self,
        scenario: Optional[Scenario] = None,
        timeout: Optional[float] = None,
        cycles: Optional[int] = None,
    ) -> SolveResult:
        """Run to completion; with a scenario, interleave solving phases
        with the event stream (reference: orchestrator.py:245,336)."""
        if self.status == "PAUSED":
            raise RuntimeError(
                "orchestrator is paused; call resume_computations() first"
            )
        if self.status == "STOPPED":
            raise RuntimeError(
                "orchestrator was stopped; create a new one to run again"
            )
        self.start_time = perf_counter()
        if self.status == "INITIAL":
            self.deploy_computations()
        self.status = "RUNNING"
        self._maybe_resume()
        resume = getattr(self, "_resume_next", False)
        self._resume_next = False

        if scenario is None or not len(scenario):
            res = self._run_plain(cycles, timeout, resume=resume)
            self.status = res.status
            return self._finalize(res)
        res: Optional[SolveResult] = None
        for event in scenario:
            if timeout is not None and \
                    perf_counter() - self.start_time > timeout:
                break
            if event.is_delay:
                # a delay = let the system run for that much wall time.
                # Scenario delays are written in seconds of solver
                # activity (reference: the actor system simply keeps
                # running, orchestrator.py:336); here the device rate is
                # measured on the first phase and each delay converts to
                # a cycle budget, so `delay: 2` runs ~2s worth of cycles
                # instead of an arbitrary fixed count.  The effective
                # delay also bounds the phase as a timeout (safety when
                # the rate estimate is stale) and is clamped to the
                # run-level timeout's remaining budget.
                eff = event.delay
                if timeout is not None:
                    remaining = timeout - (
                        perf_counter() - self.start_time
                    )
                    eff = max(0.0, min(eff, remaining))
                if eff > 0:
                    self._phase_delay = eff
                    res = self._delay_phase(eff, cycles, resume)
                    self._phase_delay = None
                    resume = True
            else:
                for action in event.actions:
                    self._apply_action(action)
                self.events_log.append(
                    {"id": event.id,
                     "actions": [a.type for a in event.actions]}
                )
        # final phase to (re)converge after the last event: the explicit
        # per-phase cycle count unbounded (caller's contract), else the
        # budget of a 1-second delay clamped to the remaining run timeout
        if cycles is not None:
            res = self._run_phase(cycles, timeout=None, resume=resume)
        else:
            final_delay = 1.0
            if timeout is not None:
                remaining = timeout - (perf_counter() - self.start_time)
                final_delay = min(1.0, remaining)
            if final_delay > 0 or res is None:
                self._phase_delay = max(final_delay, 0.05)
                res = self._delay_phase(self._phase_delay, None, resume)
                self._phase_delay = None
        if timeout is not None and \
                perf_counter() - self.start_time > timeout:
            res.status = "TIMEOUT"
        self.status = res.status
        return self._finalize(res)

    def _run_plain(self, cycles: Optional[int], timeout: Optional[float],
                   resume: bool) -> SolveResult:
        """A scenario-less run; with an explicit cycle budget the run is
        split at fault-plan agent-kill cycles (so each kill fires
        MID-run and the solve re-converges after the repair) and at
        checkpoint boundaries (so snapshots land every *k* cycles, not
        only at the end).  With no explicit budget the solver runs its
        default phase unbroken."""
        target = None if cycles is None else self._cycles_done + cycles
        res = None
        while True:
            n = cycles
            stops = [f.cycle for f in self._pending_agent_kills
                     if f.cycle > self._cycles_done]
            if self._ckpt_mgr is not None:
                stops.append(self._cycles_done + self.checkpoint_every)
            if target is not None:
                stop = min(stops + [target])
                n = stop - self._cycles_done
            res = self._run_phase(n, timeout, resume=resume)
            resume = True
            if target is None or self._cycles_done >= target \
                    or res.status == "TIMEOUT":
                return res

    #: cycles of the rate-calibration phase (first delay event) and the
    #: upper bound on any single delay phase's budget
    CALIBRATION_CYCLES = 20
    MAX_PHASE_CYCLES = 200_000

    def _delay_phase(self, delay: float, cycles: Optional[int],
                     resume: bool) -> SolveResult:
        """One scenario solving phase worth ``delay`` seconds.

        With an explicit per-phase ``cycles`` the caller's count wins
        (back-compat / deterministic tests), bounded by the delay.
        Otherwise the first phase runs CALIBRATION_CYCLES to measure the
        device rate, then every delay converts to ``delay * rate``
        cycles; the rate is refreshed from each phase so drift (bigger
        tables after repair, metric collection) is tracked.
        """
        if cycles is not None:
            return self._normalize(
                self._run_phase(cycles, timeout=delay, resume=resume)
            )
        if self._cycle_rate is not None:
            res = self._run_phase(
                self._budget(delay), timeout=delay, resume=resume
            )
            self._update_rate(res)
            return self._normalize(res)
        # cold start: the calibration phase's wall time includes the
        # packing, the first kernel calls and a capture, so its rate
        # underestimates the device.  Top up against the REMAINING wall
        # budget of this delay (so one event never runs ~2x its
        # duration) until it is consumed; the warm top-up rates replace
        # the skewed first estimate.
        t0 = perf_counter()
        res = self._run_phase(
            self.CALIBRATION_CYCLES, timeout=delay, resume=resume
        )
        self._update_rate(res)
        for _ in range(4):
            remaining = delay - (perf_counter() - t0)
            if remaining <= max(0.05 * delay, 1e-3):
                break
            res = self._run_phase(
                self._budget(remaining), timeout=remaining, resume=True
            )
            self._update_rate(res)
        return self._normalize(res)

    @staticmethod
    def _normalize(res: SolveResult) -> SolveResult:
        """A delay phase cut by its wall budget behaved exactly as asked
        ("run for that much time") — that is not a run-level TIMEOUT.
        run() re-applies TIMEOUT when the RUN deadline is exhausted."""
        if res.status == "TIMEOUT":
            res.status = "FINISHED"
        return res

    def _budget(self, delay: float) -> int:
        return max(1, min(
            self.MAX_PHASE_CYCLES, int(round(delay * self._cycle_rate))
        ))

    def _update_rate(self, res: SolveResult) -> None:
        if res.cycle > 0 and res.time > 0:
            self._cycle_rate = res.cycle / res.time

    def _finalize(self, res: SolveResult) -> SolveResult:
        res.cycle = self._cycles_done
        res.time = perf_counter() - self.start_time
        if self._ckpt_mgr is not None \
                and self._cycles_done > self._last_ckpt_cycle:
            # final snapshot: a new orchestrator can auto-resume from
            # exactly where this run ended
            self._last_ckpt_cycle = self._cycles_done
            if getattr(self.solver, "_last_state", None) is not None:
                self._ckpt_mgr.save_solver(self.solver, self._cycles_done)
                self.fault_counters.inc("checkpoints_saved")
        return res

    # -- scenario actions ---------------------------------------------------

    def _apply_action(self, action) -> None:
        if action.type == "remove_agent":
            self._agents_removal([action.parameters["agent"]])
        elif action.type == "add_agent":
            # new agents become available hosts (computations stay put until
            # a repair needs them)
            from pydcop_tpu_torch.dcop.objects import AgentDef

            name = action.parameters["agent"]
            if name not in self.dcop.agents:
                self.dcop.agents[name] = AgentDef(name)
            self.distribution.host_on_agent(name, [])
        elif action.type == "set_external":
            if self.warm is not None:
                self.warm.external_change(
                    action.parameters["variable"],
                    action.parameters["value"],
                )
                return
            ev = self.dcop.external_variables[
                action.parameters["variable"]
            ]
            ev.value = action.parameters["value"]
            if hasattr(self.solver, "on_external_change"):
                self.solver.on_external_change(ev.name, ev.value)
        elif action.type in ("add_constraint", "remove_constraint",
                             "add_variable", "remove_variable"):
            # structural mutations: only the warm-repair
            # layer can rewire a compiled problem at a fixed shape
            if self.warm is None:
                raise ValueError(
                    f"scenario action {action.type!r} needs the "
                    "warm-repair layer; run with warm_repair=True "
                    "(CLI: --warm-repair)"
                )
            self._apply_structural(action)
        elif action.type == "change_factor":
            # factor hot-swap mid-scenario (∅→+ over the reference's
            # add/remove_agent events; pairs with maxsum_dynamic's
            # change_factor_function, ref maxsum_dynamic.py:188)
            from pydcop_tpu_torch.dcop.relations import constraint_from_str

            if self.warm is None and not hasattr(
                    self.solver, "change_factor_function"):
                raise ValueError(
                    f"algorithm {self.algo_def.algo!r} cannot hot-swap "
                    "factors; use maxsum_dynamic (or --warm-repair) "
                    "for change_factor scenarios"
                )
            name = action.parameters["constraint"]
            if name not in self.dcop.constraints:
                raise ValueError(
                    f"change_factor: unknown constraint {name!r}"
                )
            old = self.dcop.constraints[name]
            expr = action.parameters.get("expression")
            if expr is None:
                # seeded-perturbation form (dcop/scenario.churn_scenario
                # and the edit_factor fault kind share the jitter)
                from pydcop_tpu_torch.runtime.repair import (
                    perturbed_constraint,
                )

                new_c = perturbed_constraint(
                    old, seed=int(action.parameters.get("seed", 0))
                )
            else:
                scope = list(old.dimensions) + [
                    ev for ev in self.dcop.external_variables.values()
                ]
                new_c = constraint_from_str(name, expr, scope)
            if self.warm is not None:
                self.warm.edit_factor(new_c)
            else:
                self.solver.change_factor_function(new_c)
        else:
            raise ValueError(f"Unknown scenario action {action.type!r}")

    def _apply_structural(self, action) -> None:
        """Warm-only structural scenario actions: grow/shrink the live
        problem inside the reserved headroom (zero retraces; one
        counted repack when exhausted)."""
        from pydcop_tpu_torch.dcop.relations import constraint_from_str

        p = action.parameters
        if action.type == "add_constraint":
            scope = [self.dcop.variables[n] for n in p["scope"]] + [
                ev for ev in self.dcop.external_variables.values()
            ]
            new_c = constraint_from_str(
                p["constraint"], p["expression"], scope
            )
            self.warm.add_constraint(new_c)
        elif action.type == "remove_constraint":
            self.warm.remove_constraint(p["constraint"])
        elif action.type == "add_variable":
            from pydcop_tpu_torch.dcop.objects import Variable

            domain = self.dcop.domains[p["domain"]]
            self.warm.add_variable(Variable(p["variable"], domain))
        else:  # remove_variable
            self.warm.remove_variable(p["variable"])

    def _agents_removal(self, removed: List[str]) -> None:
        """Orphaned computations are re-hosted on their replicas via a
        repair DCOP solved with MGM (reference: orchestrator.py:943-1125 +
        agents.py:1044-1355)."""
        orphans: List[str] = []
        for a in removed:
            orphans.extend(self.distribution.remove_agent(a))
            self.dcop.agents.pop(a, None)
            event_bus.send(f"agents.rem_agent.{a}", a)
        if not orphans:
            return
        surviving = {a.name: a for a in self.dcop.agents.values()}
        candidates: Dict[str, List[str]] = {}
        for c in orphans:
            if self.replicas is not None:
                cand = [
                    a for a in self.replicas.replicas(c) if a in surviving
                ]
            else:
                cand = []
            # fall back to every surviving agent when no replica survives
            candidates[c] = cand or sorted(surviving)
        neighbors = {
            c: list(self.cg.computation(c).neighbors) for c in orphans
        }
        t0 = perf_counter()
        repair, vars_by_comp = build_repair_dcop(
            orphans,
            candidates,
            surviving,
            self.distribution,
            computation_memory=lambda c: self.algo_module.computation_memory(
                self.cg.computation(c)
            ),
            communication_load=lambda c, t: self.algo_module.
            communication_load(self.cg.computation(c), t),
            neighbors=neighbors,
        )
        t1 = perf_counter()
        placement = solve_repair_dcop(repair, vars_by_comp, seed=self.seed,
                                      device=self.device)
        self.repair_log.append({
            "orphans": len(orphans), **repair_shape(repair),
            "build_s": t1 - t0, "solve_s": perf_counter() - t1,
        })
        for comp, agent in placement.items():
            self.distribution.host_on_agent(agent, [comp])
        if self.warm is not None:
            # warm re-seat: reparation picked the hosts; the solver
            # keeps its device state and only re-converges — time it
            self.warm.mark_recovery()
        self.events_log.append({"repaired": placement})
        self.fault_counters.inc("repairs")
        send_fault("recovered.repair", {
            "orphans": orphans, "placement": placement,
        })

    # -- metrics ------------------------------------------------------------

    def end_metrics(self) -> Dict[str, Any]:
        if self._last_result is None:
            return {"status": self.status}
        m = self._last_result.metrics()
        m["status"] = self.status
        m["distribution"] = self.distribution.mapping()
        if self.replicas is not None:
            m["replicas"] = self.replicas.mapping()
        m["events"] = self.events_log
        m["resilience"] = self.fault_counters.as_dict()
        if self.warm is not None:
            m["repair"] = self.warm.counters.as_dict()
        return m

