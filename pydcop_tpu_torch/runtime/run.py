"""One-call solve API.

Equivalent capability to the reference's pydcop/infrastructure/run.py
(solve :52, run_local_thread_dcop :145, run_local_process_dcop :225)
without the thread/process agent plumbing: build graph → compile to
tensors on the device → run synchronous rounds.

* A ``Distribution`` object (e.g. loaded from a distribution YAML)
  drives a sharded solve: the factors go to the shards of their host
  agents (:func:`_solve_under_placement`, maxsum and amaxsum; with
  ``collect_cycles`` one cycle a dispatch and its cost, as in the JAX
  package, but stale's boundary halo goes on across the dispatches,
  where the JAX package restarts it at every one).  A distribution strategy given by NAME (``oneagent``,
  ``adhoc``) is computed and validated, as in the JAX package: a
  single-device solve needs no placement to run.
* ``headroom`` builds the warm-repair engine (``algorithms/warm.py``).
* ``checkpoint_dir`` runs the solve in chunks of ``checkpoint_every``
  cycles with a rotating snapshot after each (:func:`_run_with_checkpoints`,
  ``runtime/checkpoint.py``); ``resume`` warm-starts from the newest
  valid snapshot.  A fault plan's checkpoint kinds fire on that
  directory just before the resume reads it.
* :func:`run_local_thread_dcop` returns a deployed
  :class:`~pydcop_tpu_torch.runtime.orchestrator.VirtualOrchestrator`.

Refused with :class:`~pydcop_tpu_torch.errors.NotPortedError`: the
elastic path (``elastic=`` and the device-tier fault kinds), the rank
fault kinds and :func:`run_local_process_dcop` (the process runtime).
"""
from __future__ import annotations

import logging
from time import perf_counter
from typing import Any, Dict, Optional, Union

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.graph import load_graph_module


def _build_algo_def(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    algo_params: Optional[Dict[str, Any]],
) -> AlgorithmDef:
    if isinstance(algo, AlgorithmDef):
        return algo
    return AlgorithmDef.build_with_default_params(
        algo, algo_params or {}, mode=dcop.objective
    )


def solve_result(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    distribution: Optional[Any] = None,
    graph: Optional[str] = None,
    timeout: Optional[float] = None,
    cycles: Optional[int] = None,
    algo_params: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    device: DeviceLike = None,
    collect_cycles: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    pipeline: bool = False,
    chunk: Optional[int] = None,
    headroom: Optional[float] = None,
    fault_plan=None,
    elastic: Optional[Dict[str, Any]] = None,
    shard_overlap: Optional[str] = None,
    shard_boundary_threshold: float = 0.5,
    n_shards: Optional[int] = None,
) -> SolveResult:
    """Solve a DCOP on ``device`` (cuda unless the caller passes
    ``device="cpu"``) and return the full result + metrics.

    ``cycles`` runs exactly that many cycles; otherwise the run stops when
    the solver is stable, at the algorithm's ``stop_cycle`` parameter, or
    at ``timeout``.

    ``collect_cycles=True`` keeps each cycle's cost in the result's
    ``history`` (the anytime cost curve of ``solve --run_metrics``; for
    the exact search, each chunk's bound sandwich).  ``chunk`` overrides
    the harness's chunk policy and ``pipeline=True`` turns on its
    pipelined dispatch (``algorithms/base.py``); solvers without a chunk
    loop (dpop, syncbb, ncbb) ignore both, as in the JAX package.

    ``headroom`` (a fraction, e.g. 0.25) builds the warm-repair engine
    at that reserved capacity instead of the cold one (maxsum,
    maxsum_dynamic, mgm, dsa, adsa; ValueError for the others), and
    sets ``metrics()["repair"]``.

    ``distribution`` as a ``Distribution`` object drives a sharded maxsum
    or amaxsum solve (:func:`_solve_under_placement`) over ``n_shards``
    shards of ``device`` — by default one per visible device of its kind: the card
    count on cuda, 1 on the CPU.  ``shard_overlap`` and
    ``shard_boundary_threshold`` choose its collective path as in the JAX
    package (dense, or the boundary-compacted exact and stale modes); they
    and ``n_shards`` apply to that path only.  As a strategy NAME it is computed and validated
    (an unported strategy raises ``NotPortedError``).

    ``checkpoint_dir`` + ``checkpoint_every`` (default 10) persist
    rotating state snapshots every *k* cycles
    (``runtime/checkpoint.CheckpointManager``); ``resume=True``
    warm-starts from the newest valid snapshot in that directory
    (damaged snapshots are skipped with a warning).  Not supported on
    the placement-driven path.  ``fault_plan``'s checkpoint kinds
    (``corrupt_checkpoint``, ``truncate_checkpoint``) fire on that
    directory before the resume; its other kinds have no consumer in a
    single solve and raise."""
    from pydcop_tpu_torch.distribution.objects import Distribution

    if elastic is not None:
        raise NotPortedError(
            "elastic= (the elastic sharded driver, parallel/elastic.py) "
            "is not ported to the PyTorch package yet")
    if fault_plan is not None:
        _check_fault_plan(fault_plan, checkpoint_dir, resume)
    dev = resolve_device(device)
    if isinstance(distribution, Distribution):
        if checkpoint_dir or resume:
            raise ValueError(
                "checkpointing is not supported on the placement-"
                "driven solve path; rerun without an explicit "
                "distribution object"
            )
        if headroom is not None:
            raise ValueError(
                "headroom builds the single-device warm-repair engine; it "
                "does not combine with a distribution")
        return _solve_under_placement(
            dcop, algo, algo_params, distribution, cycles, timeout, dev,
            shard_overlap, shard_boundary_threshold, n_shards,
            collect_cycles)
    if n_shards is not None or shard_overlap is not None:
        raise ValueError(
            "n_shards and shard_overlap apply to a sharded solve only: "
            "pass a Distribution object as well")
    algo_def = _build_algo_def(dcop, algo, algo_params)
    algo_module = load_algorithm_module(algo_def.algo)
    graph_module = load_graph_module(graph or algo_module.GRAPH_TYPE)
    cg = graph_module.build_computation_graph(dcop)
    if distribution is not None:
        from pydcop_tpu_torch.distribution import load_distribution_module

        dist_module = load_distribution_module(distribution)
        if dcop.agents:
            dist_module.distribute(
                cg,
                dcop.agents.values(),
                hints=getattr(dcop, "dist_hints", None),
                computation_memory=algo_module.computation_memory,
                communication_load=algo_module.communication_load,
            )
    if headroom is not None:
        from pydcop_tpu_torch.algorithms.warm import build_warm_solver
        from pydcop_tpu_torch.runtime.stats import RepairCounters

        solver = build_warm_solver(
            dcop, algo=algo_def.algo, algo_def=algo_def, seed=seed,
            headroom=headroom, device=dev,
        )
        # standalone solves get the scorecard too: metrics()["repair"]
        # pins that the warm engine (not the cold one) actually ran
        solver.repair_counters = RepairCounters()
    else:
        solver = algo_module.build_solver(dcop, cg, algo_def, seed=seed,
                                          device=dev)
    stop_cycle = (
        cycles
        if cycles is not None
        else (algo_def.params.get("stop_cycle") or None)
    )
    if checkpoint_dir:
        if resume and fault_plan is not None:
            from pydcop_tpu_torch.runtime.faults import \
                apply_checkpoint_faults

            for path in apply_checkpoint_faults(fault_plan, checkpoint_dir,
                                                attempt=0):
                logging.getLogger("pydcop_tpu_torch.run").warning(
                    "fault plan damaged checkpoint %s", path)
        return _run_with_checkpoints(
            solver, checkpoint_dir, checkpoint_every or 10, stop_cycle,
            timeout, resume, collect_cycles,
        )
    if resume:
        raise ValueError("resume=True reads checkpoint_dir's snapshots: "
                         "pass checkpoint_dir as well")
    return solver.run(
        cycles=stop_cycle, timeout=timeout, collect_cycles=collect_cycles,
        pipeline=pipeline,
        **({"chunk": chunk} if chunk is not None else {}),
    )


def _check_fault_plan(fault_plan, checkpoint_dir: Optional[str],
                      resume: bool) -> None:
    """A single solve consumes a fault plan's checkpoint kinds only
    (before its resume); every other kind is refused, never ignored."""
    from pydcop_tpu_torch.runtime.faults import CHECKPOINT_KINDS, \
        check_consumed

    check_consumed(fault_plan, CHECKPOINT_KINDS, "a single solve")
    if fault_plan.faults and not (checkpoint_dir and resume):
        raise ValueError(
            "checkpoint fault kinds fire on checkpoint_dir's newest "
            "snapshot before a resume: pass checkpoint_dir and resume=True")


def _run_with_checkpoints(
    solver,
    checkpoint_dir: str,
    checkpoint_every: int,
    cycles: Optional[int],
    timeout: Optional[float],
    resume: bool,
    collect_cycles: bool,
) -> SolveResult:
    """Chunked solver run with periodic rotating snapshots.

    Every ``checkpoint_every`` cycles the solver state is snapshotted
    (atomic + checksummed); with ``resume`` the newest valid snapshot
    warm-starts the run and only the remaining cycles execute.  With no
    explicit cycle budget the run executes the solver's default budget
    with a final snapshot at the end.  Each checkpoint boundary ends a
    ``run``: the packed engines launch once a chunk of at most
    ``checkpoint_every`` cycles.
    """
    from pydcop_tpu_torch.runtime.checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    done = 0
    warm = False
    if resume:
        meta = mgr.load_latest_into(solver)
        if meta is not None:
            done = int(meta.get("cycle", 0) or 0)
            warm = True
    if cycles is None:
        res = solver.run(timeout=timeout, collect_cycles=collect_cycles,
                         resume=warm)
        mgr.save_solver(solver, done + res.cycle)
        return res
    t0 = perf_counter()
    every = max(1, checkpoint_every)
    res = None
    history = []
    while done < cycles:
        n = min(every, cycles - done)
        left = None if timeout is None else timeout - (perf_counter() - t0)
        if left is not None and left <= 0:
            break
        res = solver.run(cycles=n, timeout=left,
                         collect_cycles=collect_cycles, resume=warm)
        warm = True
        done += res.cycle
        if res.history:
            history.extend(res.history)
        mgr.save_solver(solver, done)
        if res.status == "TIMEOUT":
            break
        if res.cycle < n:
            # the solver finished ahead of its cycle budget (e.g. the
            # frontier search proved optimality): burning the rest of
            # the budget in no-op chunks would just churn snapshots
            break
    if res is None:  # resumed at/after the requested budget
        res = solver.run(cycles=1, collect_cycles=collect_cycles,
                         resume=warm)
        done += res.cycle
        mgr.save_solver(solver, done)
    res.cycle = done
    res.time = perf_counter() - t0
    if history:
        res.history = history
    return res


def _solve_under_placement(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    algo_params: Optional[Dict[str, Any]],
    distribution,
    cycles: Optional[int],
    timeout: Optional[float],
    dev,
    shard_overlap: Optional[str] = None,
    shard_boundary_threshold: float = 0.5,
    n_shards: Optional[int] = None,
    collect_cycles: bool = False,
) -> SolveResult:
    """A sharded maxsum or amaxsum solve whose factor→shard assignment
    follows an explicit placement: agents fold (sorted, round-robin) onto
    the shards and each factor lands on its host agent's shard.  amaxsum
    rides the same engine with its per-edge activation mask
    (``ShardedMaxSum(activation=...)``).  The other algorithms have no
    device placement to drive, so asking for one fails loudly instead of
    being ignored."""
    import numpy as np
    import torch

    from pydcop_tpu_torch.algorithms import DEFAULT_INFINITY
    from pydcop_tpu_torch.ops.compile import compile_factor_graph
    from pydcop_tpu_torch.parallel.mesh import ShardedMaxSum, build_mesh
    from pydcop_tpu_torch.parallel.partition import \
        assigns_from_distribution
    from pydcop_tpu_torch.runtime.stats import resolved_config

    name = algo.algo if isinstance(algo, AlgorithmDef) else algo
    if name not in ("maxsum", "amaxsum"):
        raise ValueError(
            f"an explicit distribution can only drive device sharding "
            f"for the factor-graph BP family (maxsum/amaxsum), not "
            f"{name!r}; rerun without -d or with a strategy name"
        )
    algo_def = _build_algo_def(dcop, algo, algo_params)
    t0 = perf_counter()
    tensors = compile_factor_graph(dcop, device=dev)
    mesh = build_mesh(n_shards, dev)
    assigns = assigns_from_distribution(distribution, tensors, len(mesh))
    if len(mesh) == 1:
        logging.getLogger("pydcop_tpu_torch.run").warning(
            "placement-driven solve on one shard: all %d agents fold onto "
            "it", len(distribution.agents),
        )
    damping = algo_def.params.get("damping")
    damping = 0.5 if damping is None else float(damping)  # 0 is valid
    activation = None
    if algo_def.algo == "amaxsum":
        from pydcop_tpu_torch.algorithms.amaxsum import DEFAULT_ACTIVATION

        activation = float(
            algo_def.params.get("activation", DEFAULT_ACTIVATION))
    sharded = ShardedMaxSum(tensors, mesh, damping=damping,
                            assigns=assigns, activation=activation,
                            overlap=shard_overlap,
                            boundary_threshold=shard_boundary_threshold,
                            precision=algo_def.params.get("precision"))
    n_cycles = cycles or 30
    status = "FINISHED"
    history = []
    if timeout is None and not collect_cycles:
        values, _q, _r = sharded.run(cycles=n_cycles)
    else:
        # chunked so the timeout is honoured (and per-cycle costs are
        # collected) between device dispatches; stale's halo goes on
        # from chunk to chunk, so a chunk of one cycle still combines
        # the previous cycle's boundary totals
        from pydcop_tpu_torch.ops.compile import total_cost

        chunk = 1 if collect_cycles else max(1, min(10, n_cycles))
        done = 0
        q = r = None
        values = None
        while done < n_cycles:
            n = min(chunk, n_cycles - done)
            values, q, r = sharded.run(cycles=n, q=q, r=r, keep_halo=True)
            done += n
            if collect_cycles:
                history.append({
                    "cycle": done,
                    "cost": float(total_cost(
                        tensors, torch.as_tensor(values, device=dev)))
                    * tensors.sign,
                    "time": perf_counter() - t0,
                })
            if timeout is not None and perf_counter() - t0 > timeout:
                status = "TIMEOUT"
                break
        n_cycles = done
    assignment = tensors.assignment_from_indices(np.asarray(values))
    violation, cost = dcop.solution_cost(assignment, DEFAULT_INFINITY)
    edges = tensors.n_edges
    return SolveResult(
        status=status,
        assignment=assignment,
        cost=cost,
        violation=violation,
        cycle=n_cycles,
        msg_count=2 * edges * n_cycles,
        msg_size=float(2 * edges * n_cycles * tensors.max_domain_size),
        time=perf_counter() - t0,
        history=history or None,
        shard=sharded.comm_stats(),
        config=resolved_config(
            algo_def.algo, "sharded_mesh",
            overlap=shard_overlap or "default",
            boundary_threshold=shard_boundary_threshold,
            precision=sharded.precision,
        ),
    )


def solve(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    distribution: Optional[Any] = None,
    graph: Optional[str] = None,
    timeout: Optional[float] = None,
    cycles: Optional[int] = None,
    algo_params: Optional[Dict[str, Any]] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Solve a DCOP and return the assignment (reference-parity
    signature).

    >>> from pydcop_tpu_torch.dcop import load_dcop
    >>> dcop = load_dcop('''
    ... name: mini
    ... objective: min
    ... domains: {d: {values: [0, 1]}}
    ... variables:
    ...   x: {domain: d}
    ...   y: {domain: d}
    ... constraints:
    ...   c: {type: intention, function: "10 if x == y else 0"}
    ... agents: [a1, a2, a3]
    ... ''')
    >>> a = solve(dcop, 'maxsum', device='cpu')
    >>> a['x'] != a['y']
    True
    """
    return solve_result(
        dcop, algo, distribution, graph, timeout, cycles, algo_params, seed,
        device=device,
    ).assignment


#: the replica-placement method (``replication/__init__.py``)
REPLICATION_METHOD = "dist_ucs_hostingcosts"


def run_local_thread_dcop(
    dcop: DCOP,
    algo: Union[str, AlgorithmDef],
    distribution: Union[str, Any] = "adhoc",
    graph: Optional[str] = None,
    collector=None,
    collect_moment: str = "value_change",
    period: Optional[float] = None,
    replication: Optional[str] = None,
    seed: int = 0,
    device: DeviceLike = None,
):
    """Reference-parity constructor (infrastructure/run.py:145): returns a
    deployed orchestrator.  In thread mode the tensor runtime is the whole
    agent population in one process.  ``replication`` names the one
    replica-placement method (``dist_ucs_hostingcosts``); replicas are
    placed by ``start_replication(k)``."""
    from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator

    if replication not in (None, REPLICATION_METHOD):
        raise ValueError(
            f"unknown replication method {replication!r}; the one method "
            f"is {REPLICATION_METHOD!r}")
    orch = VirtualOrchestrator(
        dcop, algo, distribution=distribution, graph=graph,
        collect_on=collect_moment, period=period, collector=collector,
        seed=seed, device=device,
    )
    orch.deploy_computations()
    return orch



def run_local_process_dcop(*args, **kwargs):
    """The reference's multi-process runtime (infrastructure/run.py
    :225): the JAX package runs it over OS processes
    (``runtime/process.py``), which is not ported."""
    raise NotPortedError(
        "run_local_process_dcop (the process runtime, runtime/process.py) "
        "is not ported to the PyTorch package yet; use "
        "run_local_thread_dcop")
