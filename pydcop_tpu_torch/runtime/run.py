"""One-call solve API.

Equivalent capability to the reference's pydcop/infrastructure/run.py
(solve) without the thread/process agent plumbing: build graph → compile
to tensors on the device → run synchronous rounds.  A ``Distribution``
object (e.g. loaded from a distribution YAML) drives a sharded solve: the
factors go to the shards of their host agents
(:func:`_solve_under_placement`, maxsum and amaxsum; with
``collect_cycles`` one cycle a dispatch and its cost, as in the JAX
package).  A distribution
strategy given by name, checkpointing, warm-repair headroom and the
elastic driver each refuse with :class:`~pydcop_tpu_torch.errors.NotPortedError`.
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

    ``distribution`` as a ``Distribution`` object drives a sharded maxsum
    or amaxsum solve (:func:`_solve_under_placement`) over ``n_shards``
    shards of ``device`` — by default one per visible device of its kind: the card
    count on cuda, 1 on the CPU.  ``shard_overlap`` and
    ``shard_boundary_threshold`` choose its collective path as in the JAX
    package (only the dense one is ported); they and ``n_shards`` apply
    to that path only."""
    from pydcop_tpu_torch.distribution.objects import Distribution

    refused = {
        "checkpoint_dir/resume": bool(checkpoint_dir) or resume,
        "headroom": headroom is not None,
        "fault_plan/elastic": fault_plan is not None or elastic is not None,
        "a distribution strategy given by name": (
            distribution is not None
            and not isinstance(distribution, Distribution)),
    }
    for name, given in refused.items():
        if given:
            raise NotPortedError(
                f"{name} is not ported to the PyTorch package yet: pass a "
                f"Distribution object (e.g. a distribution YAML file) or "
                f"none")
    dev = resolve_device(device)
    if isinstance(distribution, Distribution):
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
    solver = algo_module.build_solver(dcop, cg, algo_def, seed=seed,
                                      device=dev)
    stop_cycle = (
        cycles
        if cycles is not None
        else (algo_def.params.get("stop_cycle") or None)
    )
    return solver.run(
        cycles=stop_cycle, timeout=timeout, collect_cycles=collect_cycles,
        pipeline=pipeline,
        **({"chunk": chunk} if chunk is not None else {}),
    )


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
        # collected) between device dispatches
        from pydcop_tpu_torch.ops.compile import total_cost

        chunk = 1 if collect_cycles else max(1, min(10, n_cycles))
        done = 0
        q = r = None
        values = None
        while done < n_cycles:
            n = min(chunk, n_cycles - done)
            values, q, r = sharded.run(cycles=n, q=q, r=r)
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
