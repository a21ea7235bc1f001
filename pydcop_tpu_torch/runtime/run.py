"""One-call solve API, on one device.

Equivalent capability to the reference's pydcop/infrastructure/run.py
(solve) without the thread/process agent plumbing: build graph → compile
to tensors on the device → run synchronous rounds.  Only the
single-device path is ported: an explicit distribution, checkpointing,
warm-repair headroom and the elastic driver each refuse with
:class:`~pydcop_tpu_torch.errors.NotPortedError`.
"""
from __future__ import annotations

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
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    headroom: Optional[float] = None,
    fault_plan=None,
    elastic: Optional[Dict[str, Any]] = None,
) -> SolveResult:
    """Solve a DCOP on ``device`` (cuda unless the caller passes
    ``device="cpu"``) and return the full result + metrics.

    ``cycles`` runs exactly that many cycles; otherwise the run stops when
    the solver is stable, at the algorithm's ``stop_cycle`` parameter, or
    at ``timeout``."""
    refused = {
        "distribution": distribution is not None,
        "checkpoint_dir/resume": bool(checkpoint_dir) or resume,
        "headroom": headroom is not None,
        "fault_plan/elastic": fault_plan is not None or elastic is not None,
    }
    for name, given in refused.items():
        if given:
            raise NotPortedError(
                f"{name} is not ported to the PyTorch package yet: it "
                f"runs the single-device solve path only"
            )
    dev = resolve_device(device)
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
    return solver.run(cycles=stop_cycle, timeout=timeout)


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
