"""Resilience and the control plane on the card: checkpointed solves
through the packed kernels equal their straight runs, a card-written
checkpoint restores on the CPU, and the orchestrator's repair and phases
equal the CPU run.

``cuda``-marked; each test skips where no GPU is visible (the kernels
have no CPU mode).  No JAX here: on the card the port is held to itself.
Run on a machine with a card with
``python -m pytest tests/test_torch_resilience_cuda.py -m cuda``."""
import os

import pytest
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import (
    AgentDef,
    DcopEvent,
    EventAction,
    Scenario,
    load_dcop_from_file,
)
from pydcop_tpu_torch.ops import read_launch_counters, reset_launch_counters
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    flatten_state,
    load_checkpoint,
)
from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")

pytestmark = pytest.mark.cuda

#: the kernel each checkpointed algorithm launches on a binary graph
COUNTERS = {"maxsum": "packed_maxsum_cycle", "mgm": "mgm", "dsa": "dsa"}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _colouring(V=400, E=1200, seed=3, algo="mgm", agents=40):
    """A soft 3-colouring whose agents' capacities hold the algorithm's
    computations five times over (adhoc then spreads them evenly and the
    replicas of one agent's computations spread over many agents, which
    keeps the repair DCOP's capacity constraints narrow)."""
    import numpy as np

    from pydcop_tpu_torch.dcop import (
        DCOP,
        Domain,
        NAryMatrixRelation,
        Variable,
    )
    from pydcop_tpu_torch.graph import load_graph_module

    rng = np.random.default_rng(seed)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i:04d}", d) for i in range(V)]
    dcop = DCOP("coloring")
    for v in vs:
        dcop.add_variable(v)
    for k in range(E):
        i, j = rng.choice(V, size=2, replace=False)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], rng.uniform(0, 1, (3, 3)) + 3 * np.eye(3),
            name=f"c{k:05d}"))
    mod = load_algorithm_module(algo)
    cg = load_graph_module(mod.GRAPH_TYPE).build_computation_graph(dcop)
    share = sum(mod.computation_memory(n) for n in cg.nodes) / agents
    dcop.add_agents([AgentDef(f"a{i:02d}", capacity=5 * share)
                     for i in range(agents)])
    return dcop


def _solver(dcop, algo, device):
    return load_algorithm_module(algo).build_solver(
        dcop, None, AlgorithmDef.build_with_default_params(
            algo, {}, mode=dcop.objective), seed=0, device=device)


@pytest.mark.parametrize("algo", sorted(COUNTERS))
def test_resume_equals_straight_through_the_kernel(algo, tmp_path):
    """A run restored from a mid-run snapshot equals the straight run,
    bit for bit, and each checkpoint boundary ends a kernel launch."""
    _need_gpu()
    dcop = _colouring()
    d = str(tmp_path)
    reset_launch_counters()
    solve_result(dcop, algo, cycles=60, checkpoint_dir=d,
                 checkpoint_every=20, device="cuda")
    assert read_launch_counters()[COUNTERS[algo]] == 3
    straight = _solver(dcop, algo, "cuda")
    straight.run(cycles=60)
    restored = _solver(dcop, algo, "cuda")
    load_checkpoint(CheckpointManager(d).path_for(20), restored)
    restored.run(cycles=40, resume=True)
    for a, b in zip(flatten_state(straight._last_state),
                    flatten_state(restored._last_state)):
        assert torch.equal(a, b)
    if algo == "dsa":
        assert torch.equal(straight.coins.get_state(),
                           restored.coins.get_state())


@pytest.mark.parametrize("algo", sorted(COUNTERS))
def test_card_checkpoint_restores_on_the_cpu(algo, tmp_path):
    _need_gpu()
    dcop = _colouring()
    card = _solver(dcop, algo, "cuda")
    card.run(cycles=30)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_solver(card, 30)
    cpu = _solver(dcop, algo, "cpu")
    assert mgr.load_latest_into(cpu)["cycle"] == 30
    for a, b in zip(flatten_state(card._last_state),
                    flatten_state(cpu._last_state)):
        assert torch.equal(a.cpu(), b)
    r1 = card.run(cycles=10, resume=True)
    r2 = cpu.run(cycles=10, resume=True)
    assert r1.assignment == r2.assignment


@pytest.mark.parametrize("algo", ["maxsum", "mgm"])
def test_orchestrator_equals_the_cpu(algo):
    """A scenario removing an agent, 10 cycles a phase: the card's
    placements, repair and final assignment equal the CPU's."""
    _need_gpu()
    out = []
    for device in ("cuda", "cpu"):
        orch = VirtualOrchestrator(_colouring(algo=algo), algo,
                                   distribution="adhoc", device=device)
        orch.deploy_computations()
        orch.start_replication(2)
        victim = sorted(a for a in orch.distribution.agents
                        if orch.distribution.computations_hosted(a))[0]
        res = orch.run(Scenario([
            DcopEvent("d1", delay=600.0),
            DcopEvent("e1", actions=[EventAction("remove_agent",
                                                 agent=victim)]),
            DcopEvent("d2", delay=600.0)]), cycles=10)
        m = orch.end_metrics()
        out.append((res.assignment, res.cost, m["distribution"],
                    m["events"], m["resilience"]))
    assert out[0] == out[1]


def test_tuto_orchestrator_on_the_card():
    _need_gpu()
    path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
    orch = VirtualOrchestrator(load_dcop_from_file(path), "mgm",
                               distribution="adhoc", device="cuda")
    orch.deploy_computations()
    orch.start_replication(2)
    res = orch.run(cycles=12)
    cpu = VirtualOrchestrator(load_dcop_from_file(path), "mgm",
                              distribution="adhoc", device="cpu")
    cpu.deploy_computations()
    assert res.assignment == cpu.run(cycles=12).assignment
