"""The port's ``VirtualOrchestrator`` (``pydcop_tpu_torch/runtime/
orchestrator.py``) and ``run_local_thread_dcop`` on the CPU, held to the
JAX package's ``runtime/orchestrator.py`` through the same seeded inputs,
after the JAX package's ``tests/unit/test_runtime.py`` (static run,
scenario removal, pause/resume/stop) and ``tests/unit/test_faults.py``
(kill_agent, checkpoint and auto-resume):

* every phase runs an explicit ``cycles=`` (a scenario delay converts to
  cycles at the measured rate, which no two runs share), with delays
  long enough never to cut a phase;
* maxsum runs at noise 0, the port's generic engine beside the JAX
  package's (its CPU default), and the JAX package's continued run is
  held to ``atol=1e-4`` through the assignment (exact);
* mgm starts both packages from one numpy-made assignment (the initial
  values are each package's own stream, ROADMAP C-w5) and is exact;
* the end metrics (distribution, replicas, events, the ``resilience``
  fault section, the repair scorecard) equal the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.dcop import DcopEvent as JaxEvent
from pydcop_tpu.dcop import EventAction as JaxAction
from pydcop_tpu.dcop import Scenario as JaxScenario
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.runtime import faults as jax_faults
from pydcop_tpu.runtime.orchestrator import \
    VirtualOrchestrator as JaxOrchestrator
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.dcop import (
    DcopEvent,
    EventAction,
    Scenario,
    load_dcop_from_file,
)
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import faults
from pydcop_tpu_torch.runtime.checkpoint import CheckpointManager
from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator
from pydcop_tpu_torch.runtime.run import (
    run_local_process_dcop,
    run_local_thread_dcop,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
#: a delay no CPU phase of these instances reaches
LONG = 600.0
#: the end-metrics keys compared between the packages
COMPARED = ("status", "distribution", "replicas", "events", "resilience",
            "assignment", "cost", "violation", "cycle")


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _params(algo):
    return {"noise": 0.0} if "maxsum" in algo else {}


def _x0(dcop, seed=5):
    rng = np.random.default_rng(seed)
    sizes = [len(dcop.variables[n].domain) for n in sorted(dcop.variables)]
    return (rng.uniform(0, 1, len(sizes)) * np.array(sizes)).astype(np.int32)


def _pair(algo, name="graph_coloring_tuto", distribution="adhoc", **kw):
    """The port's and the JAX package's orchestrators on one instance,
    both on their generic engines and from one start."""
    import jax.numpy as jnp

    dcop, jdcop = load_dcop_from_file(_path(name)), jax_load_dcop(_path(name))
    port = VirtualOrchestrator(
        dcop, AlgorithmDef.build_with_default_params(
            algo, _params(algo), mode=dcop.objective),
        distribution=distribution, device="cpu", **kw)
    jkw = {k: v for k, v in kw.items() if k != "fault_plan"}
    if "fault_plan" in kw:
        jkw["fault_plan"] = jax_faults.FaultPlan.from_json(
            kw["fault_plan"].to_json())
    ref = JaxOrchestrator(
        jdcop, JaxAlgorithmDef.build_with_default_params(
            algo, _params(algo), mode=jdcop.objective),
        distribution=distribution, **jkw)
    if algo == "maxsum" and getattr(port.solver, "packed", None) is not None:
        from pydcop_tpu_torch.algorithms.maxsum import build_solver

        port.solver = build_solver(dcop, None, port.algo_def, device="cpu",
                                   use_packed=False)
    if algo in ("mgm", "dsa"):
        x0 = _x0(dcop)
        port.solver.initial_state = lambda: (torch.as_tensor(x0),)
        ref.solver.initial_state = lambda: (jnp.asarray(x0),)
    return port, ref


def _metrics(orch, res):
    m = orch.end_metrics()
    m["assignment"], m["cost"] = res.assignment, res.cost
    m["violation"], m["cycle"] = res.violation, res.cycle
    return {k: m.get(k) for k in COMPARED}


def _scenario(pkg, agent="a1", cycles_between=True):
    E, A, S = ((DcopEvent, EventAction, Scenario) if pkg == "port"
               else (JaxEvent, JaxAction, JaxScenario))
    events = [E("d1", delay=LONG),
              E("e1", actions=[A("remove_agent", agent=agent)])]
    if cycles_between:
        events.append(E("d2", delay=LONG))
    return S(events)


# ---------------------------------------------------------------------------
# runs held to the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["maxsum", "mgm"])
@pytest.mark.parametrize("name", ["graph_coloring_tuto", "coloring_csp",
                                  "ising_grid"])
def test_static_run_equals_jax(algo, name):
    port, ref = _pair(algo, name)
    for o in (port, ref):
        o.deploy_computations()
    got, want = port.run(cycles=12), ref.run(cycles=12)
    assert _metrics(port, got) == _metrics(ref, want)
    assert set(port.end_metrics()) == set(ref.end_metrics())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("algo", ["maxsum", "mgm"])
@pytest.mark.parametrize("victim", ["a1", "a2", "a3"])
def test_scenario_remove_agent_equals_jax(victim, algo, k):
    port, ref = _pair(algo)
    for o in (port, ref):
        o.deploy_computations()
        o.start_replication(k)
    got = port.run(_scenario("port", victim), cycles=10)
    want = ref.run(_scenario("jax", victim), cycles=10)
    assert _metrics(port, got) == _metrics(ref, want)
    assert victim not in port.distribution.agents
    assert sorted(port.distribution.computations) == \
        sorted(n.name for n in port.cg.nodes)
    # a repair DCOP was built and solved iff the victim hosted anything
    repaired = [e for e in port.events_log if "repaired" in e]
    assert len(port.repair_log) == len(repaired)
    for r in port.repair_log:
        assert r["variables"] >= r["orphans"] > 0
    assert [p["cycles"] for p in port.phase_log] == [10, 10, 10]


def test_scenario_add_agent_and_removal_of_the_new_one():
    port, ref = _pair("maxsum")
    scen = {}
    for pkg, E, A, S in (("port", DcopEvent, EventAction, Scenario),
                         ("jax", JaxEvent, JaxAction, JaxScenario)):
        scen[pkg] = S([E("d1", delay=LONG),
                       E("e1", actions=[A("add_agent", agent="a9")]),
                       E("e2", actions=[A("remove_agent", agent="a1")]),
                       E("d2", delay=LONG)])
    for o in (port, ref):
        o.deploy_computations()
        o.start_replication(2)
    got, want = port.run(scen["port"], cycles=6), ref.run(scen["jax"],
                                                           cycles=6)
    assert _metrics(port, got) == _metrics(ref, want)


def test_kill_agent_fault_routes_through_repair():
    victim = "a1"
    plan = faults.FaultPlan(faults=[faults.Fault(kind="kill_agent",
                                                 agent=victim, cycle=10)])
    port, ref = _pair("maxsum", fault_plan=plan)
    for o in (port, ref):
        o.deploy_computations()
        o.start_replication(2)
    got, want = port.run(cycles=20), ref.run(cycles=20)
    assert got.cycle == 20  # the kill split, not shortened, the run
    m = port.end_metrics()
    assert m["resilience"]["faults_injected"] == 1
    assert m["resilience"]["repairs"] == 1
    assert victim not in m["distribution"]
    assert _metrics(port, got) == _metrics(ref, want)
    assert [p["cycles"] for p in port.phase_log] == [10, 10]


@pytest.mark.parametrize("kind,count", [("remove_agent_burst", 2),
                                        ("add_agent_burst", 3)])
def test_churn_bursts_equal_jax(kind, count):
    plan = faults.FaultPlan(faults=[faults.Fault(kind=kind, count=count,
                                                 cycle=4)], seed=9)
    port, ref = _pair("mgm", fault_plan=plan)
    for o in (port, ref):
        o.deploy_computations()
        o.start_replication(1)
    got, want = port.run(cycles=8), ref.run(cycles=8)
    assert _metrics(port, got) == _metrics(ref, want)
    assert sorted(port.dcop.agents) == sorted(ref.dcop.agents)


def test_checkpoint_and_auto_resume(tmp_path):
    d = str(tmp_path)
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                               distribution="adhoc", checkpoint_dir=d,
                               checkpoint_every=5, device="cpu")
    orch.deploy_computations()
    orch.run(cycles=12)
    assert orch.end_metrics()["resilience"]["checkpoints_saved"] == 3
    assert [c for c, _ in CheckpointManager(d).snapshots()] == [12, 10, 5]
    # a fresh orchestrator resumes exactly where the run ended: 8 more
    # cycles land on the same state as one 20-cycle run
    orch2 = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                                distribution="adhoc", checkpoint_dir=d,
                                auto_resume=True, device="cpu")
    orch2.deploy_computations()
    res2 = orch2.run(cycles=8)
    m2 = orch2.end_metrics()
    assert m2["resilience"]["resumes"] == 1 and res2.cycle == 20
    assert {"resumed_from": 12} in m2["events"]
    straight = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                                   distribution="adhoc", device="cpu")
    straight.deploy_computations()
    res = straight.run(cycles=20)
    assert res2.assignment == res.assignment and res2.cost == res.cost
    for a, b in zip(orch2.solver._last_state, straight.solver._last_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["corrupt_checkpoint",
                                  "truncate_checkpoint"])
def test_auto_resume_skips_a_damaged_snapshot(kind, tmp_path):
    """The plan's checkpoint kind damages the newest snapshot before the
    auto-resume: the run resumes from the one before (the JAX test damages
    the file by hand; the port's plan does it)."""
    d = str(tmp_path)
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                               distribution="adhoc", checkpoint_dir=d,
                               checkpoint_every=5, device="cpu")
    orch.deploy_computations()
    orch.run(cycles=10)
    plan = faults.FaultPlan(faults=[faults.Fault(kind=kind)], seed=4)
    orch2 = VirtualOrchestrator(load_dcop_from_file(TUTO), "maxsum",
                                distribution="adhoc", checkpoint_dir=d,
                                auto_resume=True, fault_plan=plan,
                                device="cpu")
    orch2.deploy_computations()
    res = orch2.run(cycles=5)
    m = orch2.end_metrics()
    assert res.status == "FINISHED" and res.cycle == 10
    assert m["resilience"]["resumes"] == 1
    assert m["resilience"]["faults_injected"] == 1
    assert {"resumed_from": 5} in m["events"]


def test_auto_resume_with_every_snapshot_damaged(tmp_path):
    d = str(tmp_path)
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "mgm",
                               distribution="adhoc", checkpoint_dir=d,
                               checkpoint_every=5, device="cpu")
    orch.deploy_computations()
    orch.run(cycles=10)
    for _c, path in CheckpointManager(d).snapshots():
        faults.corrupt_checkpoint(path, seed=1, mode="truncate")
    orch2 = VirtualOrchestrator(load_dcop_from_file(TUTO), "mgm",
                                distribution="adhoc", checkpoint_dir=d,
                                auto_resume=True, device="cpu")
    orch2.deploy_computations()
    res = orch2.run(cycles=5)
    m = orch2.end_metrics()["resilience"]
    assert res.cycle == 5 and m["resumes"] == 0
    assert m["checkpoints_rejected"] == 2


def test_warm_repair_equals_jax():
    """--warm-repair: the churn fault re-seats on the warm engine, and the
    repair scorecard and placements equal the JAX package's."""
    plan = faults.FaultPlan(faults=[faults.Fault(kind="kill_agent",
                                                 agent="a2", cycle=8)])
    kw = dict(fault_plan=plan, warm_repair=True, headroom=0.5)
    port, ref = _pair("maxsum", **kw)
    for o in (port, ref):
        o.deploy_computations()
        o.start_replication(2)
    got, want = port.run(cycles=16), ref.run(cycles=16)
    pm, rm = port.end_metrics(), ref.end_metrics()
    assert set(pm["repair"]) == set(rm["repair"])
    assert pm["repair"]["repair_retraces"] == 0
    assert got.assignment == want.assignment
    assert _metrics(port, got) == _metrics(ref, want)


def test_phases_convert_delays_at_the_measured_rate():
    """Without ``cycles=``, the first delay phase calibrates the rate and
    each later delay converts to a budget (capped at MAX_PHASE_CYCLES)."""
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "mgm",
                               distribution="adhoc", device="cpu")
    orch.deploy_computations()
    orch.start_replication(1)
    scen = Scenario([DcopEvent("d1", delay=0.2),
                     DcopEvent("e1", actions=[EventAction(
                         "remove_agent", agent="a3")]),
                     DcopEvent("d2", delay=0.2)])
    res = orch.run(scen, timeout=30)
    assert res.status == "FINISHED"
    first = orch.phase_log[0]
    assert first["budget"] == orch.CALIBRATION_CYCLES
    assert first["delay"] == pytest.approx(0.2)
    for p in orch.phase_log:
        assert 0 < p["cycles"] <= orch.MAX_PHASE_CYCLES
        assert p["delay"] is not None
    assert sum(p["cycles"] for p in orch.phase_log) == res.cycle


# ---------------------------------------------------------------------------
# lifecycle (the reference's pause/resume/stop verbs)
# ---------------------------------------------------------------------------


def _orch(algo="maxsum", **kw):
    o = VirtualOrchestrator(load_dcop_from_file(TUTO), algo,
                            distribution="adhoc", device="cpu", **kw)
    return o


def test_pause_blocks_run():
    orch = _orch()
    orch.deploy_computations()
    orch.pause_computations()
    assert orch.status == "PAUSED"
    with pytest.raises(RuntimeError, match="paused"):
        orch.run(cycles=5)


def test_pause_before_deploy_rejected():
    with pytest.raises(RuntimeError, match="deploy"):
        _orch().pause_computations()


def test_run_after_stop_rejected():
    orch = _orch()
    orch.deploy_computations()
    orch.run(cycles=3)
    orch.stop_agents(2)
    assert orch.status == "STOPPED"
    with pytest.raises(RuntimeError, match="stopped"):
        orch.run(cycles=3)
    with pytest.raises(RuntimeError, match="stopped"):
        orch.pause_computations()


def test_double_pause_is_idempotent():
    orch = _orch()
    orch.deploy_computations()
    orch.pause_computations()
    orch.pause_computations()
    orch.resume_computations()
    assert orch.status != "PAUSED"
    assert orch.run(cycles=3).status == "FINISHED"


@pytest.mark.parametrize("algo", ["mgm", "dsa"])
def test_resume_continues_from_state(algo):
    """A warm restart after pause/resume equals one straight run (the
    dsa coins continue their stream, they are not replayed)."""
    orch = _orch(algo)
    orch.deploy_computations()
    orch.run(cycles=3)
    orch.pause_computations()
    orch.resume_computations()
    res2 = orch.run(cycles=3)
    straight = _orch(algo)
    straight.deploy_computations()
    res6 = straight.run(cycles=6)
    assert res2.assignment == res6.assignment and res2.cost == res6.cost
    assert torch.equal(orch.solver.coins.get_state(),
                       straight.solver.coins.get_state())


def test_invalid_distribution_rejected():
    orch = _orch()
    orch.distribution.remove_computation("v1")
    with pytest.raises(ValueError):
        orch.deploy_computations()


def test_structural_action_needs_warm_repair():
    orch = _orch()
    orch.deploy_computations()
    scen = Scenario([DcopEvent("e", actions=[EventAction(
        "remove_constraint", constraint="c_1_2")])])
    with pytest.raises(ValueError, match="warm"):
        orch.run(scen, cycles=2)


def test_run_local_thread_dcop_deploys():
    orch = run_local_thread_dcop(load_dcop_from_file(TUTO), "mgm",
                                 device="cpu")
    ref = __import__("pydcop_tpu.runtime.run", fromlist=["x"]) \
        .run_local_thread_dcop(jax_load_dcop(TUTO), "mgm")
    assert orch.status == ref.status == "DEPLOYED"
    assert orch.distribution.mapping() == ref.distribution.mapping()
    with pytest.raises(ValueError, match="replication"):
        run_local_thread_dcop(load_dcop_from_file(TUTO), "mgm",
                              replication="nope", device="cpu")


# ---------------------------------------------------------------------------
# refusals that stay
# ---------------------------------------------------------------------------


def test_run_local_process_dcop_not_ported():
    with pytest.raises(NotPortedError, match="process"):
        run_local_process_dcop(load_dcop_from_file(TUTO), "mgm",
                               n_processes=2)


@pytest.mark.parametrize("fault", [
    dict(kind="kill_device", device=0),
    dict(kind="shrink_mesh", devices=1),
    dict(kind="corrupt_slab", operand="x"),
    dict(kind="kill_rank", rank=0),
    dict(kind="stall_rank", rank=1, duration=1.0),
], ids=lambda f: f["kind"])
def test_device_and_rank_faults_not_ported(fault):
    plan = faults.FaultPlan(faults=[faults.Fault(**fault)])
    with pytest.raises(NotPortedError, match=fault["kind"]):
        _orch(fault_plan=plan)


def test_serve_faults_have_no_consumer_here():
    plan = faults.FaultPlan(faults=[faults.Fault(kind="stall_tick",
                                                 duration=1.0)])
    with pytest.raises(ValueError, match="serve"):
        _orch(fault_plan=plan)


def test_repair_of_unbounded_agents_refused():
    """Agents of unbounded capacity: the replicas of the victim's 36
    computations all go to its nearest agent, so the repair DCOP would
    hold an arity-36 capacity constraint (a table of 2^36 entries).  The
    repair refuses it by name instead of building it."""
    from pydcop_tpu_torch.dcop import DCOP, AgentDef, Domain, \
        NAryMatrixRelation, Variable

    rng = np.random.default_rng(3)
    d = Domain("colors", "color", [0, 1, 2])
    vs = [Variable(f"v{i:04d}", d) for i in range(60)]
    dcop = DCOP("coloring")
    for v in vs:
        dcop.add_variable(v)
    for k in range(150):
        i, j = rng.choice(60, size=2, replace=False)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], rng.uniform(0, 1, (3, 3)) + 3 * np.eye(3),
            name=f"c{k:05d}"))
    dcop.add_agents([AgentDef(f"a{i:02d}", capacity=10 ** 9)
                     for i in range(6)])
    orch = VirtualOrchestrator(dcop, "maxsum", distribution="adhoc",
                               device="cpu")
    orch.deploy_computations()
    orch.start_replication(2)
    with pytest.raises(ValueError, match="arity 36.*'a00'"):
        orch.run(Scenario([
            DcopEvent("d1", delay=LONG),
            DcopEvent("e1", actions=[EventAction("remove_agent",
                                                 agent="a01")]),
            DcopEvent("d2", delay=LONG)]), cycles=3)


def test_unported_strategy_refused():
    with pytest.raises(NotPortedError, match="gh_cgdp"):
        VirtualOrchestrator(load_dcop_from_file(TUTO), "mgm",
                            distribution="gh_cgdp", device="cpu")


def test_sharded_sentinel_still_refused():
    """``sentinel=True`` (the integrity sentinels of runtime/integrity.py)
    stays with the elastic mesh."""
    from pydcop_tpu_torch.ops.compile import compile_factor_graph
    from pydcop_tpu_torch.parallel.mesh import ShardedMaxSum, build_mesh

    t = compile_factor_graph(load_dcop_from_file(TUTO), device="cpu")
    with pytest.raises(NotPortedError):
        ShardedMaxSum(t, build_mesh(2, "cpu"), sentinel=True)
