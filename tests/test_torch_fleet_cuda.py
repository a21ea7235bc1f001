"""The solve fleets on the card, held to the port's own standalone solves
on the card and, for a fallback kernel, to the CPU solve.

``cuda``-marked; each test skips where no GPU is visible (a replica's
bucket runners are CUDA graphs, its fallback launches K6; no CPU mode).
No JAX here: the fleets are held to the JAX package on the CPU
(``tests/test_torch_fleet.py``, ``tests/test_torch_procfleet.py``).  Run
on a machine with a card with ``python -m pytest
tests/test_torch_fleet_cuda.py -m cuda``."""
import os
import signal
import threading
import time

import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.algorithms import load_algorithm_module
from pydcop_tpu_torch.batch import BatchItem
from pydcop_tpu_torch.dcop import dcop_yaml
from pydcop_tpu_torch.ops import read_launch_counters, reset_launch_counters
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.faults import Fault, FaultPlan
from pydcop_tpu_torch.serve import ProcessFleet, SolveFleet

LIMIT = 63

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _sequential(dcop, algo, seed, limit=LIMIT):
    extra = {"use_packed": False} if algo == "maxsum" else {}
    solver = load_algorithm_module(algo).build_solver(
        dcop, None, BatchItem(dcop, algo).algo_def(), seed=seed,
        device="cuda", **extra)
    return solver.run(max_cycles=limit)


def _same(a, b):
    return (a.assignment, a.cost, a.cycle, a.status) == \
        (b.assignment, b.cost, b.cycle, b.status)


def _drain(fleet, max_ticks=4000):
    for _ in range(max_ticks):
        if not fleet.tick():
            return
    raise AssertionError("fleet did not drain")


@pytest.mark.parametrize("algo", ["mgm", "dsa", "maxsum"])
def test_thread_fleet_kill_reseats_equal_on_the_card(algo, tmp_path):
    """Eight jobs through two replicas on the card, replica-0 killed at
    supervisor pass 3: every job equals its sequential solve on the
    card, the orphans re-seated from their lane checkpoints."""
    _need_gpu()
    dcops = [C.coloring_dcop(40, 100, seed=s) for s in range(8)]
    plan = FaultPlan(faults=[Fault(kind="kill_replica", replica=0,
                                   cycle=3)])
    fleet = SolveFleet(replicas=2, lanes=4, max_cycles=LIMIT,
                       journal_dir=str(tmp_path), checkpoint_every=1,
                       fault_plan=plan, device="cuda")
    jids = [fleet.submit(d, algo, seed=i) for i, d in enumerate(dcops)]
    _drain(fleet)
    for i, (d, jid) in enumerate(zip(dcops, jids)):
        assert _same(fleet.result(jid, timeout=60),
                     _sequential(d, algo, i)), i
    assert fleet.metrics()["fleet"]["jobs_reseated"] >= 1


def test_overlapping_prewarms_capture_and_replay():
    """Two started replicas prewarmed at once (their captures meet the
    process-wide capture lock); each serves its jobs by replays, every
    job equal to its sequential solve."""
    _need_gpu()
    dcops = [C.coloring_dcop(60, 150, seed=s) for s in range(8)]
    fleet = SolveFleet(replicas=2, lanes=4, max_cycles=LIMIT,
                       device="cuda")
    try:
        fleet.start()
        threads = [threading.Thread(
            target=fleet.handle(i).service.prewarm,
            args=([(d, "mgm") for d in dcops[:4]],),
            kwargs={"block": True}) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        jids = []
        for k in (0, 1):
            fleet.router.set_partitioned(f"replica-{1 - k}", True)
            fleet.router.set_partitioned(f"replica-{k}", False)
            jids += [fleet.submit(dcops[i], "mgm", seed=i)
                     for i in range(4 * k, 4 * k + 4)]
        for i, jid in enumerate(jids):
            assert _same(fleet.result(jid, timeout=120),
                         _sequential(dcops[i], "mgm", i)), i
        for i in (0, 1):
            calls = fleet.handle(i).service.metrics()["runners"]
            assert calls["captures"] >= 1 and calls["replays"] >= 1
    finally:
        fleet.stop(drain=False)


def test_mgm2_fallback_launches_k6_and_equals_the_cpu():
    _need_gpu()
    dcop = C.coloring_dcop(300, 900, seed=21)
    fleet = SolveFleet(replicas=2, lanes=2, max_cycles=200, device="cuda")
    try:
        fleet.start()
        reset_launch_counters()
        res = fleet.result(fleet.submit(dcop, "mgm2", seed=3), timeout=300)
        assert read_launch_counters()["mgm2"] >= 1
    finally:
        fleet.stop(drain=False)
    assert _same(res, solve_result(dcop, "mgm2", seed=3, device="cpu"))


def test_process_fleet_on_the_card(tmp_path):
    """Two children on the card: jobs equal to their sequential solves,
    a kill -9 of replica-0 re-seats its jobs, and a cold-joined child
    prewarms from the artifact store with no miss and no nvcc run."""
    _need_gpu()
    from pydcop_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    dcops = [C.coloring_dcop(60, 150, seed=s) for s in range(8)]
    files = []
    for i, d in enumerate(dcops):
        files.append(str(tmp_path / f"job{i}.yaml"))
        with open(files[-1], "w", encoding="utf-8") as f:
            f.write(dcop_yaml(d))
    fleet = ProcessFleet(replicas=2, lanes=4, max_cycles=LIMIT,
                         journal_dir=str(tmp_path / "fleet"),
                         checkpoint_every=1, backoff_base=0.1,
                         device="cuda")
    try:
        assert fleet.wait_ready(timeout=300)
        fleet.start()
        fleet.prewarm([(files[0], "dsa")])
        jids = [fleet.submit(d, "dsa", seed=i, source_file=files[i])
                for i, d in enumerate(dcops)]
        time.sleep(0.05)
        os.kill(fleet.handle(0).proc.pid, signal.SIGKILL)
        for i, jid in enumerate(jids):
            assert _same(fleet.result(jid, timeout=300),
                         _sequential(dcops[i], "dsa", i)), i
        name = fleet.add_replica()
        assert fleet.wait_ready(timeout=300)
        hc = fleet.handle(name)
        hc.service.prewarm([(files[0], "dsa", {})])
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                hc.service.cache.stats().get("pooled", 0) > 0
                and name in fleet.metrics()["processes"]):
            time.sleep(0.05)
        stats = hc.service.cache.stats()
        assert stats["misses"] == 0 and stats["artifact_hits"] >= 1
        assert fleet.metrics()["processes"][name]["nvcc_runs"] == 0
    finally:
        fleet.stop(drain=False)
