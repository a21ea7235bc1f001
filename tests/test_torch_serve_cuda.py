"""The solve service on the card, held to the port's own sequential
solves on the card.

``cuda``-marked; each test skips where no GPU is visible (a bucket
runner's CUDA graph has no CPU mode).  No JAX here: the service is held
to the JAX package on the CPU (``tests/test_torch_serve_service.py``,
``tests/test_torch_serve_faults.py``).  Run on a machine with a card
with ``python -m pytest tests/test_torch_serve_cuda.py -m cuda``."""
import os

import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.algorithms import load_algorithm_module
from pydcop_tpu_torch.batch import BatchItem, CompileCache
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import read_launch_counters, reset_launch_counters
from pydcop_tpu_torch.serve import SolveService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "ising_grid"]
LIMIT = 63

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _sequential(dcop, algo, seed, device, limit=LIMIT):
    extra = {"use_packed": False} if algo == "maxsum" else {}
    solver = load_algorithm_module(algo).build_solver(
        dcop, None, BatchItem(dcop, algo).algo_def(), seed=seed,
        device=device, **extra)
    return solver.run(max_cycles=limit)


def _drain(svc, max_ticks=400):
    for _ in range(max_ticks):
        if not svc.tick() and all(
                j.done.is_set() for j in svc._jobs.values()):
            return
    raise AssertionError("service did not drain")


@pytest.mark.parametrize("algo", ["maxsum", "mgm", "dsa", "adsa", "gdba"])
def test_served_jobs_equal_their_sequential_solves_on_the_card(algo):
    """Eight jobs (three instances and generated colourings) through two
    lanes, admitted mid-flight into running buckets, on the card: each
    equals its sequential solve on the card (maxsum's generic engine,
    the others' default engines), and the buckets launch no kernel of
    the port."""
    _need_gpu()
    dcops = [load_dcop_from_file(os.path.join(INSTANCES, n + ".yaml"))
             for n in NAMES] + [C.coloring_dcop(40, 100, seed=s)
                                for s in range(5)]
    svc = SolveService(lanes=2, cache=CompileCache(), max_cycles=LIMIT,
                       device="cuda")
    reset_launch_counters()
    jids = []
    for k, d in enumerate(dcops):
        jids.append(svc.submit(d, algo, seed=k))
        svc.tick()
    _drain(svc)
    assert not any(read_launch_counters().values())
    calls = svc.metrics()["runners"]
    assert calls["captures"] >= 1 and calls["replays"] >= 1
    for k, (jid, d) in enumerate(zip(jids, dcops)):
        res = svc.result(jid, timeout=10)
        seq = _sequential(d, algo, k, "cuda")
        assert (res.assignment, res.cost, res.cycle, res.status) == \
            (seq.assignment, seq.cost, seq.cycle, seq.status), (algo, k)


def test_a_prewarmed_signature_replays_at_its_first_step():
    """prewarm() builds and captures the runner; the admitted jobs (one
    bucket's worth) take it from the pool: no capture and no regrow
    after the prewarm, and the service thread's steps all replay."""
    _need_gpu()
    dcops = [C.coloring_dcop(60, 180, seed=300 + i) for i in range(6)]
    svc = SolveService(lanes=8, cache=CompileCache(), max_cycles=200,
                       device="cuda")
    try:
        svc.start()
        svc.prewarm([(d, "mgm") for d in dcops], block=True)
        after_prewarm = svc.metrics()["runners"]
        assert after_prewarm["captures"] == 1
        jids = [svc.submit(d, "mgm", seed=i) for i, d in enumerate(dcops)]
        results = [svc.result(j, timeout=120) for j in jids]
        calls = svc.metrics()["runners"]
    finally:
        svc.stop(drain=False)
    assert calls["captures"] == 1 and calls["regrows"] == 0
    assert calls["eager_calls"] == after_prewarm["eager_calls"]
    assert calls["replays"] > after_prewarm["replays"]
    for i, (d, res) in enumerate(zip(dcops, results)):
        seq = _sequential(d, "mgm", i, "cuda", limit=200)
        assert (res.assignment, res.cost, res.cycle) == \
            (seq.assignment, seq.cost, seq.cycle)
