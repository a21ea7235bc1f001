"""The harness's captured chunk on the card, held to its own CPU run.

``cuda``-marked; each test skips where no GPU is visible (a CUDA graph
and the K2 kernel have no CPU mode).  No JAX here: on the card the port
is held to itself.  Run on a machine with a card with
``python -m pytest tests/test_torch_harness_cuda.py -m cuda``."""
import os

import pytest
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.algorithms.capture import EAGER_CALLS, ChunkRunner
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import packed_local_search as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _solver(algo, name, device, params=None, seed=1, **kw):
    dcop = load_dcop_from_file(os.path.join(INSTANCES, name + ".yaml"))
    algo_def = AlgorithmDef.build_with_default_params(
        algo, params or {}, mode=dcop.objective)
    return load_algorithm_module(algo).build_solver(
        dcop, None, algo_def, seed=seed, device=device, **kw)


@pytest.mark.parametrize("algo,kw", [
    ("dba", {}), ("gdba", {}), ("amaxsum", {}),
    ("maxsum", {"use_packed": False}), ("dsa", {"use_packed": False}),
    ("mgm2", {"use_packed": False})])
@pytest.mark.parametrize("name", ["coloring_csp", "secp_small"])
def test_captured_runs_equal_the_cpu(algo, kw, name):
    _need_gpu()
    params = {"noise": 0} if algo == "maxsum" else None
    cpu = _solver(algo, name, "cpu", params, **kw)
    card = _solver(algo, name, "cuda", params, **kw)
    card.check_chunk_syncs = True
    for run in ({"cycles": 30, "chunk": 7}, {"chunk": 7},
                {"cycles": 30, "chunk": 7, "collect_cycles": True}):
        want, got = cpu.run(**run), card.run(**run)
        assert (got.assignment, got.cost, got.cycle) == \
            (want.assignment, want.cost, want.cycle), run
        if run.get("collect_cycles"):
            assert [h["cost"] for h in got.history] == \
                [h["cost"] for h in want.history]
        # a new runner's first EAGER_CALLS chunks run eagerly, the rest
        # replay
        assert got.harness["donated_chunks"] >= \
            got.harness["chunks_dispatched"] - EAGER_CALLS
    assert card.trace_count() == 2  # (7, no collect) and (7, collect)


@pytest.mark.parametrize("algo", ["mgm", "dsa", "adsa", "mgm2"])
@pytest.mark.parametrize("name,kw", [("meeting_scheduling", {}),
                                     ("secp_small", {"use_packed": True})])
def test_collect_launches_k2_once_a_cycle(algo, name, kw):
    _need_gpu()
    cpu = _solver(algo, name, "cpu", **kw)
    card = _solver(algo, name, "cuda", **kw)
    assert card.packed is not None
    mixed = card.packed.pg.mixed is not None
    want = cpu.run(cycles=24, chunk=8, collect_cycles=True)
    P.reset_launches()
    got = card.run(cycles=24, chunk=8, collect_cycles=True)
    assert (got.assignment, got.cost) == (want.assignment, want.cost)
    assert [h["cost"] for h in got.history] == \
        [h["cost"] for h in want.history]
    counts = (P.ls_tables.launches, P.ls_tables.mixed_launches)
    assert counts == ((0, 24) if mixed else (24, 0))
    assert P.packed_mgm_cycles.launches == P.packed_dsa_cycles.launches == 0
    # a tail chunk replays the whole graph: its frozen cycles launch too
    P.reset_launches()
    card.run(cycles=20, chunk=8, collect_cycles=True)
    assert sum((P.ls_tables.launches, P.ls_tables.mixed_launches)) == 24


@pytest.mark.parametrize("name,kw", [("meeting_scheduling", {}),
                                     ("secp_small", {"use_packed": True})])
def test_captured_graph_holds_one_k2_node_a_cycle(name, kw, tmp_path):
    """The launches a replay counts are the graph's: a captured collect
    chunk of 8 cycles holds 8 K2 kernel nodes."""
    _need_gpu()
    card = _solver("mgm", name, "cuda", **kw)
    ChunkRunner.keep_graph = True
    try:
        card.run(cycles=24, chunk=8, collect_cycles=True)
    finally:
        ChunkRunner.keep_graph = False
    runner = card._runners[("masked", 8, True)]
    key = ("ls_tables_mixed" if card.packed.pg.mixed is not None
           else "ls_tables")
    assert runner.recorded == {key: 8}
    path = tmp_path / "chunk.dot"
    runner.graph.debug_dump(str(path))
    lines = path.read_text().splitlines()
    assert sum("ls_tables_kernel" in line for line in lines) == 8


def test_pipeline_on_the_card():
    _need_gpu()
    ref = _solver("dba", "coloring_csp", "cuda").run(max_cycles=300)
    res = _solver("dba", "coloring_csp", "cuda").run(max_cycles=300,
                                                      pipeline=True)
    assert res.assignment == ref.assignment
    assert ref.cycle <= res.cycle <= ref.cycle + 7
    assert res.harness["overshoot_cycles"] == res.cycle - ref.cycle


def test_a_failed_capture_raises():
    _need_gpu()
    solver = _solver("dba", "coloring_csp", "cuda")
    real = solver.cycle

    def syncing(state):
        x, w = real(state)
        w = w + float(w.sum().item()) * 0.0  # a host read in the cycle
        return x, w

    solver.cycle = syncing
    with pytest.raises(RuntimeError):
        solver.run(cycles=20, chunk=7)
