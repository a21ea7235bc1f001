"""The exact-search slice on the card: the frontier engine and the
maxsum_dynamic swap, held to their own CPU runs and plain versions.

``cuda``-marked; each test skips where no GPU is visible (the frontier
is PyTorch tensor code, K1 a hand-written kernel with no CPU mode).  No
JAX here: on the card the port is held to itself."""
import numpy as np
import pytest
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.maxsum_dynamic import build_solver
from pydcop_tpu_torch.dcop import (
    DCOP,
    AgentDef,
    Domain,
    NAryMatrixRelation,
    Variable,
)
from pydcop_tpu_torch.ops import packed_maxsum as pm
from pydcop_tpu_torch.search.solver import FrontierSearchSolver


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _dense(seed, n=9, D=3):
    rng = np.random.default_rng(seed)
    dcop = DCOP(f"dense-{seed}", objective="min")
    dom = Domain("d", "v", list(range(D)))
    vs = [Variable(f"v{i:02d}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            m = rng.integers(0, 97, (D, D)).astype(float)
            dcop.add_constraint(NAryMatrixRelation([vs[i], vs[j]], m,
                                                   name=f"c{k}"))
            k += 1
    dcop.add_agents([AgentDef("a0")])
    return dcop


@pytest.mark.cuda
def test_frontier_card_equals_cpu_with_one_read_a_chunk():
    _need_gpu()
    dcop = _dense(3)
    kw = dict(frontier_width=8, steps=2, i_bound=1)
    cpu = FrontierSearchSolver(dcop, device="cpu", **kw).run(
        collect_cycles=True)
    card = FrontierSearchSolver(dcop, device="cuda", **kw)
    res = card.run(collect_cycles=True)
    assert res.search["optimal"]
    assert res.cost == cpu.cost and res.assignment == cpu.assignment
    keys = ("cycle", "cost", "lower_bound", "upper_bound", "gap")
    assert [[h[k] for k in keys] for h in res.history] == \
        [[h[k] for k in keys] for h in cpu.history]
    state = card.initial_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, stats = card.engine.run_chunk(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stats.cpu().shape == (2,)


@pytest.mark.cuda
def test_swapped_layout_kernel_equals_plain_on_gpu():
    """K1 on a layout swapped in place equals its plain version."""
    _need_gpu()
    rng = np.random.default_rng(5)
    dcop = DCOP("bin", objective="min")
    dom = Domain("d", "v", [0, 1, 2])
    vs = [Variable(f"v{i:03d}", dom) for i in range(200)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(600):
        i = int(rng.integers(0, 200))
        j = int((i + 1 + rng.integers(0, 199)) % 200)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], rng.integers(0, 10, (3, 3)).astype(float),
            name=f"c{k:03d}"))
    solver = build_solver(dcop, device="cuda", algo_def=AlgorithmDef.
                          build_with_default_params("maxsum_dynamic",
                                                    {"noise": 0}))
    solver.run(cycles=10)
    for name in sorted(dcop.constraints)[::7]:
        dims = list(dcop.constraints[name].dimensions)
        solver.change_factor_function(NAryMatrixRelation(
            dims, rng.integers(0, 10, (3, 3)).astype(float), name=name))
    pg = solver.packed
    q, r = pm.packed_init_state(pg)
    got = pm.packed_cycles(pg, q, r, 20, damping=0.5)
    want = pm.packed_cycles_plain(pg, q, r, 20, damping=0.5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
