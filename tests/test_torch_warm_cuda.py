"""The warm-repair engines on the card: no re-capture over a mutation
stream, held to their own CPU run.

``cuda``-marked; each test skips where no GPU is visible (a CUDA graph
has no CPU mode).  No JAX here: on the card the port is held to itself.
Run on a machine with a card with
``python -m pytest tests/test_torch_warm_cuda.py -m cuda``."""
import os

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.dcop import Variable, constraint_from_str, \
    load_dcop_from_file
from pydcop_tpu_torch.runtime.repair import (
    WarmRepairController,
    perturbed_constraint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _stream(algo, device, n=30):
    """A seeded stream of table edits, variable/factor adds and removes
    on the colouring CSP, one 3-chunk window after each; returns the
    phase results, the captures after warm-up and at the end, and the
    final state's values."""
    dcop = load_dcop_from_file(os.path.join(INSTANCES, "coloring_csp.yaml"))
    params = {"noise": 0.0} if algo == "maxsum" else {}
    ctl = WarmRepairController(
        dcop, algo, AlgorithmDef.build_with_default_params(algo, params),
        seed=3, headroom=1.0, min_free=8, chunk=8, device=device)
    out = [ctl.solver.run(chunk=8, cycles=24)]
    ctl.phase_done(out[0])
    out.append(ctl.solver.run(chunk=8, cycles=24, resume=True))
    ctl.phase_done(out[-1])
    base = ctl.total_traces()
    rng = np.random.default_rng(11)
    names = sorted(dcop.constraints)
    v0 = sorted(dcop.variables)[0]
    added = []
    for m in range(n):
        roll = rng.integers(4)
        if roll == 0 and len(added) < 3:
            z = Variable(f"z{m:02d}", dcop.variables[v0].domain)
            ctl.add_variable(z)
            c = constraint_from_str(f"cz{m:02d}", f"0 if z{m:02d} == {v0} "
                                    f"else 2", [z, dcop.variables[v0]])
            ctl.add_constraint(c)
            added.append((z.name, c.name))
        elif roll == 1 and added:
            vn, cn = added.pop()
            ctl.remove_constraint(cn)
            ctl.remove_variable(vn)
        else:
            name = names[int(rng.integers(len(names)))]
            ctl.edit_factor(perturbed_constraint(dcop.constraints[name],
                                                 seed=m))
        out.append(ctl.solver.run(chunk=8, cycles=24, resume=True))
        ctl.phase_done(out[-1])
    state = ctl.solver._last_state
    return out, base, ctl.total_traces(), state, ctl


@pytest.mark.parametrize("algo", ["maxsum", "mgm", "dsa"])
def test_stream_keeps_its_capture_and_equals_the_cpu(algo):
    _need_gpu()
    want, _, _, cpu_state, _ = _stream(algo, "cpu")
    got, base, end, card_state, ctl = _stream(algo, "cuda")
    assert end == base == 1  # one capture, never another
    assert ctl.counters.as_dict()["repair_retraces"] == 0
    for i, (g, w) in enumerate(zip(got, want)):
        if algo == "maxsum":
            assert g.assignment == w.assignment, i
        else:
            assert (g.assignment, g.cost) == (w.assignment, w.cost), i
    if algo == "maxsum":
        for k in (0, 1):
            assert torch.allclose(card_state[k].cpu(), cpu_state[k],
                                  atol=1e-4)
    # the replays really ran: every chunk after the warm-up replayed
    assert got[-1].harness["donated_chunks"] == 3


def test_repack_adds_exactly_one_capture():
    _need_gpu()
    dcop = load_dcop_from_file(os.path.join(INSTANCES, "coloring_csp.yaml"))
    ctl = WarmRepairController(dcop, "mgm", seed=7, headroom=0.0,
                               min_free=1, chunk=8, device="cuda")
    for _ in range(3):
        ctl.phase_done(ctl.solver.run(chunk=8, cycles=24,
                                      resume=ctl.solver._last_state
                                      is not None))
    base = ctl.total_traces()
    d = next(iter(dcop.variables.values())).domain
    for i in range(2):
        ctl.add_variable(Variable(f"z{i}", d))
        for _ in range(3):
            ctl.phase_done(ctl.solver.run(chunk=8, cycles=24, resume=True))
    c = ctl.counters.as_dict()
    assert c["headroom_exhausted_repacks"] == 1
    assert ctl.total_traces() == base + 1
    assert c["repair_retraces"] == 1
