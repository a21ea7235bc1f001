"""``solve -a maxsum`` end to end: the port on the CPU against the JAX
package's ``solve_result`` on every test instance.

The symmetry-breaking noise is drawn from different generators in the two
packages (``jax.random`` there, a CPU ``torch.Generator`` here), so the
parity runs set ``noise`` to 0 on both sides.  Then the assignment, the
cost, the status and the stop cycle must be equal, and the metrics must
have the same keys.  The port takes its packed engine on the all-binary
instances and its generic engine on the mixed-arity ones."""
import json
import os
import subprocess
import sys

import pytest
import torch

from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.algorithms.maxsum import build_solver
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.runtime import solve, solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
BINARY = {"coloring_csp", "coloring_intention", "graph_coloring_tuto",
          "meeting_scheduling"}


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


@pytest.mark.parametrize("name", NAMES)
def test_solve_matches_jax(name):
    params = {"noise": 0}
    ref = jax_solve_result(jax_load_dcop(_path(name)), "maxsum",
                           algo_params=params)
    got = solve_result(load_dcop_from_file(_path(name)), "maxsum",
                       algo_params=params, device="cpu")
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.status == ref.status
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size
    assert set(got.metrics()) == set(ref.metrics())
    assert set(got.metrics()["harness"]) == set(ref.metrics()["harness"])
    assert got.metrics()["config"] == ref.metrics()["config"]


@pytest.mark.parametrize("name", NAMES)
def test_engine_choice(name):
    solver = build_solver(load_dcop_from_file(_path(name)), device="cpu")
    assert (solver.packed is not None) == (name in BINARY)


@pytest.mark.parametrize("name", sorted(set(NAMES) - BINARY))
def test_engine_choice_mixed_with_use_packed(name):
    """use_packed=True packs a mixed-arity graph on the CPU too (the mixed
    layout, run by the kernel's plain version); False never packs."""
    dcop = load_dcop_from_file(_path(name))
    solver = build_solver(dcop, device="cpu", use_packed=True)
    assert solver.packed is not None and solver.packed.mixed is not None
    assert build_solver(dcop, device="cpu", use_packed=False).packed is None


def test_tutorial_default_noise_cost_12():
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    res = solve_result(dcop, "maxsum", device="cpu")
    assert res.status == "FINISHED"
    assert res.cost == 12 and res.violation == 0
    assert res.metrics()["harness"]["chunks_dispatched"] == \
        res.metrics()["harness"]["host_sync_count"]
    assert solve(dcop, "maxsum", device="cpu") == {
        "v1": "G", "v2": "G", "v3": "G", "v4": "G"}


def test_fixed_cycles_and_stop_cycle():
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    res = solve_result(dcop, "maxsum", cycles=5, device="cpu")
    assert res.cycle == 5
    # no convergence read in a fixed-cycle run: one chunk, no host sync
    assert res.metrics()["harness"]["host_sync_count"] == 0
    res = solve_result(dcop, "maxsum", algo_params={"stop_cycle": 9},
                       device="cpu")
    assert res.cycle == 9


def test_unported_options_refuse():
    from pydcop_tpu_torch.errors import NotPortedError

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    for kw in ({"distribution": "oneagent"}, {"checkpoint_dir": "x"},
               {"headroom": 0.25}, {"elastic": {}}):
        with pytest.raises(NotPortedError):
            solve_result(dcop, "maxsum", device="cpu", **kw)
    with pytest.raises(NotPortedError):
        solve_result(dcop, "maxsum", device="cpu",
                     algo_params={"precision": "bf16"})
    with pytest.raises(ImportError, match="available: \\['adsa', 'amaxsum', "
                       "'dba', 'dpop', 'dsa', 'dsatuto', 'gdba', 'maxsum', "
                       "'mgm', 'mgm2', 'mixeddsa'\\]"):
        solve_result(dcop, "syncbb", device="cpu")


def test_cli_solve_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "--device", "cpu", _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["status"] == "FINISHED" and res["cost"] == 12
    assert res["assignment"] == {"v1": "G", "v2": "G", "v3": "G", "v4": "G"}
    assert set(res) == {"status", "assignment", "cost", "violation",
                        "cycle", "msg_count", "msg_size", "time",
                        "harness", "config"}


@pytest.mark.parametrize("name", ["graph_coloring_tuto", "secp_small"])
def test_distribution_cost_callbacks_match_jax(name):
    from pydcop_tpu.algorithms import maxsum as jax_maxsum
    from pydcop_tpu.graph import load_graph_module as jax_graph_module
    from pydcop_tpu_torch.algorithms import maxsum
    from pydcop_tpu_torch.graph import load_graph_module

    ref = jax_graph_module("factor_graph").build_computation_graph(
        jax_load_dcop(_path(name)))
    got = load_graph_module("factor_graph").build_computation_graph(
        load_dcop_from_file(_path(name)))
    assert [n.name for n in got.nodes] == [n.name for n in ref.nodes]
    for gn, rn in zip(got.nodes, ref.nodes):
        assert maxsum.computation_memory(gn) == \
            jax_maxsum.computation_memory(rn)
        for target in gn.neighbors:
            assert maxsum.communication_load(gn, target) == \
                jax_maxsum.communication_load(rn, target)
