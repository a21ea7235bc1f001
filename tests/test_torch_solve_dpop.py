"""``solve -a dpop`` end to end: the port on the CPU against the JAX
package's ``solve_result`` on every test instance, and the JAX package's
complete-algorithm checks (tests/api/test_api_complete.py) for dpop.

DPOP is exact and draws no random numbers, so the two packages must
agree exactly: assignment, cost, cycle, message counts, the executed
config and the metrics keys.  On the CPU ``engine=auto`` takes the level
scan in both; ``engine=wholesweep`` runs the whole-sweep kernel's plain
version here (the JAX package warns and takes the level scan off a TPU)
and must give the same assignment."""
import itertools
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from pydcop_tpu.algorithms import dpop as jax_dpop
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.graph import pseudotree as jax_pseudotree
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.algorithms import dpop
from pydcop_tpu_torch.dcop import load_dcop, load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.graph import load_graph_module
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
#: the instances whose pseudo-tree has width 1 (the whole-sweep kernel's
#: scope)
WIDTH_ONE = {"coloring_intention", "meeting_scheduling"}


def _path(name):
    return os.path.join(ROOT, "tests", "instances", name + ".yaml")


def _same(got, ref):
    assert got.status == ref.status
    assert got.assignment == ref.assignment
    assert got.cost == ref.cost
    assert got.violation == ref.violation
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count
    assert got.msg_size == ref.msg_size
    assert set(got.metrics()) == set(ref.metrics())


@pytest.mark.parametrize("name", NAMES)
def test_solve_matches_jax(name):
    ref = jax_solve_result(jax_load_dcop(_path(name)), "dpop")
    got = solve_result(load_dcop_from_file([_path(name)]), "dpop",
                       device="cpu")
    _same(got, ref)
    assert got.metrics()["config"] == ref.metrics()["config"]
    assert got.config["engine"] == "sweep"


@pytest.mark.parametrize("name", NAMES)
def test_wholesweep_engine_on_cpu(name):
    """engine=wholesweep runs the kernel's plain version on the CPU where
    the plan has width 1 (the JAX package takes its level scan off a
    TPU); the assignment is the same either way."""
    ref = jax_solve_result(jax_load_dcop(_path(name)), "dpop",
                           algo_params={"engine": "wholesweep"})
    got = solve_result(load_dcop_from_file([_path(name)]), "dpop",
                       algo_params={"engine": "wholesweep"}, device="cpu")
    _same(got, ref)
    assert got.config["engine"] == (
        "wholesweep" if name in WIDTH_ONE else "sweep")
    assert ref.config["engine"] == "sweep"


@pytest.mark.parametrize("name", NAMES)
def test_pernode_path_matches_jax(name):
    jd = jax_load_dcop(_path(name))
    ref = jax_dpop.build_solver(jd)._run_pernode()
    got = dpop.build_solver(load_dcop_from_file([_path(name)]),
                            device="cpu")._run_pernode()
    _same(got, ref)
    assert got.config == ref.config


@pytest.mark.parametrize("name", NAMES)
def test_minibucket_matches_jax(name):
    params = {"engine": "minibucket", "i_bound": 1}
    ref = jax_solve_result(jax_load_dcop(_path(name)), "dpop",
                           algo_params=params)
    got = solve_result(load_dcop_from_file([_path(name)]), "dpop",
                       algo_params=params, device="cpu")
    _same(got, ref)
    assert got.dpop == ref.dpop
    assert got.config == ref.config


@pytest.mark.parametrize("name", ["graph_coloring_tuto", "secp_small"])
def test_distribution_cost_callbacks_match_jax(name):
    ref = jax_pseudotree.build_computation_graph(jax_load_dcop(_path(name)))
    got = load_graph_module("pseudotree").build_computation_graph(
        load_dcop_from_file([_path(name)]))
    for gn, rn in zip(got.nodes, ref.nodes):
        assert gn.name == rn.name
        assert dpop.computation_memory(gn) == \
            jax_dpop.computation_memory(rn)
        assert dpop.communication_load(gn) == \
            jax_dpop.communication_load(rn)


# ---------------------------------------------------------------------------
# the JAX package's complete-algorithm checks, for dpop
# ---------------------------------------------------------------------------


def brute_force(dcop, mode="min"):
    names = sorted(dcop.variables)
    domains = [list(dcop.variables[n].domain) for n in names]
    costs = [dcop.solution_cost(dict(zip(names, combo)), 10000000)[1]
             for combo in itertools.product(*domains)]
    return min(costs) if mode == "min" else max(costs)


def test_tuto_optimum():
    res = solve_result(load_dcop_from_file([_path("graph_coloring_tuto")]),
                       "dpop", device="cpu")
    assert res.cost == 12
    assert res.assignment == {"v1": "G", "v2": "G", "v3": "G", "v4": "G"}
    assert res.status == "FINISHED"
    assert res.msg_count >= 3 and res.msg_size > 0


def test_intention_with_variable_costs():
    dcop = load_dcop_from_file([_path("coloring_intention")])
    res = solve_result(dcop, "dpop", device="cpu")
    assert res.cost == pytest.approx(brute_force(dcop))


def test_random_weighted_instances():
    rng = random.Random(42)
    for trial in range(3):
        n = 5
        lines = [
            "name: rnd", "objective: min",
            "domains: {dom: {values: [0, 1, 2]}}", "variables:",
        ]
        for i in range(n):
            lines.append(f"  v{i}: {{domain: dom}}")
        lines.append("constraints:")
        cnum = 0
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < 0.6:
                    w1, w2 = rng.randint(0, 9), rng.randint(0, 9)
                    lines.append(
                        f"  c{cnum}: {{type: intention, function: "
                        f"'{w1} if v{i} == v{j} else {w2} * abs(v{i} - v{j})'}}"
                    )
                    cnum += 1
        lines.append("agents: [a1]")
        dcop = load_dcop("\n".join(lines))
        for engine in ("auto", "wholesweep"):
            res = solve_result(dcop, "dpop", device="cpu",
                               algo_params={"engine": engine})
            assert res.cost == pytest.approx(brute_force(dcop)), trial


def test_max_mode():
    dcop = load_dcop("""
name: maxtest
objective: max
domains: {d: {values: [0, 1, 2]}}
variables:
  v1: {domain: d}
  v2: {domain: d}
  v3: {domain: d}
constraints:
  c1: {type: intention, function: v1 + v2 if v1 != v2 else 0}
  c2: {type: intention, function: 2 * v3 - v2}
agents: [a1]
""")
    best = max(
        (a + b if a != b else 0) + 2 * c - b
        for a in range(3) for b in range(3) for c in range(3)
    )
    for engine in ("auto", "wholesweep"):
        res = solve_result(dcop, "dpop", device="cpu",
                           algo_params={"engine": engine})
        assert res.cost == pytest.approx(best)
    assert res.config["engine"] == "wholesweep"


def test_disconnected():
    dcop = load_dcop("""
name: disc
domains: {d: {values: [0, 1]}}
variables:
  a1v: {domain: d}
  a2v: {domain: d}
  b1v: {domain: d}
  b2v: {domain: d}
  lone: {domain: d}
constraints:
  ca: {type: intention, function: 5 if a1v == a2v else 1}
  cb: {type: intention, function: 3 if b1v != b2v else 2}
agents: [ag1]
""")
    for engine in ("auto", "wholesweep"):
        res = solve_result(dcop, "dpop", device="cpu",
                           algo_params={"engine": engine})
        assert res.cost == 3  # 1 + 2
        assert set(res.assignment) == {"a1v", "a2v", "b1v", "b2v", "lone"}


@pytest.mark.parametrize("name", ["ising_grid", "secp_small"])
def test_minibucket_bounds_sandwich_the_optimum(name):
    dcop = load_dcop_from_file([_path(name)])
    exact = solve_result(dcop, "dpop", device="cpu").cost
    for i_bound in (1, 2):
        res = solve_result(dcop, "dpop", device="cpu", algo_params={
            "engine": "minibucket", "i_bound": i_bound})
        info = res.metrics()["dpop"]
        assert info["engine"] == "minibucket" and info["i_bound"] == i_bound
        assert info["lower_bound"] <= exact + 1e-6
        assert exact <= info["upper_bound"] + 1e-6
        assert res.config["engine"] == "minibucket"


def test_unported_engines_raise():
    dcop = load_dcop_from_file([_path("graph_coloring_tuto")])
    with pytest.raises(NotPortedError, match="sharded"):
        solve_result(dcop, "dpop", algo_params={"engine": "sharded"},
                     device="cpu")
    # the frontier engine is ported: it proves the sweep's optimum
    res = solve_result(dcop, "dpop", algo_params={"engine": "frontier"},
                       device="cpu")
    assert res.search["optimal"] and res.cost == 12
    assert res.config["engine"] == "frontier"
    # auto with a budget the sweep exceeds: the JAX ladder tiles it over
    # the mesh, this one refuses instead of skipping to mini-bucket
    with pytest.raises(NotPortedError, match="sharded"):
        solve_result(dcop, "dpop", algo_params={
            "budget_mb": 1e-6, "i_bound": 1}, device="cpu")


@pytest.mark.parametrize("params", [
    {"prune": False}, {"prune": "false"}, {"shards": 2},
    {"engine": "minibucket", "i_bound": 1, "shards": 4},
], ids=["prune_false", "prune_false_str", "shards", "shards_minibucket"])
def test_sharded_knobs_raise(params):
    """prune and shards set only the sharded sweep: any value but their
    defaults is refused rather than ignored."""
    dcop = load_dcop_from_file([_path("graph_coloring_tuto")])
    with pytest.raises(NotPortedError, match="sharded"):
        solve_result(dcop, "dpop", algo_params=params, device="cpu")
    res = solve_result(dcop, "dpop", algo_params={"prune": True,
                                                  "shards": 0}, device="cpu")
    assert res.cost == 12


def test_cli_solve_dpop_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "dpop",
         "--device", "cpu", _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["status"] == "FINISHED" and res["cost"] == 12
    assert res["assignment"] == {"v1": "G", "v2": "G", "v3": "G", "v4": "G"}
    ref = jax_solve_result(jax_load_dcop(_path("graph_coloring_tuto")),
                           "dpop")
    assert set(res) == set(ref.metrics())


def test_cli_dpop_shorthands():
    def run(*argv):
        proc = subprocess.run(
            [sys.executable, "-m", "pydcop_tpu_torch", "solve", *argv,
             "--device", "cpu", _path("ising_grid")],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        return proc.returncode, json.loads(proc.stdout)

    rc, res = run("-a", "dpop", "-p", "engine:minibucket", "--i-bound", "1")
    assert rc == 0 and res["dpop"]["i_bound"] == 1
    assert res["config"]["i_bound"] == 1
    # --dpop-no-prune configures the sharded sweep, which is not ported
    rc, res = run("-a", "dpop", "-p", "engine:minibucket", "--i-bound", "1",
                  "--dpop-no-prune")
    assert rc == 1 and res["status"] == "ERROR"
    assert "'sharded' is not ported" in res["error"]
    rc, res = run("-a", "mgm", "--i-bound", "1")
    assert rc == 1 and res["status"] == "ERROR"
    assert "only apply to -a dpop" in res["error"]
