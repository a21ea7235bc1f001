"""The port's breakout algorithms (``solve -a dba|gdba``) and the
weighted local cost tables they run on, against the JAX package, on the
CPU.

* ``local_cost_tables`` with ``bucket_tensors``, ``factor_weights`` and
  ``include_unary=False`` equals the JAX function on all six
  ``tests/instances`` — bit for bit (the same ordered segment sums);
* one cycle at a time, dba and gdba (all 24 modifier × violation ×
  increase-mode combinations, 5 cycles on ``secp_small``; the defaults,
  10 cycles on ``coloring_csp``) equal the JAX solvers' ``cycle`` from one
  numpy-made state (x and breakout weights, carried across with
  ``state_from_numpy``): x and every weight exactly, after every cycle;
* ``solve_result(..., "dba"|"gdba", device="cpu")`` equals the JAX
  package's ``solve_result`` from one start: assignment, cost, status,
  stop cycle and message counts.  Both packages draw the initial values
  from their own generators (the port's stated deviation), so the test
  hands both one numpy-made start.
"""
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.algorithms._local_search as jax_ls
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.ops.compile import compile_constraint_graph as jax_compile
from pydcop_tpu.ops.compile import local_cost_tables as jax_tables
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.algorithms import (
    AlgorithmDef,
    _local_search,
    load_algorithm_module,
)
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import (
    local_cost_tables,
    numpy_fields,
    tensors_from_numpy,
)
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
SOLVERS = {"dba": "DbaSolver", "gdba": "GdbaSolver"}
#: every GDBA rule: modifier × violation × increase mode
GDBA_RULES = list(itertools.product("AM", ("NZ", "NM", "MX"), "ERCT"))


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def compiled(name):
    """(the JAX compiled constraints graph, the same arrays in the
    port)."""
    jt = jax_compile(jax_load_dcop(_path(name)))
    return jt, tensors_from_numpy(numpy_fields(jt), device="cpu")


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_weighted_local_cost_tables_match_jax(name):
    """DBA's call (0/1 indicators, integer weights, no unary costs),
    GDBA's (effective tensors base + W, with unary costs) and weights
    alone, each equal to the JAX function's."""
    jt, t = compiled(name)
    rng = np.random.default_rng(4)
    x = random_x(t, 2)
    w = rng.integers(1, 6, t.n_factors).astype(np.float32)
    eff = [np.where(b.tensors.numpy() >= 5e29, b.tensors.numpy(),
                    b.tensors.numpy() + rng.integers(0, 4, b.tensors.shape))
           .astype(np.float32) for b in t.buckets]
    ind = [np.where(b.tensors.numpy() >= 5e29, 1e30,
                    (b.tensors.numpy() > 0)).astype(np.float32)
           for b in t.buckets]
    for kw in (dict(bucket_tensors=ind, factor_weights=w,
                    include_unary=False),
               dict(bucket_tensors=eff), dict(factor_weights=w)):
        ref = np.asarray(jax_tables(jt, jnp.asarray(x), **{
            k: ([jnp.asarray(a) for a in v] if k == "bucket_tensors"
                else jnp.asarray(v) if k == "factor_weights" else v)
            for k, v in kw.items()}))
        got = local_cost_tables(t, torch.as_tensor(x), **{
            k: ([torch.as_tensor(a) for a in v] if k == "bucket_tensors"
                else torch.as_tensor(v) if k == "factor_weights" else v)
            for k, v in kw.items()}).numpy()
        assert np.array_equal(got, ref), sorted(kw)
    # unweighted, the tables are those of the local-search family
    assert np.array_equal(
        local_cost_tables(t, torch.as_tensor(x)).numpy(),
        np.asarray(jax_tables(jt, jnp.asarray(x))))


def _solvers(name, algo, params):
    jdcop = jax_load_dcop(_path(name))
    jsolver = jax_algo_module(algo).build_solver(
        jdcop, None, JaxAlgorithmDef.build_with_default_params(
            algo, params, mode=jdcop.objective))
    t = tensors_from_numpy(numpy_fields(jsolver.tensors), device="cpu")
    solver = getattr(load_algorithm_module(algo), SOLVERS[algo])(
        None, t, AlgorithmDef.build_with_default_params(algo, params))
    return jsolver, solver, t


def _start(algo, t, params, seed):
    """A numpy-made state: x and non-trivial breakout weights (DBA:
    integers 1-3 per factor; GDBA: integers from the modifier's initial
    value, per tensor entry)."""
    rng = np.random.default_rng(seed)
    x = random_x(t, seed)
    if algo == "dba":
        return x, rng.integers(1, 4, t.n_factors).astype(np.float32)
    lo = 0 if params.get("modifier", "A") == "A" else 1
    return x, [rng.integers(lo, lo + 3, b.tensors.shape).astype(np.float32)
               for b in t.buckets]


def _run_cycles(name, algo, params, cycles, seed=1):
    """Both solvers' ``cycle`` from one state; asserts x and the weights
    equal after every cycle.  Returns (the number of weights raised, the
    last x)."""
    jsolver, solver, t = _solvers(name, algo, params)
    x, w = _start(algo, t, params, seed)
    jstate = (jnp.asarray(x), jnp.asarray(w) if algo == "dba"
              else tuple(jnp.asarray(a) for a in w))
    state = solver.state_from_numpy(x, w)
    w0 = solver.state_to_numpy(state)[1]
    for c in range(cycles):
        jstate = jsolver.cycle(jstate, None)
        state = solver.cycle(state)
        gx, gw = solver.state_to_numpy(state)
        assert np.array_equal(gx, np.asarray(jstate[0])), f"cycle {c}"
        ref = ([np.asarray(jstate[1])] if algo == "dba"
               else [np.asarray(a) for a in jstate[1]])
        got = [gw] if algo == "dba" else gw
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == np.float32
            assert np.array_equal(a, b), f"weights, cycle {c}"
    w0 = [w0] if algo == "dba" else w0
    return sum(int((a != b).sum()) for a, b in zip(got, w0)), gx


@pytest.mark.parametrize("modifier,violation,increase", GDBA_RULES)
def test_gdba_cycles_match_jax(modifier, violation, increase):
    _run_cycles("secp_small", "gdba", {
        "modifier": modifier, "violation": violation,
        "increase_mode": increase}, 5)


@pytest.mark.parametrize("name,cycles", [("secp_small", 5),
                                         ("coloring_csp", 10)])
@pytest.mark.parametrize("algo", ["dba", "gdba"])
def test_breakout_cycles_match_jax(algo, name, cycles):
    raised, x = _run_cycles(name, algo, {}, cycles)
    if name == "secp_small":
        assert raised > 0  # the breakout fired
    else:
        assert len(set(x.tolist())) == 3  # the triangle is coloured


@pytest.mark.parametrize("name", ["secp_small", "meeting_scheduling"])
def test_breakout_building_blocks_match_jax(name):
    """The GDBA and DBA helpers on every bucket of an instance, against
    the JAX ones, exactly: ``factor_min_max``, ``effective_tensor`` (A and
    M), ``violation_mask`` (NZ, NM, MX, on costs that hit each factor's
    minimum and maximum), ``increase_mask`` (E, R, C, T) and
    ``violation_indicator`` — the rules a short run may never fire."""
    import pydcop_tpu.algorithms.dba as jdba
    import pydcop_tpu.algorithms.gdba as jgdba
    from pydcop_tpu_torch.algorithms import dba, gdba

    jt, t = compiled(name)
    rng = np.random.default_rng(8)
    seen = {}
    for b in t.buckets:
        F, a = b.n_factors, b.arity
        base = b.tensors
        jbase = jnp.asarray(base.numpy())
        fmin, fmax = gdba.factor_min_max(base, a)
        jmin, jmax = jgdba.factor_min_max(jbase, a)
        assert np.array_equal(fmin.numpy(), np.asarray(jmin))
        assert np.array_equal(fmax.numpy(), np.asarray(jmax))
        w = rng.integers(0, 4, base.shape).astype(np.float32)
        for modifier in "AM":
            assert np.array_equal(
                gdba.effective_tensor(base, torch.as_tensor(w),
                                      modifier).numpy(),
                np.asarray(jgdba.effective_tensor(jbase, jnp.asarray(w),
                                                  modifier)))
        # current costs at the minimum, the maximum and in between
        pick = rng.integers(0, 3, F)
        cur = np.where(pick == 0, fmin.numpy(), np.where(
            pick == 1, fmax.numpy(), rng.uniform(0, 5, F))).astype(
            np.float32)
        for violation in ("NZ", "NM", "MX"):
            got = gdba.violation_mask(torch.as_tensor(cur), fmin, fmax,
                                      violation).numpy()
            assert np.array_equal(got, np.asarray(jgdba.violation_mask(
                jnp.asarray(cur), jmin, jmax, violation)))
            seen.setdefault(violation, set()).update(got.tolist())
        vals = rng.integers(0, base.shape[1], (F, a))
        for mode in "ERCT":
            assert np.array_equal(
                gdba.increase_mask(base, torch.as_tensor(vals), mode).numpy(),
                np.asarray(jgdba.increase_mask(jbase, jnp.asarray(vals),
                                               mode)))
        assert np.array_equal(dba.violation_indicator(base).numpy(),
                              np.asarray(jdba.violation_indicator(jbase)))
    # each violation test said both yes and no somewhere
    assert all(v == {True, False} for v in seen.values()), seen


@pytest.mark.parametrize("name", ["coloring_csp", "secp_small"])
@pytest.mark.parametrize("algo", ["dba", "gdba"])
def test_solve_matches_jax_from_shared_start(algo, name, monkeypatch):
    dcop, jdcop = load_dcop_from_file(_path(name)), jax_load_dcop(
        _path(name))
    t = tensors_from_numpy(numpy_fields(jax_compile(jdcop)), device="cpu")
    x0 = random_x(t, 9)
    monkeypatch.setattr(_local_search, "random_valid_values",
                        lambda tensors, seed: torch.as_tensor(x0))
    monkeypatch.setattr(jax_ls.LocalSearchSolver, "initial_values",
                        lambda self, key: jnp.asarray(x0))
    ref = jax_solve_result(jdcop, algo)
    got = solve_result(dcop, algo, device="cpu")
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.status == ref.status
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size
    assert set(got.metrics()) == set(ref.metrics())
    assert got.metrics()["config"] == ref.metrics()["config"]


@pytest.mark.parametrize("algo", ["dba", "gdba"])
def test_algorithm_module_contract(algo):
    from pydcop_tpu_torch.graph import load_graph_module

    mod, jmod = load_algorithm_module(algo), jax_algo_module(algo)
    assert [(p.name, p.type, p.values, p.default_value)
            for p in mod.algo_params] == \
        [(p.name, p.type, p.values, p.default_value)
         for p in jmod.algo_params]
    graph = load_graph_module(mod.GRAPH_TYPE).build_computation_graph(
        load_dcop_from_file(_path("graph_coloring_tuto")))
    for node in graph.nodes:
        assert mod.computation_memory(node) == jmod.computation_memory(node)
        assert mod.communication_load(node) == jmod.communication_load(node)
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    solver = mod.build_solver(dcop, device="cpu")
    assert solver.packed is None  # the generic engine only
    assert solver.msgs_per_cycle == 2 * solver.tensors.n_pairs
    with pytest.raises(TypeError):
        mod.build_solver(dcop, device="cpu", use_packed=True)
    for precision in ("bf16", "int8"):
        with pytest.raises(NotPortedError):
            solve_result(dcop, algo, device="cpu",
                         algo_params={"precision": precision})


def test_runs_repeat_and_stop_cycle():
    dcop = load_dcop_from_file(_path("coloring_csp"))
    for algo in ("dba", "gdba"):
        a = solve_result(dcop, algo, cycles=12, device="cpu")
        b = solve_result(dcop, algo, device="cpu",
                         algo_params={"stop_cycle": 12})
        assert a.cycle == b.cycle == 12 and a.assignment == b.assignment
        assert a.msg_count == 12 * 2 * load_algorithm_module(
            algo).build_solver(dcop, device="cpu").tensors.n_pairs


@pytest.mark.parametrize("algo", ["dba", "gdba"])
def test_cli_solve_on_cpu(algo):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", algo,
         "--device", "cpu", _path("coloring_csp")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["status"] == "FINISHED" and res["cost"] == 0
    assert res["config"]["algo"] == algo
    assert set(res) == set(jax_solve_result(
        jax_load_dcop(_path("coloring_csp")), algo).metrics())
    own = solve_result(load_dcop_from_file(_path("coloring_csp")), algo,
                       device="cpu")
    assert res["assignment"] == own.assignment and res["cycle"] == own.cycle
