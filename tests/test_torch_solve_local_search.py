"""``solve -a mgm|dsa|dsatuto|mixeddsa|adsa``: the port's solvers on the
CPU against the JAX package's, end to end through each solver's ``run``.

The two packages draw their random numbers from different generators
(``jax.random`` there, CPU ``torch.Generator``s here), so a parity run
starts both solvers from one numpy-made assignment (``initial_state``)
and feeds both the same numpy-made coins: the port through its
``draw_uniforms`` hook, the JAX solver through a test subclass whose
cycle reads row t of the same table where its module would call
``jax.random.uniform`` (the JAX package itself is not changed).  MGM and
DSA at p=1.0 draw on no coin at all.  Then the assignment, cost,
violation, status, stop cycle, message counts, metric keys and executed
config must be equal.  DSA with its own coins at p=0.7 is held to the
JAX package statistically: mean final cost over 8 seeds within 10%.
"""
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
BINARY = {"coloring_csp", "coloring_intention", "graph_coloring_tuto",
          "meeting_scheduling"}
#: algorithm → parameters of the parity runs (coins shared where drawn)
ALGOS = {
    "mgm": {},
    "dsa": {"probability": 1.0},
    "dsa-p0.7-C": {"probability": 0.7, "variant": "C"},
    "dsatuto": {},
    "mixeddsa": {"proba_hard": 0.9, "proba_soft": 0.4},
    "adsa": {"activation": 0.6, "probability": 0.8},
}
#: the longest run a parity test can make (2,000-cycle cap + a chunk)
MAX_ROWS = 2100


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


class _Coins:
    """One numpy-made table of coins per draw kind, shared by both
    packages: ``move`` for every DSA-family cycle, ``wake`` for adsa."""

    def __init__(self, V, seed=5):
        rng = np.random.default_rng(seed)
        self.move = rng.uniform(0, 1, (MAX_ROWS, V)).astype(np.float32)
        self.wake = rng.uniform(0, 1, (MAX_ROWS, V)).astype(np.float32)

    def port_hook(self, wake_coins):
        """``draw_uniforms(n)`` for the port: the next n rows of each
        table, in the solver's draw order ((wake, move) for adsa)."""
        kinds = ["wake", "move"] if wake_coins else ["move"]
        pos = {"wake": 0, "move": 0}
        calls = [0]

        def draw(n):
            kind = kinds[calls[0] % len(kinds)]
            calls[0] += 1
            rows = getattr(self, kind)[pos[kind]: pos[kind] + n]
            pos[kind] += n
            return torch.from_numpy(rows.copy())

        return draw


def _share_coins_with_jax(solver, coins, x0):
    """Make the JAX solver's state (x, t) and let its own cycle read row
    t of the shared tables wherever its module draws a uniform."""
    module = sys.modules[type(solver).cycle.__module__]
    wake_key, move_key = object(), object()
    move, wake = jnp.asarray(coins.move), jnp.asarray(coins.wake)
    base = type(solver)

    class Shared(base):
        def initial_state(self):
            return (jnp.asarray(x0), jnp.int32(0))

        def cycle(self, state, key):
            x, t = state

            def uniform(k, shape):
                return wake[t] if k is wake_key else move[t]

            real = module.jax
            module.jax = types.SimpleNamespace(random=types.SimpleNamespace(
                uniform=uniform, split=lambda k: (wake_key, move_key)))
            try:
                (x2,) = base.cycle(self, (x,), key)
            finally:
                module.jax = real
            return (x2, t + 1)

    solver.__class__ = Shared


def _initial_x(dcop, seed):
    rng = np.random.default_rng(seed)
    sizes = [len(dcop.variables[n].domain) for n in sorted(dcop.variables)]
    return (rng.uniform(0, 1, len(sizes)) * np.array(sizes)).astype(np.int32)


def _run_both(name, label, cycles=None, seed=0):
    algo = label.split("-")[0]
    params = ALGOS[label]
    jdcop, dcop = jax_load_dcop(_path(name)), load_dcop_from_file(
        _path(name))
    x0 = _initial_x(dcop, seed)
    jmod, mod = jax_algo_module(algo), load_algorithm_module(algo)
    jdef = JaxAlgorithmDef.build_with_default_params(
        algo, params, mode=jdcop.objective)
    tdef = AlgorithmDef.build_with_default_params(
        algo, params, mode=dcop.objective)
    jsolver = jmod.build_solver(jdcop, None, jdef, seed=seed)
    solver = mod.build_solver(dcop, None, tdef, seed=seed, device="cpu")
    coins = _Coins(len(x0))
    if algo == "mgm" or params.get("probability") == 1.0:
        jsolver.initial_state = lambda: (jnp.asarray(x0),)
    else:
        _share_coins_with_jax(jsolver, coins, x0)
        solver.draw_uniforms = coins.port_hook(algo == "adsa")
    solver.initial_state = lambda: (torch.as_tensor(x0),)
    return jsolver.run(cycles=cycles), solver.run(cycles=cycles), solver


@pytest.mark.parametrize("label", sorted(ALGOS))
@pytest.mark.parametrize("name", NAMES)
def test_solver_matches_jax_from_shared_start(name, label):
    ref, got, _ = _run_both(name, label)
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.status == ref.status
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size
    assert set(got.metrics()) == set(ref.metrics())
    assert set(got.metrics()["harness"]) == set(ref.metrics()["harness"])
    assert got.metrics()["config"] == ref.metrics()["config"]


@pytest.mark.parametrize("label", ["mgm", "dsa-p0.7-C", "adsa"])
def test_fixed_cycles_match_jax(label):
    ref, got, _ = _run_both("meeting_scheduling", label, cycles=30, seed=2)
    assert got.cycle == ref.cycle == 30
    assert got.assignment == ref.assignment


@pytest.mark.parametrize("name", NAMES)
def test_engine_choice(name):
    for algo in ("mgm", "dsa"):
        solver = load_algorithm_module(algo).build_solver(
            load_dcop_from_file(_path(name)), device="cpu")
        assert (solver.packed is not None) == (name in BINARY)


@pytest.mark.parametrize("algo", ["mgm", "dsa", "dsatuto", "mixeddsa",
                                  "adsa"])
def test_engine_choice_mixed_with_use_packed(algo):
    """use_packed=True packs a mixed-arity graph on the CPU too; False
    never packs, not even an all-binary graph."""
    mod = load_algorithm_module(algo)
    for name in sorted(set(NAMES) - BINARY):
        dcop = load_dcop_from_file(_path(name))
        solver = mod.build_solver(dcop, device="cpu", use_packed=True)
        assert solver.packed is not None
        assert solver.packed.pg.mixed is not None
    tuto = load_dcop_from_file(_path("graph_coloring_tuto"))
    assert mod.build_solver(tuto, device="cpu",
                            use_packed=False).packed is None


@pytest.mark.parametrize("algo", ["mgm", "dsa"])
def test_packed_and_generic_engines_agree(algo):
    """Same seed, same coins: the packed engine (plain versions on the
    CPU) and the generic engine take the same run on an integer-cost
    instance."""
    from test_torch_local_search import build_dcop

    import pydcop_tpu_torch.dcop as tpkg

    mod = load_algorithm_module(algo)
    cls = mod.MgmSolver if algo == "mgm" else mod.DsaSolver
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph

    dcop = build_dcop(tpkg, V=30, F=70, kind="int", seed=11)
    algo_def = AlgorithmDef.build_with_default_params(algo)
    res = []
    for packed in (True, False):
        s = cls(dcop, compile_constraint_graph(dcop, device="cpu"),
                algo_def, seed=4)
        assert s.packed is not None
        if not packed:
            s.packed = None  # the generic engine
        res.append(s.run(cycles=20))
    assert res[0].assignment == res[1].assignment
    assert res[0].cost == res[1].cost


def test_dsa_matches_jax_statistically():
    """DSA-B at p=0.7 with each package's own coins: the mean final cost
    over 8 seeds on the 40-variable colouring agrees within 10%."""
    from test_torch_local_search import build_dcop

    import pydcop_tpu.dcop as jpkg
    import pydcop_tpu_torch.dcop as tpkg

    jdcop, dcop = build_dcop(jpkg), build_dcop(tpkg)
    jc = [jax_solve_result(jdcop, "dsa", seed=s).cost for s in range(8)]
    tc = [solve_result(dcop, "dsa", seed=s, device="cpu").cost
          for s in range(8)]
    assert np.mean(tc) == pytest.approx(np.mean(jc), rel=0.10)


def test_runs_repeat_and_seeds_differ():
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    a = solve_result(dcop, "dsa", cycles=9, seed=1, device="cpu")
    solver = load_algorithm_module("dsa").build_solver(dcop, seed=1,
                                                       device="cpu")
    assert solver.run(cycles=9).assignment == a.assignment
    assert solver.run(cycles=9).assignment == a.assignment  # coins reseed
    x1 = solver.initial_state()[0]
    x2 = load_algorithm_module("dsa").build_solver(
        load_dcop_from_file(_path("secp_small")), seed=1,
        device="cpu").initial_state()[0]
    assert x1.dtype == x2.dtype == torch.int32


@pytest.mark.parametrize("algo", ["mgm", "dsa"])
def test_cli_solve_on_cpu(algo):
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", algo,
         "--device", "cpu", _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["status"] == "FINISHED"
    ref = jax_solve_result(jax_load_dcop(_path("graph_coloring_tuto")),
                           algo).metrics()
    assert set(res) == set(ref)
    assert res["config"]["algo"] == algo
    own = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                       algo, device="cpu")
    assert res["cost"] == own.cost and res["assignment"] == own.assignment


def test_unported_options_refuse():
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph, \
        local_cost_tables

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    for algo in ("mgm", "dsa", "mixeddsa", "adsa"):
        with pytest.raises(NotPortedError):
            solve_result(dcop, algo, device="cpu",
                         algo_params={"precision": "bf16"})
    # the weighted tables of dba/gdba are ported: they equal the JAX
    # package's
    from pydcop_tpu.ops.compile import compile_constraint_graph as jax_cg
    from pydcop_tpu.ops.compile import local_cost_tables as jax_tables

    t = compile_constraint_graph(dcop, device="cpu")
    jt = jax_cg(jax_load_dcop(_path("graph_coloring_tuto")))
    x = torch.zeros(t.n_vars, dtype=torch.int32)
    w = torch.arange(1, t.n_factors + 1, dtype=torch.float32)
    assert np.array_equal(
        local_cost_tables(t, x, factor_weights=w).numpy(),
        np.asarray(jax_tables(jt, jnp.asarray(x.numpy()),
                              factor_weights=jnp.asarray(w.numpy()))))
    doubled = [b.tensors * 2 for b in t.buckets]
    assert np.array_equal(
        local_cost_tables(t, x, bucket_tensors=doubled).numpy(),
        np.asarray(jax_tables(jt, jnp.asarray(x.numpy()), bucket_tensors=[
            jnp.asarray(b.numpy()) for b in doubled])))
