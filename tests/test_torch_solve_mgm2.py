"""``solve -a mgm2``: the port's solver on the CPU against the JAX
package's, end to end through each solver's ``run``.

The two packages draw their random numbers from different generators,
so a parity run starts both solvers from one numpy-made assignment and
feeds both the same numpy-made coins (offer, pick and favor tables): the
port through its ``draw_uniforms`` hook (``chunk_coins`` draws the three
kinds in that order), the JAX solver through a test subclass whose cycle
reads row t of the same tables where its module would call
``jax.random.uniform`` (the JAX package itself is not changed).

On the CPU the JAX package runs its generic cycle.  The port runs its
packed engine on the four all-binary instances (the plain version of the
kernel, which repeats the JAX Pallas kernel's arithmetic) and its generic
cycle on the two mixed-arity ones.  No instance shows the float32
reassociation gap between the two JAX engines, so the port is held to
the generic JAX run everywhere: assignment, cost, violation, status,
stop cycle, message counts, metric keys and the executed config.
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
from pydcop_tpu_torch.algorithms import (
    AlgoParameterException,
    AlgorithmDef,
    list_available_algorithms,
    load_algorithm_module,
)
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
FAVORS = ["unilateral", "no", "coordinated"]
#: the longest run a parity test makes (2,000-cycle cap + a chunk)
MAX_ROWS = 2100
KINDS = ("off", "pick", "fav")


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


class _Coins:
    """One numpy-made [MAX_ROWS, V] table per coin kind, shared by both
    packages."""

    def __init__(self, V, seed=5):
        rng = np.random.default_rng(seed)
        self.tables = {k: rng.uniform(0, 1, (MAX_ROWS, V)).astype(np.float32)
                       for k in KINDS}

    def port_hook(self):
        """``draw_uniforms(n)`` for the port: the next n rows of the
        offer, pick and favor tables, in turn."""
        pos = {k: 0 for k in KINDS}
        calls = [0]

        def draw(n):
            kind = KINDS[calls[0] % 3]
            calls[0] += 1
            rows = self.tables[kind][pos[kind]: pos[kind] + n]
            pos[kind] += n
            return torch.from_numpy(rows.copy())

        return draw


def _share_coins_with_jax(solver, coins, x0):
    """Make the JAX solver's state (x, t) and let its own cycle read row
    t of the shared tables where its module draws each uniform."""
    module = sys.modules[type(solver).cycle.__module__]
    keys = {k: object() for k in KINDS}
    tables = {id(keys[k]): jnp.asarray(coins.tables[k]) for k in KINDS}
    base = type(solver)

    class Shared(base):
        def initial_state(self):
            return (jnp.asarray(x0), jnp.int32(0))

        def cycle(self, state, key):
            x, t = state

            def uniform(k, shape):
                return tables[id(k)][t]

            real = module.jax
            module.jax = types.SimpleNamespace(random=types.SimpleNamespace(
                uniform=uniform,
                split=lambda k, n: tuple(keys[c] for c in KINDS)))
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


def _run_both(name, params, cycles=None, seed=0):
    jdcop, dcop = jax_load_dcop(_path(name)), load_dcop_from_file(
        _path(name))
    x0 = _initial_x(dcop, seed)
    jdef = JaxAlgorithmDef.build_with_default_params(
        "mgm2", params, mode=jdcop.objective)
    tdef = AlgorithmDef.build_with_default_params(
        "mgm2", params, mode=dcop.objective)
    jsolver = jax_algo_module("mgm2").build_solver(jdcop, None, jdef,
                                                   seed=seed)
    solver = load_algorithm_module("mgm2").build_solver(
        dcop, None, tdef, seed=seed, device="cpu")
    coins = _Coins(len(x0))
    _share_coins_with_jax(jsolver, coins, x0)
    solver.draw_uniforms = coins.port_hook()
    solver.initial_state = lambda: (torch.as_tensor(x0),)
    return jsolver.run(cycles=cycles), solver.run(cycles=cycles), solver


@pytest.mark.parametrize("favor", FAVORS)
@pytest.mark.parametrize("name", NAMES)
def test_solver_matches_jax_from_shared_start(name, favor):
    ref, got, solver = _run_both(name, {"favor": favor})
    assert (solver.packed is not None) == (name in BINARY)
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.status == ref.status
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size
    assert set(got.metrics()) == set(ref.metrics())
    assert set(got.metrics()["harness"]) == set(ref.metrics()["harness"])
    assert got.metrics()["config"] == ref.metrics()["config"]


@pytest.mark.parametrize("name", sorted(set(NAMES) - BINARY))
def test_mixed_graph_keeps_the_generic_engine(name, monkeypatch):
    """MGM-2 picks its engine on a mixed-arity graph as the rest of the
    local-search family: on the CPU the default (None) and False keep
    the generic engine (the solver asks ``solver_layout`` with the flag
    as given), while True packs the mixed layout and
    ``pack_mgm2_from_pls`` returns its mixed statics."""
    from pydcop_tpu_torch.algorithms import _local_search
    from pydcop_tpu_torch.ops.packed_local_search import pack_local_search
    from pydcop_tpu_torch.ops.packed_mgm2 import pack_mgm2_from_pls

    dcop = load_dcop_from_file(_path(name))
    asked = []
    layout = _local_search.solver_layout
    monkeypatch.setattr(_local_search, "solver_layout",
                        lambda t, use_packed: asked.append(use_packed)
                        or layout(t, use_packed))
    mod = load_algorithm_module("mgm2")
    for use_packed in (None, False):
        solver = mod.build_solver(dcop, device="cpu", use_packed=use_packed)
        assert solver.packed is None and solver.packed_mgm2 is None
    assert asked == [None, False]
    solver = mod.build_solver(dcop, device="cpu", use_packed=True)
    assert asked == [None, False, True]
    pm = solver.packed_mgm2
    assert pm is not None and pm.pls is solver.packed
    assert pm.pls.pg.mixed is not None
    pls = pack_local_search(solver.tensors)
    again = pack_mgm2_from_pls(pls)
    assert pls.pg.mixed is not None and again is not None
    for a, b in ((again.pick_rank, pm.pick_rank), (again.edge_id, pm.edge_id),
                 (again.deg_col, pm.deg_col)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threshold", [0.2, 0.9])
def test_fixed_cycles_and_threshold_match_jax(threshold):
    ref, got, _ = _run_both("meeting_scheduling",
                            {"favor": "coordinated", "threshold": threshold},
                            cycles=30, seed=2)
    assert got.cycle == ref.cycle == 30
    assert got.assignment == ref.assignment


def test_packed_and_generic_engines_agree_on_integer_costs():
    """Same seed, same coins: the packed engine (plain version on the
    CPU) and the generic cycle take the same run on an integer-cost
    colouring, where the two associations of the joint table agree."""
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from test_torch_local_search import build_dcop

    mod = load_algorithm_module("mgm2")
    dcop = build_dcop(tpkg, V=30, F=70, kind="int", seed=11)
    algo_def = AlgorithmDef.build_with_default_params(
        "mgm2", {"favor": "coordinated"})
    res = []
    for packed in (True, False):
        s = mod.Mgm2Solver(dcop, compile_constraint_graph(dcop, device="cpu"),
                           algo_def, seed=4)
        assert s.packed is not None
        if not packed:
            s.packed = None  # the generic engine
        res.append(s.run(cycles=20))
    assert res[0].assignment == res[1].assignment
    assert res[0].cost == res[1].cost


def test_coins_draw_three_kinds_whatever_favor():
    """Every favor draws offer, pick and favor coins in that order, so
    runs with different favors see the same offers and picks."""
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    draws = {}
    for favor in FAVORS:
        solver = load_algorithm_module("mgm2").build_solver(
            dcop, None, AlgorithmDef.build_with_default_params(
                "mgm2", {"favor": favor}), seed=3, device="cpu")
        solver.coins.manual_seed(3)
        draws[favor] = solver.chunk_coins(5)
        assert len(draws[favor]) == 3
    for favor in FAVORS[1:]:
        for a, b in zip(draws[favor], draws[FAVORS[0]]):
            assert torch.equal(a, b)


def test_runs_repeat_and_seeds_differ():
    dcop = load_dcop_from_file(_path("meeting_scheduling"))
    a = solve_result(dcop, "mgm2", cycles=9, seed=1, device="cpu")
    solver = load_algorithm_module("mgm2").build_solver(dcop, seed=1,
                                                        device="cpu")
    assert solver.run(cycles=9).assignment == a.assignment
    assert solver.run(cycles=9).assignment == a.assignment  # coins reseed
    assert a.msg_count == 9 * 5 * solver.tensors.n_pairs


def test_algorithm_module_contract():
    from pydcop_tpu_torch.graph import load_graph_module

    assert "mgm2" in list_available_algorithms()
    mod = load_algorithm_module("mgm2")
    jmod = jax_algo_module("mgm2")
    assert [(p.name, p.type, p.values, p.default_value)
            for p in mod.algo_params] == \
        [(p.name, p.type, p.values, p.default_value)
         for p in jmod.algo_params]
    graph = load_graph_module(mod.GRAPH_TYPE).build_computation_graph(
        load_dcop_from_file(_path("graph_coloring_tuto")))
    for node in graph.nodes:
        assert mod.computation_memory(node) == 2.0 * len(node.neighbors)
        assert mod.communication_load(node) == \
            float(len(node.variable.domain)) ** 2


def test_unported_options_refuse():
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    for precision in ("bf16", "int8"):
        with pytest.raises(NotPortedError):
            solve_result(dcop, "mgm2", device="cpu",
                         algo_params={"precision": precision})
    with pytest.raises(AlgoParameterException):
        solve_result(dcop, "mgm2", device="cpu",
                     algo_params={"favor": "sometimes"})


def test_cli_solve_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "mgm2",
         "-p", "favor:coordinated", "-p", "threshold:0.7", "--device", "cpu",
         _path("graph_coloring_tuto")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout)
    assert res["status"] == "FINISHED"
    ref = jax_solve_result(jax_load_dcop(_path("graph_coloring_tuto")),
                           "mgm2").metrics()
    assert set(res) == set(ref)
    assert res["config"]["algo"] == "mgm2"
    own = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                       "mgm2", device="cpu",
                       algo_params={"favor": "coordinated",
                                    "threshold": 0.7})
    assert res["cost"] == own.cost and res["assignment"] == own.assignment


def test_cuda_by_default_raises_without_gpu(monkeypatch):
    from pydcop_tpu_torch.errors import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    mod = load_algorithm_module("mgm2")
    for call in (lambda: solve_result(dcop, "mgm2"),
                 lambda: solve_result(dcop, "mgm2", device="cuda"),
                 lambda: mod.build_solver(dcop)):
        with pytest.raises(DeviceUnavailableError):
            call()
