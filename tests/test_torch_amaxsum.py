"""``amaxsum`` in the port: the single-device solver
(``algorithms/amaxsum.py``, the generic engine with a per-edge activation
mask) and the sharded engine's activation branch
(``ShardedMaxSum(activation=...)``, K7's activation kernel; its plain
version here), against the JAX package on the CPU.

The two packages draw their masks from different generators
(``jax.random`` there, CPU ``torch.Generator``s here), so parity runs
share the uniforms:

* one device: one numpy-made ``(E,)`` uniform row per cycle, fed to the
  port through ``AMaxSumSolver.draw_uniforms`` and to the JAX solver by a
  test subclass whose ``cycle`` reads row t where its module calls
  ``jax.random.uniform`` (the JAX package itself is not changed).  At
  noise 0 the assignment, cost, violation, status, stop cycle and
  message count are equal, and q, r within atol 1e-4 after 5 cycles;
* sharded: the uniforms JAX's generic sharded engine draws
  (``pydcop_tpu/parallel/mesh.py:803-809``: per cycle, ``fold_in(key,
  shard)``, one row per shard-local edge), mapped to the port's slots
  through ``slot_of``.  The port's rotated schedule applies cycle n's
  mask at launch n+1; the values after 8 cycles equal the generic
  engine's exactly.  The JAX package's own semantic pins hold too:
  activation -> 1 equals the engine without activation exactly, and 0.6
  changes the result.
"""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import dcop_yaml
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.generators import generate_graph_coloring
from pydcop_tpu.generators.secp import generate_secp
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
from pydcop_tpu.parallel.partition import partition_factors as \
    jax_partition
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.distribution import Distribution, yaml_dist
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel import ShardedMaxSum, build_mesh
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "graph_coloring_tuto", "meeting_scheduling",
         "secp_small"]
#: the longest run a parity test can make (2,000-cycle cap + a chunk)
MAX_ROWS = 2100


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _full_distribution(dcop, n_agents, cls):
    """Round-robin placement of all computations (vars + constraints),
    as ``tests/test_torch_sharded.py`` places them."""
    comps = sorted(dcop.variables) + sorted(dcop.constraints)
    agents = [f"a{i:02d}" for i in range(n_agents)]
    mapping = {a: [] for a in agents}
    for i, c in enumerate(comps):
        mapping[agents[i % n_agents]].append(c)
    return cls(mapping)


def _share_uniforms_with_jax(solver, U):
    """Make the JAX solver's state (q, r, values, t) and let its own
    cycle read row t of ``U`` where its module draws the mask's
    uniforms."""
    module = sys.modules[type(solver).cycle.__module__]
    table = jnp.asarray(U)
    base = type(solver)

    class Shared(base):
        def initial_state(self):
            return base.initial_state(self) + (jnp.int32(0),)

        def cycle(self, state, key):
            q, r, values, t = state

            def uniform(k, shape):
                return table[t][:, None]

            real = module.jax
            module.jax = types.SimpleNamespace(
                random=types.SimpleNamespace(uniform=uniform))
            try:
                out = base.cycle(self, (q, r, values), key)
            finally:
                module.jax = real
            return out + (t + 1,)

    solver.__class__ = Shared


def _port_hook(U):
    pos = [0]

    def draw(n):
        rows = U[pos[0]: pos[0] + n]
        pos[0] += n
        return torch.from_numpy(rows.copy())

    return draw


def _pair(name, params, seed=0):
    jdcop, dcop = jax_load_dcop(_path(name)), load_dcop_from_file(
        _path(name))
    params = {"noise": 0, **params}
    jdef = JaxAlgorithmDef.build_with_default_params(
        "amaxsum", params, mode=jdcop.objective)
    tdef = AlgorithmDef.build_with_default_params(
        "amaxsum", params, mode=dcop.objective)
    jsolver = jax_algo_module("amaxsum").build_solver(jdcop, None, jdef,
                                                      seed=seed)
    solver = load_algorithm_module("amaxsum").build_solver(
        dcop, None, tdef, seed=seed, device="cpu")
    E = solver.tensors.n_edges
    assert E == jsolver.tensors.n_edges
    U = np.random.default_rng(7).uniform(0, 1, (MAX_ROWS, E)).astype(
        np.float32)
    _share_uniforms_with_jax(jsolver, U)
    solver.draw_uniforms = _port_hook(U)
    return jsolver, solver, U


@pytest.mark.parametrize("cycles", [None, 30])
@pytest.mark.parametrize("params", [{}, {"activation": 0.4,
                                         "damping": 0.0}])
@pytest.mark.parametrize("name", NAMES)
def test_amaxsum_matches_jax_with_shared_masks(name, params, cycles):
    jsolver, solver, _ = _pair(name, params)
    ref, got = jsolver.run(cycles=cycles), solver.run(cycles=cycles)
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert (got.violation, got.status, got.cycle, got.msg_count) == (
        ref.violation, ref.status, ref.cycle, ref.msg_count)
    assert got.config["algo"] == "amaxsum"
    assert got.config["engine"] == "harness"


def test_amaxsum_messages_match_jax():
    """q and r after 5 cycles, from the same masks, within atol 1e-4."""
    jsolver, solver, U = _pair("secp_small", {})
    jstate = jsolver.initial_state()
    key = jax.random.PRNGKey(0)
    for _ in range(5):
        jstate = jsolver.cycle(jstate, key)
    q, r, values = solver.run_cycles(solver.initial_state(), 5)
    np.testing.assert_allclose(q.numpy(), np.asarray(jstate[0]), atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(jstate[1]), atol=1e-4)
    assert np.array_equal(values.numpy(), np.asarray(jstate[2]))


def test_amaxsum_params_and_own_masks():
    mod = load_algorithm_module("amaxsum")
    assert [p.name for p in mod.algo_params] == [
        "stop_cycle", "damping", "stability", "noise", "activation",
        "precision"]
    assert mod.DEFAULT_ACTIVATION == 0.7
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    a = solve_result(dcop, "amaxsum", cycles=20, device="cpu")
    b = solve_result(dcop, "amaxsum", cycles=20, device="cpu")
    assert a.assignment == b.assignment  # the masks repeat per seed
    solver = mod.build_solver(dcop, device="cpu")
    assert solver.packed is None  # the generic engine only
    with pytest.raises(NotPortedError):
        solve_result(dcop, "amaxsum", algo_params={"precision": "bf16"},
                     device="cpu")


# -- sharded: the activation branch of K7 -------------------------------------


def _coloring():
    return generate_graph_coloring(n_variables=24, n_colors=3, n_edges=40,
                                   soft=True, n_agents=1, seed=7)


SHARDED = {
    "coloring_24": _coloring,
    "secp3": lambda: generate_secp(n_lights=30, n_models=10, n_rules=6,
                                   max_model_size=2, seed=3),
    "secp4": lambda: generate_secp(n_lights=30, n_models=10, n_rules=6,
                                   max_model_size=3, seed=3),
}


def _jax_generic_uniforms(jax_engine, port, cycles, seed):
    """The uniforms JAX's generic engine draws in ``run(cycles, seed)``
    from a fresh start, per port shard: [cycles, N_s] at the port's
    slots."""
    st = jax_engine.st
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0), cycles)
    out = []
    for s, sh in enumerate(port.packs.shards):
        rows = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, s), (st.edges_per_shard, 1)))[:, 0]
            for k in keys])
        u = np.zeros((cycles, sh.N), dtype=np.float32)
        off = 0
        for sb, asg in zip(st.buckets, st.assigns):
            a, Fs = sb.arity, sb.factors_per_shard
            F_s = int((asg == s).sum())
            if F_s:
                k, p = np.meshgrid(np.arange(F_s), np.arange(a),
                                   indexing="ij")
                # JAX row off + k*a + p  →  port endpoint e = p*F_s + k
                u[:, sh.slot_of[a][(p * F_s + k).ravel()]] = \
                    rows[:, off + (k * a + p).ravel()]
            off += Fs * a
        out.append(torch.as_tensor(u))
    return out


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_amaxsum_matches_jax_generic(name, n_shards):
    jt = jax_compile(SHARDED[name]())
    assigns = jax_partition([np.asarray(b.var_idx) for b in jt.buckets],
                            jt.n_vars, n_shards)
    jax_engine = JaxMaxSum(jt, jax_build_mesh(n_shards), damping=0.5,
                           assigns=assigns, activation=0.6,
                           use_packed=False, overlap="off")
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    port = ShardedMaxSum(t, build_mesh(n_shards, "cpu"), damping=0.5,
                         assigns=assigns, activation=0.6)
    cycles, seed = 8, 11
    jv, _, _ = jax_engine.run(cycles=cycles, seed=seed)
    draws = _jax_generic_uniforms(jax_engine, port, cycles, seed)
    port.draw_uniforms = lambda n: draws
    v, state, _ = port.run(cycles=cycles)
    assert np.array_equal(v, np.asarray(jv))
    # the last cycle's mask waits in the state for the next launch
    for pend, u in zip(state[4], draws):
        assert torch.equal(pend, (u[-1] < 0.6).float())


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_activation_pins(name):
    """The JAX package's semantic pins (its
    ``test_activation_rotated_semantics_pinned``): a mask at 0.6 changes
    the values, an always-active one gives the engine without
    activation exactly; and a run continued through its state equals
    one run of the same masks."""
    t = tensors_from_numpy(numpy_fields(jax_compile(SHARDED[name]())),
                           device="cpu")
    mesh = build_mesh(4, "cpu")
    plain, _, _ = ShardedMaxSum(t, mesh, damping=0.5).run(cycles=6)
    masked = ShardedMaxSum(t, mesh, damping=0.5, activation=0.6)
    va, _, _ = masked.run(cycles=6, seed=11)
    assert (va != plain).any()
    near_one = ShardedMaxSum(t, mesh, damping=0.5, activation=0.9999999)
    vn, _, _ = near_one.run(cycles=6, seed=11)
    assert np.array_equal(vn, plain)
    assert ShardedMaxSum(t, mesh, activation=1.0).activation is None
    draws = masked.draw_uniforms(6)
    masked.draw_uniforms = lambda n: [u[:n] for u in draws]
    v6, _, _ = masked.run(cycles=6)
    _, q3, r3 = masked.run(cycles=3)
    masked.draw_uniforms = lambda n: [u[3:3 + n] for u in draws]
    v33, _, _ = masked.run(cycles=3, q=q3, r=r3)
    assert np.array_equal(v33, v6)
    with pytest.raises(ValueError, match="continuation"):
        ShardedMaxSum(t, mesh).run(cycles=1, q=q3, r=r3)


def _placement_dcop(tmp_path):
    text = dcop_yaml(SHARDED["secp3"]())
    prob = tmp_path / "prob.yaml"
    prob.write_text(text)
    return prob, load_dcop_from_file([str(prob)])


def test_solve_under_placement_runs_amaxsum(tmp_path):
    _, d = _placement_dcop(tmp_path)
    dist = _full_distribution(d, 4, Distribution)
    res = solve_result(d, "amaxsum", distribution=dist, cycles=10,
                       n_shards=4, device="cpu")
    again = solve_result(d, "amaxsum", distribution=dist, cycles=10,
                         n_shards=4, device="cpu")
    plain = solve_result(d, "maxsum", distribution=dist, cycles=10,
                         n_shards=4, device="cpu")
    assert res.status == "FINISHED" and res.cycle == 10
    assert res.assignment == again.assignment
    assert res.config["algo"] == "amaxsum"
    assert res.config["engine"] == "sharded_mesh"
    assert plain.config["algo"] == "maxsum"
    one = solve_result(d, "amaxsum", distribution=dist, cycles=10,
                       n_shards=4, device="cpu",
                       algo_params={"activation": 1.0})
    assert one.assignment == plain.assignment


def test_cli_amaxsum(tmp_path):
    prob, d = _placement_dcop(tmp_path)
    dist = _full_distribution(d, 4, Distribution)
    dist_f = tmp_path / "dist.yaml"
    dist_f.write_text(yaml_dist(dist))
    base = [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a",
            "amaxsum", "--device", "cpu", "--cycles", "10"]
    for extra, want in (
            ([], solve_result(d, "amaxsum", cycles=10, device="cpu")),
            (["-d", str(dist_f)], solve_result(
                d, "amaxsum", distribution=dist, cycles=10, device="cpu"))):
        out = subprocess.run(base + extra + [str(prob)], capture_output=True,
                             text=True, timeout=300, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        data = json.loads(out.stdout)
        assert data["assignment"] == want.assignment
        assert data["cost"] == want.cost and data["cycle"] == 10
