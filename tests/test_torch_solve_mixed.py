"""Mixed-arity graphs end to end: the port's solvers with
``use_packed=True`` on the CPU (the mixed layout through the kernels'
plain versions) against the JAX package's solvers built with
``use_packed=True`` (its mixed Pallas kernels in interpret mode), on the
two mixed-arity test instances.

* maxsum at noise 0: assignment, cost, violation, status and stop cycle
  equal.  The two packages' generic engines, their CPU default on these
  graphs, are held to each other in ``tests/test_torch_solve.py``; the
  packed and generic engines add in another order and part on
  ``secp_small`` (cycle 42, cost 4.223333 against cycle 35, 3.713333).
* mgm and dsa from one numpy-made start; dsa's coins are the ones the
  JAX harness draws (``key, sub = split(key)``, one ``uniform(key_t,
  (V,))`` per cycle of a chunk), fed to the port through its
  ``draw_uniforms`` hook — the JAX packed path draws its coins inside its
  fused chunk runner, where the generic cycle's hook of
  ``tests/test_torch_solve_local_search.py`` does not reach.  7 cycles:
  a prime chunk, so the JAX runner fuses one cycle per kernel call (its
  fused kernels unroll 5, 4, 3 or 2 cycles when they divide the chunk,
  which takes seconds to trace in interpret mode).

It also holds the port's copy of the SECP generator to the JAX
package's.  The engine choice on mixed graphs is pinned beside each
solver's other tests (``test_torch_solve*.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.ops import compile as jcompile
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import compile as tcompile

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = ["ising_grid", "secp_small"]
CYCLES = 7


def _path(name):
    return os.path.join(ROOT, "tests", "instances", name + ".yaml")


def _same(got, ref):
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.status == ref.status
    assert got.cycle == ref.cycle
    assert got.msg_count == ref.msg_count and got.msg_size == ref.msg_size


@pytest.mark.parametrize("name", MIXED)
def test_packed_maxsum_matches_jax_packed(name):
    params = {"noise": 0}
    jdcop, dcop = jax_load_dcop(_path(name)), load_dcop_from_file(
        _path(name))
    jdef = JaxAlgorithmDef.build_with_default_params(
        "maxsum", params, mode=jdcop.objective)
    jmod = jax_algo_module("maxsum")
    jsolver = jmod.MaxSumSolver(jdcop, jcompile.compile_factor_graph(jdcop),
                                jdef, seed=0, use_packed=True)
    assert jsolver.packed is not None and jsolver.packed.mixed
    solver = load_algorithm_module("maxsum").build_solver(
        dcop, None, AlgorithmDef.build_with_default_params(
            "maxsum", params, mode=dcop.objective),
        device="cpu", use_packed=True)
    assert solver.packed is not None and solver.packed.mixed is not None
    _same(solver.run(), jsolver.run())


class _JaxStream:
    """The uniforms the JAX harness draws, chunk by chunk, from
    ``PRNGKey(seed)``: the port's ``draw_uniforms`` hook."""

    def __init__(self, seed, V):
        self.key, self.V = jax.random.PRNGKey(seed), V

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, n)
        u = np.stack([np.asarray(jax.random.uniform(k, (self.V,)))
                      for k in keys])
        return torch.from_numpy(u)


@pytest.mark.parametrize("algo", ["mgm", "dsa"])
@pytest.mark.parametrize("name", MIXED)
def test_packed_local_search_matches_jax_packed(name, algo):
    params = {"probability": 0.7} if algo == "dsa" else {}
    jdcop, dcop = jax_load_dcop(_path(name)), load_dcop_from_file(
        _path(name))
    rng = np.random.default_rng(3)
    sizes = [len(dcop.variables[n].domain) for n in sorted(dcop.variables)]
    x0 = (rng.uniform(0, 1, len(sizes)) * np.array(sizes)).astype(np.int32)
    jmod = jax_algo_module(algo)
    cls = {"mgm": "MgmSolver", "dsa": "DsaSolver"}[algo]
    jsolver = getattr(jmod, cls)(
        jdcop, jcompile.compile_constraint_graph(jdcop),
        JaxAlgorithmDef.build_with_default_params(algo, params,
                                                  mode=jdcop.objective),
        seed=0, use_packed=True)
    assert jsolver.packed is not None and jsolver.packed.mixed
    jsolver.initial_state = lambda: (jnp.asarray(x0),)
    solver = load_algorithm_module(algo).build_solver(
        dcop, None, AlgorithmDef.build_with_default_params(
            algo, params, mode=dcop.objective),
        seed=0, device="cpu", use_packed=True)
    assert solver.packed is not None and solver.packed.pg.mixed is not None
    solver.initial_state = lambda: (torch.as_tensor(x0),)
    solver.draw_uniforms = _JaxStream(0, len(x0))
    _same(solver.run(cycles=CYCLES), jsolver.run(cycles=CYCLES))


def test_packed_run_on_the_cpu_counts_no_launch():
    from pydcop_tpu_torch.ops import packed_local_search as P
    from pydcop_tpu_torch.ops.packed_maxsum import packed_cycles

    dcop = load_dcop_from_file(_path("secp_small"))
    for algo in ("maxsum", "mgm", "dsa"):
        solver = load_algorithm_module(algo).build_solver(
            dcop, device="cpu", use_packed=True)
        assert solver.run(cycles=5).cycle == 5
    assert packed_cycles.mixed_launches == 0
    assert P.packed_local_tables.mixed_launches == 0
    assert P.packed_dsa_cycles.mixed_launches == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_secp_generator_matches_jax(seed):
    from pydcop_tpu.generators.secp import generate_secp as jax_secp
    from pydcop_tpu_torch.generators import generate_secp

    kw = dict(n_lights=30, n_models=9, n_rules=6, max_model_size=3,
              seed=seed)
    jd, td = jax_secp(**kw), generate_secp(**kw)
    assert sorted(td.variables) == sorted(jd.variables)
    for n, c in td.constraints.items():
        assert [v.name for v in c.dimensions] == \
            [v.name for v in jd.constraints[n].dimensions]
    assert sorted(td.constraints) == sorted(jd.constraints)
    assert sorted(a.name for a in td.agents.values()) == \
        sorted(a.name for a in jd.agents.values())
    for name, a in td.agents.items():
        ja = jd.agents[name]
        for v in list(td.variables)[:10] + list(td.constraints)[:10]:
            assert a.hosting_cost(v) == ja.hosting_cost(v)
    ref = tcompile.numpy_fields(jcompile.compile_factor_graph(jd))
    got = tcompile.numpy_fields(tcompile.compile_factor_graph(
        td, device="cpu"))
    assert got["var_names"] == ref["var_names"]
    assert np.array_equal(got["unary_costs"], ref["unary_costs"])
    assert len(got["buckets"]) == len(ref["buckets"])
    for gb, rb in zip(got["buckets"], ref["buckets"]):
        assert gb["arity"] == rb["arity"]
        assert np.array_equal(gb["var_idx"], rb["var_idx"])
        assert np.array_equal(gb["tensors"], rb["tensors"])
