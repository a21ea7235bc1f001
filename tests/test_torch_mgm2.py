"""The port's MGM-2 engine against the JAX package, on the same
numpy-made inputs.

* pairing statics: ``pick_rank``, ``edge_id`` and the pair degree equal
  the JAX package's ``pack_mgm2_from_pls`` per edge endpoint and per
  variable;
* packed engine: the plain version of the port's ``packed_mgm2_cycles``
  against the JAX Pallas kernel run in interpret mode, from one x and one
  set of coins — bit for bit in x (the plain version repeats the Pallas
  kernel's arithmetic, ``A_i + (A_j + M)``);
* generic engine: ``Mgm2Solver.cycle`` against the JAX package's generic
  cycle with the same coins, on mixed-arity instances — bit for bit
  (both keep the generic association ``(A_i + A_j) + M``).

The JAX kernel's rows are lane-padded ``[1, Vp]`` in its own column
order: :func:`jax_rows` puts variable-order rows there, and
:func:`jax_var_order` / :func:`jax_endpoint_order` take its rows back to
variable order or edge-endpoint order (``var_order`` /
``slot_of_edge``), where the port's own packing (``pack_x``,
``pack_uniforms``) takes the same numpy arrays.

A Pallas interpret call traces and compiles the whole unrolled kernel
(about 2 s a cycle on this layout), so these tests run few cycles.  The
CUDA kernel cannot run here; ``test_kernel_matches_plain_on_gpu`` holds
it against the plain version where a GPU is visible.
"""
import os
import sys
import types
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.ops import pallas_local_search as jpls
from pydcop_tpu.ops import pallas_mgm2 as jmgm2
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops import packed_mgm2 as M
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy

torch.set_num_threads(1)

INSTANCES = os.path.join(os.path.dirname(__file__), "instances")
FAVORS = ["unilateral", "no", "coordinated"]


def coloring_dcop(seed):
    """The JAX MGM-2 tests' ``_coloring_dcop``: 40 variables, 100
    soft 3-colouring constraints."""
    from pydcop_tpu.generators import generate_graph_coloring

    return generate_graph_coloring(n_variables=40, n_colors=3, n_edges=100,
                                   soft=True, n_agents=1, seed=seed)


def unequal_dcop():
    """Odd variables take 2 of the 3 values; integer costs."""
    import pydcop_tpu.dcop as pkg
    from test_torch_local_search import build_dcop

    return build_dcop(pkg, V=40, F=90, kind="unequal", seed=3)


GRAPHS = {"coloring3": lambda: coloring_dcop(3),
          "coloring11": lambda: coloring_dcop(11),
          "unequal": unequal_dcop}


def jax_packed(dcop):
    """The JAX solver's MGM-2 layout, as ``tests/unit/test_pallas_mgm2.py``
    gets it (backend patched to "tpu"), and its compiled graph carried
    into the port's packed layout on the CPU."""
    algo_def = JaxAlgorithmDef.build_with_default_params("mgm2")
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        s = jax_algo_module("mgm2").build_solver(dcop, algo_def=algo_def)
    jpm = s.packed_mgm2
    assert jpm is not None
    t = tensors_from_numpy(numpy_fields(s.tensors), device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    assert pm is not None
    return jpm, pm, t


def jax_rows(jpm, a):
    """[n, V] variable-order rows → the JAX kernel's [n, Vp] rows (pads
    1.0: never an offerer)."""
    pg = jpm.pls.pg
    out = np.ones((a.shape[0], pg.Vp), np.float32)
    out[:, np.asarray(pg.var_order)] = a
    return jnp.asarray(out)


def jax_var_order(jpm, row):
    """A JAX [1, Vp] column row → [V] in variable order."""
    return np.asarray(row)[0, np.asarray(jpm.pls.pg.var_order)]


def jax_endpoint_order(jpm, row):
    """A JAX [1, N] slot row → [2F] in edge-endpoint order (p*F + f)."""
    return np.asarray(row)[0, jpm.pls.pg.slot_of_edge]


def coins(V, n, seed):
    """(u_off, u_pick, u_fav), each [n, V] float32 from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (n, V)).astype(np.float32)
                 for _ in range(3))


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int32)


def run_both(jpm, pm, t, x, u, threshold, favor):
    jp = jpm.pls
    ref = jax_var_order(jpm, jmgm2.packed_mgm2_cycles(
        jpm, jpls.pack_x(jp, jnp.asarray(x)), *(jax_rows(jpm, a) for a in u),
        threshold, favor, interpret=True))
    pls = pm.pls
    got = P.unpack_x(pls, M.packed_mgm2_cycles(
        pm, P.pack_x(pls, x), *(P.pack_uniforms(pls, a) for a in u),
        threshold, favor))
    return ref, got.numpy()


# ---------------------------------------------------------------------------
# pairing statics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pairing_statics_match_jax(graph):
    jpm, pm, t = jax_packed(GRAPHS[graph]())
    soe = pm.pls.pg.slot_of_edge
    assert np.array_equal(pm.pick_rank.numpy()[soe],
                          jax_endpoint_order(jpm, jpm.pick_rank))
    assert np.array_equal(pm.edge_id.numpy()[soe],
                          jax_endpoint_order(jpm, jpm.edge_id))
    assert np.array_equal(pm.deg_col.numpy()[pm.pls.pg.var_order.numpy()],
                          jax_var_order(jpm, jpm.deg_col))
    # pick_rank is the inc[v] order, not the layout's slot rank: on a
    # variable with both sides, side-0 slots come first in the layout
    pg = pm.pls.pg
    k = ((torch.arange(pg.N) - pg.col_slot0.long()[pg.slot_col])
         // pg.col_stride.long()[pg.slot_col])
    assert not torch.equal(k.int(), pm.pick_rank)
    # each column's ranks are a permutation of 0..deg-1
    ranks = M._per_column(pm.pls, pm.pick_rank.long(), torch.add, 0)
    deg = pg.col_deg.long()
    assert torch.equal(ranks, deg * (deg - 1) // 2)


# ---------------------------------------------------------------------------
# the packed engine against the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("favor", FAVORS)
def test_packed_mgm2_matches_jax_kernel(favor, threshold):
    """Every favor × threshold on the first colouring; two cycles at 0.5
    (pairs form), one at 0 (no offers) and 1 (every offer meets an
    offerer)."""
    jpm, pm, t = jax_packed(GRAPHS["coloring3"]())
    n = 2 if threshold == 0.5 else 1
    x = random_x(t, 21)
    ref, got = run_both(jpm, pm, t, x, coins(t.n_vars, n, 5), threshold,
                        favor)
    assert np.array_equal(got, ref)
    assert np.any(got != x)


@pytest.mark.parametrize("favor", FAVORS)
@pytest.mark.parametrize("graph", ["coloring11", "unequal"])
def test_packed_mgm2_matches_jax_kernel_other_graphs(graph, favor):
    jpm, pm, t = jax_packed(GRAPHS[graph]())
    x = random_x(t, 8)
    ref, got = run_both(jpm, pm, t, x, coins(t.n_vars, 1, 9), 0.5, favor)
    assert np.array_equal(got, ref)
    if graph == "unequal":
        valid = t.domain_mask.numpy()[np.arange(t.n_vars), got] > 0
        assert valid.all()


def test_pairs_form_and_thresholds_0_and_1_never_pair():
    """On the hard-cost instance, at threshold 0 (no offerer) and 1 (every
    offer meets an offerer) nothing pairs: the two cycles are equal, for
    every favor.  At 0.5 pairs form and the cycle differs from them."""
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from test_torch_local_search import build_dcop

    t = compile_constraint_graph(build_dcop(tpkg, V=40, F=90, kind="hard"),
                                 device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    differs = 0
    for s in range(6):
        x_col = P.pack_x(pm.pls, random_x(t, s))
        u = [P.pack_uniforms(pm.pls, a)[0]
             for a in coins(t.n_vars, 1, 100 + s)]
        for favor in FAVORS:
            none = M.mgm2_cycle_plain(pm, x_col, *u, 0.0, favor)
            assert torch.equal(
                none, M.mgm2_cycle_plain(pm, x_col, *u, 1.0, favor))
            half = M.mgm2_cycle_plain(pm, x_col, *u, 0.5, favor)
            differs += int((half != none).sum())
    assert differs > 0


def test_wrapper_checks_operands_and_leaves_inputs_alone():
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(2)
    ei = rng.integers(0, 30, 60)
    ej = (ei + 1 + rng.integers(0, 29, 60)) % 30
    t = compile_binary_from_arrays(
        ei, ej, rng.uniform(0, 1, (60, 3, 3)).astype(np.float32), 30,
        device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    x = P.pack_x(pm.pls, random_x(t, 1))
    u = [P.pack_uniforms(pm.pls, a) for a in coins(30, 3, 1)]
    keep = [x.clone()] + [a.clone() for a in u]
    M.packed_mgm2_cycles(pm, x, *u, 0.5, "no")
    for a, b in zip([x] + u, keep):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, *u, 0.5, "sometimes")
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, u[0], u[1][:2], u[2], 0.5)
    with pytest.raises(TypeError):
        M.packed_mgm2_cycles(pm, x.long(), *u, 0.5)
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, *(a[:0] for a in u), 0.5)
    assert M.packed_mgm2_cycles.launches == 0  # nothing launches on a CPU


# ---------------------------------------------------------------------------
# the generic engine against the JAX generic cycle
# ---------------------------------------------------------------------------


def _jax_cycle_with(jsolver, x, u_off, u_pick, u_fav):
    """One JAX generic cycle where each ``jax.random.uniform`` of the
    module reads the given row instead (keys from a patched split)."""
    module = sys.modules[type(jsolver).cycle.__module__]
    keys = (object(), object(), object())
    rows = dict(zip(map(id, keys), map(jnp.asarray, (u_off, u_pick, u_fav))))
    real = module.jax
    module.jax = types.SimpleNamespace(random=types.SimpleNamespace(
        split=lambda k, n: keys, uniform=lambda k, shape: rows[id(k)]))
    try:
        (x2,) = jsolver.cycle((jnp.asarray(x),), None)
    finally:
        module.jax = real
    return np.asarray(x2)


@pytest.mark.parametrize("favor", FAVORS)
@pytest.mark.parametrize("name", ["secp_small", "ising_grid"])
def test_generic_cycle_matches_jax(name, favor):
    from pydcop_tpu.dcop import load_dcop_from_file as jax_load

    jdcop = jax_load(os.path.join(INSTANCES, name + ".yaml"))
    jdef = JaxAlgorithmDef.build_with_default_params(
        "mgm2", {"favor": favor}, mode=jdcop.objective)
    jsolver = jax_algo_module("mgm2").build_solver(jdcop, None, jdef)
    assert jsolver.packed is None
    mod = load_algorithm_module("mgm2")
    t = tensors_from_numpy(numpy_fields(jsolver.tensors), device="cpu")
    solver = mod.Mgm2Solver(None, t, AlgorithmDef.build_with_default_params(
        "mgm2", {"favor": favor}), seed=0)
    assert solver.packed is None and solver.n_pairs == jsolver.n_pairs > 0
    x = random_x(t, 3)
    moved = 0
    for c, (uo, up, uf) in enumerate(zip(*coins(t.n_vars, 4, 40))):
        ref = _jax_cycle_with(jsolver, x, uo, up, uf)
        got = solver.cycle(torch.as_tensor(x), tuple(
            torch.as_tensor(a) for a in (uo, up, uf))).numpy()
        assert np.array_equal(got, ref), f"cycle {c}"
        moved += int((got != x).sum())
        x = got
    assert moved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["coloring", "hard", "unequal"])
def test_kernel_matches_plain_on_gpu(graph):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from test_torch_local_search import build_dcop

    kind = {"coloring": "float"}.get(graph, graph)
    t = compile_constraint_graph(build_dcop(tpkg, V=400, F=1200, kind=kind),
                                 device="cuda")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    x = P.pack_x(pm.pls, random_x(t, 1))
    u = [P.pack_uniforms(pm.pls, a) for a in coins(t.n_vars, 20, 2)]
    for favor in FAVORS:
        for threshold in (0.0, 0.5, 1.0):
            before = M.packed_mgm2_cycles.launches
            k = M.packed_mgm2_cycles(pm, x, *u, threshold, favor)
            assert M.packed_mgm2_cycles.launches == \
                before + 20 * M.LAUNCHES_PER_CYCLE
            p = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
            assert torch.equal(k, p), (favor, threshold)
    torch.cuda.synchronize()
