"""The port's local-search primitives and packed kernels against the JAX
package, on the same numpy-made inputs.

* generic engine: ``local_cost_tables``, ``gains_and_best`` and
  ``neighborhood_winner`` against ``pydcop_tpu``'s on arrays compiled
  once by the JAX package and carried over with ``numpy_fields`` /
  ``tensors_from_numpy`` — exact (the port's ``segment_sum`` adds in the
  XLA CPU order);
* packed engine: the plain versions of the port's ``packed_local_tables``,
  ``packed_mgm_cycles`` and ``packed_dsa_cycles`` against the JAX Pallas
  kernels run in interpret mode, with the same uniforms on both sides.
  Tolerance, as the JAX package pins its own packed-vs-generic equality
  (``tests/unit/test_pallas_local_search.py``): exact tables and x on
  integer-cost instances; on float instances tables within
  1e-5·(1+|t|) and one cycle's values equal outside counted near-ties
  (the two layouts add a column's slots in different orders).

The CUDA kernels cannot run here; ``test_kernels_match_plain_on_gpu``
holds them against the plain versions where a GPU is visible.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pydcop_tpu.algorithms import _local_search as jls
from pydcop_tpu.ops import compile as jcompile
from pydcop_tpu.ops import pallas_local_search as jpls
from pydcop_tpu.ops.pallas_maxsum import pack_for_pallas
from pydcop_tpu.ops.pallas_maxsum import packed_local_tables as \
    jax_packed_local_tables
from pydcop_tpu_torch.algorithms import _local_search as ls
from pydcop_tpu_torch.ops import packed_local_search as pls_mod
from pydcop_tpu_torch.ops.compile import (
    PAD_COST,
    local_cost_tables,
    numpy_fields,
    tensors_from_numpy,
)
from pydcop_tpu_torch.ops.segments import segment_max, segment_min, \
    segment_sum

torch.set_num_threads(1)


def build_dcop(pkg, V=40, F=90, D=3, kind="int", seed=3):
    """A random binary DCOP built from numpy arrays with the DCOP objects
    of ``pkg`` (``pydcop_tpu.dcop`` or ``pydcop_tpu_torch.dcop``):

    * int: integer costs 0..4, +10 on equal values (soft colouring);
    * hard: integer costs 0..1, 10000 on equal values (ties are common,
      so conflicts and lateral moves fire);
    * float: uniform [0, 1) costs, +10 on equal values;
    * unequal: odd variables take 2 of the D values, integer costs."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    if kind == "float":
        mats = rng.uniform(0, 1, (F, D, D)) + 10 * np.eye(D)
    else:
        hard = kind == "hard"
        mats = (rng.integers(0, 2 if hard else 5, (F, D, D))
                + (10000 if hard else 10) * np.eye(D))
    sizes = [2 if kind == "unequal" and i % 2 else D for i in range(V)]
    doms = {s: pkg.Domain(f"d{s}", "d", list(range(s))) for s in set(sizes)}
    vs = [pkg.Variable(f"v{i:02d}", doms[sizes[i]]) for i in range(V)]
    dcop = pkg.DCOP(f"{kind}{V}")
    for v in vs:
        dcop.add_variable(v)
    for k in range(F):
        a, b = vs[ei[k]], vs[ej[k]]
        m = mats[k][:len(a.domain), :len(b.domain)].astype(np.float32)
        dcop.add_constraint(pkg.NAryMatrixRelation([a, b], m,
                                                   name=f"c{k:03d}"))
    return dcop


def jax_dcop(**kw):
    import pydcop_tpu.dcop as pkg

    return build_dcop(pkg, **kw)


def carried(jt):
    """The JAX-compiled graph carried into the port, on the CPU."""
    return tensors_from_numpy(numpy_fields(jt), device="cpu")


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int32)


KINDS = ["int", "hard", "float", "unequal"]


def instance(kind, **kw):
    jt = jcompile.compile_constraint_graph(jax_dcop(kind=kind, **kw))
    return jt, carried(jt)


# ---------------------------------------------------------------------------
# segment reductions
# ---------------------------------------------------------------------------


def test_segment_sum_equals_cpu_index_add_bit_for_bit():
    # a degree-300 hub (segment 0) among low-degree segments, float rows
    # whose sum depends on the order of the adds
    rng = np.random.default_rng(1)
    ids = np.concatenate([np.zeros(300, np.int64),
                          rng.integers(1, 50, 400)])
    rng.shuffle(ids)
    ids_t = torch.as_tensor(ids)
    data = torch.as_tensor(
        (rng.normal(0, 1, (700, 3)) * 10 ** rng.uniform(-3, 3, (700, 1)))
        .astype(np.float32))
    ref = torch.zeros((50, 3)).index_add_(0, ids_t, data)
    got = segment_sum(data, ids_t, 50)
    assert torch.equal(got, ref)
    # and the JAX package's XLA CPU segment_sum, too
    jref = jax.ops.segment_sum(jnp.asarray(data.numpy()), jnp.asarray(ids),
                               num_segments=50)
    assert np.array_equal(got.numpy(), np.asarray(jref))


def test_segment_max_min_empty_identities():
    ids = torch.tensor([0, 0, 2])
    f = torch.tensor([1.0, 3.0, -2.0])
    i = torch.tensor([5, 4, 7], dtype=torch.int32)
    assert segment_max(f, ids, 4).tolist() == [3.0, -float("inf"), -2.0,
                                               -float("inf")]
    big = torch.iinfo(torch.int32).max
    assert segment_min(i, ids, 4).tolist() == [4, big, 7, big]
    jmax = jax.ops.segment_max(jnp.asarray(f.numpy()),
                               jnp.asarray(ids.numpy()), num_segments=4)
    assert np.array_equal(np.asarray(jmax), segment_max(f, ids, 4).numpy())


# ---------------------------------------------------------------------------
# compile and the hypergraph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_compile_constraint_graph_matches_jax(kind):
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph

    jt = jcompile.compile_constraint_graph(jax_dcop(kind=kind))
    t = compile_constraint_graph(build_dcop(tpkg, kind=kind), device="cpu")
    ref, got = numpy_fields(jt), numpy_fields(t)
    for k in ("neighbor_src", "neighbor_dst", "domain_mask",
              "unary_costs", "edge_var"):
        assert np.array_equal(ref[k], got[k]), k
    assert np.array_equal(ref["buckets"][0]["tensors"],
                          got["buckets"][0]["tensors"])
    back = carried(jt)
    assert np.array_equal(back.neighbor_src.numpy(), ref["neighbor_src"])
    assert back.n_pairs == len(ref["neighbor_dst"])


@pytest.mark.parametrize("name", ["graph_coloring_tuto", "secp_small",
                                  "ising_grid"])
def test_constraints_hypergraph_matches_jax(name):
    import os

    from pydcop_tpu.dcop import load_dcop_from_file as jax_load
    from pydcop_tpu.graph import load_graph_module as jax_graph
    from pydcop_tpu_torch.algorithms import dsa, mgm
    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.graph import load_graph_module

    path = os.path.join(os.path.dirname(__file__), "instances",
                        name + ".yaml")
    ref = jax_graph("constraints_hypergraph").build_computation_graph(
        jax_load(path))
    got = load_graph_module("constraints_hypergraph").build_computation_graph(
        load_dcop_from_file(path))
    assert [n.name for n in got.nodes] == [n.name for n in ref.nodes]
    for gn, rn in zip(got.nodes, ref.nodes):
        assert [c.name for c in gn.constraints] == \
            [c.name for c in rn.constraints]
        assert [(lk.constraint_name, lk.nodes) for lk in gn.links] == \
            [(lk.constraint_name, lk.nodes) for lk in rn.links]
        assert sorted(gn.neighbors) == sorted(rn.neighbors)
        for mod in (mgm, dsa):
            assert mod.computation_memory(gn) == float(len(rn.neighbors))


# ---------------------------------------------------------------------------
# the generic engine against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_local_cost_tables_match_jax(kind):
    jt, t = instance(kind)
    for s in range(3):
        x = random_x(t, s)
        ref = np.asarray(jcompile.local_cost_tables(jt, jnp.asarray(x)))
        got = local_cost_tables(t, torch.as_tensor(x)).numpy()
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("name", ["ising_grid", "secp_small"])
def test_local_cost_tables_mixed_arity_match_jax(name):
    import os

    from pydcop_tpu.dcop import load_dcop_from_file as jax_load

    jt = jcompile.compile_constraint_graph(jax_load(os.path.join(
        os.path.dirname(__file__), "instances", name + ".yaml")))
    t = carried(jt)
    x = random_x(t, 4)
    ref = np.asarray(jcompile.local_cost_tables(jt, jnp.asarray(x)))
    assert np.array_equal(local_cost_tables(t, torch.as_tensor(x)).numpy(),
                          ref)


@pytest.mark.parametrize("prefer_change", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_gains_and_best_match_jax(kind, prefer_change):
    jt, t = instance(kind)
    x = random_x(t, 7)
    jcur, jbest, jgain, _ = jls.gains_and_best(
        jt, jnp.asarray(x), prefer_change=prefer_change)
    cur, best, gain, _ = ls.gains_and_best(
        t, torch.as_tensor(x), prefer_change=prefer_change)
    assert np.array_equal(cur.numpy(), np.asarray(jcur))
    assert np.array_equal(best.numpy(), np.asarray(jbest))
    assert np.array_equal(gain.numpy(), np.asarray(jgain))


@pytest.mark.parametrize("kind", KINDS)
def test_neighborhood_winner_matches_jax(kind):
    jt, t = instance(kind)
    rng = np.random.default_rng(9)
    # gains from a small set, so neighbourhoods tie often
    for gains in (rng.integers(0, 3, t.n_vars).astype(np.float32),
                  np.array(jls.gains_and_best(
                      jt, jnp.asarray(random_x(t, 2)))[2])):
        ref = np.asarray(jls.neighborhood_winner(jt, jnp.asarray(gains)))
        got = ls.neighborhood_winner(t, torch.as_tensor(gains)).numpy()
        assert np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# the packed engine against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def packed_pair(kind, **kw):
    jt, t = instance(kind, **kw)
    pls = pls_mod.pack_local_search(t)
    assert pls is not None
    return jt, t, pls


def jax_uniforms(jpls_, u):
    """[n, V] uniforms in the JAX packed column order (pads get 1.0)."""
    pg = jpls_.pg
    out = np.ones((u.shape[0], pg.Vp), np.float32)
    out[:, np.asarray(pg.var_order)] = u
    return jnp.asarray(out)


def near_ties(tables, tol):
    """Variables whose two best valid entries lie within tol."""
    two = torch.topk(tables, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= tol * (1 + two[:, 0].abs())


@pytest.mark.parametrize("kind", KINDS)
def test_packed_local_tables_match_jax(kind):
    jt, t, pls = packed_pair(kind)
    jpg = pack_for_pallas(jt)
    for s in range(2):
        x = random_x(t, 10 + s)
        ref = np.asarray(jax_packed_local_tables(jpg, jnp.asarray(x),
                                                 interpret=True))
        got = pls_mod.packed_local_tables(pls, torch.as_tensor(x)).numpy()
        assert got.shape == (t.n_vars, t.max_domain_size)
        if kind == "float":
            assert np.all(np.abs(got - ref) <= 1e-5 * (1 + np.abs(ref)))
        else:
            assert np.array_equal(got, ref)
        # and the generic engine's tables, PAD_COST at invalid values
        gen = local_cost_tables(t, torch.as_tensor(x)).numpy()
        assert np.allclose(got, gen, rtol=1e-5, atol=1e-5)
        assert np.all(got[t.domain_mask.numpy() == 0] == np.float32(PAD_COST))


@pytest.mark.parametrize("kind", ["int", "hard", "unequal"])
def test_packed_mgm_matches_jax(kind):
    jt, t, pls = packed_pair(kind)
    jp = jpls.pack_local_search(jt)
    x = random_x(t, 21)
    ref = jpls.unpack_x(jp, jpls.packed_mgm_cycles(
        jp, jpls.pack_x(jp, jnp.asarray(x)), 12))
    got = pls_mod.unpack_x(pls, pls_mod.packed_mgm_cycles(
        pls, pls_mod.pack_x(pls, torch.as_tensor(x)), 12))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    # the generic engine, 12 cycles from the same x
    from pydcop_tpu_torch.algorithms.mgm import mgm_cycle

    xg = torch.as_tensor(x)
    for _ in range(12):
        xg = mgm_cycle(t, xg)
    assert torch.equal(xg, got)


def test_packed_mgm_float_one_cycle_within_near_ties():
    jt, t, pls = packed_pair("float")
    jp = jpls.pack_local_search(jt)
    x = random_x(t, 5)
    ref = np.asarray(jpls.unpack_x(jp, jpls.packed_mgm_cycles(
        jp, jpls.pack_x(jp, jnp.asarray(x)), 1)))
    got = pls_mod.unpack_x(pls, pls_mod.packed_mgm_cycles(
        pls, pls_mod.pack_x(pls, torch.as_tensor(x)), 1)).numpy()
    differ = got != ref
    ties = near_ties(local_cost_tables(t, torch.as_tensor(x)), 1e-5).numpy()
    assert not np.any(differ & ~ties)


DSA_CASES = [
    dict(variant="A", probability=0.7),
    dict(variant="B", probability=0.7),
    dict(variant="C", probability=0.7),
    dict(variant="B", probability=0.4, probability_hard=0.9),
    dict(variant="C", probability=0.4, probability_hard=0.9),
    dict(variant="B", probability=0.7, activation=0.6),
    dict(variant="A", probability=0.7, activation=0.6),
]


@pytest.mark.parametrize("case", DSA_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
@pytest.mark.parametrize("kind", ["int", "hard", "unequal"])
def test_packed_dsa_matches_jax(kind, case):
    jt, t, pls = packed_pair(kind)
    jp = jpls.pack_local_search(jt)
    rng = np.random.default_rng(33)
    n = 10
    u = rng.uniform(0, 1, (n, t.n_vars)).astype(np.float32)
    w = rng.uniform(0, 1, (n, t.n_vars)).astype(np.float32)
    case = dict(case)
    activation = case.pop("activation", None)
    x = random_x(t, 17)
    ref = jpls.unpack_x(jp, jpls.packed_dsa_cycles(
        jp, jpls.pack_x(jp, jnp.asarray(x)), jax_uniforms(jp, u),
        awake_uniforms=None if activation is None else jax_uniforms(jp, w),
        activation=activation, **case))
    got = pls_mod.unpack_x(pls, pls_mod.packed_dsa_cycles(
        pls, pls_mod.pack_x(pls, torch.as_tensor(x)),
        pls_mod.pack_uniforms(pls, torch.as_tensor(u)),
        awake_uniforms=(None if activation is None else
                        pls_mod.pack_uniforms(pls, torch.as_tensor(w))),
        activation=activation, **case))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_hard_instance_fires_conflicts_and_lateral_moves():
    """On the hard-cost instance variant B moves laterally in conflict,
    which variant A never does: the two runs must differ."""
    jt, t, pls = packed_pair("hard")
    u = torch.zeros((1, pls.Vp))  # every coin says move
    n_lateral = 0
    for s in range(10):
        x = pls_mod.pack_x(pls, torch.as_tensor(random_x(t, s)))
        _, cur, best, gain = pls_mod.ls_tables(pls, x, prefer_change=True)
        assert bool((cur >= ls.HARD_THRESHOLD).any())
        a = pls_mod.packed_dsa_cycles(pls, x, u, 1.0, "A")
        b = pls_mod.packed_dsa_cycles(pls, x, u, 1.0, "B")
        lateral = (gain <= 1e-9) & (best != x) & (cur >= ls.HARD_THRESHOLD)
        n_lateral += int(lateral.sum())
        assert torch.equal(b[lateral], best[lateral])
        assert torch.equal(a[lateral], x[lateral])
    assert n_lateral > 0


# ---------------------------------------------------------------------------
# rules that decide ties
# ---------------------------------------------------------------------------


def _tiny_dcop(pkg, with_isolated=False):
    d = pkg.Domain("c", "c", [0, 1])
    dcop = pkg.DCOP("tie", objective="min")
    va, vb = pkg.Variable("a", d), pkg.Variable("b", d)
    dcop.add_constraint(pkg.constraint_from_str(
        "conf", "10 if a == b else 0", [va, vb]))
    if with_isolated:
        from importlib import import_module

        objs = import_module(pkg.__name__ + ".objects")
        dcop.add_variable(objs.VariableWithCostDict("z", d,
                                                    {0: 10.0, 1: 0.0}))
    return dcop


@pytest.mark.parametrize("packed", [True, False])
def test_mgm_lexic_tiebreak_smallest_index_wins(packed):
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.algorithms.mgm import mgm_cycle
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph

    t = compile_constraint_graph(_tiny_dcop(tpkg), device="cpu")
    x = torch.tensor([0, 0], dtype=torch.int32)  # conflict, tied gains
    if packed:
        pls = pls_mod.pack_local_search(t)
        got = pls_mod.unpack_x(pls, pls_mod.packed_mgm_cycles(
            pls, pls_mod.pack_x(pls, x), 1))
    else:
        got = mgm_cycle(t, x)
    assert got.tolist() == [1, 0]  # only "a" (index 0) moves


@pytest.mark.parametrize("packed", [True, False])
def test_degree_zero_variable_moves_on_unary_gain(packed):
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.algorithms.mgm import mgm_cycle
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph

    t = compile_constraint_graph(_tiny_dcop(tpkg, True), device="cpu")
    iz = t.var_names.index("z")
    x = torch.zeros(3, dtype=torch.int32)
    if packed:
        pls = pls_mod.pack_local_search(t)
        assert int(pls.pg.col_deg[pls.pg.var_order[iz]]) == 0
        got = pls_mod.unpack_x(pls, pls_mod.packed_mgm_cycles(
            pls, pls_mod.pack_x(pls, x), 1))
    else:
        got = mgm_cycle(t, x)
    assert int(got[iz]) == 1


def test_unequal_domains_best_never_lands_on_padding():
    jt, t, pls = packed_pair("unequal")
    for s in range(5):
        x = pls_mod.pack_x(pls, torch.as_tensor(random_x(t, s)))
        for prefer in (False, True):
            _, _, best, _ = pls_mod.ls_tables(pls, x, prefer_change=prefer)
            assert bool((pls.pg.mask_p.T[torch.arange(pls.Vp),
                                         best.long()] > 0).all())


def test_prefer_change_nudge_is_an_add_that_vanishes_at_10000():
    """On tables of 10,000 the 1e-6 nudge is lost in float32, so the first
    index of the tie wins even when it is the current value; on small
    tables the nudge moves the argmin away from the current value."""
    t = torch.tensor([[10000.0, 10000.0], [3.0, 3.0]])
    x = torch.tensor([0, 0], dtype=torch.int32)

    class T:  # the two fields gains_and_best reads
        n_vars = 2
        domain_mask = torch.ones(2, 2)

    _, best, gain, _ = ls.gains_and_best(T, x, tables=t, prefer_change=True)
    assert best.tolist() == [0, 1] and gain.tolist() == [0.0, 0.0]
    class JT:
        n_vars = 2
        domain_mask = jnp.ones((2, 2))

    jbest = jls.gains_and_best(JT, jnp.asarray(x.numpy()),
                               tables=jnp.asarray(t.numpy()),
                               prefer_change=True)[1]
    assert np.asarray(jbest).tolist() == [0, 1]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_wrappers_check_operands_and_leave_inputs_alone():
    _, t, pls = packed_pair("int")
    x = pls_mod.pack_x(pls, torch.as_tensor(random_x(t, 1)))
    keep = x.clone()
    pls_mod.packed_mgm_cycles(pls, x, 3)
    pls_mod.packed_dsa_cycles(pls, x, torch.rand(3, pls.Vp), 0.7)
    assert torch.equal(x, keep)
    with pytest.raises(TypeError):
        pls_mod.ls_tables(pls, x.long())
    with pytest.raises(ValueError):
        pls_mod.ls_tables(pls, x[:-1])
    with pytest.raises(ValueError):
        pls_mod.packed_mgm_cycles(pls, x, 0)
    with pytest.raises(ValueError):
        pls_mod.packed_dsa_cycles(pls, x, torch.rand(2, pls.Vp), 0.7,
                                  variant="D")
    with pytest.raises(ValueError):
        pls_mod.dsa_cycle(pls, x, torch.rand(pls.Vp), 0.7,
                          awake_u=torch.rand(pls.Vp))
    # no launch happens on the CPU
    assert pls_mod.ls_tables.launches == 0
    assert pls_mod.dsa_cycle.launches == 0


def test_pack_roundtrip_and_layout():
    _, t, pls = packed_pair("unequal")
    x = torch.as_tensor(random_x(t, 3))
    assert torch.equal(pls_mod.unpack_x(pls, pls_mod.pack_x(pls, x)), x)
    pg = pls.pg
    # mate_col is the column on the other end of each slot, mate_idx that
    # column's variable
    assert torch.equal(pls.mate_col.long(), pg.slot_col[pg.mate.long()])
    assert torch.equal(pls.col_var.long()[pg.var_order],
                       torch.arange(t.n_vars))
    assert torch.equal(pls.mate_idx, pls.col_var[pls.mate_col.long()])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_plain_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    jt = jcompile.compile_constraint_graph(jax_dcop(kind=kind, V=400,
                                                    F=1200))
    t = tensors_from_numpy(numpy_fields(jt), device="cuda")
    pls = pls_mod.pack_local_search(t)
    x = pls_mod.pack_x(pls, torch.as_tensor(random_x(t, 1), device="cuda"))
    for prefer in (False, True):
        k = pls_mod.ls_tables(pls, x, prefer_change=prefer)
        p = pls_mod.ls_tables_plain(pls, x, prefer_change=prefer)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    before = pls_mod.mgm_move.launches
    k = pls_mod.packed_mgm_cycles(pls, x, 20)
    assert pls_mod.mgm_move.launches == before + 20
    assert torch.equal(k, pls_mod.packed_mgm_cycles_plain(pls, x, 20))
    u = torch.rand((20, pls.Vp), device="cuda")
    w = torch.rand((20, pls.Vp), device="cuda")
    for case in DSA_CASES:
        case = dict(case)
        act = case.pop("activation", None)
        aw = None if act is None else w
        k = pls_mod.packed_dsa_cycles(pls, x, u, awake_uniforms=aw,
                                      activation=act, **case)
        p = pls_mod.packed_dsa_cycles_plain(pls, x, u, awake_uniforms=aw,
                                            activation=act, **case)
        assert torch.equal(k, p)
    torch.cuda.synchronize()
