"""The port's local-search primitives on the mixed-arity layout
(``ops/packed_local_search.py``: ``packed_local_tables``,
``packed_mgm_cycles``, ``packed_dsa_cycles``, each running its plain
version here) against the JAX package's Pallas kernels on its mixed
layout, run in interpret mode, with the same numpy-made start and
uniforms on both sides.

Tolerance: none — tables, and x after every run, are equal, as the JAX
package pins its own packed-vs-generic local search on these graphs
(``tests/unit/test_mixed_arity_packing.py``): a column's slot costs add
in the same order in both layouts (unary, binary, ternary, quaternary
slots, each arity by edge id), and on the hub instance the JAX layout's
sub-column split only regroups integer sums.  The instances are those of
``tests/test_torch_packed_maxsum_mixed.py``.

The CUDA kernels cannot run here; ``test_mixed_kernels_match_plain_on_gpu``
holds them against the plain versions where a GPU is visible.
"""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.dcop.relations import NAryMatrixRelation
from pydcop_tpu.ops import pallas_local_search as jpls
from pydcop_tpu.ops.compile import compile_constraint_graph as jax_compile
from pydcop_tpu.ops.pallas_maxsum import pack_mixed_for_pallas
from pydcop_tpu.ops.pallas_maxsum import packed_local_tables as \
    jax_packed_local_tables
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops.compile import (
    local_cost_tables,
    numpy_fields,
    tensors_from_numpy,
)
from test_torch_packed_maxsum_mixed import INSTANCES, mixed_dcop

torch.set_num_threads(1)

#: the DSA-family rules: DSA A and C, mixeddsa (hard probability) and
#: adsa (wake coins), the last two under variant B's conflict rule
DSA_CASES = {
    "dsa_A": dict(variant="A", probability=0.7),
    "dsa_C": dict(variant="C", probability=0.7),
    "mixeddsa": dict(variant="B", probability=0.4, probability_hard=0.9),
    "adsa": dict(variant="B", probability=0.8, activation=0.6),
}
#: cycles per run (a mixed Pallas MGM cycle takes ~0.25 s in interpret
#: mode, more at D = 5 with quaternary factors)
CYCLES = 3
#: the instances of the tables check: ragged domains, arity {1, 2, 4},
#: the hub, SECP (arity {1, 3, 4})
TABLES = ["mixed_hub", "quaternary_no_ternary", "ragged", "secp12"]


def hard_mixed_dcop(seed=6):
    """Arity 1-4 at D = 3 with hard costs: integer costs 0..2, plus
    10,000 where every endpoint of a factor takes the same value — random
    starts are in conflict, and mixeddsa's hard probability and variant
    B's conflict rule fire."""
    dcop, vs, _ = mixed_dcop(V=24, n2=0, n3=0, n1=0, D=3, seed=seed)
    rng = np.random.default_rng(seed)
    k = 0
    for a, n in ((1, 6), (2, 20), (3, 10), (4, 6)):
        for _ in range(n):
            sc = [vs[i] for i in rng.choice(len(vs), a, replace=False)]
            m = rng.integers(0, 3, (3,) * a).astype(np.float32)
            if a > 1:
                for d in range(3):
                    m[(d,) * a] += 10000
            dcop.add_constraint(NAryMatrixRelation(sc, m, name=f"h{k:03d}"))
            k += 1
    return dcop


@functools.lru_cache(maxsize=None)
def pair(name):
    """Both packages' mixed layouts of one compiled instance, built once a
    process (the tests only read them)."""
    build = hard_mixed_dcop if name == "hard" else INSTANCES[name]
    jt = jax_compile(build())
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    pls = P.pack_local_search(t)
    assert pls is not None and pls.pg.mixed is not None
    jp = jpls.pack_from_pg(pack_mixed_for_pallas(jt))
    return jt, t, pls, jp


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    sizes = np.asarray(t.domain_sizes)
    return (rng.uniform(0, 1, t.n_vars) * sizes).astype(np.int32)


def jax_uniforms(jp, u):
    """[n, V] uniforms in the JAX packed column order (pads get 1.0)."""
    out = np.ones((u.shape[0], jp.pg.Vp), np.float32)
    out[:, np.asarray(jp.pg.var_order)] = u
    return jnp.asarray(out)


@pytest.mark.parametrize("name", TABLES)
def test_packed_local_tables_mixed_match_jax(name):
    jt, t, pls, jp = pair(name)
    x = random_x(t, 10)
    ref = np.asarray(jax_packed_local_tables(jp.pg, jnp.asarray(x),
                                             interpret=True))
    got = P.packed_local_tables(pls, torch.as_tensor(x)).numpy()
    assert np.array_equal(got, ref)
    # and the generic engine's tables (another order of the adds)
    gen = local_cost_tables(t, torch.as_tensor(x)).numpy()
    assert np.allclose(got, gen, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_packed_local_tables_plain_mixed_match_jax(name):
    """The variable-order plain version (the CPU half of K2-mixed's
    solve-path form) against the JAX mixed Pallas kernel in interpret
    mode, exactly, on every mixed instance."""
    jt, t, pls, jp = pair(name)
    x = random_x(t, 21)
    ref = np.asarray(jax_packed_local_tables(jp.pg, jnp.asarray(x),
                                             interpret=True))
    got = P.packed_local_tables_plain(pls, torch.as_tensor(x)).numpy()
    assert got.shape == (t.n_vars, t.max_domain_size)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("name", ["mixed_hub", "secp12"])
def test_packed_mgm_mixed_matches_jax(name):
    jt, t, pls, jp = pair(name)
    x = random_x(t, 21)
    ref = jpls.unpack_x(jp, jpls.packed_mgm_cycles(
        jp, jpls.pack_x(jp, jnp.asarray(x)), CYCLES, interpret=True))
    got = P.unpack_x(pls, P.packed_mgm_cycles(
        pls, P.pack_x(pls, torch.as_tensor(x)), CYCLES))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert not np.array_equal(got.numpy(), x)  # someone moved


@pytest.mark.parametrize("name", ["ising_grid", "secp_small"])
def test_packed_mgm_two_cycles_match_jax_on_instances(name):
    """packed_mgm_cycles at n = 2 on the mixed-arity graphs of
    tests/instances against the JAX mixed Pallas kernel, from three
    starts, bit for bit."""
    from pydcop_tpu.dcop import load_dcop_from_file as jax_load

    jt = jax_compile(jax_load(os.path.join(os.path.dirname(__file__),
                                           "instances", name + ".yaml")))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    pls = P.pack_local_search(t)
    assert pls.pg.mixed is not None
    jp = jpls.pack_from_pg(pack_mixed_for_pallas(jt))
    for seed in range(3):
        x = random_x(t, seed)
        ref = jpls.unpack_x(jp, jpls.packed_mgm_cycles(
            jp, jpls.pack_x(jp, jnp.asarray(x)), 2, interpret=True))
        got = P.unpack_x(pls, P.packed_mgm_cycles(
            pls, P.pack_x(pls, torch.as_tensor(x)), 2))
        assert np.array_equal(got.numpy(), np.asarray(ref)), seed


@pytest.mark.parametrize("case", sorted(DSA_CASES))
def test_packed_dsa_mixed_matches_jax(case):
    """Arity 1-4 with hard costs that drive mixeddsa's hard probability
    and variant B's conflict rule."""
    kw = dict(DSA_CASES[case])
    jt, t, pls, jp = pair("hard")
    rng = np.random.default_rng(33)
    u = rng.uniform(0, 1, (CYCLES, t.n_vars)).astype(np.float32)
    w = rng.uniform(0, 1, (CYCLES, t.n_vars)).astype(np.float32)
    activation = kw.pop("activation", None)
    x = random_x(t, 17)
    ref = jpls.unpack_x(jp, jpls.packed_dsa_cycles(
        jp, jpls.pack_x(jp, jnp.asarray(x)), jax_uniforms(jp, u),
        awake_uniforms=None if activation is None else jax_uniforms(jp, w),
        activation=activation, interpret=True, **kw))
    got = P.unpack_x(pls, P.packed_dsa_cycles(
        pls, P.pack_x(pls, torch.as_tensor(x)),
        P.pack_uniforms(pls, torch.as_tensor(u)),
        awake_uniforms=(None if activation is None
                        else P.pack_uniforms(pls, torch.as_tensor(w))),
        activation=activation, **kw))
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["hard", "secp12"])
def test_conflicts_take_the_hard_probability(name):
    """Hard costs of 10,000 (SECP's model factors cost that when
    violated): random starts are in conflict, and with probability 0 and
    probability_hard 1 (mixeddsa) exactly the conflicted columns that can
    improve move."""
    _, t, pls, _ = pair(name)
    u = torch.zeros((1, pls.Vp))
    n_moved = 0
    for s in range(10):
        x = P.pack_x(pls, torch.as_tensor(random_x(t, s)))
        _, cur, best, gain = P.ls_tables_plain(pls, x, prefer_change=True)
        want = (cur >= P.HARD) & (gain > 1e-9)
        got = P.packed_dsa_cycles(pls, x, u, 0.0, "A", probability_hard=1.0)
        assert torch.equal(got != x, want)
        assert torch.equal(got[want], best[want])
        n_moved += int(want.sum())
    assert n_moved > 0


def test_mixed_siblings_layout():
    _, t, pls, _ = pair("secp12")
    pg = pls.pg
    arity = pg.mixed.arity.long()
    cols = [c.long() for c, _ in pls.siblings()]
    idxs = [i.long() for _, i in pls.siblings()]
    mates = [pg.mate.long(), pg.mixed.mate2.long(), pg.mixed.mate3.long()]
    for r in range(3):
        has = arity >= r + 2  # a slot of arity a has a - 1 siblings
        assert torch.equal(cols[r] >= 0, has)
        assert torch.equal(cols[r][has], pg.slot_col[mates[r][has]])
        assert torch.equal(idxs[r][has], pls.col_var.long()[cols[r][has]])
        assert torch.all(idxs[r][~has] == P.NO_INDEX)
    x = torch.as_tensor(random_x(t, 3))
    assert torch.equal(P.unpack_x(pls, P.pack_x(pls, x)), x)
    # the wrappers run the plain versions here: no launch is counted
    P.packed_mgm_cycles(pls, P.pack_x(pls, x), 2)
    assert P.packed_local_tables.mixed_launches == 0
    assert P.packed_mgm_cycles.mixed_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_mixed_kernels_match_plain_on_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    jt = jax_compile(INSTANCES[name]())
    t = tensors_from_numpy(numpy_fields(jt), device="cuda")
    pls = P.pack_local_search(t)
    x = P.pack_x(pls, torch.as_tensor(random_x(t, 1), device="cuda"))
    x_var = P.unpack_x(pls, x)
    assert torch.equal(P.packed_local_tables(pls, x_var),
                       P.packed_local_tables_plain(pls, x_var))
    before = P.packed_mgm_cycles.mixed_launches
    k = P.packed_mgm_cycles(pls, x, 20)
    assert P.packed_mgm_cycles.mixed_launches == before + 1
    assert torch.equal(k, P.packed_mgm_cycles_plain(pls, x, 20))
    u = torch.rand((20, pls.Vp), device="cuda")
    w = torch.rand((20, pls.Vp), device="cuda")
    for case in DSA_CASES.values():
        case = dict(case)
        act = case.pop("activation", None)
        aw = None if act is None else w
        k = P.packed_dsa_cycles(pls, x, u, awake_uniforms=aw,
                                activation=act, **case)
        p = P.packed_dsa_cycles_plain(pls, x, u, awake_uniforms=aw,
                                      activation=act, **case)
        assert torch.equal(k, p)
    torch.cuda.synchronize()
