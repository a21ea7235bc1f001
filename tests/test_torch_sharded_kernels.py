"""The port's sharded kernels (``ops/packed_sharded.py``: the per-shard
plain versions of K7 ``shard_fused_ba_plain`` and K9
``shard_tables_plain``, which the device-level launches run shard by
shard, and K8 ``shard_route_gains_plain``, which ``device_mgm_move``'s
plain version runs shard by shard) against the JAX package's Pallas
kernels of
``ops/pallas_sharded.py`` run in interpret mode, called directly on one
shard's operands from JAX's ``parallel/packed_mesh.py::build_shard_packs``
(no ``shard_map``), and the plain helpers of the move rule against their
JAX (XLA) originals.

Both packages shard the same compiled arrays with the same factor→shard
assignment.  Their layouts differ (the TPU layout pads to 128 lanes and
routes through Clos plans), so slot arrays are compared edge by edge
through each layout's slot map (JAX ``slot_maps[s]``, the port's
``slot_of[2]``, both over the shard's local edges ``p*F_s + k``) and
column arrays variable by variable (JAX ``var_order``; the port's column
is the variable).  Tolerances: K7 ``np.allclose(atol=1e-4)`` on r_new and
the partial beliefs (as the packed-vs-generic checks of the JAX tests),
K8, K9 and the move-rule helpers exactly.

The CUDA kernels cannot run here: the tests marked ``cuda`` hold each one
(K7, K8 and K9 as one launch over a device's group of shards) against its
plain version where a GPU is visible.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pydcop_tpu.ops.compile import compile_binary_from_arrays as \
    jax_compile_binary
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.ops.pallas_local_search import (
    _bucket_expand,
    _cur_best_gain,
    _mgm_decision,
    _tiebreak_idx_partial,
)
from pydcop_tpu.ops.pallas_sharded import (
    packed_shard_fused_ba,
    packed_shard_route_gains,
    packed_shard_tables,
)
from pydcop_tpu.parallel.packed_mesh import build_shard_packs as \
    jax_build_shard_packs
from pydcop_tpu.parallel.partition import partition_factors as \
    jax_partition_factors
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel.packed_mesh import build_shard_packs

torch.set_num_threads(1)


def _random(V=60, F=150, D=3, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    un = rng.uniform(0, 1, (V, D)).astype(np.float32)
    return jax_compile_binary(ei, ej, mats, V, unary=un)


def _star(leaves=120, seed=7):
    rng = np.random.default_rng(seed)
    ei = np.zeros(leaves, dtype=np.int64)
    ej = np.arange(1, leaves + 1)
    mats = rng.uniform(0, 1, (leaves, 3, 3)).astype(np.float32)
    un = rng.uniform(0, 1, (leaves + 1, 3)).astype(np.float32)
    return jax_compile_binary(ei, ej, mats, leaves + 1, unary=un)


def _unequal_domains(V=30, F=60, seed=3):
    # even variables take 3 values, odd ones 2: padded values in D=3
    from pydcop_tpu.dcop import DCOP, Domain, NAryMatrixRelation, Variable

    rng = np.random.default_rng(seed)
    d3 = Domain("d3", "d", [0, 1, 2])
    d2 = Domain("d2", "d", [0, 1])
    vs = [Variable(f"v{i:02d}", d3 if i % 2 == 0 else d2) for i in range(V)]
    dcop = DCOP("unequal")
    for v in vs:
        dcop.add_variable(v)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    for k, (i, j) in enumerate(zip(ei, ej)):
        a, b = vs[i], vs[j]
        m = rng.uniform(0, 5, (len(a.domain), len(b.domain)))
        dcop.add_constraint(NAryMatrixRelation([a, b], m, name=f"c{k:03d}"))
    return jax_compile(dcop)


def _integer_coloring(V=50, F=120, seed=5):
    # integer costs: equal gains across neighbours, so MGM's tie-break runs
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = np.tile(np.eye(3, dtype=np.float32) * 2, (F, 1, 1))
    return jax_compile_binary(ei, ej, mats, V, unary=np.zeros((V, 3),
                                                               np.float32))


INSTANCES = {"random": _random, "star": _star,
             "unequal_domains": _unequal_domains,
             "integer_coloring": _integer_coloring}
#: (instance, shards, the shard checked)
CASES = [("random", 4, 1), ("random", 2, 0), ("star", 4, 3),
         ("unequal_domains", 4, 2), ("integer_coloring", 3, 1)]


@functools.lru_cache(maxsize=None)
def _both(name, n_shards):
    """(JAX stacked packs, the port's packs) under one assignment, built
    once per case (no test modifies them)."""
    jt = INSTANCES[name]()
    assigns = jax_partition_factors([np.asarray(jt.buckets[0].var_idx)],
                                    jt.n_vars, n_shards)
    sp = jax_build_shard_packs(jt, n_shards, assigns)
    assert sp is not None
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    packs = build_shard_packs(t, [torch.device("cpu")] * n_shards, assigns)
    return sp, packs


def _to_jax_cols(sp, a):
    """[R, V] per-variable rows → JAX's padded [R, Vp] columns."""
    out = np.zeros((a.shape[0], sp.Vp), dtype=np.float32)
    out[:, np.asarray(sp.pg0.var_order)] = a
    return jnp.asarray(out)


def _to_jax_slots(sp, s, a):
    """[R, E_s] per-local-edge rows → JAX's [R, N] slots of shard s."""
    out = np.zeros((a.shape[0], sp.N), dtype=np.float32)
    out[:, sp.slot_maps[s]] = a
    return jnp.asarray(out)


def _jax_cols(sp, a):
    return np.asarray(a)[:, np.asarray(sp.pg0.var_order)]


def _jax_slots(sp, s, a):
    return np.asarray(a)[:, sp.slot_maps[s]]


def _shard_consts(sp, s):
    return tuple(c[s] for c in sp.consts)


@pytest.mark.parametrize("damping", [0.0, 0.5])
@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k7_plain_matches_jax(name, n_shards, s, damping):
    sp, packs = _both(name, n_shards)
    sh = packs.shards[s]
    D, V, E = packs.D, packs.Vp, sh.N
    rng = np.random.default_rng(11)
    bel = rng.uniform(-2, 4, (D, V)).astype(np.float32)
    r = rng.uniform(-1, 3, (D, E)).astype(np.float32)
    jbel, jr = _to_jax_cols(sp, bel), _to_jax_slots(sp, s, r)
    tbel = torch.as_tensor(bel)
    tr = torch.zeros((D, sh.N))
    tr[:, sh.slot_of[2]] = torch.as_tensor(r)
    args = (sp.cost_rows[s], sp.vmask[s], sp.inv_dcount[s],
            _shard_consts(sp, s), damping)
    for _ in range(2):  # the second launch from the first one's outputs
        jr, jpart = packed_shard_fused_ba(sp.pg0, jbel, jr, None, None,
                                          None, *args, interpret=True)
        tr, tpart = K.shard_fused_ba_plain(sh, tbel, tr, damping)
        np.testing.assert_allclose(tr.numpy()[:, sh.slot_of[2]],
                                   _jax_slots(sp, s, jr), atol=1e-4)
        np.testing.assert_allclose(tpart.numpy(), _jax_cols(sp, jpart),
                                   atol=1e-4)
        # next cycle's combined beliefs, the same on both sides
        bel = bel + tpart.numpy()
        jbel, tbel = _to_jax_cols(sp, bel), torch.as_tensor(bel)


def test_k7_zero_state_pending_side_is_a_no_op():
    _, packs = _both("random", 2)
    sh = packs.shards[0]
    r, part = K.shard_fused_ba_plain(sh, torch.zeros((packs.D, packs.Vp)),
                                     torch.zeros((packs.D, sh.N)), 0.5)
    # with q = 0 the factor side is the masked min over the other value
    D = packs.D
    rows = sh.cost_rows.reshape(D, D, sh.N)
    want = 0.5 * (rows.min(dim=0).values * sh.vmask)
    assert torch.allclose(r, want, atol=1e-6)
    assert torch.allclose(part, K.reduce_columns(sh, r, "sum", 0.0))


def _gains(rng, V):
    # non-negative, with zeros and exact ties
    g = rng.choice([0.0, 0.5, 1.0, 1.0, 2.0, 3.25], V).astype(np.float32)
    return g


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k8_plain_matches_jax(name, n_shards, s):
    sp, packs = _both(name, n_shards)
    sh = packs.shards[s]
    gain = _gains(np.random.default_rng(3), packs.Vp)
    jnm, jgn = packed_shard_route_gains(
        sp.pg0, _to_jax_cols(sp, gain[None]), _shard_consts(sp, s),
        sp.gmask1[s], interpret=True)
    tnm, tgn = K.shard_route_gains_plain(sh, torch.as_tensor(gain))
    assert np.array_equal(tnm.numpy(), _jax_cols(sp, jnm)[0])
    assert np.array_equal(tgn.numpy()[sh.slot_of[2]],
                          _jax_slots(sp, s, jgn)[0])


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k9_plain_matches_jax(name, n_shards, s):
    sp, packs = _both(name, n_shards)
    sh = packs.shards[s]
    D = packs.D
    sizes = packs.mask_p.sum(axis=0)
    rng = np.random.default_rng(4)
    x = (rng.uniform(0, 1, packs.Vp) * sizes).astype(np.int32)
    slabs = [sp.cost_rows[s][j * D:(j + 1) * D] for j in range(D)]
    jt = packed_shard_tables(sp.pg0, _to_jax_cols(sp, x[None]), slabs,
                             _shard_consts(sp, s), interpret=True)
    tt = K.shard_tables_plain(sh, torch.as_tensor(x))
    assert np.array_equal(tt.numpy(), _jax_cols(sp, jt))


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_move_rule_helpers_match_jax(name, n_shards, s):
    """cur_best_gain, tiebreak_idx_partial and mgm_decision against the
    JAX package's XLA originals, exactly."""
    sp, packs = _both(name, n_shards)
    sh = packs.shards[s]
    D, V = packs.D, packs.Vp
    rng = np.random.default_rng(6)
    tables = np.where(packs.mask_p > 0,
                      rng.choice([0.0, 1.0, 2.0, 2.5], (D, V)),
                      1e30).astype(np.float32)
    x = (rng.uniform(0, 1, V) * packs.mask_p.sum(0)).astype(np.int32)
    jtab, jx = _to_jax_cols(sp, tables), _to_jax_cols(sp, x[None])
    for prefer in (False, True):
        jcur, jbest, jgain = _cur_best_gain(sp.pg0, jtab, jx, prefer)
        cur, best, gain = K.cur_best_gain(torch.as_tensor(tables),
                                          torch.as_tensor(x), prefer)
        assert np.array_equal(cur.numpy(), _jax_cols(sp, jcur)[0])
        assert np.array_equal(best.numpy(), _jax_cols(sp, jbest)[0])
        assert np.array_equal(gain.numpy(), _jax_cols(sp, jgain)[0])
    gain = _gains(rng, V)
    nm = np.maximum(_gains(rng, V), gain)  # a combined neighbourhood max
    _, gn = K.shard_route_gains_plain(sh, torch.as_tensor(gain))
    jgn = _to_jax_slots(sp, s, gn.numpy()[sh.slot_of[2]][None])
    jidx = _tiebreak_idx_partial(
        sp.pg0, _bucket_expand(sp.pg0, _to_jax_cols(sp, nm[None]), 1), jgn,
        sp.mate_idx[s])
    idx = K.tiebreak_idx_partial(sh, torch.as_tensor(nm), gn)
    assert np.array_equal(idx.numpy(), _jax_cols(sp, jidx)[0])
    jmove = _mgm_decision(_to_jax_cols(sp, gain[None]), sp.idx_row,
                          _to_jax_cols(sp, nm[None]), jidx)
    move = K.mgm_decision(torch.as_tensor(gain),
                          torch.arange(V, dtype=torch.float32),
                          torch.as_tensor(nm), idx)
    assert np.array_equal(move.numpy(), _jax_cols(sp, jmove)[0])


def test_wrappers_check_their_operands():
    _, packs = _both("random", 2)
    sh, g = packs.shards[0], packs.groups[0]
    D, V = packs.D, packs.Vp
    bel, r = torch.zeros((D, V)), torch.zeros(D * g.n_slots)
    with pytest.raises(TypeError):
        K.device_fused_ba(g, bel.double(), r)
    with pytest.raises(ValueError):
        K.device_fused_ba(g, bel, r[:-1])
    with pytest.raises(ValueError):
        K.device_mgm_move(g, torch.zeros(V - 1), torch.zeros(V))
    with pytest.raises(TypeError):
        K.device_tables(g, torch.zeros(V))  # values must be int32


def _cuda_packs(name, n_shards):
    sp, packs = _both(name, n_shards)
    t = tensors_from_numpy(numpy_fields(INSTANCES[name]()), device="cuda")
    assigns = packs.assigns
    return build_shard_packs(t, [torch.device("cuda")] * n_shards, assigns)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 0.5])
def test_k7_kernel_matches_plain_on_gpu(damping):
    """One K7 launch over the card's 4 shards: the new messages and the
    combined beliefs equal the plain version bit for bit."""
    _need_gpu()
    packs = _cuda_packs("unequal_domains", 4)
    grp = packs.groups[0]
    g = torch.Generator(device="cpu").manual_seed(0)
    bel = torch.rand((packs.D, packs.Vp), generator=g).cuda()
    r = torch.rand(packs.D * grp.n_slots, generator=g).cuda()
    before = K.device_fused_ba.launches
    k = K.device_fused_ba(grp, bel, r, damping)
    assert K.device_fused_ba.launches == before + 1
    p = K.device_fused_ba_plain(grp, bel, r, damping)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.cuda
def test_k8_kernel_matches_plain_on_gpu():
    """One K8 launch over the card's 3 shards (the move mask), and the two
    modes of a device that holds only some shards, equal the plain
    version bit for bit."""
    _need_gpu()
    packs = _cuda_packs("integer_coloring", 3)
    grp = packs.groups[0]
    gain = torch.as_tensor(_gains(np.random.default_rng(1),
                                  packs.Vp)).cuda()
    row = packs.common_on(grp.device)[2]
    before = K.device_mgm_move.launches
    k = K.device_mgm_move(grp, gain, row)
    assert K.device_mgm_move.launches == before + 1
    p = K.device_mgm_move_plain(grp, gain, row)
    torch.cuda.synchronize()
    assert k.dtype == torch.bool and torch.equal(k, p)
    nm = K.device_mgm_move(grp, gain, mode="max")
    assert torch.equal(nm, K.device_mgm_move_plain(grp, gain, mode="max"))
    nm = torch.clamp_min(nm, 0.0)
    assert torch.equal(K.device_mgm_move(grp, gain, mode="min", neigh_max=nm),
                       K.device_mgm_move_plain(grp, gain, mode="min",
                                               neigh_max=nm))


@pytest.mark.cuda
def test_k9_kernel_matches_plain_on_gpu():
    _need_gpu()
    packs = _cuda_packs("unequal_domains", 4)
    rng = np.random.default_rng(2)
    x = (rng.uniform(0, 1, packs.Vp) * packs.mask_p.sum(0)).astype(np.int32)
    x = torch.as_tensor(x).cuda()
    grp = packs.groups[0]
    before = K.device_tables.launches
    k, p = K.device_tables(grp, x), K.device_tables_plain(grp, x)
    assert K.device_tables.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(k, p)
