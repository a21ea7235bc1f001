"""The mixed-arity and activation branches of the port's sharded kernels
(``ops/packed_sharded.py``: the per-shard plain versions of K7
``shard_fused_ba_plain`` on a mixed layout and with an activation row and
of K9 ``shard_tables_plain`` on a mixed layout, which the device-level
launches run shard by shard, and K8 ``shard_route_gains_plain`` with the
second and third siblings, which ``device_mgm_move``'s plain version runs
shard by shard) against the JAX package's Pallas kernels of
``ops/pallas_sharded.py`` in interpret mode, called directly on one
shard's operands from JAX's ``parallel/packed_mesh.py::build_shard_packs``
and its ``mixed=`` bundle (``parallel/mesh.py::_mixed_bundle``), no
``shard_map``; and K3's plain ``lane_permute`` (``ops/permute.py``)
against the JAX package's ``lane_permute`` on a Clos plan.

Both packages shard the same compiled arrays with the same factor→shard
assignment.  Their layouts differ (the TPU layout pads to 128 lanes,
reserves shard-invariant arity sections holding dummy slots and routes
through Clos plans), so slot arrays are compared endpoint by endpoint
through each layout's per-arity slot maps (the port's ``slot_of``; the
JAX side's rebuilt from the layout its packer forced on every shard, by
``pack_mixed_for_pallas``'s own formula) and column arrays variable by
variable.  K8's second and third gain masks are the shard's real
ternary-or-quaternary and quaternary slots on both sides: the JAX engine
passes its section masks, which also mark dummy slots whose identity
route carries the column's own gain, and the port's layout has no dummy
slot; the test also holds the port's masks equal to JAX's section masks
on the real slots.  Tolerances: K7 ``np.allclose(atol=1e-4)`` (as the JAX package's
packed-vs-generic checks), K8, K9, the tie-break partial and K3 exactly.

The CUDA kernels cannot run here: the tests marked ``cuda`` hold each one
(K7, K8 and K9 as one launch over a device's group of shards) against its
plain version where a GPU is visible.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pydcop_tpu.generators.secp import generate_secp
from pydcop_tpu.ops.clos_routing import plan_permutation
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.ops.pallas_local_search import (
    _bucket_expand,
    _tiebreak_idx_partial,
)
from pydcop_tpu.ops.pallas_permute import lane_permute as jax_lane_permute
from pydcop_tpu.ops.pallas_sharded import (
    packed_shard_fused_ba,
    packed_shard_route_gains,
    packed_shard_tables,
)
from pydcop_tpu.parallel import packed_mesh as jax_packed_mesh
from pydcop_tpu.parallel.mesh import _mixed_bundle, _mixed_entries
from pydcop_tpu.parallel.partition import partition_factors as \
    jax_partition_factors
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.ops.permute import lane_permute, lane_permute_plain
from pydcop_tpu_torch.parallel.packed_mesh import build_shard_packs

torch.set_num_threads(1)


def _secp(seed=3, **kw):
    kw.setdefault("n_lights", 30)
    kw.setdefault("n_models", 10)
    kw.setdefault("n_rules", 6)
    kw.setdefault("max_model_size", 2)
    return generate_secp(seed=seed, **kw)


INSTANCES = {
    "secp3": lambda: _secp(),
    "secp4": lambda: _secp(max_model_size=3),
    # tests/unit/test_packed_mesh.py's sparse-ternary instance: at 8
    # shards some shards hold no ternary factor
    "sparse_ternary": lambda: _secp(seed=5, n_lights=40, n_models=4,
                                    n_rules=2),
    "binary_shard": lambda: _secp(max_model_size=3),
}
#: (instance, shards, the shard checked): None picks a shard without
#: ternary and quaternary factors — on "sparse_ternary" at 8 shards one
#: that holds unary factors only; "binary_shard" puts every binary factor
#: of secp4 on shard 2 and nothing else there
CASES = [("secp3", 4, 1), ("secp4", 4, 0), ("secp4", 8, 3),
         ("sparse_ternary", 8, None), ("binary_shard", 4, None)]


@functools.lru_cache(maxsize=None)
def _both(name, n_shards):
    """(JAX stacked packs, JAX slot maps per shard and arity, the port's
    packs) under one assignment, built once per case."""
    jt = jax_compile(INSTANCES[name]())
    buckets = [b for b in jt.buckets if b.n_factors]
    assigns = jax_partition_factors([np.asarray(b.var_idx) for b in buckets],
                                    jt.n_vars, n_shards)
    if name == "binary_shard":
        assigns = [np.full(b.n_factors, 2) if b.arity == 2
                   else np.asarray(a) % 2 for b, a in zip(buckets, assigns)]
    seen = {}
    build = jax_packed_mesh._mixed_layout

    def spy(*args):
        seen["layout"] = build(*args)
        return seen["layout"]

    with mock.patch.object(jax_packed_mesh, "_mixed_layout", spy):
        sp = jax_packed_mesh.build_shard_packs(jt, n_shards, assigns)
    assert sp is not None and sp.mixed
    lay = seen["layout"]
    jslots = []
    for s in range(n_shards):
        per = {}
        for b, asg in zip(buckets, assigns):
            e = np.asarray(b.var_idx)[np.asarray(asg) == s].T.ravel()
            if e.size == 0:
                continue
            a = b.arity
            deg = np.bincount(e, minlength=jt.n_vars)
            order = np.argsort(e, kind="stable")
            rank = np.empty(len(e), dtype=np.int64)
            rank[order] = np.arange(len(e)) - np.concatenate(
                [[0], np.cumsum(deg)[:-1]])[e[order]]
            split = np.maximum(lay.keys[:, a - 1], 1)[e]
            col = lay.var_pcol[e] + rank // split
            k = lay.col_base[a][col] + rank % split
            per[a] = (lay.col_soff[col] + k * lay.col_nvp[col]
                      + (col - lay.col_voff[col]))
        jslots.append(per)
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    packs = build_shard_packs(t, [torch.device("cpu")] * n_shards, assigns)
    assert packs.mixed
    return sp, jslots, packs


def _shard(name, n_shards, s):
    sp, jslots, packs = _both(name, n_shards)
    if s is None:
        s = next(i for i, sh in enumerate(packs.shards)
                 if sh.N and not {3, 4} & set(sh.slot_of))
    sh = packs.shards[s]
    assert sorted(sh.slot_of) == sorted(jslots[s])
    return sp, jslots[s], packs, sh, s


def _pairs(sh, jslot):
    """(port slots, JAX slots) of every endpoint of the shard."""
    a = sorted(sh.slot_of)
    return (np.concatenate([sh.slot_of[k] for k in a]),
            np.concatenate([jslot[k] for k in a]))


def _to_jax_cols(sp, a):
    out = np.zeros((a.shape[0], sp.pg0.Vp), dtype=np.float32)
    out[:, np.asarray(sp.pg0.var_order)] = a
    return jnp.asarray(out)


def _jax_cols(sp, a):
    return np.asarray(a)[:, np.asarray(sp.pg0.var_order)]


def _slot_pair(sp, sh, jslot, a):
    """[R, N] port slot rows → (the port's tensor, JAX's [R, N] slots,
    dummy slots 0)."""
    ps, js = _pairs(sh, jslot)
    out = np.zeros((a.shape[0], sp.pg0.N), dtype=np.float32)
    out[:, js] = a[:, ps]
    return torch.as_tensor(a), jnp.asarray(out)


def _consts(stack, s):
    return tuple(c[s] for c in stack)


def _bundle(sp, s):
    """Shard s's ``mixed=`` operands, as the engine slices them."""
    extra = [a[s: s + 1] if sharded else a
             for a, sharded in _mixed_entries(sp)]
    return _mixed_bundle(sp, extra)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("damping", [0.0, 0.5])
@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k7_mixed_plain_matches_jax(name, n_shards, s, damping):
    sp, jslot, packs, sh, s = _shard(name, n_shards, s)
    D, V = packs.D, packs.Vp
    rng = np.random.default_rng(11)
    bel = rng.uniform(-2, 4, (D, V)).astype(np.float32)
    r, jr = _slot_pair(sp, sh, jslot,
                       rng.uniform(-1, 3, (D, sh.N)).astype(np.float32))
    jr_new, jpart = packed_shard_fused_ba(
        sp.pg0, _to_jax_cols(sp, bel), jr, None, None, None,
        sp.cost_rows[s], sp.vmask[s], sp.inv_dcount[s],
        _consts(sp.consts, s), damping, mixed=_bundle(sp, s),
        interpret=True)
    r_new, part = K.shard_fused_ba_plain(sh, torch.as_tensor(bel), r,
                                         damping)
    ps, js = _pairs(sh, jslot)
    _close(r_new.numpy()[:, ps], np.asarray(jr_new)[:, js])
    _close(part.numpy(), _jax_cols(sp, jpart))


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k7_activation_plain_matches_jax(name, n_shards, s):
    """The mixed branch with an activation row (amaxsum on a mixed
    graph), at damping 0.5: r_new, the partial beliefs and the committed
    q1, r1."""
    sp, jslot, packs, sh, s = _shard(name, n_shards, s)
    D, V = packs.D, packs.Vp
    rng = np.random.default_rng(12)
    bel = rng.uniform(-2, 4, (D, V)).astype(np.float32)
    rows = [rng.uniform(-1, 3, (D, sh.N)).astype(np.float32)
            for _ in range(3)]
    (r, jr), (qm, jqm), (rm, jrm) = [_slot_pair(sp, sh, jslot, a)
                                     for a in rows]
    act = (rng.uniform(0, 1, (1, sh.N)) < 0.6).astype(np.float32)
    a, ja = _slot_pair(sp, sh, jslot, act)
    jout = packed_shard_fused_ba(
        sp.pg0, _to_jax_cols(sp, bel), jr, jqm, jrm, ja, sp.cost_rows[s],
        sp.vmask[s], sp.inv_dcount[s], _consts(sp.consts, s), 0.5,
        mixed=_bundle(sp, s), interpret=True)
    out = K.shard_fused_ba_plain(sh, torch.as_tensor(bel), r, 0.5, qm, rm,
                                 a[0])
    ps, js = _pairs(sh, jslot)
    for k in (0, 2, 3):  # r_new, q1, r1
        _close(out[k].numpy()[:, ps], np.asarray(jout[k])[:, js])
    _close(out[1].numpy(), _jax_cols(sp, jout[1]))
    # the select orientation: inactive slots keep the carry
    off = ~(act[0] > 0)
    assert torch.equal(out[3][:, off], rm[:, off])
    assert torch.equal(out[2][:, off], qm[:, off])


def _gains(rng, V):
    # non-negative, with zeros and exact ties
    return rng.choice([0.0, 0.5, 1.0, 1.0, 2.0, 3.25], V).astype(np.float32)


def _occupancy(sp, sh, jslot):
    """JAX [1, N] masks of the shard's real slots of arity >= 3 and 4."""
    m2 = np.zeros((1, sp.pg0.N), dtype=np.float32)
    m3 = np.zeros((1, sp.pg0.N), dtype=np.float32)
    for a, js in jslot.items():
        if a >= 3:
            m2[0, js] = 1.0
        if a == 4:
            m3[0, js] = 1.0
    return jnp.asarray(m2), jnp.asarray(m3)


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k8_mixed_and_tiebreak_plain_match_jax(name, n_shards, s):
    sp, jslot, packs, sh, s = _shard(name, n_shards, s)
    V = packs.Vp
    rng = np.random.default_rng(3)
    gain = _gains(rng, V)
    gm2, gm3 = _occupancy(sp, sh, jslot)
    has2, has3 = sp.consts2 is not None, sp.consts3 is not None
    jout = packed_shard_route_gains(
        sp.pg0, _to_jax_cols(sp, gain[None]), _consts(sp.consts, s),
        sp.gmask1[s],
        consts2=_consts(sp.consts2, s) if has2 else None,
        gmask2=gm2 if has2 else None,
        consts3=_consts(sp.consts3, s) if has3 else None,
        gmask3=gm3 if has3 else None, interpret=True)
    nm, gn, gn2, gn3 = K.shard_route_gains_plain(sh, torch.as_tensor(gain))
    assert np.array_equal(nm.numpy(), _jax_cols(sp, jout[0])[0])
    ps, js = _pairs(sh, jslot)
    # the port's masks are JAX's section masks on the real slots (the
    # engine's gmask2 = am3 + am4, gmask3 = am4): the two differ only at
    # JAX's dummy slots
    if has2:
        jm2 = sp.am3 if sp.am4 is None else sp.am3 + sp.am4
        assert np.array_equal(sh.mixed.gmask2.numpy()[ps],
                              np.asarray(jm2)[0, js])
    if has3:
        assert np.array_equal(sh.mixed.gmask3.numpy()[ps],
                              np.asarray(sp.am4)[0, js])
    routed = [gn, gn2, gn3][:len(jout) - 1]
    for got, ref in zip(routed, jout[1:]):
        assert np.array_equal(got.numpy()[ps], np.asarray(ref)[0, js])
    if not has3:  # no quaternary slot anywhere: the third row is 0
        assert not gn3.any()
    # the tie-break partial over every sibling, from one combined max
    nm_all = np.maximum(_gains(rng, V), nm.numpy())
    jg = [_slot_pair(sp, sh, jslot, g.numpy()[None])[1]
          for g in (gn, gn2, gn3)]
    jidx = _tiebreak_idx_partial(
        sp.pg0, _bucket_expand(sp.pg0, _to_jax_cols(sp, nm_all[None]), 1),
        jg[0], sp.mate_idx[s],
        jg[1] if has2 else None, sp.mate2_idx[s] if has2 else None,
        jg[2] if has3 else None, sp.mate3_idx[s] if has3 else None)
    idx = K.tiebreak_idx_partial(sh, torch.as_tensor(nm_all), gn, gn2, gn3)
    assert np.array_equal(idx.numpy(), _jax_cols(sp, jidx)[0])


@pytest.mark.parametrize("name,n_shards,s", CASES)
def test_k9_mixed_plain_matches_jax(name, n_shards, s):
    sp, jslot, packs, sh, s = _shard(name, n_shards, s)
    rng = np.random.default_rng(4)
    x = (rng.uniform(0, 1, packs.Vp)
         * packs.mask_p.sum(axis=0)).astype(np.int32)
    jt = packed_shard_tables(sp.pg0, _to_jax_cols(sp, x[None]),
                             sp.cost_rows[s], _consts(sp.consts, s),
                             mixed=_bundle(sp, s), interpret=True)
    tt = K.shard_tables_plain(sh, torch.as_tensor(x))
    assert np.array_equal(tt.numpy(), _jax_cols(sp, jt))


def test_mixed_shard_layout_invariants():
    """Every shard of a mixed graph takes the mixed layout; every local
    endpoint owns one slot; siblings are cyclic within each factor; the
    arity masks are the shard's own occupancy."""
    _, _, packs = _both("sparse_ternary", 8)
    for sh in packs.shards:
        if not sh.N:
            continue
        m = sh.mixed
        assert m is not None and sh.cost_rows is None
        every = np.concatenate([sh.slot_of[a] for a in sorted(sh.slot_of)])
        assert sorted(every.tolist()) == list(range(sh.N))
        arity = m.arity.long()
        assert torch.equal(sh.gmask1, (arity >= 2).float())
        assert torch.equal(m.gmask2, (arity >= 3).float())
        assert torch.equal(m.gmask3, (arity == 4).float())
        assert bool((sh.mate[arity == 1] == -1).all())
        assert bool((sh.mate_idx[arity == 1] == K.BIG_IDX).all())
        for a, s in sh.slot_of.items():
            F = len(s) // a
            for p in range(a):
                mine = torch.as_tensor(s[p * F:(p + 1) * F])
                if a >= 2:
                    sib = s[((p + 1) % a) * F:((p + 1) % a + 1) * F]
                    assert np.array_equal(sh.mate[mine].numpy(), sib)


def test_k3_plain_matches_jax():
    """``lane_permute`` on random permutations of N = 16,384 columns
    (the Clos plan's 128 x 128 tile) and one of N = 32,768, exactly."""
    rng = np.random.default_rng(5)
    for A, S in ((1, 3), (2, 2)):
        N = A * 128 * 128
        perm = rng.permutation(N)
        x = rng.uniform(-5, 5, (S, N)).astype(np.float32)
        want = np.asarray(jax_lane_permute(
            jnp.asarray(x), plan_permutation(perm, A), interpret=True))
        got = lane_permute(torch.as_tensor(x),
                           torch.as_tensor(perm, dtype=torch.int32))
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want, x[:, perm])


def test_k3_checks_its_permutation():
    x = torch.zeros((2, 5))
    for bad in ([0, 1, 2, 3, 3], [-1, 1, 2, 3, 4], [1, 2, 3, 4, 5]):
        with pytest.raises(ValueError, match="permutation"):
            lane_permute(x, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(TypeError):
        lane_permute(x, torch.arange(5))  # int64


def test_activation_wrapper_checks_its_operands():
    _, _, packs = _both("secp3", 4)
    g = packs.groups[0]
    D, V, N = packs.D, packs.Vp, g.n_slots
    bel, r = torch.zeros((D, V)), torch.zeros(D * N)
    with pytest.raises(ValueError):
        K.device_fused_ba(g, bel, r, 0.5, r, r, torch.ones(N + 1))
    with pytest.raises(ValueError, match="activation"):
        K.device_fused_ba(g, bel, r, 0.5, r, r)


# -- the kernels against their plain versions, on the card ----------------


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _cuda_packs(name, n_shards):
    _, _, packs = _both(name, n_shards)
    jt = jax_compile(INSTANCES[name]())
    t = tensors_from_numpy(numpy_fields(jt), device="cuda")
    return build_shard_packs(t, [torch.device("cuda")] * n_shards,
                             packs.assigns)


def _random_state(packs, grp, seed, act):
    """(bel, r_u, and with ``act`` q_m, r_m, active) on the card, the
    slot rows as the group's slabs."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    D, N = packs.D, grp.n_slots
    bel = torch.rand((D, packs.Vp), generator=g).cuda()
    r, qm, rm = (torch.rand(D * N, generator=g).cuda() for _ in range(3))
    extra = ((qm, rm, (torch.rand(N, generator=g) < 0.6).float().cuda())
             if act else ())
    return bel, r, extra


@pytest.mark.cuda
@pytest.mark.parametrize("damping", [0.0, 0.5])
@pytest.mark.parametrize("act", [False, True])
def test_k7_mixed_kernel_matches_plain_on_gpu(act, damping):
    """One mixed K7 launch over the card's 4 shards equals the plain
    version bit for bit."""
    _need_gpu()
    packs = _cuda_packs("secp4", 4)
    grp = packs.groups[0]
    bel, r, extra = _random_state(packs, grp, 0, act)
    k = K.device_fused_ba(grp, bel, r, damping, *extra)
    p = K.device_fused_ba_plain(grp, bel, r, damping, *extra)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.cuda
def test_k7_activation_kernel_matches_plain_on_gpu():
    """The binary K7 with an activation row."""
    _need_gpu()
    from pydcop_tpu.generators import generate_graph_coloring

    jt = jax_compile(generate_graph_coloring(
        n_variables=300, n_colors=4, n_edges=900, soft=True, n_agents=1,
        seed=7))
    packs = build_shard_packs(
        tensors_from_numpy(numpy_fields(jt), device="cuda"),
        [torch.device("cuda")] * 4)
    grp = packs.groups[0]
    bel, r, extra = _random_state(packs, grp, 1, True)
    before = K.device_fused_ba.act_launches
    k = K.device_fused_ba(grp, bel, r, 0.5, *extra)
    p = K.device_fused_ba_plain(grp, bel, r, 0.5, *extra)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert K.device_fused_ba.act_launches == before + 1


@pytest.mark.cuda
def test_k8_k9_mixed_kernels_match_plain_on_gpu():
    _need_gpu()
    packs = _cuda_packs("secp4", 8)
    rng = np.random.default_rng(2)
    gain = torch.as_tensor(_gains(rng, packs.Vp)).cuda()
    x = (rng.uniform(0, 1, packs.Vp) * packs.mask_p.sum(0)).astype(np.int32)
    x = torch.as_tensor(x).cuda()
    grp = packs.groups[0]
    row = packs.common_on(grp.device)[2]
    before = K.device_mgm_move.mixed_launches
    k8 = K.device_mgm_move(grp, gain, row)
    assert K.device_mgm_move.mixed_launches == before + 1
    p8 = K.device_mgm_move_plain(grp, gain, row)
    torch.cuda.synchronize()
    assert torch.equal(k8, p8)
    k9, p9 = K.device_tables(grp, x), K.device_tables_plain(grp, x)
    torch.cuda.synchronize()
    assert torch.equal(k9, p9)


@pytest.mark.cuda
def test_k3_kernel_matches_plain_on_gpu():
    _need_gpu()
    g = torch.Generator(device="cpu").manual_seed(3)
    for S, N in ((1, 30_000), (4, 300_000)):
        x = torch.rand((S, N), generator=g).cuda()
        perm = torch.randperm(N, generator=g).int().cuda()
        before = lane_permute.launches
        k = lane_permute(x, perm)
        assert lane_permute.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(k, lane_permute_plain(x, perm))
