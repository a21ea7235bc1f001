"""The device-level launches of the sharded engines (``ops/packed_sharded.py``:
K7 ``device_fused_ba`` and K9 ``device_tables``, one launch per device over
its group of shards, ``parallel/packed_mesh.py::ShardGroup``), on the CPU
through their plain versions.

What the CUDA kernels must equal is held here: the device-level plain
versions equal the per-shard plain versions followed by the ordered
all-sum of ``parallel/collectives.py`` and the unary add, bit for bit
(``torch.equal``), in every branch, at 1, 4 and 8 shards with an empty
shard; the group's slabs, walk tables and arity-ordered slots describe
the same layout the shards had before they were grouped; and a mesh
whose devices each hold part of the shards (the partials branch) runs
the engines to the same values.  The kernels themselves are held to
these plain versions on the card (``chip_smoke.py`` and the tests marked
``cuda`` in ``tests/test_torch_sharded*_kernels.py``).
"""
import functools
import os

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import PAD_COST, \
    compile_binary_from_arrays, compile_factor_graph
from pydcop_tpu_torch.parallel import ShardedLocalSearch, ShardedMaxSum
from pydcop_tpu_torch.parallel import packed_mesh
from pydcop_tpu_torch.parallel.collectives import all_sum
from pydcop_tpu_torch.parallel.partition import partition_factors

torch.set_num_threads(1)
INST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "instances")
CPU = torch.device("cpu")


def _instance(name):
    return compile_factor_graph(
        load_dcop_from_file([os.path.join(INST, name + ".yaml")]),
        device="cpu")


def _random_binary(V=60, F=150, D=3, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    un = rng.uniform(0, 1, (V, D)).astype(np.float32)
    return compile_binary_from_arrays(ei, ej, mats, V, unary=un,
                                      device="cpu")


GRAPHS = {
    # binary: a 4-valued meeting scheduling, a 60-variable random graph
    "meeting_scheduling": lambda: _instance("meeting_scheduling"),
    "random_60": _random_binary,
    # mixed: unary + binary factors, and arity 1-4
    "ising_grid": lambda: _instance("ising_grid"),
    "secp_small": lambda: _instance("secp_small"),
}
SHARDS = [1, 4, 8]


def _assigns(t, n_shards):
    """The locality partition with shard 1 emptied into shard 0 (an empty
    shard at every S > 1)."""
    vis = [np.asarray(b.var_idx) for b in t.buckets]
    parts = partition_factors(vis, t.n_vars, n_shards)
    return [np.where(np.asarray(a) == 1, 0, a) for a in parts]


@functools.lru_cache(maxsize=None)
def _packs(name, n_shards):
    t = GRAPHS[name]()
    packs = packed_mesh.build_shard_packs(t, [CPU] * n_shards,
                                          _assigns(t, n_shards))
    if n_shards > 1:
        assert packs.shards[1].N == 0
    return t, packs


def _state(packs, seed):
    g = packs.groups[0]
    rng = np.random.default_rng(seed)
    D, N = packs.D, g.n_slots

    def rand(*shape):
        return torch.as_tensor(rng.uniform(-2, 3, shape).astype(np.float32))
    active = torch.as_tensor((rng.uniform(0, 1, N) < 0.6).astype(np.float32))
    return rand(D, packs.Vp), rand(D * N), rand(D * N), rand(D * N), active


def _ordered(packs, parts):
    """The ordered all-sum of the per-shard partials
    (``parallel/collectives.py``), then the unary add: what a whole
    group's launch must equal."""
    unary_p = packs.common_on(CPU)[0]
    return unary_p + all_sum(parts, [CPU] * len(parts))[0]


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k7_device_plain_equals_per_shard_then_ordered_sum(name, n_shards,
                                                           act):
    _, packs = _packs(name, n_shards)
    g = packs.groups[0]
    assert g.whole and g.index == tuple(range(n_shards))
    bel, r, qm, rm, active = _state(packs, 7)
    extra = (qm, rm, active) if act else ()
    got = K.device_fused_ba(g, bel, r, 0.5, *extra)
    views = [g.views(a, packs.D) for a in (r, qm, rm)] + [
        g.views(active, None)]
    parts, outs = [], []
    for k, sh in enumerate(packs.shards):
        if sh.N == 0:
            parts.append(torch.zeros((packs.D, packs.Vp)))
            continue
        more = (views[1][k], views[2][k], views[3][k]) if act else ()
        out = K.shard_fused_ba_plain(sh, bel, views[0][k], 0.5, *more)
        parts.append(out[1])
        outs.append((k, out))
    assert torch.equal(got[1], _ordered(packs, parts))
    for k, out in outs:
        for slab, ref in zip((got[0], *got[2:]), (out[0], *out[2:])):
            assert torch.equal(g.views(slab, packs.D)[k], ref)
    assert len(got) == (4 if act else 2)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k9_device_plain_equals_per_shard_then_ordered_sum(name, n_shards):
    _, packs = _packs(name, n_shards)
    g = packs.groups[0]
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.uniform(0, 1, packs.Vp)
                         * packs.mask_p.sum(axis=0)).astype(np.int32))
    parts = [K.shard_tables_plain(sh, x) if sh.N
             else torch.zeros((packs.D, packs.Vp)) for sh in packs.shards]
    want = torch.where(packs.common_on(CPU)[1] > 0, _ordered(packs, parts),
                       PAD_COST)
    assert torch.equal(K.device_tables(g, x), want)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_group_slab_views_equal_the_shards_layouts(name, n_shards):
    """Each shard's fields are views of the group's slabs, in shard order,
    and hold what the shard's own layout held before it was grouped."""
    t, packs = _packs(name, n_shards)
    g = packs.groups[0]
    assigns = packs.assigns
    for k, sh in enumerate(packs.shards):
        own = packed_mesh._shard_layout(
            t, k, [np.flatnonzero(a == k) for a in assigns], CPU,
            packs.mixed)
        fields = [f for f in packed_mesh.SLAB_FIELDS
                  if not (packs.mixed and f == "cost_rows")]
        pairs = [(getattr(sh, f), getattr(own, f), g.slabs[f], 1)
                 for f in fields]
        if sh.mixed is not None:
            pairs += [(getattr(sh.mixed, f), getattr(own.mixed, f),
                       g.slabs[f], 1) for f in packed_mesh.SLAB_MIXED]
            pairs += [(sh.mixed.costs[a - 1], own.mixed.costs[a - 1],
                       g.slabs[f"cost{a}"], None) for a in (1, 2, 3, 4)]
        for view, ref, slab, one in pairs:
            assert torch.equal(view, ref)
            assert view.is_contiguous()
            if one and view.numel():  # inside the slab, at R * soff[k]
                assert view.untyped_storage().data_ptr() == \
                    slab.untyped_storage().data_ptr()
                rows = view.numel() // sh.N
                assert view.storage_offset() == rows * g.soff[k]


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_group_walk_and_items_cover_every_slot(name, n_shards):
    """The kernels' column walk visits each shard's slots of each column in
    rank order, and K7's items list every slot once, by arity (all of
    arity 2 on the all-binary layout)."""
    _, packs = _packs(name, n_shards)
    g = packs.groups[0]
    want = [[] for _ in range(packs.Vp)]  # (shard, group slot) in order
    for k, sh in enumerate(packs.shards):
        for deg, nvp, toff, soff in sh.buckets:
            for j in range(deg):
                for t in range(nvp):
                    want[int(sh.tcol[toff + t])].append(
                        (k, g.soff[k] + soff + j * nvp + t))
    for lst in want:  # the walk's order: shard, then rank
        lst.sort()
    ptr = g.cptr.tolist()
    got = [list(zip(g.cshard[ptr[c]:ptr[c + 1]].tolist(),
                    g.centry[ptr[c]:ptr[c + 1]].tolist()))
           for c in range(packs.Vp)]
    assert got == want
    assert sorted(g.corder.tolist()) == list(range(packs.Vp))
    tot = g.cptr[1:] - g.cptr[:-1]
    tot = tot[g.corder.long()]
    assert bool((tot[:-1] >= tot[1:]).all())  # largest degree first
    seen = set()
    for a in range(1, 5):
        for it in range(g.aseg[a - 1], g.aseg[a]):
            k, s = int(g.item_shard[it]), int(g.items[it])
            sh = packs.shards[k]
            assert (int(sh.mixed.arity[s]) if packs.mixed else 2) == a
            seen.add((k, s))
    assert len(seen) == g.aseg[4] == sum(sh.N for sh in packs.shards)


def _round_robin(devices):
    """Two groups on the CPU, as on two cards: even and odd shards."""
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


@pytest.mark.parametrize("name", ["random_60", "secp_small"])
def test_partials_branch_runs_the_engines_alike(name, monkeypatch):
    """A mesh whose devices each hold part of the shards: each group's
    launch writes its shards' partials, the engine adds them in shard
    order, and MaxSum (with and without activation), MGM and DSA end
    where the one-group mesh ends, bit for bit."""
    t = GRAPHS[name]()
    mesh = [CPU] * 4
    ref = {"maxsum": ShardedMaxSum(t, mesh).run(6),
           "amaxsum": ShardedMaxSum(t, mesh, activation=0.7).run(6,
                                                                 seed=2)}
    monkeypatch.setattr(packed_mesh, "_device_groups", _round_robin)
    split = ShardedMaxSum(t, mesh)
    assert [g.whole for g in split.groups] == [False, False]
    bel, r = split.init_messages()[0][1][0], split.init_messages()[0][0]
    for g in split.groups:  # the partials equal the per-shard plain ones
        parts = K.device_fused_ba(g, bel, g.slab_of([r[s] for s in
                                                     g.index]), 0.5)[1]
        assert parts.shape == (len(g.index), split.packs.D, split.packs.Vp)
        for k, sh in enumerate(g.shards):
            if sh.N:
                assert torch.equal(parts[k], K.shard_fused_ba_plain(
                    sh, bel, r[g.index[k]], 0.5)[1])
    for label, got in (("maxsum", split.run(6)),
                       ("amaxsum", ShardedMaxSum(t, mesh, activation=0.7)
                        .run(6, seed=2))):
        v, state, _ = got
        assert np.array_equal(v, ref[label][0])
        for a, b in zip(state, ref[label][1]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    for rule in ("mgm", "dsa"):
        got = ShardedLocalSearch(t, mesh, rule=rule).run(6, seed=1)
        monkeypatch.undo()
        want = ShardedLocalSearch(t, mesh, rule=rule).run(6, seed=1)
        monkeypatch.setattr(packed_mesh, "_device_groups", _round_robin)
        assert np.array_equal(got, want)


def test_engine_state_is_views_of_one_slab_per_group():
    """run()'s per-shard state keeps its shapes; its pieces are views of
    one allocation, and continuing from it equals one longer run."""
    _, packs = _packs("secp_small", 4)
    t = GRAPHS["secp_small"]()
    eng = ShardedMaxSum(t, [CPU] * 4, assigns=packs.assigns)
    v8, q8, _ = eng.run(8)
    v4, q4, r4 = eng.run(4)
    base = {p.untyped_storage().data_ptr() for p in q4[0]}
    assert len(base) == 1
    assert [tuple(p.shape) for p in q4[0]] == [(packs.D, sh.N)
                                               for sh in packs.shards]
    v44, q44, _ = eng.run(4, q=q4, r=r4)
    assert np.array_equal(v44, v8)
    assert all(torch.equal(a, b) for a, b in zip(q44[0], q8[0]))
