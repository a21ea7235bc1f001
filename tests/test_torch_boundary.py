"""The port's ``parallel/boundary.py`` against the JAX package's, array for
array: the boundary analysis (with the patchable touch counts), the
incremental patch against a fresh analysis, the neighbour-exchange plan
(rounds, send/recv/valid arrays) and its patch, and the padded boundary
index, on the ring, star and random partitions of the JAX package's own
boundary tests (``tests/unit/test_boundary_comm.py``,
``tests/unit/test_boundary_patch.py``) and on the locality partition of
seeded colourings.
"""
import numpy as np
import pytest

from pydcop_tpu.parallel import boundary as J
from pydcop_tpu_torch.parallel import boundary as P
from pydcop_tpu_torch.parallel.partition import partition_factors

INFO_FIELDS = ("owner", "boundary_mask", "touch_count")
INFO_SCALARS = ("n_vars", "n_shards", "n_boundary", "n_touched",
                "cut_fraction", "boundary_fraction")
PLAN_ARRAYS = ("send_idx", "recv_idx", "recv_valid")


def _ring(V=16, parts=4):
    vi = np.stack([np.arange(V), (np.arange(V) + 1) % V],
                  axis=1).astype(np.int32)
    return V, [vi], [(np.arange(V) // (V // parts)).astype(np.int32)], parts


def _star():
    vi = np.stack([np.zeros(8), np.arange(1, 9)], axis=1).astype(np.int32)
    return 9, [vi], [(np.arange(8) // 2).astype(np.int32)], 4


def _random(V=24, F=40, S=3, seed=0):
    rng = np.random.default_rng(seed)
    vi = np.stack([rng.integers(0, V, F), rng.integers(0, V, F)],
                  1).astype(np.int32)
    return V, [vi], [(np.arange(F) % S).astype(np.int64)], S


def _pairwise_chain():
    vi = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6],
                   [6, 7], [7, 8]], np.int32)
    return 12, [vi], [np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int64)], 3


def _locality(V, E, S, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, E)
    ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
    vi = np.stack([ei, ej], 1).astype(np.int32)
    ter = np.stack([ei[:E // 3], ej[:E // 3], (ej[:E // 3] + 3) % V],
                   1).astype(np.int32)
    vis = [vi, ter]
    return V, vis, partition_factors(vis, V, S), S


def _ring_lattice(V=64, S=8):
    idx = np.arange(V)
    vi = np.stack([np.concatenate([idx, idx]),
                   np.concatenate([(idx + 1) % V, (idx + 2) % V])],
                  1).astype(np.int32)
    return V, [vi], partition_factors([vi], V, S), S


CASES = {
    "ring": _ring,
    "ring_2": lambda: _ring(16, 2),
    "star": _star,
    "random": _random,
    "random_5": lambda: _random(30, 60, 5, seed=3),
    "chain": _pairwise_chain,
    "locality_mixed": lambda: _locality(40, 90, 4, seed=1),
    "ring_lattice_8": _ring_lattice,
}


def _same_info(a, b):
    for f in INFO_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in INFO_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    assert a.pairwise == b.pairwise
    assert np.array_equal(a.boundary_vars, b.boundary_vars)
    if a.touch is None or b.touch is None:
        assert a.touch is None and b.touch is None
    else:
        assert np.array_equal(a.touch, b.touch)


def _same_plan(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert (a.n_shards, a.n_rounds, a.bpair, a.lanes_moved) == (
        b.n_shards, b.n_rounds, b.bpair, b.lanes_moved)
    assert [list(map(tuple, r)) for r in a.rounds] == \
        [list(map(tuple, r)) for r in b.rounds]
    for f in PLAN_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("keep_touch", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_analysis_plan_and_index_equal_jax(case, keep_touch):
    V, vis, asg, S = CASES[case]()
    a = P.analyze_boundary(vis, asg, V, S, keep_touch=keep_touch)
    b = J.analyze_boundary(vis, asg, V, S, keep_touch=keep_touch)
    _same_info(a, b)
    _same_plan(P.build_exchange_plan(a, vis, asg),
               J.build_exchange_plan(b, vis, asg))
    for q in (1, 8, 128):
        pi, ji = P.padded_boundary_idx(a, q), J.padded_boundary_idx(b, q)
        assert pi.dtype == ji.dtype and np.array_equal(pi, ji)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pairs_from_touch_equal_jax(case):
    V, vis, asg, S = CASES[case]()
    a = P.analyze_boundary(vis, asg, V, S, keep_touch=True)
    b = J.analyze_boundary(vis, asg, V, S, keep_touch=True)
    assert P._pairs_from_touch(a, a.touch > 0) == \
        J._pairs_from_touch(b, b.touch > 0)


def test_exchange_rounds_are_partial_permutations():
    V, vis, asg, S = _ring()
    plan = P.build_exchange_plan(P.analyze_boundary(vis, asg, V, S), vis,
                                 asg)
    for perm in plan.rounds:
        assert len({a for a, _ in perm}) == len(perm)
        assert len({b for _, b in perm}) == len(perm)
    directed = [e for perm in plan.rounds for e in perm]
    assert len(directed) == len(set(directed))


@pytest.mark.parametrize("degree", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_color_equals_jax(degree, seed):
    from pydcop_tpu.ops.clos_routing import edge_color

    rng = np.random.default_rng(seed)
    n = 6
    # a degree-regular bipartite multigraph: `degree` random permutations
    src = np.concatenate([np.arange(n)] * degree)
    dst = np.concatenate([rng.permutation(n) for _ in range(degree)])
    got = P._edge_color(src, dst, n, n, degree)
    assert np.array_equal(got, edge_color(src, dst, n, n, degree))
    for c in range(degree):
        assert len(set(src[got == c])) == n == len(set(dst[got == c]))


PATCHES = {
    # (removed, added) as (factor index, new row or None, new shard)
    "move_factor": ([5], [(np.array([0, 13], np.int32), 2)]),
    "add_only": ([], [(np.array([3, 17], np.int32), 1)]),
    "remove_only": ([0, 7], []),
    "same_scope": ([9], None),
}


@pytest.mark.parametrize("what", sorted(PATCHES))
def test_patch_equals_fresh_analysis_and_jax(what):
    V, (vi,), (asg,), S = _random()
    removed_f, added = PATCHES[what]
    if added is None:  # the edit of a factor that keeps its scope
        added = [(vi[f], int(asg[f])) for f in removed_f]
    removed = [(vi[f], int(asg[f])) for f in removed_f]
    info = P.analyze_boundary([vi], [asg], V, S, keep_touch=True)
    got = P.patch_boundary(info, removed=removed, added=added)
    want = J.patch_boundary(J.analyze_boundary([vi], [asg], V, S,
                                               keep_touch=True),
                            removed=removed, added=added)
    _same_info(got, want)
    keep = np.ones(len(vi), bool)
    keep[removed_f] = False
    vi2 = np.concatenate([vi[keep]] + [r[None] for r, _ in added])
    asg2 = np.concatenate([asg[keep], [s for _, s in added]]).astype(
        np.int64)
    _same_info(got, P.analyze_boundary([vi2], [asg2], V, S,
                                       keep_touch=True))
    # the patch is pure
    _same_info(info, P.analyze_boundary([vi], [asg], V, S, keep_touch=True))


def test_patch_refusals_equal_jax():
    V, (vi,), (asg,), S = _random()
    for mod in (P, J):
        with pytest.raises(ValueError, match="keep_touch"):
            mod.patch_boundary(mod.analyze_boundary([vi], [asg], V, S),
                               removed=[(vi[0], int(asg[0]))])
        info = mod.analyze_boundary([vi], [asg], V, S, keep_touch=True)
        ghost = np.array([vi[0, 0], vi[0, 1]], np.int32)
        with pytest.raises(ValueError, match="stale"):
            for _ in range(5):
                info = mod.patch_boundary(
                    info, removed=[(ghost, (int(asg[0]) + 1) % 3)])
        with pytest.raises(ValueError, match="keep_touch"):
            mod.patch_exchange_plan(None, mod.analyze_boundary(
                [vi], [asg], V, S))


EXCHANGE_PATCHES = {
    "same_pairs": ([2], [(np.array([2, 4], np.int32), 0)]),
    "new_pair": ([], [(np.array([0, 8], np.int32), 0)]),
    "not_pairwise": ([], [(np.array([2, 3], np.int32), 2)]),
}


@pytest.mark.parametrize("what", sorted(EXCHANGE_PATCHES))
def test_patch_exchange_plan_equals_jax(what):
    V, (vi,), (asg,), S = _pairwise_chain()
    removed_f, added = EXCHANGE_PATCHES[what]
    removed = [(vi[f], int(asg[f])) for f in removed_f]
    out = []
    for mod in (P, J):
        info = mod.analyze_boundary([vi], [asg], V, S, keep_touch=True)
        plan = mod.build_exchange_plan(info, [vi], [asg])
        info2 = mod.patch_boundary(info, removed=removed, added=added)
        out.append(mod.patch_exchange_plan(plan, info2))
    (pp, p_ok), (jp, j_ok) = out
    assert p_ok == j_ok
    _same_plan(pp, jp)
    if what == "same_pairs":
        assert p_ok  # the schedule is patched in place, not rebuilt


def test_patch_exchange_plan_without_plan_builds_one():
    V, (vi,), (asg,), S = _pairwise_chain()
    info = P.analyze_boundary([vi], [asg], V, S, keep_touch=True)
    plan, patched = P.patch_exchange_plan(None, info)
    assert not patched
    _same_plan(plan, P.build_exchange_plan(info, [vi], [asg]))
    star = _star()
    info = P.analyze_boundary(star[1], star[2], star[0], star[3],
                              keep_touch=True)
    assert P.patch_exchange_plan(None, info) == (None, False)


def test_partition_stats_shares_the_analysis():
    from pydcop_tpu_torch.parallel.partition import partition_stats

    V, vis, asg, S = _ring()
    stats = partition_stats(vis, asg, S)
    info = P.analyze_boundary(vis, asg, V, S)
    assert stats["n_boundary"] == info.n_boundary
    assert stats["cut_fraction"] == pytest.approx(info.cut_fraction)
    assert stats["pairwise_cut"] == info.pairwise
