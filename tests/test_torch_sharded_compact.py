"""The compact collective modes of the port's sharded engines
(``overlap="exact"|"stale"``, ``exchange=True``; ``parallel/mesh.py``'s
``CommPlan``, ``parallel/collectives.py``'s boundary combine and
exchange) on the packed engine, and the plan against the JAX package's.

* The plan: ``comm_stats()`` and the ``shard.comm.selected`` payload
  equal the JAX package's for the same partition on the generic engine
  (whose layout both packages share): "auto" compacts at or under the
  cut-fraction threshold and keeps the dense sum over it, a one-shard or
  interior-only partition needs no collective (and ``stale`` runs as
  exact there), ``exchange=True`` on a cut that is not pairwise raises
  JAX's ``ValueError``.
* ``exact`` and ``exchange=True`` equal the port's dense run bit for bit
  (``torch.equal`` on values and beliefs, ``np.array_equal`` on
  assignments), on the ring lattice's locality cut and on the
  all-boundary random cut of the JAX package's own boundary tests
  (``tests/unit/test_boundary_comm.py``), for maxsum, amaxsum, the mixed
  layout, mgm, dsa and adsa, with every shard in one group (the
  launches combine inside, as on one card) and in two groups (the shards
  split even/odd, as on two cards: the launches write partials and only
  the boundary columns cross).
* ``stale`` is the same run in one group and in two, and equals the JAX
  package's packed ``stale`` (its Pallas kernels in interpret mode, a few
  cycles on a small ring: values exactly, beliefs at ``atol=1e-4``; mgm's
  values exactly), and packed local search's stale equals the generic
  engine's.  ``keep_halo=True`` carries the halo across run() calls.
* On an odd ring of shards (3 and 5), whose exchange plan puts a pair's
  two sends in different rounds, the exchange still equals the dense
  run bit for bit (ROADMAP C-f8).
"""
import contextlib
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from pydcop_tpu.generators.secp import generate_secp
from pydcop_tpu.ops.compile import compile_constraint_graph as jax_cg
from pydcop_tpu.ops.compile import compile_factor_graph as jax_fg
from pydcop_tpu.parallel.mesh import ShardedLocalSearch as JaxLocalSearch
from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel import ShardedLocalSearch, ShardedMaxSum, \
    build_mesh, packed_mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))
from test_boundary_comm import random_instance, ring_dcop, \
    ring_factor_tensors  # noqa: E402

torch.set_num_threads(1)


def _cpu(n):
    return build_mesh(n, "cpu")


def _split(devices):
    """Two groups on the CPU, as on two cards: even and odd shards."""
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


def _port(jt):
    return tensors_from_numpy(numpy_fields(jt), device="cpu")


def _adversarial(S=8):
    jt = jax_fg(random_instance())
    rng = np.random.default_rng(3)
    return jt, [rng.integers(0, S, jt.n_factors).astype(np.int32)]


def _secp():
    return jax_fg(generate_secp(n_lights=30, n_models=10, n_rules=6,
                                max_model_size=2, seed=3))


# -- the plan -----------------------------------------------------------------

PLANS = {
    "ring_auto": dict(),
    "ring_off": dict(overlap="off"),
    "ring_exact": dict(overlap="exact"),
    "ring_exact_psum": dict(overlap="exact", exchange=False),
    "ring_exchange": dict(overlap="exact", exchange=True),
    "ring_stale": dict(overlap="stale"),
    "ring_low_threshold": dict(boundary_threshold=0.01),
    "adversarial_auto": dict(adversarial=True),
    "adversarial_exact": dict(adversarial=True, overlap="exact"),
    "adversarial_stale": dict(adversarial=True, overlap="stale"),
    "one_shard_stale": dict(shards=1, overlap="stale"),
    "one_shard_auto": dict(shards=1),
}


@pytest.mark.parametrize("engine", ["maxsum", "mgm", "dsa"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_comm_stats_equal_jax(case, engine):
    kw = dict(PLANS[case])
    S = kw.pop("shards", 8)
    adversarial = kw.pop("adversarial", False)
    if engine == "maxsum":
        jt, assigns = (_adversarial(S) if adversarial
                       else (ring_factor_tensors(), None))
        j = JaxMaxSum(jt, jax_build_mesh(S), use_packed=False,
                      assigns=assigns, **kw)
        p = ShardedMaxSum(_port(jt), _cpu(S), use_packed=False,
                          assigns=assigns, **kw)
    else:
        jt = jax_cg(random_instance(seed=2) if adversarial else ring_dcop())
        j = JaxLocalSearch(jt, jax_build_mesh(S), rule=engine,
                           use_packed=False, **kw)
        p = ShardedLocalSearch(_port(jt), _cpu(S), rule=engine,
                               use_packed=False, **kw)
    assert p.comm_stats() == j.comm_stats()
    assert (p.comm.mode, p.comm.collective) == (j.comm.mode,
                                                j.comm.collective)
    if p.comm.compact and p.comm.collective != "none":
        assert np.array_equal(p.comm.bnd, np.asarray(j.comm.bnd))


def test_auto_compacts_at_or_under_the_threshold():
    """C-w3: JAX's auto policy, read the same way (exact on a low cut,
    dense on an all-boundary one)."""
    t = _port(ring_factor_tensors())
    eng = ShardedMaxSum(t, _cpu(8))
    assert eng.comm.info.cut_fraction <= 0.5
    assert eng.comm_stats()["mode"] == "compact-exact"
    jt, assigns = _adversarial()
    eng = ShardedMaxSum(_port(jt), _cpu(8), assigns=assigns)
    assert eng.comm.info.cut_fraction > 0.5
    assert eng.comm_stats()["mode"] == "dense"


def test_stale_without_boundary_runs_exact():
    t = _port(ring_factor_tensors())
    stale = ShardedMaxSum(t, _cpu(1), overlap="stale")
    assert (stale.comm.mode, stale.comm.collective) == ("exact", "none")
    vd, qd, _ = ShardedMaxSum(t, _cpu(1), overlap="off").run(cycles=8)
    vs, qs, _ = stale.run(cycles=8)
    assert np.array_equal(vs, vd) and torch.equal(stale.beliefs(qs),
                                                  stale.beliefs(qd))


@pytest.mark.parametrize("use_packed", [None, False])
def test_exchange_on_a_cut_that_is_not_pairwise_raises(use_packed):
    jt, assigns = _adversarial()
    for cls, mesh, kw in ((JaxMaxSum, jax_build_mesh(8),
                           dict(use_packed=use_packed)),
                          (ShardedMaxSum, _cpu(8),
                           dict(use_packed=use_packed))):
        with pytest.raises(ValueError, match="pairwise"):
            cls(jt if cls is JaxMaxSum else _port(jt), mesh,
                assigns=assigns, overlap="exact", exchange=True, **kw)


def test_comm_selected_event_equals_jax():
    from pydcop_tpu.runtime.events import event_bus as jax_bus
    from pydcop_tpu_torch.runtime.events import event_bus

    jt = ring_factor_tensors()
    got = []
    for bus, build in ((event_bus, lambda: ShardedMaxSum(
            _port(jt), _cpu(4), overlap="exact", use_packed=False)),
            (jax_bus, lambda: JaxMaxSum(jt, jax_build_mesh(4),
                                        overlap="exact",
                                        use_packed=False))):
        seen = []
        bus.enabled = True
        bus.subscribe("shard.*", lambda t_, e: seen.append((t_, e)))
        try:
            build()
        finally:
            bus.enabled = False
            bus._subs = [(p, cb) for p, cb in bus._subs
                         if not p.startswith("shard.")]
        got.append(seen)
    assert got[0] == got[1]
    assert got[0][0][1]["mode"] == "compact-exact"
    assert got[0][0][1]["packed"] is False


# -- exact and the exchange: the dense run, bit for bit -------------------------

MAXSUM = {
    "ring": lambda: (ring_factor_tensors(), None, {}),
    "ring_damping0": lambda: (ring_factor_tensors(seed=1), None,
                              dict(damping=0.0)),
    "ring_activation": lambda: (ring_factor_tensors(), None,
                                dict(activation=0.6)),
    "adversarial": lambda: (*_adversarial(), {}),
    "secp_mixed": lambda: (_secp(), None, {}),
    "secp_mixed_activation": lambda: (_secp(), None,
                                      dict(activation=0.7)),
}


def _maxsum_runs(jt, assigns, kw, S, overlap, exchange, split):
    t = _port(jt)
    grouping = (mock.patch.object(packed_mesh, "_device_groups", _split)
                if split else contextlib.nullcontext())
    with grouping:
        eng = ShardedMaxSum(t, _cpu(S), assigns=assigns, overlap=overlap,
                            exchange=exchange, **kw)
        assert eng.packs is not None
        assert len(eng.groups) == (2 if split else 1)
        v8, q8, _ = eng.run(cycles=8, seed=3)
        v4, q4, r4 = eng.run(cycles=4, seed=3)
        v44, q44, _ = eng.run(cycles=4, q=q4, r=r4, seed=3)
    return eng, (v8, eng.beliefs(q8)), (v44, eng.beliefs(q44))


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mode", ["exact", "exchange"])
@pytest.mark.parametrize("name", sorted(MAXSUM))
def test_packed_maxsum_exact_equals_dense(name, mode, split):
    jt, assigns, kw = MAXSUM[name]()
    S = 4 if name.startswith("secp") else 8
    _, dense, dense44 = _maxsum_runs(jt, assigns, kw, S, "off", None, split)
    exchange = mode == "exchange"
    if exchange and not _pairwise(jt, assigns, S):
        with pytest.raises(ValueError, match="pairwise"):
            _maxsum_runs(jt, assigns, kw, S, "exact", True, split)
        return
    eng, comp, comp44 = _maxsum_runs(jt, assigns, kw, S, "exact",
                                     exchange, split)
    assert eng.comm.mode == "exact"
    assert eng.comm.collective == ("ppermute" if exchange else "psum")
    for a, b in ((dense, comp), (dense44, comp44)):
        assert np.array_equal(a[0], b[0])
        assert torch.equal(a[1], b[1])


def _pairwise(jt, assigns, S):
    from pydcop_tpu_torch.parallel.boundary import analyze_boundary
    from pydcop_tpu_torch.parallel.partition import partition_factors

    vis = [np.asarray(b.var_idx) for b in jt.buckets]
    if assigns is None:
        assigns = partition_factors(vis, jt.n_vars, S)
    return analyze_boundary(vis, assigns, jt.n_vars, S).pairwise


LS = {
    "mgm": dict(rule="mgm"),
    "dsa": dict(rule="dsa"),
    "adsa": dict(rule="adsa", algo_params={"activation": 0.7,
                                           "variant": "B"}),
}


def _ls_run(jt, rule_kw, S, overlap, exchange, split, cycles=8):
    kw = dict(rule_kw)
    grouping = (mock.patch.object(packed_mesh, "_device_groups", _split)
                if split else contextlib.nullcontext())
    with grouping:
        eng = ShardedLocalSearch(_port(jt), _cpu(S), overlap=overlap,
                                 exchange=exchange, **kw)
        assert eng.packs is not None
        v, x, _ = eng.run_chunked(cycles, seed=3)
    return eng, v, eng.state_values(x)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mode", ["exact", "exchange"])
@pytest.mark.parametrize("graph", ["ring", "adversarial"])
@pytest.mark.parametrize("rule", sorted(LS))
def test_packed_local_search_exact_equals_dense(rule, graph, mode, split):
    jt = jax_cg(ring_dcop() if graph == "ring" else random_instance(seed=2))
    _, vd, xd = _ls_run(jt, LS[rule], 8, "off", None, split)
    exchange = mode == "exchange"
    try:
        eng, vc, xc = _ls_run(jt, LS[rule], 8, "exact", exchange, split)
    except ValueError as e:  # the all-boundary cut is not pairwise
        assert exchange and graph == "adversarial" and "pairwise" in str(e)
        return
    assert eng.comm.compact
    assert np.array_equal(vc, vd) and np.array_equal(xc, xd)


def test_two_group_views_differ_off_their_columns():
    """In two groups the compact beliefs are views: each group's is right
    at its own shards' columns only, and the owner reconcile gives the
    dense beliefs."""
    jt = ring_factor_tensors()
    with mock.patch.object(packed_mesh, "_device_groups", _split):
        dense = ShardedMaxSum(_port(jt), _cpu(8), overlap="off")
        comp = ShardedMaxSum(_port(jt), _cpu(8), overlap="exact",
                             exchange=False)
        _, qd, _ = dense.run(cycles=6)
        _, qc, _ = comp.run(cycles=6)
    views = [qc[1][g.index[0]] for g in comp.groups]
    assert not torch.equal(views[0], views[1])
    want = dense.beliefs(qd)
    assert torch.equal(comp.beliefs(qc), want)
    for g, view in zip(comp.groups, views):
        cols = torch.unique(torch.cat([sh.slot_col.long()
                                       for sh in g.shards]))
        assert torch.equal(view[:, cols], want[:, cols])


# -- stale ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ring", "ring_activation", "secp_mixed"])
def test_packed_maxsum_stale_one_group_equals_two(name):
    jt, assigns, kw = MAXSUM[name]()
    S = 4 if name.startswith("secp") else 8
    eng, one, _ = _maxsum_runs(jt, assigns, kw, S, "stale", None, False)
    assert eng.comm.mode == "stale"
    _, two, _ = _maxsum_runs(jt, assigns, kw, S, "stale", None, True)
    _, dense, _ = _maxsum_runs(jt, assigns, kw, S, "off", None, False)
    assert np.array_equal(one[0], two[0]) and torch.equal(one[1], two[1])
    assert not torch.equal(one[1], dense[1])  # the halo is a cycle behind


@pytest.mark.parametrize("rule", sorted(LS))
def test_packed_local_search_stale_one_group_equals_two(rule):
    jt = jax_cg(ring_dcop())
    one = _ls_run(jt, LS[rule], 8, "stale", None, False, cycles=12)
    two = _ls_run(jt, LS[rule], 8, "stale", None, True, cycles=12)
    assert one[0].comm.mode == "stale"
    assert np.array_equal(one[1], two[1])


def test_packed_stale_starts_from_the_unary_halo():
    """The first stale cycle combines a zero boundary total: the beliefs
    at the boundary columns are the unary costs; interior columns are
    the dense cycle's."""
    jt = ring_factor_tensors()
    t = _port(jt)
    stale = ShardedMaxSum(t, _cpu(8), overlap="stale")
    dense = ShardedMaxSum(t, _cpu(8), overlap="off")
    _, qs, _ = stale.run(cycles=1)
    _, qd, _ = dense.run(cycles=1)
    bnd = torch.as_tensor(stale.comm.info.boundary_vars)
    inner = torch.as_tensor(np.flatnonzero(~stale.comm.info.boundary_mask))
    unary = stale.packs.common_on(torch.device("cpu"))[0]
    assert torch.equal(stale.beliefs(qs)[:, bnd], unary[:, bnd])
    assert torch.equal(stale.beliefs(qs)[:, inner],
                       dense.beliefs(qd)[:, inner])


@pytest.mark.parametrize("damping", [0.5, 0.0])
def test_packed_maxsum_stale_equals_jax_packed_stale(damping):
    """JAX's packed engine in interpret mode, three cycles of a 32-variable
    ring at four shards: values exactly, the owner-reconciled beliefs at
    the JAX package's atol."""
    jt = ring_factor_tensors(V=32, seed=2)
    j = JaxMaxSum(jt, jax_build_mesh(4), damping=damping, use_packed=True,
                  overlap="stale")
    p = ShardedMaxSum(_port(jt), _cpu(4), damping=damping, overlap="stale")
    assert (j.comm.mode, p.comm.mode) == ("stale", "stale")
    jv, jq, _ = j.run(cycles=3)
    v, q, _ = p.run(cycles=3)
    assert np.array_equal(v, np.asarray(jv))
    own = np.asarray(j.packs.own_rows)[:, 0]
    jb = (np.asarray(jq[1]) * own[:, None, :]).sum(0)
    jb = jb[:, np.asarray(j.packs.pg0.var_order)]
    assert np.allclose(p.beliefs(q).numpy(), jb, atol=1e-4)


# -- the neighbour exchange on an odd ring of shards ----------------------------

#: (use_packed, split): every shard in one group, the shards in two
#: groups, the generic engine (every shard a unit of the exchange)
ODD_LAYOUTS = {"one_group": (None, False), "two_groups": (None, True),
               "generic": (False, False)}


def _grouping(split):
    return (mock.patch.object(packed_mesh, "_device_groups", _split)
            if split else contextlib.nullcontext())


def _directions_split(rounds):
    """Whether some shard pair's two sends fall in different rounds."""
    where = {p: r for r, pairs in enumerate(rounds) for p in pairs}
    return any(where[(a, b)] != where[(b, a)] for a, b in where)


@pytest.mark.parametrize("exchange", [True, None])
@pytest.mark.parametrize("layout", sorted(ODD_LAYOUTS))
@pytest.mark.parametrize("S", [3, 5])
def test_maxsum_exchange_on_an_odd_ring_equals_dense(S, layout, exchange):
    """An odd ring of shards has no perfect matching, so the plan puts a
    pair's two sends in different rounds; each column still adds its
    partner's own partial once and the run equals the dense one bit for
    bit (``exchange=None``: the auto policy picks the exchange)."""
    use_packed, split = ODD_LAYOUTS[layout]
    t = _port(ring_factor_tensors(V=60))
    with _grouping(split):
        dense = ShardedMaxSum(t, _cpu(S), overlap="off",
                              use_packed=use_packed)
        comp = ShardedMaxSum(t, _cpu(S), exchange=exchange,
                             use_packed=use_packed)
        assert (comp.comm.mode, comp.comm.collective) == ("exact",
                                                          "ppermute")
        assert _directions_split(comp.comm.rounds)
        vd, qd, _ = dense.run(cycles=8)
        vc, qc, _ = comp.run(cycles=8)
    assert np.array_equal(vc, vd)
    assert torch.equal(comp.beliefs(qc), dense.beliefs(qd))


@pytest.mark.parametrize("exchange", [True, None])
@pytest.mark.parametrize("layout", sorted(ODD_LAYOUTS))
@pytest.mark.parametrize("rule", ["mgm", "dsa"])
@pytest.mark.parametrize("S", [3, 5])
def test_local_search_exchange_on_an_odd_ring_equals_dense(S, rule, layout,
                                                           exchange):
    use_packed, split = ODD_LAYOUTS[layout]
    t = _port(jax_cg(ring_dcop()))
    out = []
    with _grouping(split):
        for kw in (dict(overlap="off"), dict(exchange=exchange)):
            eng = ShardedLocalSearch(t, _cpu(S), rule=rule,
                                     use_packed=use_packed, **kw)
            v, x, _ = eng.run_chunked(10, seed=3)
            out.append((eng, v, eng.state_values(x)))
    (_, vd, xd), (comp, vc, xc) = out
    assert comp.comm.mode == "exact"
    if comp.comm.collective == "ppermute":  # auto at S=3 takes the psum
        assert _directions_split(comp.comm.rounds)
    else:
        assert exchange is None and S == 3
    assert np.array_equal(vc, vd) and np.array_equal(xc, xd)


# -- packed local search's stale halo against independent references ----------


@pytest.mark.parametrize("cycles", [1, 3])
def test_packed_mgm_stale_equals_jax_packed_stale(cycles):
    """JAX's packed engine in interpret mode on a 32-variable ring at four
    shards, from the same start (MGM draws no coins): the values equal,
    and differ from the dense run's (the halo is a cycle behind)."""
    from pydcop_tpu.algorithms._local_search import random_valid_values
    import jax

    jt = jax_cg(ring_dcop(V=32, seed=1))
    j = JaxLocalSearch(jt, jax_build_mesh(4), rule="mgm", use_packed=True,
                       overlap="stale")
    assert j.packs is not None and j.comm.mode == "stale"
    jv, _, _ = j.run_chunked(cycles, seed=5)
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(5 + 17)))
    got = {}
    for overlap in ("stale", "off"):
        p = ShardedLocalSearch(_port(jt), _cpu(4), rule="mgm",
                               overlap=overlap)
        assert p.packs is not None
        got[overlap], _, _ = p.run_chunked(cycles,
                                           x=p.state_from_values(x0))
    assert np.array_equal(got["stale"], np.asarray(jv))
    assert not np.array_equal(got["stale"], got["off"])


@pytest.mark.parametrize("cycles", [1, 4])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("rule", sorted(LS))
def test_packed_local_search_stale_equals_generic_stale(rule, split, cycles):
    """The packed stale halo (K9's tables, K8's pair) against the generic
    engine's, which is held to the JAX package's generic stale: the same
    partition, start and coins (both engines draw them from the seed
    alike) give the same values, which differ from the dense run's (a
    few cycles in: later the ring settles where the dense run does)."""
    t = _port(jax_cg(ring_dcop()))
    out = []
    with _grouping(split):
        for use_packed, overlap in ((None, "stale"), (False, "stale"),
                                    (None, "off")):
            eng = ShardedLocalSearch(t, _cpu(8), overlap=overlap,
                                     use_packed=use_packed, **LS[rule])
            assert (eng.packs is not None) == (use_packed is None)
            assert eng.comm.mode == ("dense" if overlap == "off"
                                     else "stale")
            out.append(eng.run_chunked(cycles, seed=3)[0])
    assert np.array_equal(out[0], out[1])
    assert not np.array_equal(out[0], out[2])


@pytest.mark.parametrize("layout", sorted(ODD_LAYOUTS))
def test_stale_kept_halo_chunks_equal_one_run(layout):
    """``keep_halo=True`` carries stale's pending boundary totals from one
    run() call to the next: six one-cycle chunks are the six-cycle run,
    beliefs bit for bit.  Without it every chunk restarts the halo at
    zero, and a chunk of one cycle never sees another shard's messages
    at the boundary."""
    use_packed, split = ODD_LAYOUTS[layout]
    t = _port(ring_factor_tensors())
    with _grouping(split):
        eng = ShardedMaxSum(t, _cpu(8), overlap="stale",
                            use_packed=use_packed)
        assert eng.comm.mode == "stale"
        v6, q6, _ = eng.run(cycles=6)
        chunks = {}
        for keep in (True, False):
            q = r = None
            for _ in range(6):
                v, q, r = eng.run(cycles=1, q=q, r=r, keep_halo=keep)
            chunks[keep] = (v, eng.beliefs(q))
    assert np.array_equal(chunks[True][0], v6)
    assert torch.equal(chunks[True][1], eng.beliefs(q6))
    assert not torch.equal(chunks[False][1], eng.beliefs(q6))
