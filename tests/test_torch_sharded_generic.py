"""The port's generic ``[E, D]`` sharded engine (``parallel/generic_mesh.py``
behind ``ShardedMaxSum`` / ``ShardedLocalSearch`` with
``use_packed=False``, for the graphs the packers decline, and for dba and
gdba) against the JAX package's generic sharded engine on its 8-device
virtual CPU mesh.

Both packages run the same compiled arrays with the same factor→shard
assignment (the locality partition, or the placement's).  Held to JAX's
tolerances (``tests/unit/test_boundary_comm.py:1-11``): maxsum values
exactly and its message state (q, r) at ``atol=1e-4``; amaxsum on JAX's
own per-(cycle, shard) masks; mgm, dba and gdba exactly, with the
breakout weights; dsa and adsa exactly on JAX's coins (C-w5); every
overlap mode against the same mode, so ``stale`` against JAX's
``stale`` on the generic engine, including the JAX package's
``GOLDEN_STALE_24``.  Also: the shards split over two groups equal one
group bit for bit, ``exact`` and the exchange equal ``off`` bit for bit
(values, state and weights), ``edit_factor`` equals a fresh engine on the
edited graph in dense and compact mode, the continuation state's host
round trip is JAX's leaves, and the staged operands are JAX's.
"""
import contextlib
import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms._local_search import random_valid_values
from pydcop_tpu.generators import generate_graph_coloring
from pydcop_tpu.generators.secp import generate_secp
from pydcop_tpu.ops.compile import compile_binary_from_arrays as \
    jax_compile_binary
from pydcop_tpu.ops.compile import compile_constraint_graph as jax_cg
from pydcop_tpu.ops.compile import compile_factor_graph as jax_fg
from pydcop_tpu.parallel.mesh import ShardedLocalSearch as JaxLocalSearch
from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
from pydcop_tpu.parallel.mesh import shard_factor_graph as jax_shard
from pydcop_tpu_torch.dcop import load_dcop
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel import ShardedLocalSearch, ShardedMaxSum, \
    build_mesh, packed_mesh, shard_factor_graph

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "unit"))
from test_boundary_comm import GOLDEN_STALE_24, random_instance, \
    ring_dcop, ring_factor_tensors  # noqa: E402

torch.set_num_threads(1)


def _cpu(n):
    return build_mesh(n, "cpu")


def _port(jt):
    return tensors_from_numpy(numpy_fields(jt), device="cpu")


def _split(devices):
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


def _grouping(split):
    return (mock.patch.object(packed_mesh, "_device_groups", _split)
            if split else contextlib.nullcontext())


def _coloring_d10(V=40, E=80, seed=4):
    """A D = 10 colouring: the packers take D <= 8, so both packages run
    their generic engine for it by default."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, E)
    ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
    mats = rng.uniform(0, 1, (E, 10, 10)).astype(np.float32)
    mats += np.eye(10, dtype=np.float32) * 3
    return jax_compile_binary(ei, ej, mats, V)


def _arity5():
    from pydcop_tpu.dcop import load_dcop as jax_load_dcop

    names = "abcdefg"
    src = f"""
name: wide5
objective: min
domains: {{d: {{values: [0, 1]}}}}
variables:
{chr(10).join(f"  {n}: {{domain: d}}" for n in names)}
constraints:
  c1: {{type: intention, function: "a + b + c - d * e"}}
  c2: {{type: intention, function: "c * d + e - f + g"}}
  c3: {{type: intention, function: "2 if a == g else 0"}}
agents: [a1]
"""
    return jax_fg(jax_load_dcop(src))


MAXSUM = {
    "ring": lambda: ring_factor_tensors(),
    "coloring_60": lambda: jax_fg(generate_graph_coloring(
        n_variables=60, n_colors=3, n_edges=150, soft=True, n_agents=4,
        seed=1)),
    "coloring_d10": _coloring_d10,
    "arity5": _arity5,
    "secp_mixed": lambda: jax_fg(generate_secp(
        n_lights=30, n_models=10, n_rules=6, max_model_size=3, seed=3)),
}
MODES = {"off": dict(overlap="off"), "exact": dict(overlap="exact",
                                                   exchange=False),
         "exchange": dict(overlap="exact", exchange=True),
         "stale": dict(overlap="stale")}


def _directions_split(rounds):
    """Whether some shard pair's two sends fall in different rounds of an
    exchange plan (where the JAX exchange double-counts, C-f8)."""
    where = {p: r for r, pairs in enumerate(rounds) for p in pairs}
    return any(where[(a, b)] != where[(b, a)] for a, b in where)


def _maxsum_pair(name, S, mode, **kw):
    jt = MAXSUM[name]()
    kw.update(MODES[mode])
    try:
        j = JaxMaxSum(jt, jax_build_mesh(S), use_packed=False, **kw)
    except ValueError as e:
        assert "pairwise" in str(e)
        with pytest.raises(ValueError, match="pairwise"):
            ShardedMaxSum(_port(jt), _cpu(S), use_packed=False, **kw)
        return None
    p = ShardedMaxSum(_port(jt), _cpu(S), use_packed=False, **kw)
    assert p.st is not None and p.packs is None
    assert p.comm_stats() == j.comm_stats()
    return jt, j, p


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("name", sorted(MAXSUM))
def test_maxsum_equals_jax_generic(name, S, mode):
    pair = _maxsum_pair(name, S, mode)
    if pair is None:
        return
    jt, j, p = pair
    if mode == "exchange" and _directions_split(j.comm.rounds):
        # the JAX exchange counts a partner twice here (C-f8): its psum
        # run, the same function, is the reference
        j = JaxMaxSum(jt, jax_build_mesh(S), use_packed=False,
                      **MODES["exact"])
    jv, jq, jr = j.run(cycles=8)
    v, q, r = p.run(cycles=8)
    assert np.array_equal(v, np.asarray(jv))
    h = p.state_to_host(q, r)
    assert np.allclose(h["leaf_0"], np.asarray(jq), atol=1e-4)
    assert np.allclose(h["leaf_1"], np.asarray(jr), atol=1e-4)
    if mode != "stale":  # stale's halo restarts at every run() call
        v4, q4, r4 = p.run(cycles=4)
        v44, _, _ = p.run(cycles=4, q=q4, r=r4)
        assert np.array_equal(v44, v)


@pytest.mark.parametrize("S", [3, 5])
def test_exchange_on_an_odd_ring_where_jax_counts_a_partner_twice(S):
    """ROADMAP C-f8: on an odd ring of shards the plan puts a pair's two
    sends in different rounds, and the JAX package's exchange sends what
    a shard holds after the earlier rounds, so a column adds its
    partner's partial twice and the run leaves the dense one.  The port
    sends each shard's own partial: its exchange run is the JAX dense
    run."""
    jt = ring_factor_tensors(V=60)
    jd = JaxMaxSum(jt, jax_build_mesh(S), use_packed=False, overlap="off")
    je = JaxMaxSum(jt, jax_build_mesh(S), use_packed=False,
                   overlap="exact", exchange=True)
    p = ShardedMaxSum(_port(jt), _cpu(S), use_packed=False,
                      overlap="exact", exchange=True)
    assert (je.comm.collective, p.comm.collective) == ("ppermute",
                                                       "ppermute")
    jdv, jdq, _ = jd.run(cycles=8)
    _, jeq, _ = je.run(cycles=8)
    v, q, r = p.run(cycles=8)
    assert np.array_equal(v, np.asarray(jdv))
    assert np.allclose(p.state_to_host(q, r)["leaf_0"], np.asarray(jdq),
                       atol=1e-4)
    assert not np.allclose(np.asarray(jeq), np.asarray(jdq), atol=1e-4)


def test_stale_golden_stream():
    """The JAX package's guarded golden of the stale halo schedule: the
    generic engine at 4 shards, 6 cycles of a 24-variable ring."""
    t = _port(ring_factor_tensors(V=24, seed=7))
    vs, _, _ = ShardedMaxSum(t, _cpu(4), damping=0.5, overlap="stale",
                             use_packed=False).run(cycles=6, seed=11)
    assert vs.tolist() == GOLDEN_STALE_24
    vd, _, _ = ShardedMaxSum(t, _cpu(4), damping=0.5, overlap="off",
                             use_packed=False).run(cycles=6, seed=11)
    assert vs.shape == vd.shape


def _jax_masks(j, p, cycles, seed, activation):
    """The JAX generic engine's amaxsum draws of a fresh run (epoch 0):
    per cycle key k, per shard s, ``uniform(fold_in(k, s), (Es, 1))``."""
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(seed), 0), cycles)
    Es = p.st.edges_per_shard
    return [torch.as_tensor(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(k, s),
                                      (Es, 1)))[:, 0] for k in keys]))
        for s in range(p.n_shards)]


@pytest.mark.parametrize("mode", ["off", "exact", "stale"])
@pytest.mark.parametrize("name", ["ring", "coloring_d10"])
def test_amaxsum_equals_jax_generic_on_its_masks(name, mode):
    jt, j, p = _maxsum_pair(name, 4, mode, activation=0.6)
    jv, jq, _ = j.run(cycles=6, seed=5)
    draws = _jax_masks(j, p, 6, 5, 0.6)
    with mock.patch.object(p, "draw_uniforms", lambda n: draws):
        v, q, _ = p.run(cycles=6, seed=5)
    assert np.array_equal(v, np.asarray(jv))
    assert np.allclose(p.state_to_host(q, q)["leaf_0"], np.asarray(jq),
                       atol=1e-4)


@pytest.mark.parametrize("activation", [None, 0.6])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_two_groups_equal_one_group(mode, activation):
    jt = ring_factor_tensors(seed=3)
    out = []
    for split in (False, True):
        with _grouping(split):
            eng = ShardedMaxSum(_port(jt), _cpu(8), use_packed=False,
                                activation=activation, **MODES[mode])
            assert len(eng.groups) == (2 if split else 1)
            v, q, r = eng.run(cycles=8, seed=2)
            out.append((v, eng.state_to_host(q, r)))
    assert np.array_equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert np.array_equal(out[0][1][k], out[1][1][k])


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mode", ["exact", "exchange"])
@pytest.mark.parametrize("graph", ["ring", "adversarial"])
def test_maxsum_exact_equals_dense(graph, mode, split):
    if graph == "ring":
        jt, assigns = ring_factor_tensors(), None
    else:
        jt = jax_fg(random_instance())
        rng = np.random.default_rng(3)
        assigns = [rng.integers(0, 8, jt.n_factors).astype(np.int32)]
    with _grouping(split):
        dense = ShardedMaxSum(_port(jt), _cpu(8), use_packed=False,
                              assigns=assigns, overlap="off")
        vd, qd, rd = dense.run(cycles=8)
        try:
            comp = ShardedMaxSum(_port(jt), _cpu(8), use_packed=False,
                                 assigns=assigns, **MODES[mode])
        except ValueError as e:
            assert graph == "adversarial" and mode == "exchange"
            assert "pairwise" in str(e)
            return
        vc, qc, rc = comp.run(cycles=8)
    assert comp.comm.compact
    assert np.array_equal(vc, vd)
    hd, hc = dense.state_to_host(qd, rd), comp.state_to_host(qc, rc)
    assert all(np.array_equal(hd[k], hc[k]) for k in hd)


# -- local search -----------------------------------------------------------

LS_GRAPHS = {
    "ring": lambda: jax_cg(ring_dcop()),
    "adversarial": lambda: jax_cg(random_instance(seed=2)),
    "coloring_hard": lambda: jax_cg(generate_graph_coloring(
        n_variables=40, n_colors=3, n_edges=90, soft=False, n_agents=4,
        seed=2)),
}
LS_RULES = {
    "mgm": dict(rule="mgm"),
    "dsa": dict(rule="dsa"),
    "adsa": dict(rule="adsa", algo_params={"activation": 0.7,
                                           "variant": "B"}),
    "dba": dict(rule="dba"),
    "gdba": dict(rule="gdba"),
    "gdba_M_NM_R": dict(rule="gdba", algo_params={
        "modifier": "M", "violation": "NM", "increase_mode": "R"}),
    "gdba_A_MX_C": dict(rule="gdba", algo_params={
        "violation": "MX", "increase_mode": "C"}),
    "gdba_A_NZ_T": dict(rule="gdba", algo_params={"increase_mode": "T"}),
}


def _jax_coins(rule, V, cycles, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), cycles)
    if rule == "dsa":
        return np.stack([np.asarray(jax.random.uniform(k, (V,)))
                         for k in keys])
    wake, move = [], []
    for k in keys:
        k_wake, k_move = jax.random.split(k)
        wake.append(np.asarray(jax.random.uniform(k_wake, (V,))))
        move.append(np.asarray(jax.random.uniform(k_move, (V,))))
    return np.stack(wake), np.stack(move)


def _ls_run_pair(graph, case, mode, S=8, cycles=10, seed=3):
    jt = LS_GRAPHS[graph]()
    kw = dict(LS_RULES[case])
    rule = kw.pop("rule")
    kw.update(MODES[mode])
    try:
        j = JaxLocalSearch(jt, jax_build_mesh(S), rule=rule,
                           use_packed=False, **kw)
    except ValueError as e:
        assert "pairwise" in str(e)
        return None
    p = ShardedLocalSearch(_port(jt), _cpu(S), rule=rule, use_packed=False,
                           **kw)
    assert p.st is not None and p.comm_stats() == j.comm_stats()
    if mode == "exchange" and _directions_split(j.comm.rounds):  # C-f8
        kw.update(MODES["exact"])
        j = JaxLocalSearch(jt, jax_build_mesh(S), rule=rule,
                           use_packed=False, **kw)
    jv, _, jaux = j.run_chunked(cycles, seed=seed)
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(seed + 17)))
    coins = (_jax_coins(rule, jt.n_vars, cycles, seed)
             if rule in ("dsa", "adsa") else None)
    v, x, aux = p.run_chunked(cycles, x=p.state_from_values(x0),
                              coins=coins)
    return p, (np.asarray(jv), [np.asarray(a) for a in jaux]), (v, x, aux)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(LS_RULES))
@pytest.mark.parametrize("graph", ["ring", "adversarial"])
def test_local_search_equals_jax_generic(graph, case, mode):
    out = _ls_run_pair(graph, case, mode)
    if out is None:
        return
    p, (jv, jaux), (v, x, aux) = out
    assert np.array_equal(v, jv)
    assert np.array_equal(p.state_values(x), v)
    got_aux = p.aux_numpy(aux)
    assert len(got_aux) == len(jaux)
    for a, b in zip(got_aux, jaux):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["mgm", "dba", "gdba", "dsa", "adsa"])
def test_local_search_hard_coloring_equals_jax(case):
    p, (jv, jaux), (v, x, aux) = _ls_run_pair("coloring_hard", case, "off",
                                              S=4, cycles=16)
    assert np.array_equal(v, jv)
    assert all(np.array_equal(a, b) for a, b in zip(p.aux_numpy(aux), jaux))


@pytest.mark.parametrize("graph", ["ring", "adversarial"])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("mode", ["exact", "exchange", "stale"])
@pytest.mark.parametrize("case", ["mgm", "dsa", "adsa", "dba", "gdba"])
def test_local_search_modes_and_groups(case, mode, split, graph):
    """exact and the exchange equal off bit for bit (values, weights), on
    the ring's locality cut and on the all-boundary cut; two groups equal
    one group in every mode."""
    jt = LS_GRAPHS[graph]()
    kw = dict(LS_RULES[case])
    rule = kw.pop("rule")
    if mode == "exchange" and graph == "adversarial":
        with pytest.raises(ValueError, match="pairwise"):
            ShardedLocalSearch(_port(jt), _cpu(8), rule=rule,
                               use_packed=False, **kw, **MODES[mode])
        return
    runs = {}
    for m, sp in (("off", False), (mode, False), (mode, split)):
        with _grouping(sp):
            eng = ShardedLocalSearch(_port(jt), _cpu(8), rule=rule,
                                     use_packed=False, **kw,
                                     **MODES[m])
            v, x, aux = eng.run_chunked(10, seed=4)
            runs[m, sp] = (v, eng.aux_numpy(aux))
    one, two = runs[mode, False], runs[mode, split]
    assert np.array_equal(one[0], two[0])
    assert all(np.array_equal(a, b) for a, b in zip(one[1], two[1]))
    if mode != "stale":
        off = runs["off", False]
        assert np.array_equal(off[0], one[0])
        assert all(np.array_equal(a, b) for a, b in zip(off[1], one[1]))


def test_generic_mgm_is_the_packed_trajectory():
    """MGM draws no coin: on integer costs the generic sharded engine and
    the packed one walk the same trajectory (as the JAX package pins its
    packed MGM trajectory-identical to its generic engines)."""
    jt = LS_GRAPHS["coloring_hard"]()
    t = _port(jt)
    gen = ShardedLocalSearch(t, _cpu(8), rule="mgm", use_packed=False)
    packed = ShardedLocalSearch(t, _cpu(8), rule="mgm")
    assert gen.st is not None and packed.packs is not None
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(9)))
    for n in (1, 5, 20):
        a = gen.run_chunked(n, x=gen.state_from_values(x0))[0]
        b = packed.run_chunked(n, x=packed.state_from_values(x0))[0]
        assert np.array_equal(a, b)


# -- engine choice ----------------------------------------------------------


def test_out_of_scope_graphs_take_the_generic_engine_by_scope():
    for name in ("coloring_d10", "arity5"):
        t = _port(MAXSUM[name]())
        assert packed_mesh.packers_decline(t) is not None
        assert ShardedMaxSum(t, _cpu(4)).st is not None
        assert ShardedMaxSum(t, _cpu(4), use_packed=True).st is not None
    t = _port(MAXSUM["ring"]())
    assert packed_mesh.packers_decline(t) is None
    assert ShardedMaxSum(t, _cpu(4)).packs is not None
    assert ShardedMaxSum(t, _cpu(4), use_packed=False).st is not None
    tc = _port(LS_GRAPHS["ring"]())
    for rule in ("dba", "gdba"):
        assert ShardedLocalSearch(tc, _cpu(4), rule=rule).st is not None


def test_a_packer_error_raises():
    """No fallback: an error of the packers on a graph in their scope is
    the engine's error."""
    t = _port(MAXSUM["ring"]())

    def broken(*a, **k):
        raise RuntimeError("packer bug")

    with mock.patch("pydcop_tpu_torch.parallel.mesh.build_shard_packs",
                    broken):
        with pytest.raises(RuntimeError, match="packer bug"):
            ShardedMaxSum(t, _cpu(4))
        with pytest.raises(RuntimeError, match="packer bug"):
            ShardedLocalSearch(t, _cpu(4), rule="mgm")
        assert ShardedMaxSum(t, _cpu(4), use_packed=False).st is not None


# -- layout, continuation state and operands ----------------------------------


@pytest.mark.parametrize("S", [2, 3, 8])
@pytest.mark.parametrize("name", ["ring", "secp_mixed", "arity5"])
def test_shard_factor_graph_equals_jax(name, S):
    jt = MAXSUM[name]()
    got = shard_factor_graph(_port(jt), S)
    want = jax_shard(jt, S)
    assert got.edges_per_shard == want.edges_per_shard
    assert np.array_equal(got.edge_var, np.asarray(want.edge_var))
    assert len(got.buckets) == len(want.buckets)
    for a, b in zip(got.buckets, want.buckets):
        assert (a.arity, a.factors_per_shard) == (b.arity,
                                                  b.factors_per_shard)
        assert np.array_equal(a.tensors, np.asarray(b.tensors))
        assert np.array_equal(a.var_idx, np.asarray(b.var_idx))
    for a, b in zip(got.factor_rows, want.factor_rows):
        assert np.array_equal(a, b)
    assert np.array_equal(got.boundary.touch, want.boundary.touch)


def test_local_row_layout_and_pairs_equal_jax():
    from pydcop_tpu.parallel import mesh as jm
    from pydcop_tpu_torch.parallel import generic_mesh as G
    from pydcop_tpu_torch.parallel.boundary import build_exchange_plan, \
        padded_boundary_idx

    jt = ring_factor_tensors()
    st, jst = shard_factor_graph(_port(jt), 8), jax_shard(jt, 8)
    bnd = padded_boundary_idx(st.boundary)
    lr, jlr = G.local_row_layout(st, bnd), jm._local_row_layout(
        jst, np.asarray(jst.bnd_rows))
    assert lr["deg"] == jlr["deg"] and lr["rows"] == jlr["rows"]
    for k in ("gather_tbl", "edge_loc", "unary_loc", "dmask_loc",
              "slab_loc", "glob_loc"):
        assert np.array_equal(lr[k], np.asarray(jlr[k])), k
    plan = build_exchange_plan(
        st.boundary, [np.asarray(b.var_idx) for b in jt.buckets],
        st.assigns)
    send, recv = G.exchange_to_local(st, lr, plan.send_idx, plan.recv_idx)
    comm = jm._plan_comm("exact", 0.5, True, jst.boundary, jst.bnd_rows,
                         jst.own_rows, (jst.exch_send, jst.exch_recv,
                                        jst.exch_valid),
                         jst.exch_rounds, jst.n_vars + 1, 3)
    jsend, jrecv, _ = jm._exchange_to_local(jst, jlr, comm)
    assert np.array_equal(send, np.asarray(jsend))
    assert np.array_equal(recv, np.asarray(jrecv))
    src, dst = G.neighbor_pair_blocks(st)
    jsrc, jdst = jm._neighbor_pair_blocks(jst)
    assert np.array_equal(src.reshape(-1), jsrc)
    assert np.array_equal(dst.reshape(-1), jdst)


@pytest.mark.parametrize("activation", [None, 0.6])
@pytest.mark.parametrize("use_packed", [None, False])
def test_state_host_round_trip(use_packed, activation):
    jt = ring_factor_tensors()
    eng = ShardedMaxSum(_port(jt), _cpu(4), use_packed=use_packed,
                        activation=activation)
    v, q, r = eng.run(cycles=5, seed=1)
    host = eng.state_to_host(q, r)
    q2, r2 = eng.state_from_host(host)
    coins = eng.coins.get_state()  # amaxsum's masks draw on: replay them
    va, _, _ = eng.run(cycles=5, q=q, r=r)
    eng.coins.set_state(coins)
    vb, _, _ = eng.run(cycles=5, q=q2, r=r2)
    assert np.array_equal(va, vb)
    if use_packed is False:
        j = JaxMaxSum(jt, jax_build_mesh(4), use_packed=False)
        jq, jr = j.init_messages()
        want = j.state_to_host(jq, jr)
        got = eng.state_to_host(*eng.init_messages())
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape for k in got)
    with pytest.raises(ValueError, match="leaves"):
        eng.state_from_host({"leaf_0": host["leaf_0"]})
    with pytest.raises(ValueError):
        eng.state_to_host(None, None)


def test_generic_operands_equal_jax():
    jt = jax_cg(ring_dcop())
    for build_j, build_p in (
            (lambda: JaxMaxSum(jax_fg(ring_dcop()), jax_build_mesh(4),
                               use_packed=False),
             lambda: ShardedMaxSum(_port(jax_fg(ring_dcop())), _cpu(4),
                                   use_packed=False)),
            (lambda: JaxLocalSearch(jt, jax_build_mesh(4), rule="mgm",
                                    use_packed=False),
             lambda: ShardedLocalSearch(_port(jt), _cpu(4), rule="mgm",
                                        use_packed=False))):
        j, p = build_j(), build_p()
        assert p.operand_names() == j.operand_names()
        for name in p.operand_names():
            assert np.array_equal(p.get_operand(name).numpy(),
                                  np.asarray(j.get_operand(name)))
        with pytest.raises(ValueError, match="unknown operand"):
            p.get_operand("cost")


def test_set_operand_runs_as_jax():
    jt = jax_cg(ring_dcop())
    j = JaxLocalSearch(jt, jax_build_mesh(4), rule="mgm", use_packed=False)
    p = ShardedLocalSearch(_port(jt), _cpu(4), rule="mgm",
                           use_packed=False)
    new = np.asarray(j.get_operand("bucket0")).copy()
    new[: new.shape[0] // 2] *= 0.25
    j.set_operand("bucket0", new)
    p.set_operand("bucket0", new)
    jv, _, _ = j.run_chunked(8, seed=1)
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(18)))
    v, _, _ = p.run_chunked(8, x=p.state_from_values(x0))
    assert np.array_equal(v, np.asarray(jv))
    with pytest.raises(ValueError, match="shape"):
        p.set_operand("bucket0", new[:1])


def test_packed_operands_and_edit_raise_jax_errors():
    t = _port(ring_factor_tensors())
    eng = ShardedMaxSum(t, _cpu(2))
    assert eng.operand_names() == ("cost",)
    cost = eng.get_operand("cost")
    eng.set_operand("cost", cost.clone())
    with pytest.raises(ValueError, match="unknown packed operand"):
        eng.get_operand("bucket0")
    with pytest.raises(NotImplementedError, match="use_packed=False"):
        eng.edit_factor(0, 0, np.zeros((3, 3), np.float32))


def _ring_instance(V=20, F=30, D=3, seed=1):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    return ei, ej, mats, jax_compile_binary(ei, ej, mats, V)


@pytest.mark.parametrize("mode", ["off", "exact", "exchange"])
def test_edit_factor_equals_a_fresh_engine(mode):
    ei, ej, mats, jt = _ring_instance(seed=4)
    rng = np.random.default_rng(10)
    new_tab = rng.uniform(0, 5, mats.shape[1:]).astype(np.float32)
    kw = MODES[mode]
    try:
        eng = ShardedMaxSum(_port(jt), _cpu(2), use_packed=False, **kw)
    except ValueError:
        pytest.skip("the cut is not pairwise")  # pragma: no cover
    _, q, r = eng.run(cycles=8)
    info = eng.st.boundary
    eng.edit_factor(0, 7, new_tab)
    assert np.array_equal(eng.st.boundary.touch, info.touch)
    v2, q2, r2 = eng.run(cycles=8, q=q, r=r)
    mats2 = mats.copy()
    mats2[7] = new_tab
    jt2 = jax_compile_binary(ei, ej, mats2, jt.n_vars)
    fresh = ShardedMaxSum(_port(jt2), _cpu(2), use_packed=False)
    _, qf, rf = fresh.run(cycles=8)
    # the fresh engine ran its first 8 cycles on the edited table: restart
    # it from the edited engine's state to compare the same trajectory
    qs, rs = fresh.state_from_host(eng.state_to_host(q, r))
    vf2, qf2, rf2 = fresh.run(cycles=8, q=qs, r=rs)
    assert np.array_equal(v2, vf2)
    h, hf = eng.state_to_host(q2, r2), fresh.state_to_host(qf2, rf2)
    assert all(np.array_equal(h[k], hf[k]) for k in h)
    # and as the JAX package's edit
    j = JaxMaxSum(jt, jax_build_mesh(2), use_packed=False, **kw)
    _, jq, jr = j.run(cycles=8)
    j.edit_factor(0, 7, new_tab)
    jv2, _, _ = j.run(cycles=8, q=jq, r=jr)
    assert np.array_equal(v2, np.asarray(jv2))


def test_edit_factor_validates():
    _ei, _ej, mats, jt = _ring_instance()
    eng = ShardedMaxSum(_port(jt), _cpu(2), use_packed=False)
    with pytest.raises(ValueError, match="scope"):
        eng.edit_factor(0, 7, np.zeros((2, 2), np.float32))


def test_placement_metrics_equal_jax_out_of_the_packers_scope():
    """A graph the packers decline runs the generic engine in both
    packages' placement path: metrics()["shard"] and the config equal."""
    from pydcop_tpu.dcop import dcop_yaml
    from pydcop_tpu.dcop import load_dcop as jax_load_dcop
    from pydcop_tpu.distribution.objects import Distribution as JaxDist
    from pydcop_tpu.runtime import solve_result as jax_solve_result
    from pydcop_tpu_torch.distribution import Distribution
    from pydcop_tpu_torch.runtime import solve_result

    lines = ["name: d10", "objective: min",
             "domains: {d: {values: [0,1,2,3,4,5,6,7,8,9]}}", "variables:"]
    lines += [f"  v{i:02d}: {{domain: d}}" for i in range(16)]
    lines += ["constraints:"]
    rng = np.random.default_rng(2)
    for k in range(30):
        a, b = rng.choice(16, 2, replace=False)
        lines.append(f"  c{k:02d}: {{type: intention, function: "
                     f"\"{k % 5 + 1} if v{a:02d} == v{b:02d} else "
                     f"abs(v{a:02d} - v{b:02d}) * 0.1\"}}")
    lines.append("agents: [" + ", ".join(f"a{i}" for i in range(8)) + "]")
    src = "\n".join(lines) + "\n"
    jd, d = jax_load_dcop(src), load_dcop(src)
    comps = sorted(jd.variables) + sorted(jd.constraints)
    mapping = {f"a{i}": comps[i::8] for i in range(8)}
    for overlap in (None, "off", "exact", "stale"):
        want = jax_solve_result(jd, "maxsum", distribution=JaxDist(mapping),
                                cycles=12, shard_overlap=overlap)
        got = solve_result(d, "maxsum", distribution=Distribution(mapping),
                           cycles=12, n_shards=8, device="cpu",
                           shard_overlap=overlap)
        assert got.metrics()["shard"] == want.metrics()["shard"]
        assert got.config == want.config
        assert got.assignment == want.assignment and got.cost == want.cost
    assert dcop_yaml(jd)


def test_local_rows_keep_a_variable_no_factor_touches():
    """The compact generic maxsum runs on the shards' local rows (JAX's
    ``_local_row_layout``), and a variable no factor touches keeps its
    unary argmin, as in the dense run.  The JAX package's local-row
    finalize adds only the touched rows, so there it reads 0 (ROADMAP
    C-f7): its compact run differs from its dense run at ``z``."""
    from pydcop_tpu.dcop import load_dcop as jax_load_dcop

    src = """
name: iso
objective: min
domains: {d: {values: [0, 1, 2]}}
variables:
  a: {domain: d}
  b: {domain: d}
  c: {domain: d}
  z: {domain: d, cost_function: "3 - z"}
constraints:
  c1: {type: intention, function: "1 if a == b else 0"}
  c2: {type: intention, function: "1 if b == c else 0"}
  c3: {type: intention, function: "1 if a == c else 0"}
agents: [a1]
"""
    jt = jax_fg(jax_load_dcop(src))
    z = jt.var_names.index("z")
    got = {}
    for mode in ("off", "exact", "stale"):
        eng = ShardedMaxSum(_port(jt), _cpu(2), use_packed=False,
                            overlap=mode)
        if mode != "off":
            assert eng._lrows is not None
        got[mode] = eng.run(cycles=5)[0]
    assert got["off"][z] == got["exact"][z] == got["stale"][z] == 2
    assert np.array_equal(got["off"], got["exact"])
    jv = {mode: np.asarray(JaxMaxSum(jt, jax_build_mesh(2), use_packed=False,
                                     overlap=mode).run(cycles=5)[0])
          for mode in ("off", "exact")}
    assert jv["off"][z] == 2 and jv["exact"][z] == 0  # C-f7
    mask = np.arange(jt.n_vars) != z
    assert np.array_equal(jv["exact"][mask], got["exact"][mask])


@pytest.mark.parametrize("mode", ["exact", "exchange", "stale"])
def test_local_rows_equal_the_global_rows(mode):
    """The local-row cycle and the global-row one (a fan-in past the
    layout's bound) are the same run, bit for bit."""
    from pydcop_tpu_torch.parallel import generic_mesh as G

    jt = ring_factor_tensors(seed=5)
    eng = ShardedMaxSum(_port(jt), _cpu(8), use_packed=False, **MODES[mode])
    assert eng._lrows is not None
    v, q, r = eng.run(cycles=8)
    with mock.patch.object(G, "LOCAL_ROW_MAX_DEG", 1):
        glob = ShardedMaxSum(_port(jt), _cpu(8), use_packed=False,
                             **MODES[mode])
    assert glob._lrows is None
    vg, qg, rg = glob.run(cycles=8)
    assert np.array_equal(v, vg)
    h, hg = eng.state_to_host(q, r), glob.state_to_host(qg, rg)
    assert all(np.array_equal(h[k], hg[k]) for k in h)
