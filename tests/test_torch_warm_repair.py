"""Warm repair in the port (``ops/headroom.py``, ``algorithms/warm.py``,
``runtime/repair.py``) held to the JAX package on the CPU.

* **the capacity layout**: ``reserve_headroom`` and ``make_operands`` on
  all six test instances, as a factor graph and as a constraints
  hypergraph, equal to JAX's arrays exactly (names, domains, masks,
  unary rows, tables, scopes, factor ids, edge offsets, the edge→var map,
  the layout's maps, the derived neighbour pairs);
* **every mutation write**: a stream of table edits, variable and factor
  adds and removes applied to both packages' operands — the operands and
  each ``Dirty`` equal JAX's exactly after every mutation, the refused
  mutations refused alike and the layout untouched;
* **the 50-mutation stream**: the JAX test's seeded churn stream
  (``tests/unit/test_warm_repair.py``) on a 24-variable colouring through
  both packages' ``WarmRepairController`` — warm mgm equal to JAX's after
  every phase (assignment, cost, stop cycle), warm maxsum at noise 0
  with equal values and messages within ``atol=1e-4``; dsa and adsa are
  held to the port's own CPU stream (ROADMAP C-w5): after the stream the
  warm view's local cost tables and one cycle from the same coins equal
  the cold engine's on a fresh compile of the mutated DCOP;
* **no re-capture**: ``trace_count()`` unchanged over the stream; headroom
  exhaustion gives exactly one repack, one more capture and one
  ``repair.repack`` event; the depth reserve of the port's plans behaves
  like a slot reserve;
* the lifted entry points: ``solve_result(headroom=)`` (``metrics()
  ["repair"]``), ``solve --headroom`` and ``maxsum_dynamic(headroom=)``.

Instances are small and cycle budgets short: the whole file runs in
seconds besides JAX's jit compiles."""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms.warm import build_warm_solver as jax_build
from pydcop_tpu.ops import headroom as jh
from pydcop_tpu.runtime.repair import WarmRepairController as JaxController
from pydcop_tpu.runtime.repair import perturbed_constraint as jax_perturbed
from pydcop_tpu_torch import cli
from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.warm import (
    WarmLocalSearchSolver,
    WarmMaxSumSolver,
    build_warm_solver,
    repack_solver,
)
from pydcop_tpu_torch.ops import headroom as th
from pydcop_tpu_torch.ops.compile import (
    compile_constraint_graph,
    local_cost_tables,
)
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.events import event_bus
from pydcop_tpu_torch.runtime.repair import (
    WarmRepairController,
    perturbed_constraint,
)
from pydcop_tpu_torch.runtime.stats import REPAIR_COUNTERS, RepairCounters

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]

YAML = textwrap.dedent("""
    name: t
    objective: min
    domains:
      d: {values: [0, 1, 2]}
    variables:
      v1: {domain: d}
      v2: {domain: d}
      v3: {domain: d}
      v4: {domain: d}
    constraints:
      c12: {type: intention, function: "0 if v1 == v2 else 5"}
      c23: {type: intention, function: "0 if v2 != v3 else 3"}
      c34: {type: intention, function: "abs(v3 - v4)"}
    agents: [a1, a2, a3, a4, a5, a6, a7, a8]
""")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _colouring_yaml(n=24, seed=5):
    """A seeded soft 3-colouring made with the JAX package's generator,
    as YAML both packages load."""
    from pydcop_tpu.dcop.yamldcop import dcop_yaml
    from pydcop_tpu.generators import generate_graph_coloring

    return dcop_yaml(generate_graph_coloring(
        n_variables=n, n_colors=3, n_edges=2 * n, soft=True, seed=seed))


def _pair(path=None, yaml=None):
    if path is not None:
        return (jdc.load_dcop_from_file(path),
                tdc.load_dcop_from_file(path))
    return jdc.load_dcop(yaml), tdc.load_dcop(yaml)


def _assert_cap_equal(jcap, jlay, tcap, tlay, arrays=True):
    """The capacity graphs equal; ``arrays=False`` leaves out the device
    arrays, which a JAX mutation writes into its operands only (the port
    writes them in place, so its graph and its operands are one)."""
    assert tcap.var_names == jcap.var_names
    assert tcap.domain_values == list(jcap.domain_values)
    assert np.array_equal(_np(tcap.domain_sizes), _np(jcap.domain_sizes))
    if arrays:
        assert np.array_equal(_np(tcap.domain_mask), _np(jcap.domain_mask))
        assert np.array_equal(_np(tcap.unary_costs), _np(jcap.unary_costs))
        assert np.array_equal(_np(tcap.edge_var), _np(jcap.edge_var))
    assert len(tcap.buckets) == len(jcap.buckets)
    for tb, jb in zip(tcap.buckets, jcap.buckets):
        assert tb.arity == jb.arity and tb.edge_offset == jb.edge_offset
        if arrays:
            assert np.array_equal(_np(tb.tensors), _np(jb.tensors))
        assert np.array_equal(_np(tb.var_idx), _np(jb.var_idx))
        assert np.array_equal(_np(tb.factor_ids), _np(jb.factor_ids))
    assert tcap.factor_names == jcap.factor_names
    assert np.array_equal(_np(tcap.initial_values), _np(jcap.initial_values))
    assert np.array_equal(_np(tcap.has_initial), _np(jcap.has_initial))
    assert tlay.to_meta() == jlay.to_meta()
    if hasattr(jcap, "neighbor_src"):
        assert np.array_equal(_np(tcap.neighbor_src), _np(jcap.neighbor_src))
        assert np.array_equal(_np(tcap.neighbor_dst), _np(jcap.neighbor_dst))


def _assert_ops_equal(jops, tops, jcap=None):
    for key in ("mask", "unary", "edge_var"):
        assert np.array_equal(_np(tops[key]), _np(jops[key])), key
    for key in ("tensors", "var_idx"):
        assert len(tops[key]) == len(jops[key])
        for t, j in zip(tops[key], jops[key]):
            assert np.array_equal(_np(t), _np(j)), key
    if tops["pairs"] is not None:
        src, dst = jh.derived_pairs(jops["var_idx"], jcap.buckets)
        assert np.array_equal(_np(tops["pairs"][0]), _np(src))
        assert np.array_equal(_np(tops["pairs"][1]), _np(dst))


# ---------------------------------------------------------------------------
# the capacity layout
# ---------------------------------------------------------------------------


class TestCapacityLayout:
    @pytest.mark.parametrize("graph", ["factor", "constraint"])
    @pytest.mark.parametrize("name", NAMES)
    def test_reserve_and_operands_equal_jax(self, name, graph):
        jd, td = _pair(os.path.join(INSTANCES, name + ".yaml"))
        jcap, jlay = jh.reserve_headroom(jd, graph=graph, headroom=0.3,
                                         min_free=3)
        tcap, tlay = th.reserve_headroom(td, graph=graph, headroom=0.3,
                                         min_free=3, device="cpu")
        _assert_cap_equal(jcap, jlay, tcap, tlay)
        _assert_ops_equal(jh.make_operands(jcap), th.make_operands(tcap),
                          jcap)

    def test_operands_are_the_graph_tensors(self):
        _, td = _pair(yaml=YAML)
        cap, _ = th.reserve_headroom(td, device="cpu")
        ops = th.make_operands(cap)
        assert ops["mask"] is cap.domain_mask
        assert ops["tensors"][0] is cap.buckets[0].tensors
        view = th.operand_view(cap, ops)
        assert view.edge_var is ops["edge_var"]
        assert view.layout is cap.layout

    def test_rank_plan_equals_ordered_sum(self):
        from pydcop_tpu_torch.ops.segments import SegmentPlan

        rng = np.random.default_rng(3)
        seg = rng.integers(0, 9, 60)
        seg[[3, 17, 40]] = 9  # parking: left out, its rows are zero
        data = torch.as_tensor(rng.normal(size=(60, 4)).astype(np.float32))
        data[torch.as_tensor(seg == 9)] = 0.0
        plan = th.RankPlan(torch.as_tensor(
            th._rank_table(seg, 10, 12, skip=9)), 60)
        want = SegmentPlan(torch.as_tensor(seg), 10).sum(data)
        assert torch.equal(plan.sum(data), want)

    def test_exhaustion_is_typed_and_layout_untouched(self):
        _, td = _pair(yaml=YAML)
        cap, layout = th.reserve_headroom(td, headroom=0.0, min_free=1,
                                          device="cpu")
        layout.claim_var("z1")
        with pytest.raises(th.HeadroomExhausted):
            layout.claim_var("z2")
        with pytest.raises(th.HeadroomExhausted):
            layout.claim_factor("f9", 9)

    @pytest.mark.parametrize("graph", ["factor", "constraint"])
    def test_layout_claims_and_lookups_equal_jax(self, graph):
        """A seeded stream of claims and releases on both packages'
        layouts: every returned slot, the maps, each name's slot and the
        free slots equal JAX's after every step; a layout rebuilt from
        its meta answers alike (its name and free-slot indexes)."""
        jd, td = _pair(os.path.join(INSTANCES, "graph_coloring_tuto.yaml"))
        _, jl = jh.reserve_headroom(jd, graph=graph, headroom=2.0,
                                    min_free=4)
        _, tl = th.reserve_headroom(td, graph=graph, headroom=2.0,
                                    min_free=4, device="cpu")
        arity = tl.arities[0]
        rng = np.random.default_rng(11)
        vars_, facs = list(tl.claimed_vars), [
            n for ns in tl.fac_names for n in ns if n is not None]
        for i in range(60):
            op = int(rng.integers(4))
            if op == 0 and tl.free_var_slots():
                got = (tl.claim_var(f"z{i}"), jl.claim_var(f"z{i}"))
                vars_.append(f"z{i}")
            elif op == 1 and len(vars_) > 1:
                n = vars_.pop(int(rng.integers(len(vars_))))
                got = (tl.release_var(n), jl.release_var(n))
            elif op == 2 and tl.free_factor_slots(arity):
                got = (tl.claim_factor(f"f{i}", arity),
                       jl.claim_factor(f"f{i}", arity))
                facs.append(f"f{i}")
            elif op == 3 and len(facs) > 1:
                n = facs.pop(int(rng.integers(len(facs))))
                got = (tl.release_factor(n), jl.release_factor(n))
            else:
                continue
            assert got[0] == got[1]
            for lay in (tl, th.HeadroomLayout.from_meta(tl.to_meta())):
                assert lay.to_meta() == jl.to_meta()
                assert lay.free_var_slots() == jl.free_var_slots()
                assert lay.free_factor_slots(arity) == \
                    jl.free_factor_slots(arity)
                assert lay.n_free_var_slots() == len(jl.free_var_slots())
                for n in vars_:
                    assert lay.var_slot(n) == jl.var_slot(n)
                    assert lay.has_var(n)
                for n in facs:
                    assert lay.factor_slot(n) == jl.factor_slot(n)
                    assert lay.has_factor(n) == jl.has_factor(n)
        with pytest.raises(KeyError, match="unknown variable"):
            tl.var_slot("nope")
        with pytest.raises(KeyError, match="unknown factor"):
            tl.factor_slot("nope")
        assert not tl.has_factor("nope") and not tl.has_var("nope")

    def test_plan_depth_is_a_reserve(self):
        """A variable's degree may grow by the depth reserve; past it the
        mutation raises HeadroomExhausted before any write."""
        jd, td = _pair(yaml=YAML)
        cap, layout = th.reserve_headroom(td, headroom=4.0, min_free=1,
                                          device="cpu")
        ops = th.make_operands(cap)
        depth = cap.plan_depths["edge"]
        v1 = td.variables["v1"]
        added = 0
        with pytest.raises(th.HeadroomExhausted, match="depth"):
            for i in range(depth + 1):
                z = tdc.Variable(f"z{i}", td.domains["d"])
                th.apply_mutation(cap, layout, ops, th.AddVariable(z))
                before = [_np(t).copy() for t in th.operand_leaves(ops)]
                names = list(layout.var_names)
                th.apply_mutation(cap, layout, ops, th.AddFactor(
                    tdc.constraint_from_str(f"cz{i}", f"z{i} + v1",
                                            [z, v1])))
                added += 1
        assert added == depth - 1  # v1 starts at degree 1
        assert layout.var_names == names
        for a, b in zip(before, th.operand_leaves(ops)):
            assert np.array_equal(a, _np(b))


# ---------------------------------------------------------------------------
# mutation writes, one by one
# ---------------------------------------------------------------------------


def _mutations(pkg, dcop):
    """The same mutation list built from either package's DCOP objects."""
    d = dcop.domains["d"]
    z = pkg.Variable("z9", d)
    cz = pkg.constraint_from_str("cz", "0 if z9 == v4 else 7",
                                 [z, dcop.variables["v4"]])
    c21 = pkg.constraint_from_str(
        "c12", "0 if v1 != v2 else 5",
        [dcop.variables["v2"], dcop.variables["v1"]])
    c3 = pkg.constraint_from_str(
        "c3", "v1 + v2 + v3",
        [dcop.variables["v1"], dcop.variables["v2"], dcop.variables["v3"]])
    hm = jh if pkg is jdc else th
    return [
        hm.EditFactor(c21), hm.AddVariable(z), hm.AddFactor(cz),
        hm.EditFactor(pkg.constraint_from_str(
            "cz", "abs(z9 - v4)", [z, dcop.variables["v4"]])),
        hm.RemoveFactor("c23"), hm.AddFactor(c3), hm.RemoveFactor("cz"),
        hm.RemoveVariable("z9"), hm.RemoveFactor("c3"),
    ]


class TestMutationWrites:
    @pytest.mark.parametrize("graph", ["factor", "constraint"])
    def test_every_write_equals_jax(self, graph):
        jd, td = _pair(yaml=YAML)
        jcap, jlay = jh.reserve_headroom(jd, graph=graph, headroom=0.5,
                                         min_free=2, ensure_arities=(2, 3))
        tcap, tlay = th.reserve_headroom(td, graph=graph, headroom=0.5,
                                         min_free=2, ensure_arities=(2, 3),
                                         device="cpu")
        jops, tops = jh.make_operands(jcap), th.make_operands(tcap)
        ids = {id(t) for t in th.operand_leaves(tops)}
        for jm, tm in zip(_mutations(jdc, jd), _mutations(tdc, td)):
            jops, jdirty = jh.apply_mutation(jcap, jlay, jops, jm)
            tops, tdirty = th.apply_mutation(tcap, tlay, tops, tm)
            assert vars(tdirty) == vars(jdirty), type(tm).__name__
            _assert_ops_equal(jops, tops, jcap)
            _assert_cap_equal(jcap, jlay, tcap, tlay, arrays=False)
        # every write landed in the same tensors: none was replaced
        assert {id(t) for t in th.operand_leaves(tops)} == ids

    def test_plans_follow_the_mutations(self):
        """After the stream, the operand plans equal plans built afresh
        from the mutated host mirror, on both graphs."""
        for graph in ("factor", "constraint"):
            _, td = _pair(yaml=YAML)
            cap, lay = th.reserve_headroom(td, graph=graph, headroom=0.5,
                                           min_free=2,
                                           ensure_arities=(2, 3),
                                           device="cpu")
            ops = th.make_operands(cap)
            for m in _mutations(tdc, td):
                th.apply_mutation(cap, lay, ops, m)
            fresh = th.make_operands(cap)
            for a, b in zip(th.operand_leaves(ops),
                            th.operand_leaves(fresh)):
                assert torch.equal(a, b), graph

    @pytest.mark.parametrize("bad", ["scope", "remove_live", "domain",
                                     "duplicate"])
    def test_refused_mutations_touch_nothing(self, bad):
        jd, td = _pair(yaml=YAML)
        out = []
        for pkg, hm, d in ((jdc, jh, jd), (tdc, th, td)):
            kw = {} if hm is jh else {"device": "cpu"}
            cap, lay = hm.reserve_headroom(d, graph="constraint",
                                           headroom=0.5, **kw)
            ops = hm.make_operands(cap)
            before = lay.to_meta()
            m = {
                "scope": hm.EditFactor(pkg.constraint_from_str(
                    "c12", "v1 + v3",
                    [d.variables["v1"], d.variables["v3"]])),
                "remove_live": hm.RemoveVariable("v1"),
                "domain": hm.AddVariable(pkg.Variable(
                    "zb", pkg.Domain("big", "v", list(range(9))))),
                "duplicate": hm.AddFactor(d.constraints["c12"]),
            }[bad]
            with pytest.raises(ValueError) as e:
                hm.apply_mutation(cap, lay, ops, m)
            assert lay.to_meta() == before
            out.append(str(e.value))
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the 50-mutation stream against the JAX package
# ---------------------------------------------------------------------------


def _stream(ctl, dcop, pkg, state_hook, m_count=50, seed=42):
    """The JAX test's seeded churn stream, on either package's
    controller; ``state_hook(phase)`` runs after every phase."""
    rng = np.random.default_rng(seed)
    perturb = jax_perturbed if pkg is jdc else perturbed_constraint
    names = sorted(dcop.constraints)
    v0 = sorted(dcop.variables)[0]
    added = []
    for m in range(m_count):
        roll = rng.integers(4)
        if roll == 0 and len(added) < 4:
            z = pkg.Variable(f"z{m:02d}", dcop.variables[v0].domain)
            ctl.add_variable(z)
            c = pkg.constraint_from_str(
                f"cz{m:02d}", f"0 if z{m:02d} == {v0} else 2",
                [z, dcop.variables[v0]])
            ctl.add_constraint(c)
            added.append((z.name, c.name))
        elif roll == 1 and added:
            vn, cn = added.pop()
            ctl.remove_constraint(cn)
            ctl.remove_variable(vn)
        else:
            name = names[int(rng.integers(len(names)))]
            ctl.edit_factor(perturb(dcop.constraints[name], seed=m))
        state_hook(m)


def _run_phase(ctl):
    res = ctl.solver.run(resume=True, chunk=ctl.chunk, max_cycles=64)
    ctl.phase_done(res)
    return res


def _jax_first_state(jctl):
    s = jctl.solver
    s._last_state = s.initial_state()
    return s._last_state


class TestChurnStreamParity:
    def test_mgm_equals_jax_after_every_phase(self):
        jd, td = _pair(yaml=_colouring_yaml())
        jctl = JaxController(jd, "mgm", seed=7, headroom=1.0, min_free=8,
                             chunk=8)
        tctl = WarmRepairController(td, "mgm", seed=7, headroom=1.0,
                                    min_free=8, chunk=8, device="cpu")
        # the port's initial values are its own stream (C-w5): start it
        # from the JAX solver's
        x0 = _jax_first_state(jctl)[0]
        tctl.solver._last_state = (
            torch.as_tensor(np.array(x0), dtype=torch.int32),
            tctl.solver.resident_leaves())
        jres, tres = [], []
        for ctl, out in ((jctl, jres), (tctl, tres)):
            out.append(_run_phase(ctl))
        t0 = tctl.total_traces()

        def phases(ctl, out):
            return lambda m: out.append(_run_phase(ctl))

        _stream(jctl, jd, jdc, phases(jctl, jres))
        _stream(tctl, td, tdc, phases(tctl, tres))
        assert len(jres) == len(tres) == 51
        for i, (j, t) in enumerate(zip(jres, tres)):
            assert (t.assignment, t.cost, t.cycle, t.status) == \
                (j.assignment, j.cost, j.cycle, j.status), i
        assert tctl.total_traces() == t0
        c = tctl.counters.as_dict()
        assert c["repair_retraces"] == 0 and c["mutations_applied"] >= 50
        assert c["headroom_exhausted_repacks"] == 0
        assert tres[-1].metrics()["repair"]["mutations_applied"] == \
            c["mutations_applied"]

    def test_maxsum_equals_jax_after_every_phase(self):
        jd, td = _pair(yaml=_colouring_yaml(seed=6))
        params = {"noise": 0.0}
        jctl = JaxController(
            jd, "maxsum", JaxAlgorithmDef.build_with_default_params(
                "maxsum", params), seed=7, headroom=1.0, min_free=8,
            chunk=8)
        tctl = WarmRepairController(
            td, "maxsum", AlgorithmDef.build_with_default_params(
                "maxsum", params), seed=7, headroom=1.0, min_free=8,
            chunk=8, device="cpu")
        want = []

        def record(m):
            r = _run_phase(jctl)
            q, rr, vals, _ = jctl.solver._last_state
            want.append((r.assignment, r.cycle, _np(q), _np(rr),
                         _np(vals)))

        got = []

        def compare(m):
            r = _run_phase(tctl)
            q, rr, vals, _ = tctl.solver._last_state
            wa, wc, wq, wr, wv = want[len(got)]
            assert np.array_equal(_np(vals), wv), m
            assert np.allclose(_np(q), wq, atol=1e-4), m
            assert np.allclose(_np(rr), wr, atol=1e-4), m
            assert (r.assignment, r.cycle) == (wa, wc), m
            got.append(m)

        record(-1)
        _stream(jctl, jd, jdc, record)
        compare(-1)
        t0 = tctl.total_traces()
        _stream(tctl, td, tdc, compare)
        assert len(got) == len(want) == 51
        assert tctl.total_traces() == t0
        assert tctl.counters.as_dict()["repair_retraces"] == 0

    @pytest.mark.parametrize("algo", ["mgm", "dsa", "adsa"])
    def test_warm_view_equals_a_fresh_compile(self, algo):
        """After the stream, the warm graph computes what the cold engine
        computes on a fresh compile of the mutated DCOP: the claimed
        variables' local cost tables, and one cycle of the rule from the
        same x and coins (ROADMAP C-w5: the coins are the port's)."""
        _, td = _pair(yaml=_colouring_yaml(seed=8))
        ctl = WarmRepairController(td, algo, seed=3, headroom=1.0,
                                   min_free=8, chunk=8, device="cpu")
        _run_phase(ctl)
        _stream(ctl, td, tdc, lambda m: _run_phase(ctl), m_count=20)
        s = ctl.solver
        cold = compile_constraint_graph(td, device="cpu")
        slots = [s.layout.var_slot(n) for n in cold.var_names]
        x = s._last_state[0]
        xc = x[torch.as_tensor(slots)]
        warm_t = local_cost_tables(s.tensors, x)[torch.as_tensor(slots)]
        cold_t = local_cost_tables(cold, xc)
        D = cold.max_domain_size
        assert torch.equal(warm_t[:, :D], cold_t)
        u = torch.rand((2, s.tensors.n_vars),
                       generator=torch.Generator().manual_seed(4))
        coins = {"mgm": (), "dsa": (u[0],), "adsa": (u[0], u[1])}[algo]
        warm_x = s.cycle(x, coins)[torch.as_tensor(slots)]
        from pydcop_tpu_torch.algorithms import load_algorithm_module

        cold_s = load_algorithm_module(algo).build_solver(
            td, None, s.algo_def, seed=3, device="cpu", use_packed=False)
        cold_coins = tuple(c[torch.as_tensor(slots)] for c in coins)
        assert torch.equal(warm_x, cold_s.cycle(xc, cold_coins))

    def test_dsa_stream_is_the_ports_own(self):
        """dsa and adsa draw the port's coins: the same stream twice gives
        the same results, phase by phase."""
        out = []
        for _ in range(2):
            _, td = _pair(yaml=_colouring_yaml(seed=9))
            ctl = WarmRepairController(td, "adsa", seed=3, headroom=1.0,
                                       min_free=8, chunk=8, device="cpu")
            res = [_run_phase(ctl)]
            _stream(ctl, td, tdc, lambda m: res.append(_run_phase(ctl)),
                    m_count=12)
            out.append([(r.assignment, r.cost, r.cycle) for r in res])
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# no re-capture, repacks, the counters
# ---------------------------------------------------------------------------


class TestCapturesAndRepacks:
    def test_headroom_exhaustion_exactly_one_repack_one_capture(self):
        _, td = _pair(yaml=YAML)
        ctl = WarmRepairController(td, "mgm", seed=7, headroom=0.0,
                                   min_free=1, chunk=8, device="cpu")
        events = []
        was = event_bus.enabled
        event_bus.enabled = True
        event_bus.subscribe("repair.*", lambda t, e: events.append(t))
        try:
            res = ctl.solver.run(chunk=ctl.chunk)
            ctl.phase_done(res)
            for i in range(2):
                ctl.add_variable(tdc.Variable(f"z{i}", td.domains["d"]))
                res = _run_phase(ctl)
        finally:
            event_bus.enabled = was
        c = ctl.counters.as_dict()
        assert c["headroom_exhausted_repacks"] == 1, c
        assert c["repair_retraces"] == 1, c
        assert events.count("repair.repack") == 1
        assert "z0" in res.assignment and "z1" in res.assignment
        assert set(res.metrics()["repair"]) == set(c)

    @pytest.mark.parametrize("algo", ["mgm", "maxsum"])
    def test_repack_carries_state_and_claims(self, algo):
        _, td = _pair(yaml=YAML)
        A = build_warm_solver(td, algo=algo, seed=5, headroom=0.5,
                              device="cpu")
        A.run(chunk=8)
        z = tdc.Variable("z9", td.domains["d"])
        td.add_variable(z)
        A.apply_mutations([th.AddVariable(z)])
        B = repack_solver(A)
        assert sorted(B.layout.claimed_vars) == sorted(A.layout.claimed_vars)
        va, vb = A.values_of(A._last_state), B.values_of(B._last_state)
        for n in A.layout.claimed_vars:
            assert int(va[A.layout.var_slot(n)]) == \
                int(vb[B.layout.var_slot(n)])
        ra, rb = A.run(resume=True, chunk=8), B.run(resume=True, chunk=8)
        assert ra.assignment == rb.assignment

    def test_runner_reads_operands_in_place(self):
        """The fixed-shape runner keeps the operands as they are: a run's
        final state holds the very operand tensors (not copies)."""
        _, td = _pair(yaml=YAML)
        s = build_warm_solver(td, algo="maxsum", seed=0, headroom=0.5,
                              device="cpu")
        s.run(cycles=10, chunk=8)
        assert all(a is b for a, b in zip(s._last_state[3],
                                          s.resident_leaves()))
        assert s._last_state[0] is not None

    def test_every_runner_program_names_its_resident_leaves(self):
        """The chunk runner asks its program which state leaves it reads
        in place (a capture needs the answer): the solvers and the batch
        engine's bucket program both give one."""
        from pydcop_tpu_torch.algorithms.base import SynchronousTensorSolver
        from pydcop_tpu_torch.batch.engine import _BucketProgram

        for cls in (SynchronousTensorSolver, _BucketProgram):
            assert cls.resident_leaves(object.__new__(cls)) == ()

    def test_counters_schema_is_closed_and_jax_named(self):
        from pydcop_tpu.runtime.stats import REPAIR_COUNTERS as J

        assert REPAIR_COUNTERS == J
        with pytest.raises(KeyError):
            RepairCounters().inc("nope")

    def test_perturbed_constraint_equals_jax(self):
        jd, td = _pair(yaml=YAML)
        for seed in (0, 3, 11):
            a = jax_perturbed(jd.constraints["c12"], seed=seed)
            b = perturbed_constraint(td.constraints["c12"], seed=seed)
            assert np.array_equal(a.to_tensor(), b.to_tensor())


# ---------------------------------------------------------------------------
# the lifted entry points
# ---------------------------------------------------------------------------


class TestEntryPoints:
    @pytest.mark.parametrize("algo", ["maxsum", "mgm", "dsa", "adsa"])
    def test_solve_result_headroom_builds_the_warm_engine(self, algo):
        path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
        res = solve_result(tdc.load_dcop_from_file(path), algo,
                           device="cpu", headroom=0.25, seed=1)
        assert res.metrics()["repair"]["mutations_applied"] == 0
        assert res.status == "FINISHED"

    def test_solve_result_headroom_equals_jax_mgm(self):
        from pydcop_tpu.runtime.run import solve_result as jax_solve

        path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
        j = jax_solve(jdc.load_dcop_from_file(path), "maxsum",
                      headroom=0.25, algo_params={"noise": 0.0})
        t = solve_result(tdc.load_dcop_from_file(path), "maxsum",
                         device="cpu", headroom=0.25,
                         algo_params={"noise": 0.0})
        assert (t.assignment, t.cost, t.cycle) == \
            (j.assignment, j.cost, j.cycle)
        assert t.metrics()["repair"] == j.metrics()["repair"]

    def test_headroom_refuses_what_it_cannot_run(self):
        path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
        dcop = tdc.load_dcop_from_file(path)
        with pytest.raises(ValueError, match="no warm engine"):
            solve_result(dcop, "gdba", device="cpu", headroom=0.25)

    def test_solve_cli_headroom(self, capsys):
        path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
        rc = cli.main(["solve", "-a", "mgm", path, "--device", "cpu",
                       "--headroom", "0.25"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["status"] == "FINISHED"
        assert set(out["repair"]) == set(REPAIR_COUNTERS)

    def test_solve_cli_headroom_refuses_batch(self, capsys):
        path = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
        rc = cli.main(["solve", "--batch", "-a", "mgm", path,
                       "--device", "cpu", "--headroom", "0.25"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1 and "--headroom" in out["error"]

    def test_maxsum_dynamic_headroom_builds_the_warm_engine(self):
        from pydcop_tpu_torch.algorithms.maxsum_dynamic import build_solver

        _, td = _pair(yaml=YAML)
        s = build_solver(td, device="cpu", headroom=0.25)
        assert isinstance(s, WarmMaxSumSolver)
        assert s.algo_def.algo == "maxsum_dynamic"
        s.run(chunk=8)
        t0 = s.trace_count()
        c = tdc.constraint_from_str(
            "c12", "0 if v1 != v2 else 5",
            list(td.constraints["c12"].dimensions))
        s.change_factor_function(c)
        res = s.run(resume=True, chunk=8)
        assert res.assignment["v1"] != res.assignment["v2"]
        assert s.trace_count() == t0

    def test_local_search_solver_classes(self):
        _, td = _pair(yaml=YAML)
        s = build_warm_solver(td, algo="dsa", device="cpu")
        assert isinstance(s, WarmLocalSearchSolver)
        with pytest.raises(ValueError, match="no warm engine"):
            build_warm_solver(td, algo="mgm2", device="cpu")
