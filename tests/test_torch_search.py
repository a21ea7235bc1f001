"""The port's frontier-batched exact search (``pydcop_tpu_torch/search``)
against the JAX package's (``pydcop_tpu/search``) and the host loops.

The same DCOP goes through both packages (the six ``tests/instances``
YAMLs and the seeded integer instances of ``tests/unit/test_search.py``,
built with each package's classes from the same numpy draws):

* **plan** — ``compile_search_plan``'s arrays equal JAX's field for
  field (exactly: the same numpy code on the same tables);
* **frontier** — cost, assignment, node count, chunk count and the
  per-chunk ``history`` equal JAX's frontier at ``frontier_width=32,
  steps=4``, and the cost and assignment equal SyncBB's and NCBB's host
  loops (``TestHostParity``); with a weak bound (``i_bound=1``) too,
  where the search runs many chunks;
* **anytime** — the incumbent never rises and ``lower <= optimum <=
  upper`` holds at every chunk, ending in a proof (``TestAnytime``);
* **spill** — a tiny slab spills to the host and reinjects every row,
  losing none, and proves the same optimum (``TestSpill``);
* **discipline** — a chunk returns one ``[2]`` float32 vector beside the
  state, the state keeps JAX's dtypes, and a resumed run continues from
  the device state;
* **DPOP** — ``engine=frontier`` equals the sweep's cost, and the auto
  ladder over budget still refuses with ``NotPortedError("sharded")``.

Its card tests are in ``tests/test_torch_search_cuda.py``, which imports
no JAX.
"""
import os

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.search.plan import compile_search_plan as jax_plan
from pydcop_tpu.search.plan import estimate_search_bytes as jax_estimate
from pydcop_tpu.search.plan import suggest_search_i_bound as jax_suggest
from pydcop_tpu.search.solver import FrontierSearchSolver as JaxFrontier
from pydcop_tpu_torch.algorithms.ncbb import NcbbSolver
from pydcop_tpu_torch.algorithms.syncbb import SyncBBSolver
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.search import plan as tplan
from pydcop_tpu_torch.search.solver import FrontierSearchSolver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]


def _path(name):
    return os.path.join(ROOT, "tests", "instances", name + ".yaml")


def _edges(shape, n):
    if shape == "chain":
        return [(i, i + 1) for i in range(n - 1)]
    if shape == "hub":
        return [(0, i) for i in range(1, n)]
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def make_dcop(ns, shape, seed, n=8, D=3, objective="min", high=97):
    """``tests/unit/test_search.py::make_dcop`` with the classes of the
    package ``ns``: every cost an exact float32 integer."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP(f"{shape}-{seed}", objective=objective)
    dom = ns.Domain("d", "v", list(range(D)))
    vs = [ns.Variable(f"v{i:02d}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(_edges(shape, n)):
        m = rng.integers(0, high, (D, D)).astype(float)
        dcop.add_constraint(ns.NAryMatrixRelation([vs[i], vs[j]], m,
                                                  name=f"c{k}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


def both(shape, seed, **kw):
    return make_dcop(jdc, shape, seed, **kw), make_dcop(tdc, shape, seed,
                                                       **kw)


def _frontier(dcop, **kw):
    return FrontierSearchSolver(dcop, device="cpu", **kw)


def _same_run(got, ref):
    assert got.cost == ref.cost
    assert got.assignment == ref.assignment
    assert got.cycle == ref.cycle
    for key in ("optimal", "nodes", "leaves", "pruned", "lost_rows",
                "chunks", "scalar_reads", "spill_drains", "spill_rows",
                "reinjected_rows", "stash_rows", "i_bound",
                "bound_source", "root_bound", "lower_bound",
                "upper_bound", "gap", "frontier_width", "ring",
                "steps_per_chunk", "bucket_splits", "table_bytes"):
        assert got.search[key] == ref.search[key], key
    assert set(got.search) == set(ref.search)
    if ref.history is not None:
        keys = ("cycle", "cost", "lower_bound", "upper_bound", "gap")
        assert [[h[k] for k in keys] for h in got.history] == \
            [[h[k] for k in keys] for h in ref.history]
    assert got.config == ref.config


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


PLAN_FIELDS = ("order", "dom_sizes", "domain_values", "sign", "n", "Dmax",
               "unary", "c_flat", "c_base", "c_valid", "c_pos", "c_stride",
               "c_own_stride", "s_flat", "s_base", "s_valid", "s_cnt",
               "s_pri_pos", "s_pri_cnt", "s_pri_valid", "i_bound",
               "exact_heuristic", "h_flat", "m_base", "m_valid", "m_pos",
               "m_stride", "h_const", "root_bound", "bucket_splits",
               "table_bytes")


def _same_plan(got, ref):
    import dataclasses

    assert {f.name for f in dataclasses.fields(got)} == \
        {f.name for f in dataclasses.fields(ref)} == set(PLAN_FIELDS)
    for name in PLAN_FIELDS:
        g, r = getattr(got, name), getattr(ref, name)
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, name
            assert np.array_equal(g, r), name
        else:
            assert g == r, name
    assert got.info() == ref.info()


@pytest.mark.parametrize("i_bound", [0, 1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_plan_equals_jax_on_the_instances(name, i_bound):
    _same_plan(
        tplan.compile_search_plan(tdc.load_dcop_from_file(_path(name)),
                                  i_bound=i_bound),
        jax_plan(jdc.load_dcop_from_file(_path(name)), i_bound=i_bound))


@pytest.mark.parametrize("objective", ["min", "max"])
@pytest.mark.parametrize("i_bound", [0, 1])
@pytest.mark.parametrize("shape", ["chain", "hub", "dense"])
def test_plan_equals_jax_on_seeded_instances(shape, i_bound, objective):
    jd, td = both(shape, 4, n=8, objective=objective)
    _same_plan(tplan.compile_search_plan(td, i_bound=i_bound),
               jax_plan(jd, i_bound=i_bound))


def test_plan_helpers_equal_jax():
    for D in (2, 3, 4, 7, 10):
        for budget in (None, 2**10, 2**16, 2**24):
            assert tplan.suggest_search_i_bound(D, budget) == \
                jax_suggest(D, budget)
        for n, ib, B, R in ((9, 1, 32, 0), (30, 4, 256, 2048)):
            assert tplan.estimate_search_bytes(n, D, ib, B, R) == \
                jax_estimate(n, D, ib, B, R)


# ---------------------------------------------------------------------------
# host-loop and JAX parity of the frontier
# ---------------------------------------------------------------------------


class TestHostParity:
    @pytest.mark.parametrize("objective", ["min", "max"])
    @pytest.mark.parametrize("seed", [1, 2, 3])
    @pytest.mark.parametrize("shape", ["chain", "hub", "dense"])
    def test_equal_to_jax_and_the_host_loops(self, shape, seed,
                                             objective):
        n = 7 if shape == "dense" else 9
        jd, td = both(shape, seed, n=n, objective=objective)
        ref = JaxFrontier(jd, frontier_width=32, steps=4).run()
        got = _frontier(td, frontier_width=32, steps=4).run()
        _same_run(got, ref)
        assert got.search["optimal"]
        host = SyncBBSolver(td, device="cpu").run()
        ncbb = NcbbSolver(td, device="cpu").run()
        assert got.cost == host.cost == ncbb.cost
        assert got.assignment == host.assignment == ncbb.assignment

    @pytest.mark.parametrize("i_bound", [0, 1])
    @pytest.mark.parametrize("name", NAMES)
    def test_equal_to_jax_on_the_instances(self, name, i_bound):
        ref = JaxFrontier(jdc.load_dcop_from_file(_path(name)),
                          frontier_width=32, steps=4,
                          i_bound=i_bound).run(collect_cycles=True)
        got = _frontier(tdc.load_dcop_from_file(_path(name)),
                        frontier_width=32, steps=4,
                        i_bound=i_bound).run(collect_cycles=True)
        _same_run(got, ref)
        assert got.search["optimal"]
        host = NcbbSolver(tdc.load_dcop_from_file(_path(name)),
                          device="cpu").run()
        assert got.cost == host.cost

    @pytest.mark.parametrize("seed", [3, 5])
    def test_weak_bound_search_equals_jax(self, seed):
        """i_bound=1 on a 9-variable clique: a real search, dozens of
        chunks; every chunk's sandwich equal to JAX's."""
        jd, td = both("dense", seed, n=9)
        ref = JaxFrontier(jd, frontier_width=8, steps=2,
                          i_bound=1).run(collect_cycles=True)
        got = _frontier(td, frontier_width=8, steps=2,
                        i_bound=1).run(collect_cycles=True)
        assert ref.cycle > 10
        _same_run(got, ref)

    def test_no_seed_incumbent_equals_jax(self):
        jd, td = both("dense", 6, n=8, objective="max")
        ref = JaxFrontier(jd, frontier_width=16, steps=3, i_bound=1,
                          seed_incumbent=False).run(collect_cycles=True)
        got = _frontier(td, frontier_width=16, steps=3, i_bound=1,
                        seed_incumbent=False).run(collect_cycles=True)
        _same_run(got, ref)

    def test_beam_dive_equals_jax(self):
        jd, td = both("dense", 8, n=9, high=4)  # many ties
        for width in (1, 4, 64):
            ja, jg = JaxFrontier(jd, i_bound=1).engine.beam_dive(width)
            ta, tg = _frontier(td, i_bound=1).engine.beam_dive(width)
            assert np.array_equal(ta, ja) and tg == jg


# ---------------------------------------------------------------------------
# anytime semantics and the spill fallback
# ---------------------------------------------------------------------------


class TestAnytime:
    def test_sandwich_and_monotone_incumbent(self):
        td = make_dcop(tdc, "dense", 3, n=9, D=3)
        optimum = NcbbSolver(td, device="cpu").run().cost
        res = _frontier(td, frontier_width=8, steps=2,
                        i_bound=1).run(collect_cycles=True)
        assert res.search["optimal"] and res.cost == optimum
        inc = [h["cost"] for h in res.history if h["cost"] is not None]
        assert len(res.history) >= 2
        assert all(b <= a for a, b in zip(inc, inc[1:]))
        pairs = [(h["lower_bound"], h["upper_bound"]) for h in res.history
                 if h["lower_bound"] is not None]
        assert pairs
        assert all(lo <= optimum <= hi for lo, hi in pairs)
        assert res.history[-1]["gap"] == 0.0

    def test_bound_source_tiers(self):
        td = make_dcop(tdc, "dense", 3, n=7)
        exact = _frontier(td, frontier_width=32)
        assert exact.plan.exact_heuristic
        assert exact.plan.info()["bound_source"] == "dpop-exact"
        weak = _frontier(td, frontier_width=32, i_bound=1)
        assert weak.plan.info()["bound_source"] == "minibucket"
        assert exact.run().cost == weak.run().cost


class TestSpill:
    def test_tiny_slab_spills_losslessly(self):
        jd, td = both("dense", 7, n=8, D=3)
        host = SyncBBSolver(td, device="cpu").run()
        ref = JaxFrontier(jd, frontier_width=4, ring=8, steps=3,
                          i_bound=1).run(collect_cycles=True)
        res = _frontier(td, frontier_width=4, ring=8, steps=3,
                        i_bound=1).run(collect_cycles=True)
        s = res.search
        assert s["optimal"] and res.cost == host.cost
        assert s["spill_drains"] > 0 and s["spill_rows"] > 0
        assert s["reinjected_rows"] == s["spill_rows"]
        assert s["lost_rows"] == 0 and s["stash_rows"] == 0
        _same_run(res, ref)

    def test_no_spill_on_roomy_slab(self):
        res = _frontier(make_dcop(tdc, "chain", 1, n=8),
                        frontier_width=64).run()
        s = res.search
        assert s["spill_drains"] == 0 and s["spill_rows"] == 0
        assert s["lost_rows"] == 0


# ---------------------------------------------------------------------------
# the chunk's host traffic, the state, resume
# ---------------------------------------------------------------------------


class TestDiscipline:
    def test_chunk_returns_two_scalars_beside_the_state(self):
        s = _frontier(make_dcop(tdc, "chain", 1, n=8), frontier_width=16)
        jax_state = JaxFrontier(make_dcop(jdc, "chain", 1, n=8),
                                frontier_width=16).initial_state()
        state = s.initial_state()
        assert set(state) == set(jax_state)
        for k, v in state.items():
            assert str(v.dtype).split(".")[-1] == str(jax_state[k].dtype)
            assert tuple(v.shape) == tuple(jax_state[k].shape)
        out_state, stats = s.engine.run_chunk(state)
        assert set(out_state) == set(state)
        for k, v in out_state.items():
            assert v.dtype == state[k].dtype and v.shape == state[k].shape
        assert stats.shape == (2,) and stats.dtype == torch.float32

    def test_resume_continues_and_counts_reads(self):
        jd, td = both("chain", 4, n=10)
        s = _frontier(td, frontier_width=16, steps=2)
        r1 = s.run(cycles=2)
        r2 = s.run(cycles=50, resume=True)
        js = JaxFrontier(jd, frontier_width=16, steps=2)
        j1, j2 = js.run(cycles=2), js.run(cycles=50, resume=True)
        _same_run(r1, j1)
        _same_run(r2, j2)
        assert r2.search["optimal"]
        for r in (r1, r2):
            if r.search["spill_drains"] == 0:
                assert r.search["scalar_reads"] == 2 * r.search["chunks"]

    def test_config_engine_recorded(self):
        res = _frontier(make_dcop(tdc, "chain", 2, n=8),
                        frontier_width=16).run()
        assert res.config["engine"] == "frontier"
        assert res.config["algo"] == "syncbb"
        assert res.config["i_bound"] == res.search["i_bound"]
        assert "search" in res.metrics()


# ---------------------------------------------------------------------------
# DPOP's frontier engine
# ---------------------------------------------------------------------------


def _clique(ns, K, D, seed):
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP("clique", objective="min")
    dom = ns.Domain("d", "v", list(range(D)))
    vs = [ns.Variable(f"v{i:02d}", dom) for i in range(K)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for i in range(K):
        for j in range(i + 1, K):
            m = rng.integers(0, 10, (D, D)).astype(float)
            dcop.add_constraint(ns.NAryMatrixRelation([vs[i], vs[j]], m,
                                                      name=f"c{k}"))
            k += 1
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


class TestDpop:
    @pytest.mark.parametrize("case", ["dense9", "clique8", "max"])
    def test_forced_frontier_equals_the_sweep(self, case):
        from pydcop_tpu.runtime import solve_result as jax_solve_result

        if case == "dense9":
            jd, td = both("dense", 9, n=7)
        elif case == "clique8":
            jd, td = _clique(jdc, 8, 3, 2), _clique(tdc, 8, 3, 2)
        else:
            jd, td = both("hub", 2, n=9, objective="max")
        params = {"engine": "frontier", "i_bound": 2}
        res = solve_result(td, "dpop", algo_params=params, device="cpu")
        ref = jax_solve_result(jd, "dpop", algo_params=params)
        assert res.search["optimal"]
        assert res.config["engine"] == "frontier"
        assert res.cost == ref.cost and res.assignment == ref.assignment
        assert res.config == ref.config
        sweep = solve_result(td, "dpop", device="cpu")
        assert res.cost == sweep.cost

    def test_auto_over_budget_still_refuses(self):
        """The JAX ladder tries the sharded sweep (not ported) before
        its frontier tier: the port's auto ladder refuses there and
        never skips ahead to the frontier."""
        td = _clique(tdc, 10, 4, 3)
        with pytest.raises(NotPortedError, match="sharded"):
            solve_result(td, "dpop", algo_params={"budget_mb": 0.05,
                                                  "i_bound": 2},
                         device="cpu")

    def test_anytime_exact_cli_on_dpop(self):
        import json
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-m", "pydcop_tpu_torch", "solve",
             "--anytime-exact", "-a", "dpop", "--device", "cpu",
             _path("graph_coloring_tuto")],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        res = json.loads(out.stdout)
        assert res["cost"] == 12 and res["search"]["optimal"]
        assert res["config"]["engine"] == "frontier"
        assert res["config"]["algo"] == "dpop"


def test_search_counters_equal_jax():
    from pydcop_tpu.runtime import stats as jstats
    from pydcop_tpu_torch.runtime import stats

    assert stats.SEARCH_COUNTERS == jstats.SEARCH_COUNTERS
    c = stats.SearchCounters()
    c["chunks"] += 2
    assert c.as_dict()["chunks"] == 2
    with pytest.raises(KeyError):
        c["nope"] = 1

