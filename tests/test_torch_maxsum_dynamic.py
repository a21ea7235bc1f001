"""``maxsum_dynamic`` in the port against the JAX package's
``DynamicMaxSumSolver``, and the port's ``swap_factor`` against a fresh
pack.

The solver tests follow ``tests/unit/test_maxsum_dynamic_unit.py``: a swap
changes the solution and lands in the bucket slot, keeps the message
state, rejects a scope change and an unknown factor, handles a scope
listed in another order, and an external change re-slices.  Parity: the
same seeded numpy-made DCOP in both packages, noise 0, the same cycles,
the same swaps between two runs (the second ``resume=True``) — the
assignment, the cost and the stop cycle equal after each run, on the
generic engine (``use_packed=False`` on both sides), the binary packed
engine and the mixed one (``use_packed=True`` on both: the JAX Pallas
kernels in interpret mode, the port's plain versions).  The swap's
``cost_rows`` must be ``torch.equal`` to those of a fresh pack of the
changed DCOP, and it keeps the layout's cached tile tables."""
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms.maxsum_dynamic import \
    DynamicMaxSumSolver as JaxDynamic
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.algorithms.maxsum_dynamic import (
    DynamicMaxSumSolver,
    build_solver,
)
from pydcop_tpu_torch.dcop import DCOP, Domain, Variable, constraint_from_str
from pydcop_tpu_torch.dcop.objects import ExternalVariable
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import compile_factor_graph
from pydcop_tpu_torch.ops import packed_maxsum as pm

torch.set_num_threads(1)


def _equality_dcop():
    d = Domain("d", "d", [0, 1])
    dcop = DCOP("dyn", objective="min")
    x, y = Variable("x", d), Variable("y", d)
    dcop.add_constraint(constraint_from_str(
        "c", "0 if x == y else 10", [x, y]))
    # anchor y at 0 so the optimum is unambiguous
    dcop.add_constraint(constraint_from_str("anchor", "y * 1", [y]))
    return dcop


def _solver(dcop, seed=0, use_packed=None):
    algo_def = AlgorithmDef.build_with_default_params(
        "maxsum_dynamic", {"noise": 0.0})
    return DynamicMaxSumSolver(
        dcop, compile_factor_graph(dcop, device="cpu"), algo_def,
        seed=seed, use_packed=use_packed)


class TestFactorSwap:
    def test_swap_changes_solution(self):
        solver = _solver(_equality_dcop())
        res = solver.run(cycles=20)
        assert res.assignment == {"x": 0, "y": 0}
        scope = list(solver.dcop.constraints["c"].dimensions)
        solver.change_factor_function(constraint_from_str(
            "c", "0 if x != y else 10", scope))
        res = solver.run(cycles=20, resume=True)
        assert res.assignment == {"x": 1, "y": 0}

    def test_swap_lands_in_bucket_slot(self):
        solver = _solver(_equality_dcop())
        scope = list(solver.dcop.constraints["c"].dimensions)
        solver.change_factor_function(constraint_from_str(
            "c", "7 if x == y else 3", scope))
        gi = solver.tensors.factor_names.index("c")
        for b in solver.tensors.buckets:
            where = np.flatnonzero(b.factor_ids == gi)
            if where.size:
                t = b.tensors[int(where[0])].numpy()
                assert t[0, 0] == 7 and t[1, 1] == 7
                assert t[0, 1] == 3 and t[1, 0] == 3
                return
        raise AssertionError("factor not found in any bucket")

    def test_swap_preserves_message_state(self):
        """A swap is a warm restart: the messages are not reset."""
        solver = _solver(_equality_dcop())
        solver.run(cycles=10)
        q_before = solver._last_state[0].clone()
        assert q_before.abs().sum() > 0
        scope = list(solver.dcop.constraints["c"].dimensions)
        solver.change_factor_function(constraint_from_str(
            "c", "0 if x != y else 10", scope))
        assert torch.equal(solver._last_state[0], q_before)

    def test_swap_rejects_scope_change(self):
        solver = _solver(_equality_dcop())
        z = Variable("z", Domain("d", "d", [0, 1]))
        before = solver.dcop.constraints["c"]
        with pytest.raises(ValueError, match="scope"):
            solver.change_factor_function(constraint_from_str(
                "c", "z * 1", [z]))
        assert solver.dcop.constraints["c"] is before

    def test_swap_rejects_unknown_factor(self):
        solver = _solver(_equality_dcop())
        x = Variable("x", Domain("d", "d", [0, 1]))
        with pytest.raises(ValueError, match="Unknown factor"):
            solver.change_factor_function(constraint_from_str(
                "nope", "x * 1", [x]))

    @pytest.mark.parametrize("use_packed", [False, True])
    def test_swap_respects_scope_order_permutation(self, use_packed):
        from pydcop_tpu_torch.dcop.relations import NAryFunctionRelation

        d = Domain("d", "d", [0, 1, 2])
        dcop = DCOP("perm", objective="min")
        a, b = Variable("a", d), Variable("b", d)
        dcop.add_constraint(constraint_from_str("c", "a * 3 + b", [a, b]))
        solver = _solver(dcop, use_packed=use_packed)
        assert (solver.packed is not None) == use_packed
        # the same function, scope listed in the reversed axis order
        solver.change_factor_function(NAryFunctionRelation(
            lambda b_, a_: a_ * 3 + b_, [b, a], "c"))
        assert [v.name for v in
                solver.dcop.constraints["c"].dimensions] == ["b", "a"]
        bk = solver.tensors.buckets[0]
        t = bk.tensors[0].numpy()
        slot_names = [solver.tensors.var_names[int(v)]
                      for v in bk.var_idx[0]]
        idx = [0, 0]
        idx[slot_names.index("a")], idx[slot_names.index("b")] = 2, 1
        assert t[tuple(idx)] == 7
        if use_packed:
            fresh = pm.pack_binary_for_gpu(
                compile_factor_graph(solver.dcop, device="cpu"))
            assert torch.equal(solver.packed.cost_rows, fresh.cost_rows)


class TestExternalVariables:
    def _dcop(self):
        d = Domain("d", "d", [0, 1])
        dcop = DCOP("ext", objective="min")
        x = Variable("x", d)
        dcop.external_variables["sensor"] = ExternalVariable(
            "sensor", d, value=0)
        dcop.add_constraint(constraint_from_str(
            "track", "0 if x == sensor else 5",
            [x, dcop.external_variables["sensor"]]))
        return dcop

    def test_external_change_flips_solution(self):
        solver = _solver(self._dcop())
        assert solver.run(cycles=15).assignment == {"x": 0}
        solver.on_external_change("sensor", 1)
        assert solver.run(cycles=15, resume=True).assignment == {"x": 1}

    def test_external_slicing_reduces_arity(self):
        solver = _solver(self._dcop())
        assert solver.tensors.n_vars == 1
        assert all(b.arity == 1 for b in solver.tensors.buckets)


# ---------------------------------------------------------------------------
# swap_factor against a fresh pack
# ---------------------------------------------------------------------------


def _binary_dcop(ns, V=14, F=30, D=3, seed=0, objective="min"):
    """A seeded random binary DCOP with integer matrices, built with the
    classes of the package ``ns`` (``pydcop_tpu.dcop`` or
    ``pydcop_tpu_torch.dcop``)."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP(f"bin{seed}", objective=objective)
    dom = ns.Domain("d", "v", list(range(D)))
    vs = [ns.Variable(f"v{i:02d}", dom) for i in range(V)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(F):
        i = int(rng.integers(0, V))
        j = int((i + 1 + rng.integers(0, V - 1)) % V)
        m = rng.integers(0, 10, (D, D)).astype(float)
        dcop.add_constraint(ns.NAryMatrixRelation(
            [vs[i], vs[j]], m, name=f"c{k:03d}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


def _new_table(ns, dcop, name, seed, canonical=False):
    """A seeded integer table over ``name``'s scope, with the scope
    listed in reverse when the seed is odd — unless ``canonical``, which
    gives the same function in the scope's original order."""
    dims = list(dcop.constraints[name].dimensions)
    rng = np.random.default_rng(1000 + seed)
    m = rng.integers(0, 10, tuple(len(v.domain) for v in dims)).astype(
        float)
    if seed % 2 and not canonical:
        return ns.NAryMatrixRelation(dims[::-1], m.T, name=name)
    return ns.NAryMatrixRelation(dims, m, name=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swap_factor_equals_a_fresh_pack(seed):
    dcop = _binary_dcop(tdc, seed=seed)
    solver = build_solver(dcop, device="cpu", algo_def=AlgorithmDef.
                          build_with_default_params("maxsum_dynamic",
                                                    {"noise": 0}))
    pg = solver.packed
    assert pg is not None and pg.mixed is None
    tiles = pm.tile_table(pg, pm.TILE_COLS)
    cached = pm._tiles(pg, pm.TILE_COLS)
    # the same DCOP with the new tables in each scope's original order
    # (a scope listed in another order compiles to another layout)
    changed = _binary_dcop(tdc, seed=seed)
    names = sorted(dcop.constraints)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(rng.choice(names, 6, replace=False)):
        solver.change_factor_function(_new_table(tdc, dcop, name, i))
        changed.constraints[name] = _new_table(tdc, changed, name, i,
                                               canonical=True)
    assert solver.packed is pg  # swapped in place, not re-packed
    fresh = pm.pack_binary_for_gpu(
        compile_factor_graph(changed, device="cpu"))
    assert torch.equal(pg.cost_rows, fresh.cost_rows)
    # the tiles depend on the degrees only: the cached table is kept
    assert pg.tile_tables[pm.TILE_COLS] is cached
    assert np.array_equal(pm.tile_table(fresh, pm.TILE_COLS), tiles)


def test_swap_factor_refuses():
    dcop = _binary_dcop(tdc)
    pg = pm.pack_binary_for_gpu(compile_factor_graph(dcop, device="cpu"))
    with pytest.raises(ValueError, match="scope"):
        pm.swap_factor(pg, 0, np.zeros((2, 2)))
    with pytest.raises(ValueError, match="out of range"):
        pm.swap_factor(pg, 30, np.zeros((3, 3)))


def test_headroom_not_ported():
    """``headroom=`` was refused until the warm engine was ported; it now
    builds the warm engine (``tests/test_torch_warm_repair.py`` holds it
    to the JAX package), and only its combination with the packed
    engine, which the warm layer does not run, is refused."""
    from pydcop_tpu_torch.algorithms.warm import WarmMaxSumSolver

    solver = build_solver(_equality_dcop(), device="cpu", headroom=0.25)
    assert isinstance(solver, WarmMaxSumSolver)
    assert solver.run(cycles=10).assignment == {"x": 0, "y": 0}
    with pytest.raises(ValueError, match="use_packed"):
        build_solver(_equality_dcop(), device="cpu", headroom=0.25,
                     use_packed=True)


# ---------------------------------------------------------------------------
# parity with the JAX package across swaps
# ---------------------------------------------------------------------------


def _swap_run(ns, solver, dcop, names, cycles):
    out = [solver.run(cycles=cycles)]
    for i, name in enumerate(names):
        solver.change_factor_function(_new_table(ns, dcop, name, i))
    out.append(solver.run(cycles=cycles, resume=True))
    return out


def _same(got, ref):
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.cycle == ref.cycle and got.status == ref.status


@pytest.mark.parametrize("engine", ["generic", "packed"])
def test_values_equal_jax_across_swaps_binary(engine):
    use_packed = engine == "packed"
    cycles = 7 if use_packed else 30
    jd, td = _binary_dcop(jdc, seed=3), _binary_dcop(tdc, seed=3)
    names = sorted(td.constraints)[::5]
    jsolver = JaxDynamic(jd, jax_compile(jd), JaxAlgorithmDef.
                         build_with_default_params("maxsum_dynamic",
                                                   {"noise": 0}),
                         use_packed=use_packed)
    tsolver = _solver(td, use_packed=use_packed)
    assert (jsolver.packed is not None) == use_packed
    assert (tsolver.packed is not None) == use_packed
    ref = _swap_run(jdc, jsolver, jd, names, cycles)
    got = _swap_run(tdc, tsolver, td, names, cycles)
    for g, r in zip(got, ref):
        _same(g, r)
    assert got[0].assignment != got[1].assignment


def _mixed_names(dcop):
    return [n for n in sorted(dcop.constraints)
            if dcop.constraints[n].arity in (2, 3)][:3]


@pytest.mark.parametrize("engine", ["generic", "packed"])
def test_values_equal_jax_across_swaps_mixed(engine):
    import os

    path = os.path.join(os.path.dirname(__file__), "instances",
                        "secp_small.yaml")
    use_packed = engine == "packed"
    jd, td = jdc.load_dcop_from_file(path), tdc.load_dcop_from_file(path)
    names = _mixed_names(td)
    assert names
    jsolver = JaxDynamic(jd, jax_compile(jd), JaxAlgorithmDef.
                         build_with_default_params("maxsum_dynamic",
                                                   {"noise": 0},
                                                   mode=jd.objective),
                         use_packed=use_packed)
    tsolver = _solver(td, use_packed=use_packed)
    if use_packed:
        assert tsolver.packed is not None and tsolver.packed.mixed
        before = tsolver.packed
    ref = _swap_run(jdc, jsolver, jd, names, 7)
    got = _swap_run(tdc, tsolver, td, names, 7)
    for g, r in zip(got, ref):
        _same(g, r)
    if use_packed:
        # the mixed layout re-packs: a new layout with the new tables
        assert tsolver.packed is not before
        changed = tdc.load_dcop_from_file(path)
        for i, name in enumerate(names):
            changed.constraints[name] = _new_table(tdc, changed, name, i,
                                                   canonical=True)
        fresh = pm.pack_for_gpu(compile_factor_graph(changed, device="cpu"))
        for a, b in zip(tsolver.packed.mixed.costs, fresh.mixed.costs):
            assert torch.equal(a, b)


def test_registered_and_solves_on_the_cpu():
    from pydcop_tpu_torch.runtime import solve_result

    assert load_algorithm_module("maxsum_dynamic").GRAPH_TYPE == \
        "factor_graph"
    dcop = _equality_dcop()
    res = solve_result(dcop, "maxsum_dynamic", device="cpu")
    assert res.assignment == {"x": 0, "y": 0} and res.cost == 0

