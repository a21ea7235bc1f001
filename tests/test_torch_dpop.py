"""DPOP's modules in the PyTorch package against the JAX package, on the CPU.

The same DCOP, built from numpy arrays made from a seed, goes through
each JAX function and its port:

* the pseudo-tree (``graph/pseudotree.py``): the same tree node for node;
* the sweep plans (``ops/dpop_sweep.py``): every field equal;
* the level scans, global and per level, on ONE plan compiled by the JAX
  package and carried over by ``plan_from_numpy``;
* the whole sweep (``ops/packed_dpop.py``): its plain version against the
  JAX package's Pallas kernel in interpret mode, and against the JAX
  level scan at N = 2,000;
* ``minibucket_solve`` and the join/project/slice kernels across the
  host/device threshold.

Tolerance: exact everywhere (``array_equal`` on assignments, tables and
plan fields, ``==`` on bounds).  Every operation on this path is an add
of two float32 operands in a pinned order, a min/max or a first-index
argmin, so the two packages compute the same float32 numbers.

The kernel itself runs only on a card: ``test_kernel_matches_plain_on_gpu``
is marked ``cuda`` and skips here.
"""
import os

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdcop
import pydcop_tpu_torch.dcop as tdcop
from pydcop_tpu.graph import pseudotree as jpt
from pydcop_tpu.ops import dpop_kernels as jk
from pydcop_tpu.ops import dpop_shard as jshard
from pydcop_tpu.ops import dpop_sweep as jsweep
from pydcop_tpu.ops.pallas_dpop import pack_sweep as jpack_sweep
from pydcop_tpu.ops.pallas_dpop import whole_sweep_values as jwhole
from pydcop_tpu_torch.graph import pseudotree as tpt
from pydcop_tpu_torch.ops import dpop_kernels as tk
from pydcop_tpu_torch.ops import dpop_shard as tshard
from pydcop_tpu_torch.ops import dpop_sweep as tsweep
from pydcop_tpu_torch.ops import packed_dpop

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "tests", "instances"))
    if f.endswith(".yaml"))


def _path(name):
    return os.path.join(ROOT, "tests", "instances", name + ".yaml")


def tree_dcop(ns, N=60, D=4, seed=0, objective="min", ragged=False,
              forest=False):
    """A random tree (each node's parent among the 8 before it), as the
    JAX package's whole-sweep tests build it, with ``ns``'s classes."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP("t", objective=objective)
    doms = [ns.Domain("d", "vals", list(range(D)))]
    if ragged:
        doms.append(ns.Domain("d2", "vals", list(range(max(2, D - 2)))))
    vs = []
    for i in range(N):
        v = ns.Variable(f"v{i}", doms[i % len(doms)])
        vs.append(v)
        dcop.add_variable(v)
    for i in range(1, N):
        if forest and i % 17 == 0:
            continue  # no parent: this node roots a new tree
        p = int(rng.integers(max(0, i - 8), i))
        mat = rng.uniform(0, 10, (len(vs[p].domain), len(vs[i].domain)))
        dcop.add_constraint(ns.NAryMatrixRelation(
            [vs[p], vs[i]], mat.astype(np.float32), name=f"c{i}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


def bench_tree_dcop(ns, N, D=10, seed=2):
    """The JAX bench's DPOP tree (``bench.py`` bench_dpop): each node's
    parent uniform among all earlier nodes, uniform [0, 10) tables."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP("dpop_bench", objective="min")
    dom = ns.Domain("d", "vals", list(range(D)))
    vs = [ns.Variable(f"v{i}", dom) for i in range(N)]
    for v in vs:
        dcop.add_variable(v)
    parents = [int(rng.integers(0, i)) for i in range(1, N)]
    mats = rng.uniform(0, 10, (N - 1, D, D)).astype(np.float32)
    for i, p in enumerate(parents):
        dcop.add_constraint(ns.NAryMatrixRelation(
            [vs[p], vs[i + 1]], mats[i], name=f"c{i}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


def wide_dcop(ns, N=14, D=3, seed=9):
    """A random graph with cycles: separators wider than one."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP("wide", objective="min")
    dom = ns.Domain("d", "vals", list(range(D)))
    vs = [ns.Variable(f"x{i:02d}", dom) for i in range(N)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for i in range(N):
        for j in range(i + 1, N):
            if rng.uniform() < 0.3:
                dcop.add_constraint(ns.NAryMatrixRelation(
                    [vs[i], vs[j]], rng.integers(0, 9, (D, D)).astype(
                        np.float32), name=f"w{k}"))
                k += 1
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


#: tree cases of the JAX package's whole-sweep tests
#: (tests/unit/test_pallas_dpop.py): name -> tree_dcop keyword arguments
TREE_CASES = {
    "seed0": dict(seed=0),
    "seed1": dict(seed=1),
    "seed2": dict(seed=2),
    "forest": dict(N=70, seed=3, forest=True),
    "ragged": dict(N=50, D=5, seed=4, ragged=True),
    "max": dict(N=40, seed=5, objective="max"),
}


def pair(kind):
    """(JAX dcop, port dcop) of a case name: a test instance, a tree
    case, or the wide random graph."""
    if kind in TREE_CASES:
        return (tree_dcop(jdcop, **TREE_CASES[kind]),
                tree_dcop(tdcop, **TREE_CASES[kind]))
    if kind == "wide":
        return wide_dcop(jdcop), wide_dcop(tdcop)
    return (jdcop.load_dcop_from_file(_path(kind)),
            tdcop.load_dcop_from_file([_path(kind)]))


ALL_CASES = INSTANCES + sorted(TREE_CASES) + ["wide"]


# ---------------------------------------------------------------------------
# pseudo-tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_CASES)
def test_pseudotree_equals_jax(kind):
    jd, td = pair(kind)
    jt = jpt.build_computation_graph(jd)
    tt = tpt.build_computation_graph(td)
    assert tt.roots == jt.roots
    assert tt.height == jt.height
    assert [[n.name for n in lv] for lv in tt.nodes_by_depth()] == \
        [[n.name for n in lv] for lv in jt.nodes_by_depth()]
    assert tt.separators() == jt.separators()
    assert tt.induced_width == jt.induced_width
    for jn in jt.nodes:
        tn = tt.computation(jn.name)
        assert tn.parent == jn.parent
        assert tn.children == jn.children
        assert tn.pseudo_parents == jn.pseudo_parents
        assert tn.pseudo_children == jn.pseudo_children
        assert [c.name for c in tn.constraints] == \
            [c.name for c in jn.constraints]
        assert tt.depth(jn.name) == jt.depth(jn.name)


# ---------------------------------------------------------------------------
# sweep plans and level scans
# ---------------------------------------------------------------------------


def _same_fields(got, ref):
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _plans(kind):
    jd, td = pair(kind)
    mode = jd.objective
    jt = jpt.build_computation_graph(jd)
    tt = tpt.build_computation_graph(td)
    return jd, td, jt, tt, mode


@pytest.mark.parametrize("kind", ALL_CASES)
def test_compile_sweep_equals_jax(kind):
    jd, td, jt, tt, mode = _plans(kind)
    ref = jsweep.compile_sweep(jt, jd, mode)
    got = tsweep.compile_sweep(tt, td, mode, device="cpu")
    assert (got is None) == (ref is None)
    if ref is not None:
        _same_fields(tsweep.numpy_fields(got), vars(ref))
        assert got.level_sizes == [len(lv) for lv in jt.nodes_by_depth()]
    ref = jsweep.compile_sweep_perlevel(jt, jd, mode)
    got = tsweep.compile_sweep_perlevel(tt, td, mode, device="cpu")
    fields = tsweep.numpy_fields(got)
    ref_levels = [vars(lv) for lv in ref.levels]
    assert len(fields["levels"]) == len(ref_levels)
    for g, r in zip(fields.pop("levels"), ref_levels):
        _same_fields(g, r)
    _same_fields(fields, {k: v for k, v in vars(ref).items()
                          if k != "levels"})


@pytest.mark.parametrize("kind", ALL_CASES)
def test_level_scans_equal_jax_on_one_plan(kind):
    jd, _, jt, _, mode = _plans(kind)
    plan = jsweep.compile_sweep(jt, jd, mode)
    if plan is not None:
        ref, n = jsweep.run_sweep(plan)
        got, m = tsweep.run_sweep(tsweep.plan_from_numpy(vars(plan), "cpu"))
        assert (m, got.dtype) == (n, ref.dtype)
        assert np.array_equal(got, ref)
    plan = jsweep.compile_sweep_perlevel(jt, jd, mode)
    ref, n = jsweep.run_sweep_perlevel(plan)
    fields = dict(vars(plan), levels=[vars(lv) for lv in plan.levels])
    got, m = tsweep.run_sweep_perlevel(tsweep.plan_from_numpy(fields, "cpu"))
    assert m == n
    assert np.array_equal(got, ref)


def test_compile_refuses_what_jax_refuses(monkeypatch):
    jd, td, jt, tt, mode = _plans("wide")
    for mod in (jsweep, tsweep):
        monkeypatch.setattr(mod, "MAX_TABLE_ENTRIES_PER_NODE", 8)
    assert jsweep.compile_sweep(jt, jd, mode) is None
    assert tsweep.compile_sweep(tt, td, mode, device="cpu") is None
    assert tsweep.compile_sweep_perlevel(tt, td, mode, device="cpu") is None


# ---------------------------------------------------------------------------
# the whole sweep (K10): plain version against the JAX package
# ---------------------------------------------------------------------------


def _packed(td):
    tt = tpt.build_computation_graph(td)
    plan = tsweep.compile_sweep(tt, td, td.objective, device="cpu")
    assert plan is not None and plan.W == 1
    ps = packed_dpop.pack_sweep(plan)
    assert ps is not None
    return plan, ps


@pytest.mark.parametrize("kind", sorted(TREE_CASES))
def test_plain_whole_sweep_equals_pallas_interpret(kind):
    jd, td = pair(kind)
    jt = jpt.build_computation_graph(jd)
    jplan = jsweep.compile_sweep(jt, jd, jd.objective)
    ref = np.asarray(jwhole(jpack_sweep(jplan), interpret=True))
    plan, ps = _packed(td)
    assign, msg, cs = packed_dpop.whole_sweep_plain(ps)
    assert np.array_equal(assign.numpy(), ref)
    # the level scan takes the same numbers: same assignment
    assert np.array_equal(tsweep.run_sweep(plan)[0], ref)
    if kind == "ragged":
        for gid, name in enumerate(plan.gid_to_name):
            assert ref[gid] < len(td.variables[name].domain)


def test_plain_whole_sweep_equals_jax_level_scan_at_2000_nodes():
    jd, td = bench_tree_dcop(jdcop, 2000), bench_tree_dcop(tdcop, 2000)
    jt = jpt.build_computation_graph(jd)
    ref, _ = jsweep.run_sweep(jsweep.compile_sweep(jt, jd, "min"))
    plan, ps = _packed(td)
    assert ps.L > 10 and ps.max_children > 3
    assign, msg, cs = packed_dpop.whole_sweep_plain(ps)
    assert np.array_equal(assign.numpy(), ref)
    # msg of a leaf = min over own values of its table; cs of a leaf = 0
    leaves = torch.diff(ps.child_ptr) == 0
    assert torch.equal(cs[leaves], torch.zeros_like(cs[leaves]))
    assert torch.equal(msg[leaves], ps.table[leaves].amin(dim=1))


def test_pack_sweep_layout():
    td = tree_dcop(tdcop, N=70, seed=3, forest=True)
    plan, ps = _packed(td)
    N = plan.n_nodes
    parent = ps.parent.numpy()
    assert (parent < 0).sum() == len(tpt.build_computation_graph(td).roots)
    ptr, idx = ps.child_ptr.numpy(), ps.child_idx.numpy()
    for n in range(N):
        kids = idx[ptr[n]:ptr[n + 1]]
        assert list(kids) == sorted(kids)
        assert all(parent[k] == n for k in kids)
    assert ps.level_start[-1] == N and ps.level_start.dtype == np.int32
    # own value major: table[n, i, j] = local[own i, parent j]
    lv, slot = 1, 0
    gid = int(plan.node_ids[lv, slot])
    assert torch.equal(ps.table[gid].reshape(-1), plan.local[lv, slot])


def test_pack_sweep_refuses_wide_plans():
    _, td, _, tt, mode = _plans("wide")
    plan = tsweep.compile_sweep(tt, td, mode, device="cpu")
    assert plan.W > 1
    assert packed_dpop.pack_sweep(plan) is None


# ---------------------------------------------------------------------------
# mini-bucket and the join/project kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", INSTANCES + ["wide"])
@pytest.mark.parametrize("i_bound", [1, 2])
def test_minibucket_equals_jax(kind, i_bound):
    jd, td, jt, tt, mode = _plans(kind)
    ref = jshard.minibucket_solve(jt, jd, mode, i_bound)
    got = tshard.minibucket_solve(tt, td, mode, i_bound, device="cpu")
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]


def test_estimates_equal_jax():
    for kind in ALL_CASES:
        _, _, jt, tt, _ = _plans(kind)
        assert tshard.estimate_sweep_bytes(tt) == \
            jshard.estimate_sweep_bytes(jt)
        assert tshard._level_shapes(tt) == jshard._level_shapes(jt)
    for D in (2, 3, 10, 40):
        for budget in (None, 1 << 10, 1 << 20, 1 << 30):
            assert tshard.suggest_i_bound(D, budget) == \
                jshard.suggest_i_bound(D, budget)
    e = tshard.UtilTableTooLarge(3 << 20, 1 << 20, suggested_i_bound=2)
    assert isinstance(e, MemoryError)
    assert str(e) == str(jshard.UtilTableTooLarge(3 << 20, 1 << 20,
                                                  suggested_i_bound=2))


@pytest.mark.parametrize("sizes", [(4, 5, 6), (20, 30, 40)],
                         ids=["host", "device"])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_join_project_slice_equal_jax(sizes, mode):
    a, b, c = sizes
    rng = np.random.default_rng(a)
    t1 = rng.uniform(0, 10, (a, b)).astype(np.float32)
    t2 = rng.uniform(0, 10, (c, b)).astype(np.float32)
    d1, d2 = [("x", a), ("y", b)], [("z", c), ("y", b)]
    big = a * b * c >= tk.DEVICE_THRESHOLD
    assert big == (a * b * c >= jk.DEVICE_THRESHOLD)
    got, gdims = tk.join_t(t1, d1, t2, d2, device="cpu")
    ref, rdims = jk.join_t(t1, d1, t2, d2)
    assert gdims == rdims
    assert isinstance(got, torch.Tensor) == big
    assert np.array_equal(tk.to_numpy(got), np.asarray(ref))
    for var in ("x", "y", "z"):
        pg, pd = tk.project_t(got, gdims, var, mode)
        pr, prd = jk.project_t(ref, rdims, var, mode)
        assert pd == prd
        assert np.array_equal(tk.to_numpy(pg), np.asarray(pr))
    fixed = {"x": 1, "z": c - 1}
    sg, sd = tk.slice_t(got, gdims, fixed)
    sr, srd = jk.slice_t(ref, rdims, fixed)
    assert sd == srd and np.array_equal(tk.to_numpy(sg), np.asarray(sr))
    assert tk.argopt_value(sg, sd, "y", mode) == \
        jk.argopt_value(sr, srd, "y", mode)
    # a mixed host/device join lands on the device
    small = np.zeros((a,), dtype=np.float32)
    mixed, _ = tk.join_t(torch.as_tensor(small), [("x", a)], small[:2],
                         [("w", 2)])
    assert isinstance(mixed, torch.Tensor)


# ---------------------------------------------------------------------------
# the kernel, on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TREE_CASES) + ["bench2000"])
def test_kernel_matches_plain_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    td = (bench_tree_dcop(tdcop, 2000) if kind == "bench2000"
          else tree_dcop(tdcop, **TREE_CASES[kind]))
    tt = tpt.build_computation_graph(td)
    plan = tsweep.compile_sweep(tt, td, td.objective, device="cuda")
    ps = packed_dpop.pack_sweep(plan)
    packed_dpop.reset_launches()
    k = packed_dpop.whole_sweep(ps)
    assert packed_dpop.whole_sweep.launches == 1
    p = packed_dpop.whole_sweep_plain(ps)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert np.array_equal(k[0].cpu().numpy(), tsweep.run_sweep(plan)[0])
