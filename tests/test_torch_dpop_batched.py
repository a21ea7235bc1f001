"""DPOP's batched sweep in the port (``ops/dpop_sweep.py::
make_batched_sweep_fn`` and K10's instance axis,
``ops/packed_dpop.py::whole_sweep_batched``) on the CPU, held to the JAX
package's ``make_batched_sweep_fn`` (``pydcop_tpu/ops/dpop_sweep.py``):

* on the JAX test's instance (``tests/unit/test_dpop_sweep.py``
  ``test_batched_sweep_matches_single``: a 40-node tree, D = 3, B = 4,
  each instance's tables perturbed), on the port's tree cases and on a
  graph with separators wider than one: the port's batched function
  equals JAX's, and each instance equals its single sweep; the port's
  own plan (``compile_sweep``) gives the same;
* K10's batched plain version (``whole_sweep_batched`` on CPU tensors)
  equals JAX's batched function and the single sweeps, instance by
  instance (assign, msg and cs);
* the over-budget refusal: the same ``ValueError`` as JAX's on the CPU;
  on CUDA the budget is half the card's memory;
* the wrapper's CUDA branch run on CPU tensors with a stand-in C entry:
  ONE launch for the B instances (``whole_sweep.launches`` + 1), the
  operands in the entry's order with the instance count, the grid for B
  instances, a failed launch raising, the plain version never run.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop as jdcop
import pydcop_tpu_torch.dcop as tdcop
from pydcop_tpu.graph import pseudotree as jpt
from pydcop_tpu.ops import dpop_sweep as jsweep
from pydcop_tpu_torch.graph import pseudotree as tpt
from pydcop_tpu_torch.ops import dpop_sweep as tsweep
from pydcop_tpu_torch.ops import packed_dpop as PD

torch.set_num_threads(1)


def random_dcop(ns, n_vars, n_edges, dom_sizes=(2, 3), seed=0,
                objective="min", tree_only=False):
    """The JAX package's ``tests/unit/test_dpop_sweep.py::random_dcop``,
    with ``ns``'s classes."""
    rng = np.random.default_rng(seed)
    dcop = ns.DCOP("rand", objective=objective)
    doms = {d: ns.Domain(f"d{d}", "vals", list(range(d)))
            for d in dom_sizes}
    vs = []
    for i in range(n_vars):
        v = ns.Variable(f"v{i}", doms[dom_sizes[i % len(dom_sizes)]])
        vs.append(v)
        dcop.add_variable(v)
    edges = set()
    for i in range(1, n_vars):
        edges.add((int(rng.integers(0, i)), i))
    if not tree_only:
        for _ in range(n_edges):
            i, j = rng.integers(0, n_vars, 2)
            if i != j:
                edges.add((min(i, j), max(i, j)))
    for k, (i, j) in enumerate(sorted(edges)):
        m = rng.integers(0, 10, (len(vs[i].domain), len(vs[j].domain)))
        dcop.add_constraint(ns.NAryMatrixRelation(
            [vs[i], vs[j]], m.astype(float), name=f"c{k}"))
    dcop.add_agents([ns.AgentDef("a0")])
    return dcop


#: name -> random_dcop arguments: the JAX test's tree, more trees (max
#: mode, ragged domains) and graphs with wider separators
CASES = {
    "jax_test_tree": dict(n_vars=40, n_edges=0, dom_sizes=(3,), seed=5,
                          tree_only=True),
    "tree_max": dict(n_vars=30, n_edges=0, dom_sizes=(4,), seed=6,
                     objective="max", tree_only=True),
    "tree_ragged": dict(n_vars=25, n_edges=0, dom_sizes=(2, 4), seed=7,
                        tree_only=True),
    "wide": dict(n_vars=10, n_edges=6, seed=8),
    "wide_max": dict(n_vars=9, n_edges=5, dom_sizes=(3,), seed=9,
                     objective="max"),
}


def plans(case):
    """(JAX plan, the port's plan carried from it, the port's own plan)."""
    args = CASES[case]
    jd, td = random_dcop(jdcop, **args), random_dcop(tdcop, **args)
    mode = jd.objective
    jplan = jsweep.compile_sweep(jpt.build_computation_graph(jd), jd, mode)
    own = tsweep.compile_sweep(tpt.build_computation_graph(td), td, mode,
                               device="cpu")
    assert jplan is not None and own is not None
    return jplan, tsweep.plan_from_numpy(vars(jplan), "cpu"), own


def perturbed(plan, B=4, seed=5):
    """The JAX test's stacked tables: each instance perturbed by uniform
    [0, 5) noise."""
    rng = np.random.default_rng(seed)
    pert = rng.uniform(0, 5, (B,) + plan.local.shape).astype(np.float32)
    return np.asarray(plan.local)[None] + pert


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_sweep_equals_jax_and_the_single_sweeps(case):
    jplan, tplan, own = plans(case)
    local_b = perturbed(jplan)
    jfn, jargs = jsweep.make_batched_sweep_fn(jplan)
    want = np.asarray(jfn(jnp.asarray(local_b), *jargs))
    sfn, sargs = jsweep.make_sweep_fn(jplan)
    for b in range(local_b.shape[0]):
        single = np.asarray(sfn(jnp.asarray(local_b[b]), *sargs[1:]))
        np.testing.assert_array_equal(want[b], single)
    for plan in (tplan, own):
        fn, args = tsweep.make_batched_sweep_fn(plan, batch=4)
        got = fn(torch.as_tensor(local_b), *args)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        for b in range(local_b.shape[0]):
            one = dict(vars(plan))
            one["local"] = torch.as_tensor(local_b[b])
            single, _ = tsweep.run_sweep(tsweep.DpopSweepPlan(**one))
            np.testing.assert_array_equal(got[b].numpy(), single)


@pytest.mark.parametrize("case", ["jax_test_tree", "tree_max",
                                  "tree_ragged"])
def test_k10_batched_plain_equals_jax_and_the_single_sweeps(case):
    """Width-1 plans: K10's batched plain version over the packed tables
    of the B instances equals JAX's batched function, and each instance
    equals ``whole_sweep`` on a layout packed from its own tables
    (assign, msg and cs)."""
    jplan, tplan, _ = plans(case)
    local_b = perturbed(jplan, B=5, seed=11)
    jfn, jargs = jsweep.make_batched_sweep_fn(jplan)
    want = np.asarray(jfn(jnp.asarray(local_b), *jargs))
    ps = PD.pack_sweep(tplan)
    assert ps is not None
    tables = PD.pack_tables(ps, torch.as_tensor(local_b))
    assert tuple(tables.shape) == (5, ps.n_nodes, ps.D, ps.D)
    before = PD.whole_sweep.launches
    assign, msg, cs = PD.whole_sweep_batched(ps, tables)
    assert PD.whole_sweep.launches == before  # the CPU launches nothing
    np.testing.assert_array_equal(assign.numpy(), want)
    for b in range(5):
        one = dict(vars(tplan))
        one["local"] = torch.as_tensor(local_b[b])
        ps_b = PD.pack_sweep(tsweep.DpopSweepPlan(**one))
        assert torch.equal(ps_b.table, tables[b])
        for got, single in zip((assign[b], msg[b], cs[b]),
                               PD.whole_sweep(ps_b)):
            assert torch.equal(got, single)


def test_single_plain_sweep_is_the_batch_of_one():
    _, tplan, _ = plans("jax_test_tree")
    ps = PD.pack_sweep(tplan)
    for got, want in zip(PD.whole_sweep_plain(ps),
                         PD.whole_sweep_plain(ps, ps.table[None])):
        assert torch.equal(got, want[0])


def test_over_budget_batch_raises_jax_error():
    jplan, tplan, _ = plans("jax_test_tree")
    batch = tsweep.CPU_BATCH_BUDGET_ENTRIES // jplan.total_entries
    for ok in (batch // 2, None):
        tsweep.make_batched_sweep_fn(tplan, batch=ok)
        jsweep.make_batched_sweep_fn(jplan, batch=ok)
    with pytest.raises(ValueError) as jerr:
        jsweep.make_batched_sweep_fn(jplan, batch=batch + 1)
    with pytest.raises(ValueError) as terr:
        tsweep.make_batched_sweep_fn(tplan, batch=batch + 1)
    assert str(terr.value) == str(jerr.value)


def test_cuda_budget_is_half_the_card(monkeypatch):
    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    assert tsweep.batch_budget_entries(torch.device("cuda")) == \
        80 * 2 ** 30 // 8
    assert tsweep.batch_budget_entries(torch.device("cpu")) == \
        tsweep.CPU_BATCH_BUDGET_ENTRIES == 2 * 2 ** 30


# ---------------------------------------------------------------------------
# the batched wrapper's CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInBatched:
    """A stand-in for ``dpop_whole_sweep_batched``: records each call,
    writes 2 into every instance's assign and 0 into msg and cs, and
    returns ``rc``."""

    def __init__(self, ps, nb, rc=0):
        self.ps, self.nb, self.rc, self.calls = ps, nb, rc, []

    def __call__(self, *args):
        self.calls.append(args)
        n = self.nb * self.ps.n_nodes
        (ctypes.c_int32 * n).from_address(args[12])[:] = [2] * n
        for ptr in args[10:12]:
            (ctypes.c_float * (n * self.ps.D)).from_address(ptr)[:] = \
                [0.0] * (n * self.ps.D)
        return self.rc


def cuda_branch(monkeypatch, entry, capacity=(1056, 250)):
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    monkeypatch.setattr(PD, "_batched_kernel", lambda: entry)
    monkeypatch.setattr(PD, "_capacity", lambda D, mode: capacity)
    monkeypatch.setattr(PD, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(PD, "_on_cuda", lambda ps: True)
    monkeypatch.setattr(PD, "whole_sweep_plain", never)
    monkeypatch.setattr(PD.whole_sweep, "launches", 0)


@pytest.mark.parametrize("nb", [1, 3, 40])
def test_batched_launch_is_one_launch_for_all_instances(monkeypatch, nb):
    _, tplan, _ = plans("jax_test_tree")
    ps = PD.pack_sweep(tplan)
    tables = ps.table[None].expand(nb, -1, -1, -1).contiguous()
    entry = StandInBatched(ps, nb)
    cuda_branch(monkeypatch, entry)
    assign, msg, cs = PD.whole_sweep_batched(ps, tables)
    assert PD.whole_sweep.launches == 1 and len(entry.calls) == 1
    args = entry.calls[0]
    assert args[:6] == (
        tables.data_ptr(), ps.child_ptr.data_ptr(), ps.child_idx.data_ptr(),
        ps.parent.data_ptr(), ps.level_start_dev.data_ptr(),
        ps.level_start.ctypes.data)
    assert args[6:10] == (ps.L, ps.D, nb, int(ps.mode == "max"))
    assert args[10:13] == (msg.data_ptr(), cs.data_ptr(), assign.data_ptr())
    assert args[13] == PD.sweep_blocks(ps, 1056, 250, nb)
    assert args[13] >= PD.sweep_blocks(ps, 1056, 250)
    assert torch.equal(assign, torch.full((nb, ps.n_nodes), 2,
                                          dtype=torch.int32))
    assert tuple(msg.shape) == tuple(cs.shape) == (nb, ps.n_nodes, ps.D)
    PD.whole_sweep_batched(ps, tables, blocks=1)
    assert entry.calls[-1][13] == 1 and PD.whole_sweep.launches == 2
    with pytest.raises(ValueError, match="capacity"):
        PD.whole_sweep_batched(ps, tables, blocks=1057)


@pytest.mark.parametrize("rc", [1, 720])
def test_failed_batched_launch_raises_and_counts_nothing(monkeypatch, rc):
    _, tplan, _ = plans("tree_max")
    ps = PD.pack_sweep(tplan)
    tables = ps.table[None].expand(2, -1, -1, -1).contiguous()
    entry = StandInBatched(ps, 2, rc)
    cuda_branch(monkeypatch, entry)
    with pytest.raises(RuntimeError, match=f"dpop_whole_sweep_batched "
                       f"launch failed: CUDA error {rc}"):
        PD.whole_sweep_batched(ps, tables)
    assert PD.whole_sweep.launches == 0


def test_batched_tables_are_checked():
    _, tplan, _ = plans("jax_test_tree")
    ps = PD.pack_sweep(tplan)
    for bad in (ps.table, ps.table[None].double(),
                ps.table[None, :, :, :2],
                ps.table[None].expand(2, -1, -1, -1)):
        with pytest.raises(ValueError):
            PD.whole_sweep_batched(ps, bad)
