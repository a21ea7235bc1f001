"""The port's mixed-arity packed MaxSum engine (``ops/packed_maxsum.py``,
``pack_mixed_for_gpu`` + ``packed_cycles``) against the JAX package's
Pallas kernel ``packed_cycle`` on its mixed layout, run in interpret mode.

Both packages run on the very same compiled arrays (compiled once by the
JAX package, carried over with ``tensors_from_numpy``).  The layouts
differ — the GPU layout has no Clos plans, no lane padding, no quantised
class tuples and no hub splitting — so messages are compared slot by slot
through each layout's per-arity slot maps (the port keeps them as
``mixed.slot_of``; the JAX side's are rebuilt from the layout its packer
made, as ``pack_mixed_for_pallas`` computes them) and beliefs variable
by variable (through ``var_order``).  Tolerance: ``np.allclose`` with
atol 1e-4 and its default rtol 1e-5 on q, r and the valid beliefs, as
``tests/test_torch_packed_maxsum.py`` states it (the JAX kernel's XLA CPU
code rounds a few of its damping multiply-adds differently: bit-equal at
damping 0, a few float32 steps apart at 0.5), values exactly.
The instance shapes are those of
``tests/unit/test_mixed_arity_packing.py``.

The CUDA kernel cannot run here; ``test_mixed_kernel_matches_plain_on_gpu``
holds it against the plain version where a GPU is visible (exactly,
``torch.equal``).  Here the layout that the kernel's phase 1 relies on is
checked, and the wrapper's CUDA branch is driven with the C entry
replaced by a stand-in: a failed launch or a device with no resident
block raises and never runs the plain version, and each call hands the
kernel barrier words of its own, zeroed.
"""
import ctypes
from unittest import mock

import numpy as np
import pytest
import torch

from pydcop_tpu.dcop.dcop import DCOP
from pydcop_tpu.dcop.objects import Domain, Variable
from pydcop_tpu.dcop.relations import NAryMatrixRelation
from pydcop_tpu.ops import pallas_maxsum as jpm
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu_torch.ops import packed_maxsum as pm
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.ops.packed_maxsum import (
    mixed_blocks,
    mixed_work,
    pack_binary_for_gpu,
    pack_for_gpu,
    pack_mixed_for_gpu,
    packed_cycles,
    packed_cycles_plain,
    packed_init_state,
)

torch.set_num_threads(1)


def mixed_dcop(V=40, n2=60, n3=25, n1=10, D=4, seed=0, ragged=False, n4=0,
               integer=False):
    """tests/unit/test_mixed_arity_packing.py::_mixed_dcop (``integer``:
    costs 0..9 instead of uniform [0, 5))."""
    rng = np.random.default_rng(seed)
    dcop = DCOP("mixed", objective="min")
    doms = [Domain("d", "vals", list(range(D)))]
    if ragged:
        doms.append(Domain("d2", "vals", list(range(D - 1))))
    vs = []
    for i in range(V):
        v = Variable(f"v{i:02d}", doms[i % len(doms)])
        vs.append(v)
        dcop.add_variable(v)
    k = 0

    def add(sc):
        nonlocal k
        shape = [len(v.domain) for v in sc]
        m = rng.integers(0, 10, shape) if integer \
            else rng.uniform(0, 5, shape)
        dcop.add_constraint(NAryMatrixRelation(
            sc, m.astype(np.float32), name=f"c{k:03d}"))
        k += 1

    for _ in range(n2):
        add([vs[i] for i in rng.choice(V, 2, replace=False)])
    for _ in range(n3):
        add([vs[i] for i in rng.choice(V, 3, replace=False)])
    for _ in range(n1):
        add([vs[int(rng.integers(0, V))]])
    for _ in range(n4):
        add([vs[i] for i in rng.choice(V, 4, replace=False)])
    return dcop, vs, add


def hub_mixed_dcop(seed=2):
    """A degree-153 hub over 55 binary and 49 ternary factors (above the
    JAX packer's slot-class ceiling of 96: it splits the hub into
    sub-columns); integer costs, as the JAX test's."""
    dcop, vs, add = mixed_dcop(V=60, n2=80, n3=30, n1=10, seed=seed,
                               integer=True)
    for i in range(1, 56):
        add([vs[0], vs[i]])
    for i in range(1, 50):
        add([vs[0], vs[i], vs[i + 1]])
    return dcop


def secp12():
    """The JAX package's 12-light SECP with arity-4 models
    (``TestQuaternaryPacking``): unary, ternary and quaternary factors,
    hard model costs of 10,000."""
    from pydcop_tpu.generators.secp import generate_secp

    return generate_secp(n_lights=12, n_models=4, n_rules=3,
                         max_model_size=3, seed=2)


INSTANCES = {
    "ragged": lambda: mixed_dcop(ragged=True)[0],
    "ternary_only": lambda: mixed_dcop(n2=0, n1=0, n3=30, seed=3)[0],
    "quaternary": lambda: mixed_dcop(V=30, n2=20, n3=10, n1=8, n4=12,
                                     seed=4)[0],
    "quaternary_no_ternary": lambda: mixed_dcop(V=30, n2=20, n3=0, n1=8,
                                                n4=12, seed=4)[0],
    "mixed_hub": hub_mixed_dcop,
    "secp12": secp12,
}


def jax_pack_mixed(jt):
    """(the JAX mixed packing, its slot of each endpoint per arity).  The
    slot maps follow ``pack_mixed_for_pallas``'s own formula on the layout
    it built (captured on its way through ``_mixed_layout``)."""
    seen = {}
    build = jpm._mixed_layout

    def spy(*args):
        seen["layout"] = build(*args)
        return seen["layout"]

    with mock.patch.object(jpm, "_mixed_layout", spy):
        jpg = jpm.pack_mixed_for_pallas(jt)
    lay = seen["layout"]
    slot_of = {}
    for b in jt.buckets:
        if b.n_factors == 0:
            continue
        a = b.arity
        e = np.asarray(b.var_idx).T.ravel()
        deg = np.bincount(e, minlength=jt.n_vars)
        order = np.argsort(e, kind="stable")
        rank = np.empty(len(e), dtype=np.int64)
        rank[order] = np.arange(len(e)) - np.concatenate(
            [[0], np.cumsum(deg)[:-1]])[e[order]]
        split = np.maximum(lay.keys[:, a - 1], 1)[e]
        col = lay.var_pcol[e] + rank // split
        k = lay.col_base[a][col] + rank % split
        slot_of[a] = (lay.col_soff[col] + k * lay.col_nvp[col]
                      + (col - lay.col_voff[col]))
    return jpg, slot_of


def close(got, ref):
    return np.allclose(got, ref, atol=1e-4)


def both(name):
    jt = jax_compile(INSTANCES[name]())
    jpg, jslot = jax_pack_mixed(jt)
    assert jpg is not None and jpg.mixed
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(jt), device="cpu"))
    assert pg is not None and pg.mixed is not None
    assert sorted(pg.mixed.slot_of) == sorted(jslot)
    return jt, jpg, jslot, pg


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_plain_mixed_cycle_matches_jax_packed(name):
    jt, jpg, jslot, pg = both(name)
    damping = 0.0 if name == "ternary_only" else 0.5
    jq, jr = jpm.packed_init_state(jpg)
    q, r = packed_init_state(pg)
    # three cycles fused in one call on each side
    jq, jr, jbel, jvals = jpm.packed_cycles(jpg, jq, jr, 3, damping=damping,
                                            interpret=True)
    q, r, bel, vals = packed_cycles(pg, q, r, 3, damping=damping)
    for a, pe in pg.mixed.slot_of.items():
        je = jslot[a]
        assert close(q.numpy()[:, pe], np.asarray(jq)[:, je])
        assert close(r.numpy()[:, pe], np.asarray(jr)[:, je])
    # beliefs on valid entries only (the head column of a JAX hub holds
    # the whole hub's belief)
    valid = np.asarray(jt.domain_mask).T > 0
    jbel_v = np.asarray(jbel)[:, np.asarray(jpg.var_order)]
    assert close(bel.numpy()[:, pg.var_order.numpy()][valid],
                 jbel_v[valid])
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_mixed_layout_invariants():
    jt = jax_compile(INSTANCES["quaternary"]())
    pg = pack_mixed_for_gpu(tensors_from_numpy(numpy_fields(jt),
                                               device="cpu"))
    m = pg.mixed
    # every factor endpoint owns one slot
    every = np.concatenate([m.slot_of[a] for a in sorted(m.slot_of)])
    assert sorted(every.tolist()) == list(range(pg.N))
    arity = m.arity.long()
    mates = [pg.mate.long(), m.mate2.long(), m.mate3.long()]
    for a, s in m.slot_of.items():
        F = len(s) // a
        for p in range(a):
            mine = torch.as_tensor(s[p * F:(p + 1) * F])
            assert torch.all(arity[mine] == a)
            # siblings taken cyclically from the position p
            for step in range(1, 4):
                want = (torch.as_tensor(s[((p + step) % a) * F:
                                          ((p + step) % a + 1) * F])
                        if step < a else torch.full_like(mine, -1))
                assert torch.equal(mates[step - 1][mine], want)
    # a column's slots run unary, binary, ternary, quaternary, and the
    # columns of a class block share one per-arity degree tuple
    for deg, nvp, voff, soff in pg.buckets:
        block = arity[soff: soff + deg * nvp].reshape(deg, nvp)
        assert torch.all(torch.diff(block, dim=0) >= 0)
        assert torch.equal(block, block[:, :1].expand(deg, nvp))
        assert torch.equal(pg.slot_col[soff: soff + nvp],
                           torch.arange(voff, voff + nvp))
    # cost_idx ranks each arity's slots in slot order
    for a, sl, cost in zip(range(1, 5), m.slots, m.costs):
        assert cost.shape == (pg.D ** a, sl.numel())
        assert torch.equal(m.cost_idx.long()[sl], torch.arange(sl.numel()))
        assert torch.all(torch.diff(sl) > 0)
    assert int(pg.col_deg.sum()) == pg.N


def _tensors(dcop):
    return tensors_from_numpy(numpy_fields(jax_compile(dcop)), device="cpu")


def test_packer_scope_matches_the_jax_mixed_packer():
    # in scope (besides the INSTANCES, packed by both packages above):
    # D = 6 without arity >= 3
    jt = jax_compile(mixed_dcop(V=20, n2=30, n3=0, n1=5, D=6, seed=1)[0])
    assert jpm.try_pack_for_pallas(jt).mixed
    assert pack_for_gpu(tensors_from_numpy(numpy_fields(jt),
                                           device="cpu")).mixed is not None
    # out of scope: arity 5; D = 6 with a ternary factor; D = 9
    rng = np.random.default_rng(0)
    dcop5, vs, _ = mixed_dcop(V=20, n2=10, n3=0, n1=0, seed=9)
    dcop5.add_constraint(NAryMatrixRelation(
        vs[:5], rng.uniform(0, 1, [4] * 5).astype(np.float32), name="q5"))
    d6t, _, _ = mixed_dcop(V=20, n2=10, n3=3, n1=2, D=6, seed=2)
    d9, _, _ = mixed_dcop(V=20, n2=10, n3=0, n1=3, D=9, seed=3)
    for dcop in (dcop5, d6t, d9):
        jt = jax_compile(dcop)
        assert jpm.pack_mixed_for_pallas(jt) is None
        assert pack_for_gpu(tensors_from_numpy(numpy_fields(jt),
                                               device="cpu")) is None
    # an all-binary graph takes the binary layout; the mixed packer
    # refuses it
    tb = _tensors(mixed_dcop(n3=0, n1=0, seed=7)[0])
    assert pack_for_gpu(tb).mixed is None
    assert pack_mixed_for_gpu(tb) is None
    assert pack_binary_for_gpu(_tensors(INSTANCES["secp12"]())) is None


@pytest.mark.parametrize("max_model_size", [2, 3])
def test_secp_bench_configs_pack(max_model_size):
    """Both SECP configurations of the JAX bench's mixed-arity leg
    (``bench.py:681-800``) take the mixed layout in both packages."""
    from pydcop_tpu.generators.secp import generate_secp

    jt = jax_compile(generate_secp(n_lights=3000, n_models=900, n_rules=300,
                                   max_model_size=max_model_size, seed=1))
    assert jpm.try_pack_for_pallas(jt).mixed
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(jt), device="cpu"))
    assert pg.mixed is not None and pg.Vp == 3900
    assert pg.N == sum(b.n_factors * b.arity for b in jt.buckets)
    has4 = any(b.arity == 4 and b.n_factors for b in jt.buckets)
    assert has4 == (max_model_size == 3)


def test_fused_mixed_call_equals_single_cycles():
    pg = pack_for_gpu(_tensors(INSTANCES["quaternary"]()))
    q, r = packed_init_state(pg)
    q1, r1 = q, r
    for _ in range(3):
        q1, r1, b1, v1 = packed_cycles(pg, q1, r1, 1, damping=0.5)
    q3, r3, b3, v3 = packed_cycles(pg, q, r, 3, damping=0.5)
    for a, b in ((q1, q3), (r1, r3), (b1, b3), (v1, v3)):
        assert torch.equal(a, b)
    assert not q.any() and not r.any()  # inputs are left untouched
    # no kernel launch happens on the CPU
    assert packed_cycles.mixed_launches == 0


def _secp_bench(max_model_size):
    """The JAX bench's SECP (``bench.py`` ``bench_mixed_arity``), built and
    compiled by the port."""
    from pydcop_tpu_torch.generators import generate_secp
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    return compile_factor_graph(
        generate_secp(n_lights=3000, n_models=900, n_rules=300,
                      max_model_size=max_model_size, seed=1), device="cpu")


PHASE1_GRAPHS = dict(
    {name: (lambda b=build: _tensors(b())) for name, build in
     INSTANCES.items()},
    secp_bench_2=lambda: _secp_bench(2), secp_bench_3=lambda: _secp_bench(3))


@pytest.mark.parametrize("name", sorted(PHASE1_GRAPHS))
def test_layout_the_mixed_kernel_reads(name):
    """What phase 1 of the mixed kernel relies on: cost column t of arity
    a belongs to slot ``slots_a[t]`` (the kernel reads column t of a
    slot's unit directly), each sibling index is set exactly below the
    slot's arity, and the wrapper's unit count is one a unary or binary
    slot and D a ternary or quaternary slot."""
    pg = pack_for_gpu(PHASE1_GRAPHS[name]())
    m = pg.mixed
    assert m is not None
    arity = m.arity.long()
    for a, sl in zip(range(1, 5), m.slots):
        assert sl.dtype == torch.int64 and sl.is_contiguous()
        assert torch.equal(m.cost_idx.long()[sl], torch.arange(sl.numel()))
        assert torch.all(arity[sl] == a)
    assert sum(int(sl.numel()) for sl in m.slots) == pg.N
    for need, mate in ((2, pg.mate), (3, m.mate2), (4, m.mate3)):
        assert torch.equal(mate >= 0, arity >= need)
        assert torch.all(mate[arity < need] == -1)
        assert int(mate.max()) < pg.N
    units = int(torch.where(arity >= 3, pg.D, 1).sum())
    n1, n2, n3, n4 = (int(sl.numel()) for sl in m.slots)
    assert mixed_work(pg) == units == n1 + n2 + pg.D * (n3 + n4)
    # the grid: a thread a unit or a column, within the capacity
    need = -(-max(units, pg.Vp) // 128)
    assert mixed_blocks(pg, 10 ** 6, 128) == need
    assert mixed_blocks(pg, 3, 128) == min(3, need)
    assert mixed_blocks(pg, 1, 128) == 1


class _Entry:
    """A stand-in for the mixed C entry: records each launch's barrier
    words as it finds them, leaves them dirty, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls, self.bars = rc, [], []

    def __call__(self, *args):
        self.calls.append(args)
        words = (ctypes.c_uint32 * 2).from_address(args[-2])
        self.bars.append((args[-2], tuple(words)))
        words[0], words[1] = 7, 7
        return self.rc


def _cuda_branch(monkeypatch, entry, capacity=(264, 128)):
    """Patch the CUDA branch of ``packed_cycles`` to run on CPU tensors
    with ``entry`` as its kernel; the plain version must not run.  The
    stand-in's launches are counted as real ones would be, and the
    counters go back to their values at teardown, so that no later test
    of the same process finds them moved."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    for counter in ("launches", "mixed_launches"):
        monkeypatch.setattr(pm.packed_cycles, counter,
                            getattr(pm.packed_cycles, counter))
    monkeypatch.setattr(pm, "_kernel", lambda mixed: entry)
    monkeypatch.setattr(pm, "_capacity", lambda D: capacity)
    monkeypatch.setattr(pm, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(pm, "packed_cycles_plain", never)


@pytest.mark.parametrize("rc", [2, 720])
def test_failed_mixed_launch_raises(monkeypatch, rc):
    pg = pack_for_gpu(_tensors(INSTANCES["quaternary"]()))
    q, r = packed_init_state(pg)
    entry = _Entry(rc)
    _cuda_branch(monkeypatch, entry)
    before = packed_cycles.mixed_launches
    with pytest.raises(RuntimeError, match=f"CUDA error {rc}"):
        pm._launch_cycles(pg, q, r, 3, 0.5)
    assert len(entry.calls) == 1
    assert packed_cycles.mixed_launches == before


def test_no_resident_block_raises_without_launching(monkeypatch):
    pg = pack_for_gpu(_tensors(INSTANCES["secp12"]()))
    q, r = packed_init_state(pg)
    entry = _Entry()
    _cuda_branch(monkeypatch, entry, capacity=(0, 128))
    with pytest.raises(RuntimeError, match="no resident block"):
        pm._launch_cycles(pg, q, r, 2, 0.0)
    assert entry.calls == []


def test_each_call_owns_zeroed_barrier_words(monkeypatch):
    pg = pack_for_gpu(_tensors(INSTANCES["mixed_hub"]()))
    fields = dict(vars(pg))
    q, r = packed_init_state(pg)
    entry = _Entry()
    _cuda_branch(monkeypatch, entry, capacity=(5, 64))
    before = packed_cycles.mixed_launches
    for _ in range(2):
        first = len(entry.calls)
        pm._launch_cycles(pg, q, r, 3, 0.5)
        bars = entry.bars[first:]
        # one pair of words for the call's three launches, zero at its
        # first launch although the previous call left its words dirty
        assert len({ptr for ptr, _ in bars}) == 1
        assert bars[0][1] == (0, 0)
    assert packed_cycles.mixed_launches == before + 6
    # the unit count and the grid the wrapper passes (after D, N, Vp and
    # n1..n4, before damping, keep, use_damping, the barrier, the stream)
    for args in entry.calls:
        assert args[-7] == mixed_work(pg)
        assert args[-6] == mixed_blocks(pg, 5, 64) == 5
        assert args[-5:-2] == (0.5, 0.5, 1)
    # nothing of a launch is cached on the layout object
    assert vars(pg).keys() == fields.keys()
    assert all(vars(pg)[k] is v for k, v in fields.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_mixed_kernel_matches_plain_on_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    jt = jax_compile(INSTANCES[name]())
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(jt), device="cuda"))
    q, r = packed_init_state(pg)
    before = packed_cycles.mixed_launches
    kq, kr, kb, kv = packed_cycles(pg, q, r, 20, damping=0.5)
    assert packed_cycles.mixed_launches == before + 20
    pq, pr, pb, pv = packed_cycles_plain(pg, q, r, 20, damping=0.5)
    torch.cuda.synchronize()
    for a, b in ((kq, pq), (kr, pr), (kb, pb)):
        assert torch.equal(a, b)
    assert torch.equal(kv, pv)
    # two consecutive calls on one graph, each with barrier words of its
    # own, continue the cycles exactly
    hq, hr, _, _ = packed_cycles(pg, q, r, 10, damping=0.5)
    cq, cr, cb, cv = packed_cycles(pg, hq, hr, 10, damping=0.5)
    assert packed_cycles.mixed_launches == before + 40
    torch.cuda.synchronize()
    for a, b in ((cq, pq), (cr, pr), (cb, pb), (cv, pv)):
        assert torch.equal(a, b)
