"""The port's packed MaxSum engine (``ops/packed_maxsum.py``) against the
JAX package's Pallas kernel ``packed_cycle`` run in interpret mode.

Both packages run on the very same compiled arrays (compiled once by the
JAX package, carried over with ``tensors_from_numpy``).  The layouts
differ — the GPU layout has no Clos plan, no lane padding and no hub
splitting — so messages are compared edge by edge (through each
layout's ``slot_of_edge``) and beliefs variable by variable (through
``var_order``).  Tolerance, as in ``tests/unit/test_pallas_engine.py``'s
packed-vs-generic check: ``np.allclose(..., atol=1e-4)`` on messages and
beliefs, values exactly.

The CUDA kernel itself cannot run here; ``test_kernel_matches_plain_on_gpu``
holds it against the plain version where a GPU is visible.
"""
import numpy as np
import pytest
import torch

from pydcop_tpu.ops.compile import compile_binary_from_arrays as \
    jax_compile_binary
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.ops.pallas_maxsum import pack_for_pallas
from pydcop_tpu.ops.pallas_maxsum import packed_cycle as jax_packed_cycle
from pydcop_tpu.ops.pallas_maxsum import packed_init_state as jax_init
from pydcop_tpu_torch.ops.compile import (
    compile_binary_from_arrays,
    numpy_fields,
    tensors_from_numpy,
)
from pydcop_tpu_torch.ops.packed_maxsum import (
    pack_binary_for_gpu,
    pack_for_gpu,
    packed_cycles,
    packed_cycles_plain,
    packed_init_state,
)

torch.set_num_threads(1)


def _random_instance(V=60, F=150, D=3, seed=0):
    # tests/unit/test_pallas_engine.py::_random_binary_instance
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    un = rng.uniform(0, 1, (V, D)).astype(np.float32)
    return jax_compile_binary(ei, ej, mats, V, unary=un)


def _star_instance(leaves=146, seed=7):
    # one variable of degree 146: above the JAX packer's slot-class
    # ceiling of 96, so the JAX side splits it into hub sub-columns
    rng = np.random.default_rng(seed)
    ei = np.zeros(leaves, dtype=np.int64)
    ej = np.arange(1, leaves + 1)
    mats = rng.uniform(0, 1, (leaves, 3, 3)).astype(np.float32)
    un = rng.uniform(0, 1, (leaves + 1, 3)).astype(np.float32)
    return jax_compile_binary(ei, ej, mats, leaves + 1, unary=un)


def _unequal_domains_instance(V=30, F=60, seed=3):
    # even variables take 3 values, odd ones 2: padded values in D=3
    from pydcop_tpu.dcop import DCOP, Domain, NAryMatrixRelation, Variable

    rng = np.random.default_rng(seed)
    d3 = Domain("d3", "d", [0, 1, 2])
    d2 = Domain("d2", "d", [0, 1])
    vs = [Variable(f"v{i:02d}", d3 if i % 2 == 0 else d2) for i in range(V)]
    dcop = DCOP("unequal")
    for v in vs:
        dcop.add_variable(v)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    for k, (i, j) in enumerate(zip(ei, ej)):
        a, b = vs[i], vs[j]
        m = rng.uniform(0, 5, (len(a.domain), len(b.domain)))
        dcop.add_constraint(NAryMatrixRelation([a, b], m, name=f"c{k:03d}"))
    return jax_compile(dcop)


INSTANCES = {
    "random": _random_instance,
    "star_hub": _star_instance,
    "unequal_domains": _unequal_domains_instance,
}


@pytest.mark.parametrize("damping", [0.5, 0.0])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_plain_packed_matches_jax_packed(name, damping):
    jt = INSTANCES[name]()
    jpg = pack_for_pallas(jt)
    assert jpg is not None
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(jt), device="cpu"))
    assert pg is not None
    jq, jr = jax_init(jpg)
    q, r = packed_init_state(pg)
    for _ in range(4):
        jq, jr, jbel, jvals = jax_packed_cycle(jpg, jq, jr, damping=damping,
                                               interpret=True)
        q, r, bel, vals = packed_cycles(pg, q, r, 1, damping=damping)
    je, pe = np.asarray(jpg.slot_of_edge), pg.slot_of_edge
    assert np.allclose(q.numpy()[:, pe], np.asarray(jq)[:, je], atol=1e-4)
    assert np.allclose(r.numpy()[:, pe], np.asarray(jr)[:, je], atol=1e-4)
    jbel_v = np.asarray(jbel)[:, np.asarray(jpg.var_order)]
    assert np.allclose(bel.numpy()[:, pg.var_order.numpy()], jbel_v,
                       atol=1e-4)
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_fused_call_equals_single_cycles():
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(_random_instance()),
                                         device="cpu"))
    q, r = packed_init_state(pg)
    q1, r1 = q, r
    for _ in range(3):
        q1, r1, b1, v1 = packed_cycles(pg, q1, r1, 1, damping=0.5)
    q3, r3, b3, v3 = packed_cycles(pg, q, r, 3, damping=0.5)
    for a, b in ((q1, q3), (r1, r3), (b1, b3), (v1, v3)):
        assert torch.equal(a, b)
    assert not q.any() and not r.any()  # inputs are left untouched


def test_layout_invariants():
    t = tensors_from_numpy(numpy_fields(_star_instance()), device="cpu")
    pg = pack_for_gpu(t)
    F = t.buckets[0].n_factors
    assert pg.N == 2 * F and pg.Vp == t.n_vars
    # every edge endpoint owns one slot, and mate is an involution
    assert sorted(pg.slot_of_edge.tolist()) == list(range(pg.N))
    mate = pg.mate.long()
    assert torch.equal(mate[mate], torch.arange(pg.N))
    # column c's slots are col_slot0 + k * col_stride for k < col_deg
    for c in range(pg.Vp):
        s0, st = int(pg.col_slot0[c]), int(pg.col_stride[c])
        for k in range(int(pg.col_deg[c])):
            assert int(pg.slot_col[s0 + k * st]) == c
    assert int(pg.col_deg.sum()) == pg.N
    assert int(pg.col_deg.max()) == 146  # the hub is one column


def test_packer_refuses_what_it_cannot_pack():
    import os

    from pydcop_tpu_torch.dcop import load_dcop_from_file
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    inst = os.path.join(os.path.dirname(__file__), "instances")
    for name in ("ising_grid", "secp_small"):  # mixed arity 1-4
        t = compile_factor_graph(
            load_dcop_from_file(os.path.join(inst, name + ".yaml")),
            device="cpu")
        # the binary packer refuses them; pack_for_gpu gives them the
        # mixed layout
        assert pack_binary_for_gpu(t) is None
        assert pack_for_gpu(t).mixed is not None
    rng = np.random.default_rng(0)
    big_d = compile_binary_from_arrays(
        np.array([0]), np.array([1]),
        rng.uniform(0, 1, (1, 9, 9)).astype(np.float32), 2, device="cpu")
    assert pack_for_gpu(big_d) is None  # D > 8
    no_factors = compile_binary_from_arrays(
        np.zeros(0, np.int64), np.zeros(0, np.int64),
        np.zeros((0, 3, 3), np.float32), 4, device="cpu")
    assert pack_for_gpu(no_factors) is None


def test_wrapper_checks_its_operands():
    pg = pack_for_gpu(tensors_from_numpy(numpy_fields(_random_instance()),
                                         device="cpu"))
    q, r = packed_init_state(pg)
    with pytest.raises(TypeError):
        packed_cycles(pg, q.double(), r, 1)
    with pytest.raises(ValueError):
        packed_cycles(pg, q[:, :-1], r, 1)
    with pytest.raises(ValueError):
        packed_cycles(pg, q.t().contiguous().t(), r, 1)
    with pytest.raises(ValueError):
        packed_cycles(pg, q, r, 0)


def test_cuda_without_gpu_raises(monkeypatch):
    from pydcop_tpu_torch.algorithms.maxsum import build_solver
    from pydcop_tpu_torch.dcop import load_dcop
    from pydcop_tpu_torch.errors import DeviceUnavailableError
    from pydcop_tpu_torch.runtime import solve_result

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dcop = load_dcop("""
name: mini
objective: min
domains: {d: {values: [0, 1]}}
variables: {x: {domain: d}, y: {domain: d}}
constraints:
  c: {type: intention, function: "10 if x == y else 0"}
agents: [a1]
""")
    for call in (lambda: solve_result(dcop, "maxsum"),
                 lambda: solve_result(dcop, "maxsum", device="cuda"),
                 lambda: build_solver(dcop)):
        with pytest.raises(DeviceUnavailableError):
            call()
    # asking for the CPU is the one way to run there
    assert solve_result(dcop, "maxsum", device="cpu").cost == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_kernel_matches_plain_on_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    t = tensors_from_numpy(numpy_fields(INSTANCES[name]()), device="cuda")
    pg = pack_for_gpu(t)
    q, r = packed_init_state(pg)
    before = packed_cycles.launches
    kq, kr, kb, kv = packed_cycles(pg, q, r, 20, damping=0.5)
    assert packed_cycles.launches == before + 1
    pq, pr, pb, pv = packed_cycles_plain(pg, q, r, 20, damping=0.5)
    torch.cuda.synchronize()
    for a, b in ((kq, pq), (kr, pr), (kb, pb), (kv, pv)):
        assert torch.equal(a, b)
