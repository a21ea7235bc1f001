"""The port's MGM-2 engine against the JAX package, on the same
numpy-made inputs.

* pairing statics: ``pick_rank``, ``edge_id`` and the pair degree equal
  the JAX package's ``pack_mgm2_from_pls`` per edge endpoint and per
  variable;
* packed engine: the plain version of the port's ``packed_mgm2_cycles``
  against the JAX Pallas kernel run in interpret mode, from one x and one
  set of coins — bit for bit in x (the plain version repeats the Pallas
  kernel's arithmetic, ``A_i + (A_j + M)``);
* generic engine: ``Mgm2Solver.cycle`` against the JAX package's generic
  cycle with the same coins, on mixed-arity instances — bit for bit
  (both keep the generic association ``(A_i + A_j) + M``).

The JAX kernel's rows are lane-padded ``[1, Vp]`` in its own column
order: :func:`jax_rows` puts variable-order rows there, and
:func:`jax_var_order` / :func:`jax_endpoint_order` take its rows back to
variable order or edge-endpoint order (``var_order`` /
``slot_of_edge``), where the port's own packing (``pack_x``,
``pack_uniforms``) takes the same numpy arrays.

A Pallas interpret call traces and compiles the whole unrolled kernel
(about 2 s a cycle on this layout), so these tests run few cycles.  The
CUDA kernel cannot run here; ``test_kernel_matches_plain_on_gpu`` holds
it against the plain version where a GPU is visible, at the wrapper's
grid and at forced grids of 1 and 3 blocks.  The wrapper's CUDA branch
runs here on CPU tensors with a stand-in C entry: the grid it asks for,
its errors, each call's own barrier word, one launch counted a call,
and the buffer the result comes from.
"""
import ctypes
import os
import sys
import types
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.ops import pallas_local_search as jpls
from pydcop_tpu.ops import pallas_mgm2 as jmgm2
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops import packed_mgm2 as M
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy

torch.set_num_threads(1)

INSTANCES = os.path.join(os.path.dirname(__file__), "instances")
FAVORS = ["unilateral", "no", "coordinated"]


def coloring_dcop(seed):
    """The JAX MGM-2 tests' ``_coloring_dcop``: 40 variables, 100
    soft 3-colouring constraints."""
    from pydcop_tpu.generators import generate_graph_coloring

    return generate_graph_coloring(n_variables=40, n_colors=3, n_edges=100,
                                   soft=True, n_agents=1, seed=seed)


def unequal_dcop():
    """Odd variables take 2 of the 3 values; integer costs."""
    import pydcop_tpu.dcop as pkg
    from test_torch_local_search import build_dcop

    return build_dcop(pkg, V=40, F=90, kind="unequal", seed=3)


GRAPHS = {"coloring3": lambda: coloring_dcop(3),
          "coloring11": lambda: coloring_dcop(11),
          "unequal": unequal_dcop}


def jax_packed(dcop):
    """The JAX solver's MGM-2 layout, as ``tests/unit/test_pallas_mgm2.py``
    gets it (backend patched to "tpu"), and its compiled graph carried
    into the port's packed layout on the CPU."""
    algo_def = JaxAlgorithmDef.build_with_default_params("mgm2")
    with mock.patch.object(jax, "default_backend", lambda: "tpu"):
        s = jax_algo_module("mgm2").build_solver(dcop, algo_def=algo_def)
    jpm = s.packed_mgm2
    assert jpm is not None
    t = tensors_from_numpy(numpy_fields(s.tensors), device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    assert pm is not None
    return jpm, pm, t


def jax_rows(jpm, a):
    """[n, V] variable-order rows → the JAX kernel's [n, Vp] rows (pads
    1.0: never an offerer)."""
    pg = jpm.pls.pg
    out = np.ones((a.shape[0], pg.Vp), np.float32)
    out[:, np.asarray(pg.var_order)] = a
    return jnp.asarray(out)


def jax_var_order(jpm, row):
    """A JAX [1, Vp] column row → [V] in variable order."""
    return np.asarray(row)[0, np.asarray(jpm.pls.pg.var_order)]


def jax_endpoint_order(jpm, row):
    """A JAX [1, N] slot row → [2F] in edge-endpoint order (p*F + f)."""
    return np.asarray(row)[0, jpm.pls.pg.slot_of_edge]


def coins(V, n, seed):
    """(u_off, u_pick, u_fav), each [n, V] float32 from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (n, V)).astype(np.float32)
                 for _ in range(3))


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int32)


def run_both(jpm, pm, t, x, u, threshold, favor):
    jp = jpm.pls
    ref = jax_var_order(jpm, jmgm2.packed_mgm2_cycles(
        jpm, jpls.pack_x(jp, jnp.asarray(x)), *(jax_rows(jpm, a) for a in u),
        threshold, favor, interpret=True))
    pls = pm.pls
    got = P.unpack_x(pls, M.packed_mgm2_cycles(
        pm, P.pack_x(pls, x), *(P.pack_uniforms(pls, a) for a in u),
        threshold, favor))
    return ref, got.numpy()


# ---------------------------------------------------------------------------
# pairing statics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pairing_statics_match_jax(graph):
    jpm, pm, t = jax_packed(GRAPHS[graph]())
    soe = pm.pls.pg.slot_of_edge
    assert np.array_equal(pm.pick_rank.numpy()[soe],
                          jax_endpoint_order(jpm, jpm.pick_rank))
    assert np.array_equal(pm.edge_id.numpy()[soe],
                          jax_endpoint_order(jpm, jpm.edge_id))
    assert np.array_equal(pm.deg_col.numpy()[pm.pls.pg.var_order.numpy()],
                          jax_var_order(jpm, jpm.deg_col))
    # pick_rank is the inc[v] order, not the layout's slot rank: on a
    # variable with both sides, side-0 slots come first in the layout
    pg = pm.pls.pg
    k = ((torch.arange(pg.N) - pg.col_slot0.long()[pg.slot_col])
         // pg.col_stride.long()[pg.slot_col])
    assert not torch.equal(k.int(), pm.pick_rank)
    # each column's ranks are a permutation of 0..deg-1
    ranks = M._per_column(pm.pls, pm.pick_rank.long(), torch.add, 0)
    deg = pg.col_deg.long()
    assert torch.equal(ranks, deg * (deg - 1) // 2)


# ---------------------------------------------------------------------------
# the packed engine against the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("favor", FAVORS)
def test_packed_mgm2_matches_jax_kernel(favor, threshold):
    """Every favor × threshold on the first colouring; two cycles at 0.5
    (pairs form), one at 0 (no offers) and 1 (every offer meets an
    offerer)."""
    jpm, pm, t = jax_packed(GRAPHS["coloring3"]())
    n = 2 if threshold == 0.5 else 1
    x = random_x(t, 21)
    ref, got = run_both(jpm, pm, t, x, coins(t.n_vars, n, 5), threshold,
                        favor)
    assert np.array_equal(got, ref)
    assert np.any(got != x)


@pytest.mark.parametrize("favor", FAVORS)
@pytest.mark.parametrize("graph", ["coloring11", "unequal"])
def test_packed_mgm2_matches_jax_kernel_other_graphs(graph, favor):
    jpm, pm, t = jax_packed(GRAPHS[graph]())
    x = random_x(t, 8)
    ref, got = run_both(jpm, pm, t, x, coins(t.n_vars, 1, 9), 0.5, favor)
    assert np.array_equal(got, ref)
    if graph == "unequal":
        valid = t.domain_mask.numpy()[np.arange(t.n_vars), got] > 0
        assert valid.all()


def test_pairs_form_and_thresholds_0_and_1_never_pair():
    """On the hard-cost instance, at threshold 0 (no offerer) and 1 (every
    offer meets an offerer) nothing pairs: the two cycles are equal, for
    every favor.  At 0.5 pairs form and the cycle differs from them."""
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from test_torch_local_search import build_dcop

    t = compile_constraint_graph(build_dcop(tpkg, V=40, F=90, kind="hard"),
                                 device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    differs = 0
    for s in range(6):
        x_col = P.pack_x(pm.pls, random_x(t, s))
        u = [P.pack_uniforms(pm.pls, a)[0]
             for a in coins(t.n_vars, 1, 100 + s)]
        for favor in FAVORS:
            none = M.mgm2_cycle_plain(pm, x_col, *u, 0.0, favor)
            assert torch.equal(
                none, M.mgm2_cycle_plain(pm, x_col, *u, 1.0, favor))
            half = M.mgm2_cycle_plain(pm, x_col, *u, 0.5, favor)
            differs += int((half != none).sum())
    assert differs > 0


def test_wrapper_checks_operands_and_leaves_inputs_alone():
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(2)
    ei = rng.integers(0, 30, 60)
    ej = (ei + 1 + rng.integers(0, 29, 60)) % 30
    t = compile_binary_from_arrays(
        ei, ej, rng.uniform(0, 1, (60, 3, 3)).astype(np.float32), 30,
        device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    x = P.pack_x(pm.pls, random_x(t, 1))
    u = [P.pack_uniforms(pm.pls, a) for a in coins(30, 3, 1)]
    keep = [x.clone()] + [a.clone() for a in u]
    M.packed_mgm2_cycles(pm, x, *u, 0.5, "no")
    for a, b in zip([x] + u, keep):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, *u, 0.5, "sometimes")
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, u[0], u[1][:2], u[2], 0.5)
    with pytest.raises(TypeError):
        M.packed_mgm2_cycles(pm, x.long(), *u, 0.5)
    with pytest.raises(ValueError):
        M.packed_mgm2_cycles(pm, x, *(a[:0] for a in u), 0.5)
    assert M.packed_mgm2_cycles.launches == 0  # nothing launches on a CPU


# ---------------------------------------------------------------------------
# the CUDA branch on CPU tensors, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``mgm2_cycles(_mixed)``: records each
    call's arguments and its barrier word as it finds it, leaves the
    word dirty, writes 1 into every column of x_a and 2 into x_b (the
    buffers of even and odd cycles), and returns ``rc``."""

    def __init__(self, Vp, rc=0):
        self.Vp, self.rc, self.calls, self.bars = Vp, rc, [], []

    def __call__(self, *args):
        self.calls.append(args)
        word = ctypes.c_uint32.from_address(args[-2])
        self.bars.append((args[-2], word.value))
        word.value = 7
        for ptr, value in ((args[1], 1), (args[2], 2)):
            (ctypes.c_int32 * self.Vp).from_address(ptr)[:] = \
                [value] * self.Vp
        return self.rc


def cuda_branch(monkeypatch, entry, capacity=(264, 128)):
    """Patch the CUDA branch of ``packed_mgm2_cycles`` to run on CPU
    tensors with ``entry`` as its kernel, on counters of its own (zero,
    restored after the test); the plain version must not run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    monkeypatch.setattr(M, "_kernel", lambda mixed: entry)
    monkeypatch.setattr(M, "_capacity", lambda D, mixed: capacity)
    monkeypatch.setattr(M, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(M, "packed_mgm2_cycles_plain", never)
    monkeypatch.setattr(M, "mgm2_cycle_plain", never)
    monkeypatch.setattr(M.packed_mgm2_cycles, "launches", 0)
    monkeypatch.setattr(M.packed_mgm2_cycles, "mixed_launches", 0)


def launch_operands(pm, n, seed=1):
    """x and n rows of coins on the CPU, in column order."""
    pls = pm.pls
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(
        (rng.uniform(0, 1, pls.Vp) * pls.D).astype(np.int32))
    u = [torch.as_tensor(rng.uniform(0, 1, (n, pls.Vp)).astype(np.float32))
         for _ in range(3)]
    return x, u


def small_binary_pm(V=300, F=700, seed=2):
    from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays

    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    t = compile_binary_from_arrays(
        ei, ej, rng.uniform(0, 1, (F, 3, 3)).astype(np.float32), V,
        device="cpu")
    return M.pack_mgm2_from_pls(P.pack_local_search(t))


def check_grid(monkeypatch, pm, threads, capacity):
    """The grid the wrapper asks for: min(ceil(Vp / threads), capacity)."""
    entry = StandInEntry(pm.pls.Vp)
    cuda_branch(monkeypatch, entry, capacity=(capacity, threads))
    x, u = launch_operands(pm, 4)
    M._launch_cycles(pm, x, *u, 0.5, "no")
    want = max(1, min(capacity, -(-pm.pls.Vp // threads)))
    assert entry.calls[0][-3] == want == M.mgm2_blocks(pm.pls.Vp, capacity,
                                                        threads)
    # a forced grid goes to the entry as it is, within the capacity
    M._launch_cycles(pm, x, *u, 0.5, "no", blocks=1)
    assert entry.calls[1][-3] == 1
    with pytest.raises(ValueError, match="capacity"):
        M._launch_cycles(pm, x, *u, 0.5, "no", blocks=capacity + 1)
    assert len(entry.calls) == 2
    return want


def check_no_resident_block(monkeypatch, pm, counter):
    entry = StandInEntry(pm.pls.Vp)
    cuda_branch(monkeypatch, entry, capacity=(0, 128))
    x, u = launch_operands(pm, 3)
    with pytest.raises(RuntimeError, match="no resident block"):
        M._launch_cycles(pm, x, *u, 0.5, "unilateral")
    assert entry.calls == []
    assert getattr(M.packed_mgm2_cycles, counter) == 0


def check_failed_launch(monkeypatch, pm, rc, name):
    entry = StandInEntry(pm.pls.Vp, rc)
    cuda_branch(monkeypatch, entry)
    x, u = launch_operands(pm, 5)
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                       f"error {rc}"):
        M._launch_cycles(pm, x, *u, 0.5, "coordinated")
    assert len(entry.calls) == 1
    assert M.packed_mgm2_cycles.launches == 0
    assert M.packed_mgm2_cycles.mixed_launches == 0


def check_calls(monkeypatch, pm, counter, other):
    """Each call: its own barrier word, zero although the call before
    left its word dirty; one launch counted whatever n; x_in unchanged;
    the result the buffer of parity (n - 1) % 2."""
    entry = StandInEntry(pm.pls.Vp)
    cuda_branch(monkeypatch, entry)
    fields = dict(vars(pm))
    for k, n in enumerate((1, 2, 3, 100)):
        x, u = launch_operands(pm, n, seed=k)
        keep = x.clone()
        out = M._launch_cycles(pm, x, *u, 0.5, "no")
        assert torch.equal(x, keep)
        assert torch.equal(out, torch.full_like(x, 1 if n % 2 else 2))
        args = entry.calls[-1]
        assert args[0] == x.data_ptr() and out.data_ptr() in args[1:3]
        assert args[-6] == n  # the call's cycles, then threshold, favor
        assert args[-5:-3] == (0.5, M.FAVORS["no"])
        assert entry.bars[-1][1] == 0
        assert getattr(M.packed_mgm2_cycles, counter) == k + 1
        assert getattr(M.packed_mgm2_cycles, other) == 0
    # nothing of a launch is cached on the statics or the layout
    assert vars(pm).keys() == fields.keys()
    assert all(vars(pm)[k] is v for k, v in fields.items())


@pytest.mark.parametrize("threads,capacity", [(128, 264), (128, 2),
                                              (256, 1056), (64, 1)])
def test_launch_grid(monkeypatch, threads, capacity):
    pm = small_binary_pm()
    blocks = check_grid(monkeypatch, pm, threads, capacity)
    assert blocks == min(capacity, -(-pm.pls.Vp // threads))


def test_grid_sizes():
    assert M.mgm2_blocks(1, 264, 128) == 1
    assert M.mgm2_blocks(128, 264, 128) == 1
    assert M.mgm2_blocks(129, 264, 128) == 2
    assert M.mgm2_blocks(100_000, 1056, 128) == 782
    assert M.mgm2_blocks(100_000, 528, 128) == 528


def test_no_resident_block_raises_without_launching(monkeypatch):
    check_no_resident_block(monkeypatch, small_binary_pm(), "launches")


@pytest.mark.parametrize("rc", [1, 720])
def test_failed_launch_raises_and_counts_nothing(monkeypatch, rc):
    check_failed_launch(monkeypatch, small_binary_pm(), rc, "mgm2_cycles")


def test_each_call_one_launch_own_barrier_word(monkeypatch):
    check_calls(monkeypatch, small_binary_pm(), "launches", "mixed_launches")


# ---------------------------------------------------------------------------
# near ties: the kernel's one-walk response and winner rounds
# ---------------------------------------------------------------------------

EPS32 = np.float32(1e-9)
NO_ID = 2**31 - 1
#: (kind, the values c's walk meets in slot order, their edge ids or
#: tie-break ids) of chip_smoke.mgm2_tie_case: the joint gains offered to
#: c, or the gains of c's neighbours
TIE_WALKS = {
    "response": (np.float32([3e-8, 3e-8 + 6e-10, 3e-8 + 1.2e-9]), [0, 1, 2]),
    "winner": (np.float32([1e-8, 1e-8 + 6e-10, 1e-8 + 1.2e-9]), [0, 2, 3]),
}


def kernel_walk(vals, ids, start, keep, rewalk=True):
    """csrc/mgm2.cu's response / winner rule in float32: one walk keeps
    the running max (from ``start``: -1 for the response, 0 for the
    winner round) and the lowest id within 1e-9 of it, over the values
    ``keep`` admits; a new max within 1e-9 of the old one walks again
    with the final max.  Returns (max, id, whether it walked again)."""
    best, low, again = np.float32(start), NO_ID, False
    for v, i in zip(vals, ids):
        if not keep(v):
            continue
        if v > best:
            if v - EPS32 > best:
                low = i
            else:
                again = True
            best = v
        elif v >= best - EPS32:
            low = min(low, i)
    if again and rewalk:
        low = min((i for v, i in zip(vals, ids)
                   if keep(v) and v >= best - EPS32), default=NO_ID)
    return best, low, again


def two_pass(vals, ids, start, keep):
    """The plain version's rule: the max first, then the lowest id of
    the values within 1e-9 of it."""
    kept = [(v, i) for v, i in zip(vals, ids) if keep(v)]
    best = max([np.float32(start)] + [v for v, _ in kept])
    return best, min((i for v, i in kept if v >= best - EPS32),
                     default=NO_ID)


#: (start, keep) of the response and the winner round
RULES = {"response": (-1.0, lambda v: v > EPS32),
         "winner": (0.0, lambda v: True)}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_one_walk_rule_is_the_two_pass_rule(rule, seed):
    """Random walks of values 3e-10 apart (under the 1e-9 margin, so new
    maxima land within it of the old), zeros and values under 1e-9
    among them: the one walk with its re-walk gives the two-pass rule's
    max and id, and the re-walk runs."""
    start, keep = RULES[rule]
    rng = np.random.default_rng(seed)
    walks = rewalks = 0
    for _ in range(300):
        n = int(rng.integers(1, 13))
        base = rng.choice([0.0, 1e-8, 3e-8])
        vals = np.float32(base + rng.integers(0, 8, n) * 3e-10)
        vals[rng.uniform(0, 1, n) < 0.1] = 0.0
        ids = [int(i) for i in rng.permutation(100)[:n]]
        best, low, again = kernel_walk(vals, ids, start, keep)
        assert (best, low) == two_pass(vals, ids, start, keep)
        walks, rewalks = walks + 1, rewalks + again
    assert 0 < rewalks < walks


@pytest.mark.parametrize("kind", sorted(TIE_WALKS))
def test_near_tie_walks_need_the_rewalk(kind):
    """The walks of chip_smoke.mgm2_tie_case at column c: the re-walk
    runs and gives n2's id, where the one walk alone would keep n1's."""
    vals, ids = TIE_WALKS[kind]
    start, keep = RULES[kind]
    assert kernel_walk(vals, ids, start, keep) == (vals[2], ids[1], True)
    assert kernel_walk(vals, ids, start, keep, rewalk=False)[1] == ids[0]
    assert two_pass(vals, ids, start, keep) == (vals[2], ids[1])


def tie_walk_order(pm, c):
    """The variables of column c's siblings in its slot order (-1: a
    unary slot)."""
    pls = pm.pls
    col = int((pls.col_var == c).nonzero()[0])
    s0, stride = int(pls.pg.col_slot0[col]), int(pls.pg.col_stride[col])
    sib = [int(pls.mate_col[s0 + k * stride])
           for k in range(int(pls.pg.col_deg[col]))]
    return [int(pls.col_var[m]) if m >= 0 else -1 for m in sib]


def check_tie_case(kind, mixed):
    """chip_smoke.mgm2_tie_case on the CPU: c walks to n1, n2, n3 in
    that order, a column has no slot, and the plain version gives the
    exact rule's x for every favor."""
    import chip_smoke as C

    pm, x, u, threshold, want = C.mgm2_tie_case(kind, mixed, "cpu")
    c, ns = (0, [1, 2, 3]) if kind == "response" else (1, [0, 2, 3])
    assert [v for v in tie_walk_order(pm, c) if v >= 0] == ns
    assert int(pm.pls.pg.col_deg.min()) == 0
    gains = P.ls_tables_plain(pm.pls, x)[3]
    if kind == "winner":  # no offer: the gains are the unilateral ones
        got = gains[pm.pls.pg.var_order.long()[ns]].numpy()
        assert np.array_equal(got, TIE_WALKS[kind][0])
    for favor in FAVORS:
        out = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
        assert P.unpack_x(pm.pls, out).tolist() == want, favor
    return pm, x, u, threshold, want


@pytest.mark.parametrize("kind", sorted(TIE_WALKS))
def test_near_tie_case_plain(kind):
    check_tie_case(kind, mixed=False)


# ---------------------------------------------------------------------------
# the generic engine against the JAX generic cycle
# ---------------------------------------------------------------------------


def _jax_cycle_with(jsolver, x, u_off, u_pick, u_fav):
    """One JAX generic cycle where each ``jax.random.uniform`` of the
    module reads the given row instead (keys from a patched split)."""
    module = sys.modules[type(jsolver).cycle.__module__]
    keys = (object(), object(), object())
    rows = dict(zip(map(id, keys), map(jnp.asarray, (u_off, u_pick, u_fav))))
    real = module.jax
    module.jax = types.SimpleNamespace(random=types.SimpleNamespace(
        split=lambda k, n: keys, uniform=lambda k, shape: rows[id(k)]))
    try:
        (x2,) = jsolver.cycle((jnp.asarray(x),), None)
    finally:
        module.jax = real
    return np.asarray(x2)


@pytest.mark.parametrize("favor", FAVORS)
@pytest.mark.parametrize("name", ["secp_small", "ising_grid"])
def test_generic_cycle_matches_jax(name, favor):
    from pydcop_tpu.dcop import load_dcop_from_file as jax_load

    jdcop = jax_load(os.path.join(INSTANCES, name + ".yaml"))
    jdef = JaxAlgorithmDef.build_with_default_params(
        "mgm2", {"favor": favor}, mode=jdcop.objective)
    jsolver = jax_algo_module("mgm2").build_solver(jdcop, None, jdef)
    assert jsolver.packed is None
    mod = load_algorithm_module("mgm2")
    t = tensors_from_numpy(numpy_fields(jsolver.tensors), device="cpu")
    solver = mod.Mgm2Solver(None, t, AlgorithmDef.build_with_default_params(
        "mgm2", {"favor": favor}), seed=0)
    assert solver.packed is None and solver.n_pairs == jsolver.n_pairs > 0
    x = random_x(t, 3)
    moved = 0
    for c, (uo, up, uf) in enumerate(zip(*coins(t.n_vars, 4, 40))):
        ref = _jax_cycle_with(jsolver, x, uo, up, uf)
        got = solver.cycle(torch.as_tensor(x), tuple(
            torch.as_tensor(a) for a in (uo, up, uf))).numpy()
        assert np.array_equal(got, ref), f"cycle {c}"
        moved += int((got != x).sum())
        x = got
    assert moved > 0


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["coloring", "hard", "unequal", "sparse"])
def test_kernel_matches_plain_on_gpu(graph):
    """"sparse": 150 edges on 400 variables, so about 190 columns have no
    slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import pydcop_tpu_torch.dcop as tpkg
    from pydcop_tpu_torch.ops.compile import compile_constraint_graph
    from test_torch_local_search import build_dcop

    kind, F = {"coloring": ("float", 1200),
               "sparse": ("int", 150)}.get(graph, (graph, 1200))
    t = compile_constraint_graph(build_dcop(tpkg, V=400, F=F, kind=kind),
                                 device="cuda")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    x = P.pack_x(pm.pls, random_x(t, 1))
    u = [P.pack_uniforms(pm.pls, a) for a in coins(t.n_vars, 20, 2)]
    for favor in FAVORS:
        for threshold in (0.0, 0.5, 1.0):
            before = M.packed_mgm2_cycles.launches
            k = M.packed_mgm2_cycles(pm, x, *u, threshold, favor)
            assert M.packed_mgm2_cycles.launches == before + 1
            p = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
            assert torch.equal(k, p), (favor, threshold)
            # forced grids of 1 and 3 blocks: the grid-stride loops
            for blocks in (1, 3):
                f = M._launch_cycles(pm, x, *u, threshold, favor, blocks)
                assert torch.equal(f, p), (favor, threshold, blocks)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TIE_WALKS))
def test_near_tie_kernel_matches_plain_on_gpu(kind):
    """chip_smoke.mgm2_tie_case on the card (c's round walks its slots
    again; a column has no slot): the kernel equals the plain version and
    the exact rule's x, at the wrapper's grid and at 1 and 3 blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke as C

    pm, x, u, threshold, want = C.mgm2_tie_case(kind, False, "cuda")
    for favor in FAVORS:
        p = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
        assert P.unpack_x(pm.pls, p).tolist() == want, favor
        for blocks in (None, 1, 3):
            k = M._launch_cycles(pm, x, *u, threshold, favor, blocks)
            assert torch.equal(k, p), (favor, blocks)
    torch.cuda.synchronize()
