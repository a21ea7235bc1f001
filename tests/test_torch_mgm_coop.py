"""K4, the MGM kernel of ``csrc/local_search.cu`` (ONE cooperative launch
a ``packed_mgm_cycles`` call, each cycle's tables and arbitration two
phases of the grid split by a grid barrier), and its wrapper.

Here, on the CPU: the grid helper; the wrapper's CUDA branch run on CPU
tensors with a stand-in C entry (the grid it asks for and its refusal of
a forced grid out of range, a capacity of 0, a refused launch, each
call's own zeroed barrier word, one launch counted a call, the operands
in the entry's order, the buffer the result comes from); the operand
checks; the launch counters, which stay 0 on the CPU; and the near-tie
instances of ``chip_smoke.mgm_tie_case`` through the plain version,
beside a model of the kernel's one-walk arbitration.

On the card (``cuda``-marked, skipped here): the kernel against
``packed_mgm_cycles_plain`` under ``torch.equal`` after 20 cycles on both
layouts, at the wrapper's grid and at forced grids of 1 and 3 blocks,
after 1, 2 and 3 cycles (the result in either buffer), on graphs with
degree-0 columns, and on the near-tie instances.  This file imports no
JAX: the port's MGM is held to the JAX package in
``test_torch_local_search.py`` and ``test_torch_local_search_mixed.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

import chip_smoke as C
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
    compile_constraint_graph

torch.set_num_threads(1)

LAYOUTS = ["binary", "mixed"]


def colouring(V, E, device, seed=2):
    """A soft 3-colouring of uniform [0, 1) costs (E < V leaves columns
    without slots)."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, E)
    ej = (ei + 1 + rng.integers(0, V - 1, E)) % V
    return compile_binary_from_arrays(
        ei, ej, rng.uniform(0, 1, (E, 3, 3)).astype(np.float32), V,
        device=device)


def mixed(V, counts, device, seed=12):
    """Arity 1-4 at D = 4, every second variable on 3 values
    (``chip_smoke.mixed_dcop``)."""
    return compile_constraint_graph(
        C.mixed_dcop(V, 4, counts, seed=seed, ragged=True), device=device)


def small(layout):
    """A small packed layout on the CPU."""
    t = (colouring(300, 700, "cpu") if layout == "binary"
         else mixed(200, {1: 40, 2: 200, 3: 80, 4: 20}, "cpu"))
    pls = P.pack_local_search(t)
    assert (pls.pg.mixed is not None) == (layout == "mixed")
    return pls


def start(pls, seed=1):
    """A random valid x in column order."""
    return C.random_x_col(pls, seed)


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


def test_grid_blocks():
    assert P.grid_blocks(1, 1188, 128) == 1
    assert P.grid_blocks(128, 1188, 128) == 1
    assert P.grid_blocks(129, 1188, 128) == 2
    assert P.grid_blocks(10_000, 1188, 128) == 79
    assert P.grid_blocks(100_000, 1056, 128) == 782
    assert P.grid_blocks(100_000, 528, 128) == 528
    assert P.grid_blocks(5, 0, 128) == 1


# ---------------------------------------------------------------------------
# the wrapper's CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``mgm_cycles(_mixed)``: records each
    call's arguments and its barrier word as it finds it, leaves the word
    dirty, writes 1 into every column of x_a and 2 into x_b (the buffers
    of even and odd cycles), and returns ``rc``."""

    def __init__(self, Vp, rc=0):
        self.Vp, self.rc, self.calls, self.bars = Vp, rc, [], []

    def __call__(self, *args):
        self.calls.append(args)
        word = ctypes.c_uint32.from_address(args[-2])
        self.bars.append(word.value)
        word.value = 7
        for ptr, value in ((args[1], 1), (args[2], 2)):
            (ctypes.c_int32 * self.Vp).from_address(ptr)[:] = \
                [value] * self.Vp
        return self.rc


def cuda_branch(monkeypatch, entry, capacity=(1188, 128)):
    """Run the CUDA branch of ``packed_mgm_cycles`` on CPU tensors with
    ``entry`` as its kernel, on counters of its own (zero, restored after
    the test); the plain version must not run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    names = []

    def kernel(name):
        names.append(name)
        return entry

    monkeypatch.setattr(P, "_kernel", kernel)
    monkeypatch.setattr(P, "_capacity", lambda D, mixed: capacity)
    monkeypatch.setattr(P, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(P, "packed_mgm_cycles_plain", never)
    monkeypatch.setattr(P, "mgm_move_plain", never)
    monkeypatch.setattr(P.packed_mgm_cycles, "launches", 0)
    monkeypatch.setattr(P.packed_mgm_cycles, "mixed_launches", 0)
    return names


@pytest.mark.parametrize("threads,capacity", [(128, 1188), (128, 2),
                                              (256, 1056), (64, 1)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_launch_grid_and_forced_grids(monkeypatch, layout, threads,
                                      capacity):
    """The grid: min(ceil(Vp / threads), capacity) blocks; a forced grid
    goes to the entry as it is, from 1 to the capacity, and one out of
    that range is refused before any launch."""
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    cuda_branch(monkeypatch, entry, capacity=(capacity, threads))
    x = start(pls)
    P._launch_mgm(pls, x, 4)
    want = max(1, min(capacity, -(-pls.Vp // threads)))
    assert entry.calls[0][-3] == want == P.grid_blocks(pls.Vp, capacity,
                                                       threads)
    for blocks in (1, capacity):
        P._launch_mgm(pls, x, 4, blocks)
        assert entry.calls[-1][-3] == blocks
    for blocks in (0, capacity + 1):
        with pytest.raises(ValueError, match="capacity"):
            P._launch_mgm(pls, x, 4, blocks)
    assert len(entry.calls) == 3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_resident_block_raises_without_launching(monkeypatch, layout):
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    cuda_branch(monkeypatch, entry, capacity=(0, 128))
    with pytest.raises(RuntimeError, match="no resident block"):
        P._launch_mgm(pls, start(pls), 3)
    assert entry.calls == []
    assert P.packed_mgm_cycles.launches == 0
    assert P.packed_mgm_cycles.mixed_launches == 0


@pytest.mark.parametrize("rc", [1, 720])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_failed_launch_raises_and_counts_nothing(monkeypatch, layout, rc):
    pls = small(layout)
    entry = StandInEntry(pls.Vp, rc)
    cuda_branch(monkeypatch, entry)
    name = "mgm_cycles_mixed" if layout == "mixed" else "mgm_cycles"
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                       f"error {rc}"):
        P._launch_mgm(pls, start(pls), 5)
    assert len(entry.calls) == 1
    assert P.packed_mgm_cycles.launches == 0
    assert P.packed_mgm_cycles.mixed_launches == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_call_one_launch_own_barrier_word(monkeypatch, layout):
    """Each call: one launch of its layout's entry, counted once whatever
    n, with a barrier word of its own, zero although the call before left
    its word dirty; x_in unchanged; the operands in the entry's order
    (the state, the layout of ls_tables, the siblings' variables,
    col_var, n, the grid); the result the buffer of parity (n - 1) % 2."""
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    names = cuda_branch(monkeypatch, entry)
    counter, other = (("mixed_launches", "launches") if layout == "mixed"
                      else ("launches", "mixed_launches"))
    fields = dict(vars(pls))
    layout_args = P._tables_layout(pls)
    ties = tuple(i.data_ptr() for _, i in pls.siblings())
    for k, n in enumerate((1, 2, 3, 100)):
        x = start(pls, seed=k)
        keep = x.clone()
        out = P._launch_mgm(pls, x, n)
        assert torch.equal(x, keep)
        assert torch.equal(out, torch.full_like(x, 1 if n % 2 else 2))
        args = entry.calls[-1]
        assert args[0] == x.data_ptr() and out.data_ptr() in args[1:3]
        assert len({a for a in args[:5]}) == 5  # five distinct buffers
        rest = args[5:]
        assert rest[:len(layout_args)] == layout_args
        assert rest[len(layout_args):-4] == ties + (pls.col_var.data_ptr(),)
        assert args[-4] == n
        assert args[-3] == P.grid_blocks(pls.Vp, 1188, 128)
        assert entry.bars[-1] == 0
        assert getattr(P.packed_mgm_cycles, counter) == k + 1
        assert getattr(P.packed_mgm_cycles, other) == 0
    assert set(names) == {"mgm_cycles_mixed" if layout == "mixed"
                          else "mgm_cycles"}
    # nothing of a launch is cached on the layout
    assert vars(pls).keys() == fields.keys()
    assert all(vars(pls)[k] is v for k, v in fields.items())


# ---------------------------------------------------------------------------
# operands and counters on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_operand_checks(layout):
    pls = small(layout)
    x = start(pls)
    with pytest.raises(TypeError):
        P.packed_mgm_cycles(pls, x.long(), 2)
    with pytest.raises(ValueError, match="shape"):
        P.packed_mgm_cycles(pls, x[:-1], 2)
    with pytest.raises(ValueError, match="contiguous"):
        P.packed_mgm_cycles(pls, torch.stack([x, x], 1)[:, 0], 2)
    for n in (0, -1):
        with pytest.raises(ValueError, match="n_cycles"):
            P.packed_mgm_cycles(pls, x, n)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_counters_stay_zero_on_the_cpu(layout):
    """On CPU tensors the wrapper runs the plain version (blocks has no
    use there) and counts no launch."""
    P.reset_launches()
    pls = small(layout)
    x = start(pls)
    want = P.packed_mgm_cycles_plain(pls, x, 3)
    for blocks in (None, 1, 3):
        assert torch.equal(P.packed_mgm_cycles(pls, x, 3, blocks=blocks),
                           want)
    for fn in (P.packed_local_tables, P.packed_mgm_cycles,
               P.packed_dsa_cycles):
        assert fn.launches == fn.mixed_launches == 0


# ---------------------------------------------------------------------------
# near ties: the kernel's one-walk arbitration
# ---------------------------------------------------------------------------

EPS32 = np.float32(1e-9)
NO_INDEX = 2**31 - 1


def one_walk(vals, ids, rewalk=True):
    """csrc/local_search.cu's arbitration walk in float32: the running
    max from 0 and the smallest id within 1e-9 of it in one walk; a new
    max within 1e-9 of the old one walks again with the final max.
    Returns (max, id, whether it walked again)."""
    nm, idx, again = np.float32(0.0), NO_INDEX, False
    for v, i in zip(vals, ids):
        if v > nm:
            if v - EPS32 > nm:
                idx = i
            else:
                again = True
            nm = v
        elif v >= nm - EPS32:
            idx = min(idx, i)
    if again and rewalk:
        idx = min((i for v, i in zip(vals, ids) if v >= nm - EPS32),
                  default=NO_INDEX)
    return nm, idx, again


def two_pass(vals, ids):
    """The plain version's rule: the max from 0 first, then the smallest
    id of the values within 1e-9 of it."""
    nm = max([np.float32(0.0)] + list(vals))
    return nm, min((i for v, i in zip(vals, ids) if v >= nm - EPS32),
                   default=NO_INDEX)


@pytest.mark.parametrize("seed", range(4))
def test_one_walk_is_the_two_pass_rule(seed):
    """Random walks of gains 3e-10 apart (new maxima land within 1e-9 of
    the old), zeros among them: the one walk with its re-walk gives the
    two-pass rule's max and index, and the re-walk runs."""
    rng = np.random.default_rng(seed)
    rewalks = 0
    for _ in range(300):
        n = int(rng.integers(1, 13))
        vals = np.float32(rng.choice([0.0, 1e-8, 3e-8])
                          + rng.integers(0, 8, n) * 3e-10)
        vals[rng.uniform(0, 1, n) < 0.1] = 0.0
        ids = [int(i) for i in rng.permutation(100)[:n]]
        nm, idx, again = one_walk(vals, ids)
        assert (nm, idx) == two_pass(vals, ids)
        rewalks += again
    assert 0 < rewalks < 300


def sibling_walk(pls, c):
    """The variables of column c's siblings in the kernel's walk order
    (slot by slot, each slot's siblings in order)."""
    col = int((pls.col_var == c).nonzero()[0])
    s0, stride = int(pls.pg.col_slot0[col]), int(pls.pg.col_stride[col])
    out = []
    for k in range(int(pls.pg.col_deg[col])):
        for cols, idx in pls.siblings():
            if int(cols[s0 + k * stride]) >= 0:
                out.append(int(idx[s0 + k * stride]))
    return out


@pytest.mark.parametrize("kind", C.MGM_TIE_KINDS)
def test_near_tie_case_plain(kind):
    """chip_smoke.mgm_tie_case on the CPU: column c (variable 1) walks
    to n1, n2, n3 (0, 2, 3) in that order, whose gains need the re-walk
    (the one walk alone keeps n1's index and c would not move); a column
    has no slot; the plain version gives the exact rule's x."""
    pls, x, want = C.mgm_tie_case(kind, "cpu")
    assert sibling_walk(pls, 1) == [0, 2, 3]
    assert int(pls.pg.col_deg.min()) == 0
    gain = P.ls_tables_plain(pls, x)[3][pls.pg.var_order.long()]
    vals = gain[[0, 2, 3]].numpy()
    assert one_walk(vals, [0, 2, 3]) == (vals[2], 2, True)
    assert one_walk(vals, [0, 2, 3], rewalk=False)[1] == 0
    assert abs(float(gain[1]) - float(vals[2])) <= 1e-9
    out = P.packed_mgm_cycles_plain(pls, x, 1)
    assert P.unpack_x(pls, out).tolist() == want
    assert P.unpack_x(pls, P.packed_mgm_cycles(pls, x, 1)).tolist() == want


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

#: graphs of the card checks: the V = 400 colourings (150 edges leave
#: about 190 columns without slots), integer costs with ties (chip_smoke's
#: hard colouring), and arity 1-4 on ragged domains (50 variables in 60
#: factors leave columns without slots)
GRAPHS = {
    "coloring": lambda dev: colouring(400, 1200, dev),
    "sparse": lambda dev: colouring(400, 150, dev),
    "hard": lambda dev: C.hard_coloring_tensors(400, 1200, dev),
    "mixed": lambda dev: mixed(600, {1: 100, 2: 600, 3: 300, 4: 50}, dev),
    "mixed_sparse": lambda dev: mixed(
        300, {1: 20, 2: 20, 3: 15, 4: 5}, dev, seed=13),
}


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_kernel_matches_plain_on_gpu(graph):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pls = P.pack_local_search(GRAPHS[graph]("cuda"))
    assert (pls.pg.mixed is not None) == graph.startswith("mixed")
    if graph.endswith("sparse"):
        assert int((pls.pg.col_deg == 0).sum()) > 0
    counter = "mixed_launches" if pls.pg.mixed is not None else "launches"
    for seed in range(2):
        x = start(pls, seed)
        for n in (1, 2, 3, 20):
            p = P.packed_mgm_cycles_plain(pls, x, n)
            before = getattr(P.packed_mgm_cycles, counter)
            k = P.packed_mgm_cycles(pls, x, n)
            assert getattr(P.packed_mgm_cycles, counter) == before + 1
            assert torch.equal(k, p), (seed, n)
            # forced grids of 1 and 3 blocks: the grid-stride loops
            for blocks in (1, 3):
                f = P.packed_mgm_cycles(pls, x, n, blocks=blocks)
                assert torch.equal(f, p), (seed, n, blocks)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", C.MGM_TIE_KINDS)
def test_near_tie_kernel_matches_plain_on_gpu(kind):
    """chip_smoke.mgm_tie_case on the card (c's arbitration walks its
    slots again; a column has no slot): the kernel equals the plain
    version and the exact rule's x, at the wrapper's grid and at 1 and 3
    blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pls, x, want = C.mgm_tie_case(kind, "cuda")
    p = P.packed_mgm_cycles_plain(pls, x, 1)
    assert P.unpack_x(pls, p).tolist() == want
    for blocks in (None, 1, 3):
        k = P.packed_mgm_cycles(pls, x, 1, blocks=blocks)
        assert torch.equal(k, p), blocks
    torch.cuda.synchronize()
