"""K5, the DSA kernel of ``csrc/local_search.cu`` (ONE cooperative launch
a ``packed_dsa_cycles`` call, each cycle one phase of the grid, a grid
barrier between consecutive cycles), and its wrapper.

Here, on the CPU: the wrapper's CUDA branch run on CPU tensors with a
stand-in C entry (the grid it asks for and its refusal of a forced grid
out of range, a capacity of 0, a refused launch, each call's own zeroed
barrier word, one launch counted a call, the operands in the entry's
order with the coin rows, the wake pointer and the rule, the buffer the
result comes from); the checks of x and the coins; the launch counters,
which stay 0 on the CPU; and the instances of
``chip_smoke.dsa_nudge_case``, on which the prefer-change nudge decides
best, through the plain version.

On the card (``cuda``-marked, skipped here): the kernel against
``packed_dsa_cycles_plain`` under ``torch.equal`` for the five rules of
``chip_smoke.DSA_RULES`` on both layouts, at the wrapper's grid and at
forced grids of 1 and 3 blocks, after 1, 2, 3 and 20 cycles, on graphs
with degree-0 columns, and on the nudge instances.  This file imports no
JAX: the port's DSA is held to the JAX package in
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
RULES = sorted(C.DSA_RULES)


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


def coins(pls, n, seed=0):
    """[n, Vp] move and wake coins, float32 and contiguous."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, pls.Vp), generator=gen),
            torch.rand((n, pls.Vp), generator=gen))


def rule_kwargs(rule, w):
    """packed_dsa_cycles' keyword arguments of ``rule`` of DSA_RULES, the
    wake coins ``w`` for adsa."""
    kw = dict(C.DSA_RULES[rule])
    act = kw.pop("activation", None)
    return dict(kw, activation=act,
                awake_uniforms=None if act is None else w)


# ---------------------------------------------------------------------------
# the wrapper's CUDA branch, with a stand-in C entry
# ---------------------------------------------------------------------------


class StandInEntry:
    """A stand-in for the C entry ``dsa_cycles(_mixed)``: records each
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
    """Run the CUDA branch of ``packed_dsa_cycles`` on CPU tensors with
    ``entry`` as its kernel, on counters of its own (zero, restored after
    the test); the plain version must not run."""
    def never(*args, **kwargs):
        raise AssertionError("the CUDA branch ran the plain version")

    names = []

    def kernel(name):
        names.append(name)
        return entry

    monkeypatch.setattr(P, "_kernel", kernel)
    monkeypatch.setattr(P, "_dsa_capacity", lambda D, mixed: capacity)
    monkeypatch.setattr(P, "_stream", lambda x: ctypes.c_void_p(0))
    monkeypatch.setattr(P, "packed_dsa_cycles_plain", never)
    monkeypatch.setattr(P, "dsa_cycle_plain", never)
    monkeypatch.setattr(P.packed_dsa_cycles, "launches", 0)
    monkeypatch.setattr(P.packed_dsa_cycles, "mixed_launches", 0)
    return names


def launch(pls, x, u, rule="dsa_B", w=None, blocks=None):
    """The CUDA branch of packed_dsa_cycles on the operands it passes
    (``rule`` of DSA_RULES; wake coins ``w``, or fresh ones, for adsa)."""
    kw = rule_kwargs(rule, w if w is not None else torch.rand_like(u))
    return P._launch_dsa(pls, x, u, kw["probability"], kw["variant"],
                         kw.get("probability_hard"), kw["awake_uniforms"],
                         kw["activation"], blocks)


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
    x, (u, _) = start(pls), coins(pls, 4)
    launch(pls, x, u)
    want = max(1, min(capacity, -(-pls.Vp // threads)))
    assert entry.calls[0][-3] == want == P.grid_blocks(pls.Vp, capacity,
                                                       threads)
    for blocks in (1, capacity):
        launch(pls, x, u, blocks=blocks)
        assert entry.calls[-1][-3] == blocks
    for blocks in (0, capacity + 1):
        with pytest.raises(ValueError, match="capacity"):
            launch(pls, x, u, blocks=blocks)
    assert len(entry.calls) == 3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_resident_block_raises_without_launching(monkeypatch, layout):
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    cuda_branch(monkeypatch, entry, capacity=(0, 128))
    with pytest.raises(RuntimeError, match="no resident block"):
        launch(pls, start(pls), coins(pls, 3)[0])
    assert entry.calls == []
    assert P.packed_dsa_cycles.launches == 0
    assert P.packed_dsa_cycles.mixed_launches == 0


@pytest.mark.parametrize("rc", [1, 720])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_failed_launch_raises_and_counts_nothing(monkeypatch, layout, rc):
    pls = small(layout)
    entry = StandInEntry(pls.Vp, rc)
    cuda_branch(monkeypatch, entry)
    name = "dsa_cycles_mixed" if layout == "mixed" else "dsa_cycles"
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                       f"error {rc}"):
        launch(pls, start(pls), coins(pls, 5)[0])
    assert len(entry.calls) == 1
    assert P.packed_dsa_cycles.launches == 0
    assert P.packed_dsa_cycles.mixed_launches == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_call_one_launch_own_barrier_word(monkeypatch, layout):
    """Each call: one launch of its layout's entry, counted once whatever
    n, with a barrier word of its own, zero although the call before left
    its word dirty; x_in and the coins unchanged; the operands in the
    entry's order (the state, the [n, Vp] coins, a null wake pointer
    without wake coins, the layout of ls_tables, the rule, n, the grid);
    nothing of a launch cached on the layout."""
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    names = cuda_branch(monkeypatch, entry)
    counter, other = (("mixed_launches", "launches") if layout == "mixed"
                      else ("launches", "mixed_launches"))
    fields = dict(vars(pls))
    layout_args = P._tables_layout(pls)
    for k, n in enumerate((1, 2, 3, 100)):
        x = start(pls, seed=k)
        u = coins(pls, n, seed=k)[0]
        keep = x.clone(), u.clone()
        out = launch(pls, x, u)
        assert torch.equal(x, keep[0]) and torch.equal(u, keep[1])
        args = entry.calls[-1]
        assert args[0] == x.data_ptr() and out.data_ptr() in args[1:3]
        assert len({a for a in args[:3]}) == 3  # three distinct buffers
        assert args[3] == u.data_ptr() and args[4] is None
        rest = args[5:]
        assert rest[:len(layout_args)] == layout_args
        assert rest[len(layout_args):-4] == (P.VARIANTS["B"], 0.7, 0.7, 0,
                                             0.0)
        assert args[-4] == n
        assert args[-3] == P.grid_blocks(pls.Vp, 1188, 128)
        assert entry.bars[-1] == 0
        assert getattr(P.packed_dsa_cycles, counter) == k + 1
        assert getattr(P.packed_dsa_cycles, other) == 0
    assert set(names) == {"dsa_cycles_mixed" if layout == "mixed"
                          else "dsa_cycles"}
    assert vars(pls).keys() == fields.keys()
    assert all(vars(pls)[k] is v for k, v in fields.items())


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rule_and_wake_coins_reach_the_entry(monkeypatch, layout, rule):
    """Each rule of DSA_RULES reaches the entry as (variant, probability,
    probability_hard or probability, use_hard, activation or 0), and
    adsa's wake coins as their [n, Vp] rows."""
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    cuda_branch(monkeypatch, entry)
    x, (u, w) = start(pls), coins(pls, 6)
    kw = rule_kwargs(rule, w)
    launch(pls, x, u, rule, w)
    args = entry.calls[-1]
    hard = kw.get("probability_hard")
    act = kw["activation"]
    assert args[-9:-4] == (
        P.VARIANTS[kw["variant"]], kw["probability"],
        kw["probability"] if hard is None else hard, int(hard is not None),
        0.0 if act is None else act)
    assert args[3] == u.data_ptr()
    assert args[4] == (None if act is None else w.data_ptr())


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_result_comes_from_the_last_cycles_buffer(monkeypatch, layout, n):
    """Cycle i writes x_a for even i and x_b for odd i: the result of n
    cycles is x_a for odd n and x_b for even n."""
    pls = small(layout)
    entry = StandInEntry(pls.Vp)
    cuda_branch(monkeypatch, entry)
    out = launch(pls, start(pls), coins(pls, n)[0])
    args = entry.calls[-1]
    assert out.data_ptr() == args[1 if n % 2 else 2]
    assert torch.equal(out, torch.full_like(out, 1 if n % 2 else 2))


# ---------------------------------------------------------------------------
# operands and counters on the CPU
# ---------------------------------------------------------------------------


def bad_coins(u, w):
    """{case: (uniforms, awake_uniforms, activation, error, match)} of
    coins packed_dsa_cycles refuses, made from good coins u and w."""
    return {
        "one_dim": (u[0], None, None, ValueError, r"\[n >= 1, Vp\]"),
        "no_rows": (u[:0], None, None, ValueError, r"\[n >= 1, Vp\]"),
        "float64": (u.double(), None, None, TypeError, "float32"),
        "narrow": (u[:, :-1].contiguous(), None, None, ValueError,
                   "shape"),
        "not_contiguous": (torch.stack([u, u], 2)[..., 0], None, None,
                           ValueError, "contiguous"),
        "wake_float64": (u, w.double(), 0.5, TypeError, "float32"),
        "wake_rows": (u, w[:-1].contiguous(), 0.5, ValueError, "shape"),
        "wake_not_contiguous": (u, torch.stack([w, w], 2)[..., 0], 0.5,
                                ValueError, "contiguous"),
        "wake_without_activation": (u, w, None, ValueError,
                                    "go together"),
    }


#: the cases of :func:`bad_coins`
BAD = ["one_dim", "no_rows", "float64", "narrow", "not_contiguous",
       "wake_float64", "wake_rows", "wake_not_contiguous",
       "wake_without_activation"]


@pytest.mark.parametrize("case", BAD)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_coin_checks(layout, case):
    """The coins must be [n >= 1, Vp] contiguous float32 (the wake coins
    of uniforms' shape, with an activation), on the CPU as on the card."""
    pls = small(layout)
    u, w = coins(pls, 3)
    uniforms, awake, act, err, match = bad_coins(u, w)[case]
    with pytest.raises(err, match=match):
        P.packed_dsa_cycles(pls, start(pls), uniforms, 0.7,
                            awake_uniforms=awake, activation=act)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_x_checks(layout):
    pls = small(layout)
    x, (u, _) = start(pls), coins(pls, 2)
    with pytest.raises(TypeError):
        P.packed_dsa_cycles(pls, x.long(), u, 0.7)
    with pytest.raises(ValueError, match="shape"):
        P.packed_dsa_cycles(pls, x[:-1], u, 0.7)
    with pytest.raises(ValueError, match="contiguous"):
        P.packed_dsa_cycles(pls, torch.stack([x, x], 1)[:, 0], u, 0.7)
    with pytest.raises(ValueError, match="variant"):
        P.packed_dsa_cycles(pls, x, u, 0.7, variant="D")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_counters_stay_zero_on_the_cpu(layout):
    """On CPU tensors the wrapper runs the plain version for every rule
    (blocks has no use there) and counts no launch."""
    P.reset_launches()
    pls = small(layout)
    x, (u, w) = start(pls), coins(pls, 3)
    for rule in RULES:
        kw = rule_kwargs(rule, w)
        want = P.packed_dsa_cycles_plain(pls, x, u, **kw)
        for blocks in (None, 1, 3):
            assert torch.equal(P.packed_dsa_cycles(pls, x, u, **kw,
                                                   blocks=blocks), want)
    for fn in (P.packed_local_tables, P.packed_mgm_cycles,
               P.packed_dsa_cycles):
        assert fn.launches == fn.mixed_launches == 0


# ---------------------------------------------------------------------------
# the nudge instances
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", C.DSA_NUDGE_KINDS)
def test_nudge_case_plain(kind):
    """chip_smoke.dsa_nudge_case on the CPU: the tables stay below 32, so
    the 1e-6 nudge survives the add; on the columns it changes, best
    moves off x (where it stays without the nudge) to a value of equal
    cost (gain 0), and one cycle of variant C with every coin at 0 moves
    those columns there, where variant A keeps them."""
    pls, x, nudged = C.dsa_nudge_case(kind, "cpu")
    assert nudged.numel() > 0
    assert int((pls.pg.col_deg == 0).sum()) > 0
    tables, cur, best, gain = P.ls_tables_plain(pls, x, prefer_change=True)
    assert float(tables[pls.pg.mask_p > 0].abs().max()) < 32
    assert torch.all(best[nudged] != x[nudged])
    assert torch.all(gain[nudged] == 0)
    assert torch.equal(tables.gather(0, best[None].long())[0][nudged],
                       cur[nudged])
    # without the nudge best stays on x: the nudge alone moves it
    assert torch.equal(P.ls_tables_plain(pls, x)[2][nudged], x[nudged])
    u = torch.zeros((1, pls.Vp))
    c = P.packed_dsa_cycles(pls, x, u, 1.0, "C")
    a = P.packed_dsa_cycles(pls, x, u, 1.0, "A")
    assert torch.equal(c[nudged], best[nudged])
    assert torch.equal(a[nudged], x[nudged])


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


def card_checks(pls, x, rule, what):
    """The kernel against the plain version for ``rule`` from ``x``: after
    1, 2, 3 and 20 cycles, at the wrapper's grid (one launch counted a
    call) and at forced grids of 1 and 3 blocks."""
    counter = "mixed_launches" if pls.pg.mixed is not None else "launches"
    gen = torch.Generator().manual_seed(3)
    u, w = (torch.rand((20, pls.Vp), generator=gen).cuda() for _ in range(2))
    for n in (1, 2, 3, 20):
        kw = rule_kwargs(rule, w[:n])
        p = P.packed_dsa_cycles_plain(pls, x, u[:n], **kw)
        before = getattr(P.packed_dsa_cycles, counter)
        k = P.packed_dsa_cycles(pls, x, u[:n], **kw)
        assert getattr(P.packed_dsa_cycles, counter) == before + 1
        assert torch.equal(k, p), (what, rule, n)
        for blocks in (1, 3):
            f = P.packed_dsa_cycles(pls, x, u[:n], **kw, blocks=blocks)
            assert torch.equal(f, p), (what, rule, n, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_kernel_matches_plain_on_gpu(graph, rule):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pls = P.pack_local_search(GRAPHS[graph]("cuda"))
    assert (pls.pg.mixed is not None) == graph.startswith("mixed")
    if graph.endswith("sparse"):
        assert int((pls.pg.col_deg == 0).sum()) > 0
    for seed in range(2):
        card_checks(pls, start(pls, seed), rule, (graph, seed))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", C.DSA_NUDGE_KINDS)
def test_nudge_kernel_matches_plain_on_gpu(kind, rule):
    """chip_smoke.dsa_nudge_case on the card: the nudge decides best on
    some columns, and the kernel equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pls, x, nudged = C.dsa_nudge_case(kind, "cuda")
    assert nudged.numel() > 0
    card_checks(pls, x, rule, kind)
    torch.cuda.synchronize()
