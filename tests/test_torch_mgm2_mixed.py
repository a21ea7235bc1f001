"""The port's MGM-2 engine on the mixed-arity layout (the mixed branch of
``ops/packed_mgm2.py``, its plain version here) against the JAX
package's Pallas kernel on its mixed layout, run in interpret mode.

* mixed statics: ``pick_rank``, ``edge_id`` (binary slots, matched slot
  for slot through each layout's ``slot_of[2]``) and the pair degree (per
  variable) equal the JAX ``pack_mgm2_from_pls``; every other slot holds
  ``NO_INDEX``;
* the plain mixed cycle: x equals the JAX kernel's after one or two
  cycles from one numpy-made x and the coins of ``uniforms_for_mgm2``,
  for favors unilateral and coordinated, on the hub instance (arity <= 3,
  a hub of degree 153) and the quaternary one — bit for bit, tolerance
  none;
* solve: on ``secp_small`` and ``ising_grid`` the port with
  ``use_packed=True`` on the CPU equals the JAX solver built with
  ``use_packed=True`` (its Pallas kernel in interpret mode) from one
  start and the JAX key stream's coins, and equals its own generic run.

A Pallas interpret call traces the whole unrolled kernel (4-5 s for two
cycles of the hub instance on a CPU), so these tests run few cycles.  The
CUDA kernel cannot run here; ``test_mixed_kernel_matches_plain_on_gpu``
holds it against the plain version where a GPU is visible, at the
wrapper's grid and at forced grids of 1 and 3 blocks; the wrapper's CUDA
branch runs here with a stand-in C entry, as in ``test_torch_mgm2.py``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms.mgm2 import Mgm2Solver as JaxMgm2Solver
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.ops import pallas_local_search as jpls
from pydcop_tpu.ops import pallas_mgm2 as jmgm2
from pydcop_tpu.ops.compile import compile_constraint_graph as jax_compile
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import packed_local_search as P
from pydcop_tpu_torch.ops import packed_mgm2 as M
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from test_torch_mgm2 import (TIE_WALKS, StandInEntry, check_calls,
                             check_failed_launch, check_grid,
                             check_no_resident_block, check_tie_case,
                             cuda_branch, launch_operands)
from test_torch_packed_maxsum_mixed import INSTANCES, jax_pack_mixed

torch.set_num_threads(1)

INSTANCE_DIR = os.path.join(os.path.dirname(__file__), "instances")


@functools.lru_cache(maxsize=None)
def both(name):
    """(JAX statics, JAX slot of each endpoint per arity, the port's
    compiled graph and statics) of one mixed instance, built once a
    process (the tests only read them)."""
    jt = jax_compile(INSTANCES[name]())
    jpg, jslot = jax_pack_mixed(jt)
    jpm = jmgm2.pack_mgm2_from_pls(jpls.pack_from_pg(jpg))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    return jpm, jslot, t, pm


def random_x(t, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int32)


def jax_coins(jpm, n, seed):
    """``uniforms_for_mgm2``'s (u_off, u_pick, u_fav), each [n, Vp] in the
    JAX column order, and the same numbers [n, V] in variable order."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    rows = jmgm2.uniforms_for_mgm2(jpm, keys)
    order = np.asarray(jpm.pls.pg.var_order)
    return rows, [np.asarray(r)[:, order] for r in rows]


def run_both(name, favor, n, threshold=0.5, seed=0):
    """x after n cycles of the JAX kernel and of the port's plain
    version, in variable order, and the start x."""
    jpm, _, t, pm = both(name)
    x = random_x(t, seed)
    rows, u = jax_coins(jpm, n, seed)
    jp = jpm.pls
    ref = jpls.unpack_x(jp, jmgm2.packed_mgm2_cycles(
        jpm, jpls.pack_x(jp, jnp.asarray(x)), *rows, threshold, favor,
        interpret=True))
    pls = pm.pls
    got = P.unpack_x(pls, M.packed_mgm2_cycles(
        pm, P.pack_x(pls, x), *(P.pack_uniforms(pls, a) for a in u),
        threshold, favor))
    return np.asarray(ref), got.numpy(), x


# ---------------------------------------------------------------------------
# the mixed statics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mixed_hub", "quaternary"])
def test_mixed_statics_match_jax(name):
    jpm, jslot, t, pm = both(name)
    pg = pm.pls.pg
    assert pg.mixed is not None
    mine, theirs = pg.mixed.slot_of[2], jslot[2]
    assert np.array_equal(pm.pick_rank.numpy()[mine],
                          np.asarray(jpm.pick_rank)[0, theirs])
    assert np.array_equal(pm.edge_id.numpy()[mine],
                          np.asarray(jpm.edge_id)[0, theirs])
    var_order = np.asarray(jpm.pls.pg.var_order)
    assert np.array_equal(pm.deg_col.numpy()[pg.var_order.numpy()],
                          np.asarray(jpm.deg_col)[0, var_order])
    # off the binary slots: no rank, no edge; the pair degree counts a
    # column's binary slots only
    other = np.ones(pg.N, bool)
    other[mine] = False
    assert np.all(pm.pick_rank.numpy()[other] == P.NO_INDEX)
    assert np.all(pm.edge_id.numpy()[other] == P.NO_INDEX)
    binary = (pg.mixed.arity == 2).int()
    assert torch.equal(pm.deg_col,
                       M._per_column(pm.pls, binary, torch.add, 0).int())
    assert bool((pm.deg_col < pg.col_deg).any())


def test_pair_degree_is_the_degree_on_the_binary_layout():
    from test_torch_mgm2 import GRAPHS

    t = tensors_from_numpy(numpy_fields(jax_compile(GRAPHS["unequal"]())),
                           device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    assert pm.pls.pg.mixed is None
    assert torch.equal(pm.deg_col, pm.pls.pg.col_deg)


# ---------------------------------------------------------------------------
# the plain mixed cycle against the JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("favor", ["unilateral", "coordinated"])
@pytest.mark.parametrize("name", ["mixed_hub", "quaternary"])
def test_plain_mixed_cycle_matches_jax_kernel(name, favor):
    """Two cycles for unilateral, one for coordinated (the interpret trace
    grows with the cycles of a call)."""
    ref, got, x = run_both(name, favor, 2 if favor == "unilateral" else 1)
    assert np.array_equal(got, ref)
    assert np.any(got != x)


def test_pairs_form_on_the_mixed_layout():
    """At threshold 0.5 some offer is accepted on the hub instance: the
    cycle differs from the one at threshold 0 (no offerer), which equals
    the one at threshold 1 (every offer meets an offerer)."""
    _, _, t, pm = both("mixed_hub")
    pls = pm.pls
    differs = 0
    for s in range(4):
        x = P.pack_x(pls, random_x(t, s))
        rng = np.random.default_rng(50 + s)
        u = [P.pack_uniforms(pls, rng.uniform(0, 1, (1, t.n_vars)))[0]
             for _ in range(3)]
        for favor in M.FAVORS:
            none = M.mgm2_cycle_plain(pm, x, *u, 0.0, favor)
            assert torch.equal(none, M.mgm2_cycle_plain(pm, x, *u, 1.0,
                                                        favor))
            half = M.mgm2_cycle_plain(pm, x, *u, 0.5, favor)
            differs += int((half != none).sum())
    assert differs > 0


def test_column_without_binary_factor_never_offers():
    """``secp_small``'s lights hold unary, ternary and quaternary factors
    but no binary one: their pair degree is 0, and when they are the only
    offerers nobody pairs (the cycle is the one without offerers)."""
    t = tensors_from_numpy(numpy_fields(jax_compile(jax_load_dcop(
        os.path.join(INSTANCE_DIR, "secp_small.yaml")))), device="cpu")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    pls = pm.pls
    lonely = (pm.deg_col == 0) & (pls.pg.col_deg > 0)
    assert bool(lonely.any()) and bool((pm.deg_col > 0).any())
    for s in range(6):
        x = P.pack_x(pls, random_x(t, s))
        rng = np.random.default_rng(s)
        u_pick, u_fav = (torch.as_tensor(rng.uniform(0, 1, pls.Vp),
                                         dtype=torch.float32)
                         for _ in range(2))
        u_off = torch.where(lonely, 0.0, 1.0)
        for favor in M.FAVORS:
            assert torch.equal(
                M.mgm2_cycle_plain(pm, x, u_off, u_pick, u_fav, 0.5, favor),
                M.mgm2_cycle_plain(pm, x, u_off, u_pick, u_fav, 0.0, favor))


def test_no_binary_factor_gives_no_statics():
    """A mixed graph without a binary factor has nothing to pair on: no
    statics, as in the JAX package, and MGM-2 drops the layout for its
    generic engine even with use_packed=True."""
    jt = jax_compile(INSTANCES["ternary_only"]())
    assert jmgm2.pack_mgm2_from_pls(
        jpls.pack_from_pg(jax_pack_mixed(jt)[0])) is None
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    pls = P.pack_local_search(t)
    assert pls is not None and pls.pg.mixed is not None
    assert M.pack_mgm2_from_pls(pls) is None
    mod = load_algorithm_module("mgm2")
    solver = mod.Mgm2Solver(None, t, AlgorithmDef.build_with_default_params(
        "mgm2"), use_packed=True)
    assert solver.packed is None and solver.packed_mgm2 is None


# ---------------------------------------------------------------------------
# solve: the port's packed engine against the JAX packed solver
# ---------------------------------------------------------------------------


def _key_stream_coins(seed, V, cycles):
    """The coins of the JAX harness's one chunk of ``cycles``: the chunk
    key split from PRNGKey(seed), a key a cycle, each split in three
    (offer, pick, favor), as Mgm2Solver.cycle and uniforms_for_mgm2 draw
    them; [cycles, V] each."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    out = [[], [], []]
    for k in jax.random.split(sub, cycles):
        for kind, kk in enumerate(jax.random.split(k, 3)):
            out[kind].append(np.asarray(jax.random.uniform(kk, (V,))))
    return [np.stack(o) for o in out]


def _port_solver(name, favor, use_packed, x0, coins, seed=0):
    dcop = load_dcop_from_file(os.path.join(INSTANCE_DIR, name + ".yaml"))
    solver = load_algorithm_module("mgm2").build_solver(
        dcop, None, AlgorithmDef.build_with_default_params(
            "mgm2", {"favor": favor}, mode=dcop.objective),
        seed=seed, device="cpu", use_packed=use_packed)
    draws = iter(coins)
    solver.draw_uniforms = lambda n: torch.as_tensor(next(draws))
    solver.initial_state = lambda: (torch.as_tensor(x0),)
    return solver


#: cycles of a solve parity run: one chunk of 7 has no divisor in (5, 4,
#: 3, 2), so the JAX fused runner traces its one-cycle kernel only
SOLVE_CYCLES = 7


@pytest.mark.parametrize("name,favor", [("secp_small", "coordinated"),
                                        ("ising_grid", "unilateral")])
def test_packed_solve_matches_jax_packed(name, favor):
    seed = 0
    jdcop = jax_load_dcop(os.path.join(INSTANCE_DIR, name + ".yaml"))
    jdef = JaxAlgorithmDef.build_with_default_params(
        "mgm2", {"favor": favor}, mode=jdcop.objective)
    x0 = random_x(tensors_from_numpy(numpy_fields(
        jax_compile(jdcop)), device="cpu"), 7)

    class Shared(JaxMgm2Solver):
        def initial_state(self):
            return (jnp.asarray(x0),)

    jsolver = Shared(jdcop, jax_compile(jdcop), jdef, seed,
                     use_packed=True)
    assert jsolver.packed_mgm2 is not None
    assert jsolver.packed.mixed
    ref = jsolver.run(cycles=SOLVE_CYCLES)
    coins = _key_stream_coins(seed, len(x0), SOLVE_CYCLES)
    solver = _port_solver(name, favor, True, x0, coins, seed)
    assert solver.packed_mgm2 is not None
    assert solver.packed.pg.mixed is not None
    got = solver.run(cycles=SOLVE_CYCLES)
    assert got.assignment == ref.assignment
    assert got.cost == pytest.approx(ref.cost, abs=1e-9)
    assert got.violation == ref.violation
    assert got.cycle == ref.cycle == SOLVE_CYCLES
    assert got.msg_count == ref.msg_count
    # the port's packed run equals its own generic run from that start
    generic = _port_solver(name, favor, False, x0, coins, seed)
    assert generic.packed is None
    gen = generic.run(cycles=SOLVE_CYCLES)
    assert gen.assignment == got.assignment and gen.cost == got.cost


@pytest.mark.parametrize("name", ["secp_small", "ising_grid"])
def test_packed_and_generic_mixed_runs_agree(name):
    """As the JAX package pins its two engines on mixed graphs
    (``tests/unit/test_mixed_arity_packing.py``): the same seed and coins
    give the same run until the solver stops, for each favor."""
    dcop = load_dcop_from_file(os.path.join(INSTANCE_DIR, name + ".yaml"))
    mod = load_algorithm_module("mgm2")
    for favor in M.FAVORS:
        algo_def = AlgorithmDef.build_with_default_params(
            "mgm2", {"favor": favor}, mode=dcop.objective)
        packed = mod.build_solver(dcop, None, algo_def, seed=3,
                                  device="cpu", use_packed=True)
        generic = mod.build_solver(dcop, None, algo_def, seed=3,
                                   device="cpu", use_packed=False)
        assert packed.packed is not None and generic.packed is None
        a, b = packed.run(), generic.run()
        assert a.assignment == b.assignment and a.cost == b.cost
        assert a.cycle == b.cycle and a.msg_count == b.msg_count


# the CUDA branch on CPU tensors, with a stand-in C entry (the checks of
# test_torch_mgm2.py, on the mixed entry and its counter)


@pytest.mark.parametrize("threads,capacity", [(128, 264), (128, 2),
                                              (256, 1056)])
@pytest.mark.parametrize("name", ["mixed_hub", "quaternary"])
def test_mixed_launch_grid(monkeypatch, name, threads, capacity):
    pm = both(name)[3]
    blocks = check_grid(monkeypatch, pm, threads, capacity)
    assert blocks == min(capacity, -(-pm.pls.Vp // threads))


def test_mixed_no_resident_block_raises_without_launching(monkeypatch):
    check_no_resident_block(monkeypatch, both("quaternary")[3],
                            "mixed_launches")


@pytest.mark.parametrize("rc", [1, 720])
def test_mixed_failed_launch_raises_and_counts_nothing(monkeypatch, rc):
    check_failed_launch(monkeypatch, both("mixed_hub")[3], rc,
                        "mgm2_cycles_mixed")


@pytest.mark.parametrize("name", ["mixed_hub", "quaternary", "ragged"])
def test_mixed_each_call_one_launch_own_barrier_word(monkeypatch, name):
    pm = both(name)[3]
    check_calls(monkeypatch, pm, "mixed_launches", "launches")
    # the mixed entry gets the per-arity widths after D, N and Vp
    entry = StandInEntry(pm.pls.Vp)
    cuda_branch(monkeypatch, entry)
    x, u = launch_operands(pm, 3)
    M._launch_cycles(pm, x, *u, 0.5, "coordinated")
    widths = tuple(int(sl.numel()) for sl in pm.pls.pg.mixed.slots)
    assert entry.calls[0][-10:-6] == widths
    assert entry.calls[0][-13:-10] == (pm.pls.D, pm.pls.N, pm.pls.Vp)


@pytest.mark.parametrize("kind", sorted(TIE_WALKS))
def test_mixed_near_tie_case_plain(kind):
    """The mixed near-tie instance: a unary-only variable and a column
    without slots beside c, whose binary slots follow a unary one."""
    pm = check_tie_case(kind, mixed=True)[0]
    deg = pm.pls.pg.col_deg
    assert int(deg.min()) == 0 and 1 in deg.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TIE_WALKS))
def test_mixed_near_tie_kernel_matches_plain_on_gpu(kind):
    """chip_smoke.mgm2_tie_case on the mixed layout, on the card: the
    kernel equals the plain version and the exact rule's x, at the
    wrapper's grid and at 1 and 3 blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke as C

    pm, x, u, threshold, want = C.mgm2_tie_case(kind, True, "cuda")
    for favor in M.FAVORS:
        p = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
        assert P.unpack_x(pm.pls, p).tolist() == want, favor
        for blocks in (None, 1, 3):
            k = M._launch_cycles(pm, x, *u, threshold, favor, blocks)
            assert torch.equal(k, p), (favor, blocks)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed_hub", "quaternary", "ragged"])
def test_mixed_kernel_matches_plain_on_gpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    jt = jax_compile(INSTANCES[name]())
    t = tensors_from_numpy(numpy_fields(jt), device="cuda")
    pm = M.pack_mgm2_from_pls(P.pack_local_search(t))
    x = P.pack_x(pm.pls, torch.as_tensor(random_x(t, 1), device="cuda"))
    rng = np.random.default_rng(2)
    u = [P.pack_uniforms(pm.pls, rng.uniform(0, 1, (20, t.n_vars)))
         for _ in range(3)]
    for favor in M.FAVORS:
        for threshold in (0.0, 0.5, 1.0):
            before = M.packed_mgm2_cycles.mixed_launches
            k = M.packed_mgm2_cycles(pm, x, *u, threshold, favor)
            assert M.packed_mgm2_cycles.mixed_launches == before + 1
            p = M.packed_mgm2_cycles_plain(pm, x, *u, threshold, favor)
            assert torch.equal(k, p), (favor, threshold)
            # forced grids of 1 and 3 blocks: the grid-stride loops
            for blocks in (1, 3):
                f = M._launch_cycles(pm, x, *u, threshold, favor, blocks)
                assert torch.equal(f, p), (favor, threshold, blocks)
    torch.cuda.synchronize()
