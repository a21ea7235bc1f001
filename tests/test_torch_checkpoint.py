"""The solver checkpoints of the port (``pydcop_tpu_torch/runtime/
checkpoint.py``: ``save_checkpoint``, ``load_checkpoint``,
``CheckpointManager``; ``runtime/faults.py::apply_checkpoint_faults``;
``runtime/run.py``'s ``checkpoint_dir``/``resume``/``fault_plan``) on the
CPU, held to the JAX package's ``runtime/checkpoint.py`` and
``runtime/faults.py``:

* a port-written checkpoint round-trips: a fresh solver restored from it
  continues exactly as the solver that wrote it, for every algorithm with
  a state (the coin generator continues, it does not replay the seed);
* a checkpointed and resumed ``solve_result`` equals its straight run for
  maxsum, mgm and dsa on the six instances;
* a JAX-written maxsum or mgm checkpoint (the JAX package's generic
  engine) restores into the port's generic engine and continues to the
  JAX package's own continued run (maxsum beliefs within ``atol=1e-4``,
  the assignment exactly); into the packed engine it is refused, naming
  the engine; a JAX-written dsa checkpoint (its PRNG key) is refused
  before any state is touched;
* corrupt and truncated files are rejected before any state is touched
  (the behaviour the JAX package's
  ``TestSolverCheckpointHardening::test_corrupt_solver_checkpoint_rejected``
  states, at its seeds and others);
* the manager's rotation and skip-the-damaged walk, and
  ``apply_checkpoint_faults``, equal the JAX package's on twin
  directories, byte for byte;
* the warm solver's schema-v3 headroom metadata and the frontier
  search's state dict checkpoint through the same surface, the search
  with its host stash and best bound (a resume from a snapshot taken
  mid-spill ends at the straight run's proof);
* ``FaultCounters`` has the JAX package's names.
"""
import os

import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms import AlgorithmDef as JaxAlgorithmDef
from pydcop_tpu.algorithms import load_algorithm_module as jax_algo_module
from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.runtime import checkpoint as jax_ckpt
from pydcop_tpu.runtime import faults as jax_faults
from pydcop_tpu.runtime import stats as jax_stats
from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import checkpoint as ckpt
from pydcop_tpu_torch.runtime import faults
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime.stats import RESILIENCE_COUNTERS, FaultCounters

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]
#: every algorithm whose solver keeps a state between runs
STATEFUL = ["maxsum", "amaxsum", "maxsum_dynamic", "mgm", "mgm2", "dsa",
            "dsatuto", "mixeddsa", "adsa", "dba", "gdba"]
#: the meta keys of a solver checkpoint (the JAX package's)
META_KEYS = {"kind", "algo", "params", "seed", "precision", "n_leaves",
             "extra", "cycle", "version", "crc"}


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _params(algo):
    return {"noise": 0.0} if "maxsum" in algo else {}


def _port(algo, name, seed=0, **kw):
    dcop = load_dcop_from_file(_path(name))
    algo_def = AlgorithmDef.build_with_default_params(
        algo, _params(algo), mode=dcop.objective)
    return load_algorithm_module(algo).build_solver(
        dcop, None, algo_def, seed=seed, device="cpu", **kw)


def _jax(algo, name, seed=0):
    dcop = jax_load_dcop(_path(name))
    algo_def = JaxAlgorithmDef.build_with_default_params(
        algo, _params(algo), mode=dcop.objective)
    return jax_algo_module(algo).build_solver(dcop, None, algo_def,
                                              seed=seed)


def _leaves(solver):
    return [t.cpu() for t in ckpt.flatten_state(solver._last_state)]


def _same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the port's own round trip
# ---------------------------------------------------------------------------


def test_fault_counters_have_the_jax_names():
    assert RESILIENCE_COUNTERS == jax_stats.RESILIENCE_COUNTERS
    got, ref = FaultCounters(), jax_stats.FaultCounters()
    for c in (got, ref):
        c.inc("repairs")
        c.inc("checkpoints_saved", 3)
    assert got.as_dict() == ref.as_dict()
    assert got.any_faults and not FaultCounters().any_faults
    with pytest.raises(KeyError, match="RESILIENCE_COUNTERS"):
        got.inc("no_such_counter")


@pytest.mark.parametrize("algo", STATEFUL)
def test_round_trip_continues_exactly(algo, tmp_path):
    """Restored into a fresh solver, the state and the coin stream go on
    exactly as in the solver that wrote the file."""
    s1 = _port(algo, "graph_coloring_tuto")
    s1.run(cycles=6)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, s1, extra={"note": "t"}, cycle=6)
    s2 = _port(algo, "graph_coloring_tuto")
    meta = ckpt.load_checkpoint(path, s2)
    assert META_KEYS <= set(meta)
    assert meta["algo"] == s1.algo_def.algo and meta["cycle"] == 6
    assert meta["extra"] == {"note": "t",
                             "engine": ckpt.state_engine(s1)}
    _same_state(s1, s2)
    r1 = s1.run(cycles=5, resume=True)
    r2 = s2.run(cycles=5, resume=True)
    assert r1.assignment == r2.assignment and r1.cost == r2.cost
    _same_state(s1, s2)


def test_meta_keys_equal_jax(tmp_path):
    port, jax_ = _port("maxsum", "graph_coloring_tuto"), \
        _jax("maxsum", "graph_coloring_tuto")
    port.run(cycles=3)
    jax_.run(cycles=3)
    a, b = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    ckpt.save_checkpoint(a, port, cycle=3)
    jax_ckpt.save_checkpoint(b, jax_, cycle=3)
    pm, _ = ckpt.read_state_npz(a)
    jm, _ = jax_ckpt.read_state_npz(b)
    assert set(pm) == set(jm)
    for k in ("kind", "algo", "params", "seed", "precision", "n_leaves",
              "cycle", "version"):
        assert pm[k] == jm[k], k


def test_generator_continues_the_stream(tmp_path):
    """A restored dsa solver's generator is the writer's (its state in
    ``generator_0``); a resumed run advances it, it is not reseeded."""
    s1 = _port("dsa", "graph_coloring_tuto")
    s1.run(cycles=5)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, s1)
    _, arrays = ckpt.read_state_npz(path)
    assert ckpt.GENERATOR_KEY in arrays
    s2 = _port("dsa", "graph_coloring_tuto")
    ckpt.load_checkpoint(path, s2)
    assert torch.equal(s2.coins.get_state(), s1.coins.get_state())
    s2.run(cycles=5, resume=True)
    assert not torch.equal(s2.coins.get_state(), s1.coins.get_state())
    fresh = _port("dsa", "graph_coloring_tuto")
    fresh.run(cycles=5)
    assert torch.equal(fresh.coins.get_state(), s1.coins.get_state())


def test_no_state_yet_refused(tmp_path):
    with pytest.raises(ValueError, match="no state"):
        ckpt.save_checkpoint(str(tmp_path / "x.npz"),
                             _port("mgm", "graph_coloring_tuto"))


def test_other_problem_refused(tmp_path):
    s = _port("maxsum", "graph_coloring_tuto")
    s.run(cycles=2)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, s)
    other = _port("maxsum", "coloring_csp")
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, other)
    assert other._last_state is None


def test_other_engine_refused(tmp_path):
    """The packed engine's leaves restore into no generic solver (and
    back), even where the shapes agree."""
    packed = _port("maxsum", "graph_coloring_tuto")
    assert ckpt.state_engine(packed) == "packed"
    packed.run(cycles=3)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, packed)
    generic = _port("maxsum", "graph_coloring_tuto", use_packed=False)
    with pytest.raises(ValueError, match="'packed' engine.*'generic'"):
        ckpt.load_checkpoint(path, generic)
    assert generic._last_state is None


# ---------------------------------------------------------------------------
# resume equals straight, through solve_result
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["maxsum", "mgm", "dsa"])
@pytest.mark.parametrize("name", NAMES)
def test_resume_equals_straight(algo, name, tmp_path):
    """20 cycles with a snapshot every 7, a new process's resume to 40:
    the same state and result as one straight 40-cycle run, and as the
    same checkpointed run uninterrupted."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(algo_params=_params(algo), device="cpu")
    straight = solve_result(load_dcop_from_file(_path(name)), algo,
                            cycles=40, **kw)
    whole = solve_result(load_dcop_from_file(_path(name)), algo,
                         cycles=40, checkpoint_dir=d2, checkpoint_every=7,
                         **kw)
    solve_result(load_dcop_from_file(_path(name)), algo, cycles=20,
                 checkpoint_dir=d1, checkpoint_every=7, **kw)
    resumed = solve_result(load_dcop_from_file(_path(name)), algo,
                           cycles=40, checkpoint_dir=d1,
                           checkpoint_every=7, resume=True, **kw)
    assert resumed.cycle == whole.cycle == 40
    for r in (whole, straight):
        assert resumed.assignment == r.assignment
        assert resumed.cost == r.cost
    assert [c for c, _ in ckpt.CheckpointManager(d1).snapshots()] == \
        [40, 34, 27]
    m1, a1 = ckpt.read_state_npz(ckpt.CheckpointManager(d1).latest()[1])
    m2, a2 = ckpt.read_state_npz(ckpt.CheckpointManager(d2).latest()[1])
    assert m1["crc"] == m2["crc"]


def test_resume_past_the_budget_runs_one_cycle(tmp_path):
    d = str(tmp_path)
    kw = dict(device="cpu", checkpoint_dir=d, checkpoint_every=5)
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    solve_result(dcop, "mgm", cycles=10, **kw)
    res = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                       "mgm", cycles=10, resume=True, **kw)
    assert res.cycle == 11
    assert ckpt.CheckpointManager(d).latest()[0] == 11


# ---------------------------------------------------------------------------
# JAX-written checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["maxsum", "mgm"])
@pytest.mark.parametrize("name", NAMES)
def test_jax_checkpoint_continues_to_jax_result(algo, name, tmp_path):
    """The JAX package's generic engine writes; the port's generic engine
    restores and continues, to the JAX package's continued run."""
    js = _jax(algo, name)
    js.run(cycles=5)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, js, cycle=5)
    ref = js.run(cycles=5, resume=True)
    port = _port(algo, name, use_packed=False)
    meta = ckpt.load_checkpoint(path, port)
    assert meta["cycle"] == 5
    got = port.run(cycles=5, resume=True)
    assert got.assignment == ref.assignment
    import jax

    for a, b in zip(jax.tree.leaves(js._last_state), _leaves(port)):
        a = np.asarray(a)
        if algo == "maxsum" and a.dtype.kind == "f":
            np.testing.assert_allclose(b.numpy(), a, atol=1e-4)
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def test_jax_checkpoint_refused_by_the_packed_engine(tmp_path):
    js = _jax("maxsum", "graph_coloring_tuto")
    js.run(cycles=3)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, js)
    port = _port("maxsum", "graph_coloring_tuto")
    with pytest.raises(ValueError, match="JAX package.*'packed' engine"):
        ckpt.load_checkpoint(path, port)
    assert port._last_state is None


@pytest.mark.parametrize("algo", ["dsa", "adsa", "mgm2"])
def test_jax_checkpoint_of_a_coin_drawer_refused(algo, tmp_path):
    js = _jax(algo, "graph_coloring_tuto")
    js.run(cycles=3)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, js)
    _, arrays = jax_ckpt.read_state_npz(path)
    assert ckpt.JAX_KEY in arrays
    port = _port(algo, "graph_coloring_tuto", use_packed=False)
    state = port.coins.get_state()
    with pytest.raises(ValueError, match="__prng_key__"):
        ckpt.load_checkpoint(path, port)
    assert port._last_state is None
    assert torch.equal(port.coins.get_state(), state)


def test_port_container_reads_in_jax(tmp_path):
    s = _port("dsa", "graph_coloring_tuto")
    s.run(cycles=3)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save_solver(s, 3)
    got = jax_ckpt.CheckpointManager(str(tmp_path)).latest_valid_state()
    assert got is not None and got[0] == 3
    _, _, arrays = got
    assert set(arrays) == {"leaf_0", ckpt.GENERATOR_KEY}


# ---------------------------------------------------------------------------
# damaged files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2, 5, 11, 23])
def test_corrupt_solver_checkpoint_rejected(seed, tmp_path):
    """A deliberately damaged checkpoint is rejected with a clear
    ValueError, never loaded (the JAX test's stated behaviour)."""
    solver = _port("maxsum", "graph_coloring_tuto")
    solver.run(cycles=4)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, solver)
    faults.corrupt_checkpoint(path, seed=seed)
    fresh = _port("maxsum", "graph_coloring_tuto")
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(path, fresh)
    assert fresh._last_state is None


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_truncated_solver_checkpoint_rejected(seed, tmp_path):
    solver = _port("dsa", "graph_coloring_tuto")
    solver.run(cycles=4)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, solver)
    faults.corrupt_checkpoint(path, seed=seed, mode="truncate")
    fresh = _port("dsa", "graph_coloring_tuto")
    state = fresh.coins.get_state()
    with pytest.raises(ValueError, match="unreadable or truncated"):
        ckpt.load_checkpoint(path, fresh)
    assert fresh._last_state is None
    assert torch.equal(fresh.coins.get_state(), state)


def test_every_damaged_container_is_a_refusal(tmp_path):
    """Over 300 seeded damages of one container, the port's reader
    refuses every damaged file with ValueError; the JAX package's lets
    some escape as NotImplementedError (a flipped byte read as an
    unsupported zip version, ROADMAP C-f3), which its manager's resume
    walk does not skip."""
    escaped = []
    for seed in range(300):
        path = str(tmp_path / f"c{seed}.npz")
        ckpt.write_state_npz(path, {
            "leaf_0": np.arange(300, dtype=np.float32),
            "leaf_1": np.arange(30)}, {"kind": "solver"})
        faults.corrupt_checkpoint(path, seed=seed)
        with pytest.raises(ValueError):
            ckpt.read_state_npz(path)
        try:
            jax_ckpt.read_state_npz(path)
        except ValueError:
            pass
        except Exception:  # noqa: BLE001 — the JAX fault under record
            escaped.append(seed)
            mgr = ckpt.CheckpointManager(str(tmp_path / f"d{seed}"))
            good = mgr.save_state(5, {"leaf_0": np.ones(3)}, {"kind": "t"})
            os.replace(path, mgr.path_for(10))
            assert mgr.latest_valid_state()[0] == 5
            assert os.path.exists(good)
        os.path.exists(path) and os.unlink(path)
    assert escaped  # the JAX reader's escapes exist at these seeds


def _twin_dirs(tmp_path, n=3):
    """The same snapshots written by the port's and the JAX package's
    managers (raw state, one leaf each)."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    for cycle in range(5, 5 * (n + 1), 5):
        arrays = {"leaf_0": np.arange(256, dtype=np.float32) * cycle}
        ckpt.CheckpointManager(a, keep=n).save_state(cycle, arrays,
                                                     {"kind": "t"})
        jax_ckpt.CheckpointManager(b, keep=n).save_state(cycle, arrays,
                                                         {"kind": "t"})
    return a, b


def test_manager_rotation_equals_jax(tmp_path):
    a, b = str(tmp_path / "p"), str(tmp_path / "j")
    for cycle in (5, 10, 15, 20):
        for mgr in (ckpt.CheckpointManager(a, keep=2),
                    jax_ckpt.CheckpointManager(b, keep=2)):
            mgr.save_state(cycle, {"leaf_0": np.full(3, cycle)},
                           {"kind": "t"})
    assert [c for c, _ in ckpt.CheckpointManager(a).snapshots()] == \
        [c for c, _ in jax_ckpt.CheckpointManager(b).snapshots()] == [20, 15]


@pytest.mark.parametrize("kind", ["corrupt_checkpoint",
                                  "truncate_checkpoint"])
def test_apply_checkpoint_faults_equals_jax(kind, tmp_path):
    """The newest snapshot is damaged identically (same bytes after) and
    both managers fall back to the one before."""
    a, b = _twin_dirs(tmp_path)
    plan = faults.FaultPlan(faults=[faults.Fault(kind=kind)], seed=4)
    jplan = jax_faults.FaultPlan(faults=[jax_faults.Fault(kind=kind)],
                                 seed=4)
    got = faults.apply_checkpoint_faults(plan, a, attempt=0)
    ref = jax_faults.apply_checkpoint_faults(jplan, b, attempt=0)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] == ["ck_00000015.npz"]
    with open(got[0], "rb") as f1, open(ref[0], "rb") as f2:
        damaged = f1.read()
        assert len(damaged) == len(f2.read())
    assert ckpt.CheckpointManager(a).latest_valid_state()[0] == 10
    assert jax_ckpt.CheckpointManager(b).latest_valid_state()[0] == 10


def test_apply_checkpoint_faults_targets(tmp_path):
    a, _ = _twin_dirs(tmp_path)
    explicit = os.path.join(a, "ck_00000005.npz")
    plan = faults.FaultPlan(faults=[
        faults.Fault(kind="corrupt_checkpoint", path=explicit),
        faults.Fault(kind="truncate_checkpoint", attempt=1),
        faults.Fault(kind="corrupt_checkpoint", path=explicit,
                     attempt=None),
    ])
    # attempt 0 (the default): the explicit path, twice; attempt 1: the
    # newest snapshot of the directory (none without one) and the
    # every-attempt fault
    assert faults.apply_checkpoint_faults(plan, a, attempt=0) == \
        [explicit, explicit]
    assert faults.apply_checkpoint_faults(plan, None, attempt=1) == \
        [explicit]
    assert faults.apply_checkpoint_faults(plan, a, attempt=1) == \
        [os.path.join(a, "ck_00000015.npz"), explicit]
    assert faults.apply_checkpoint_faults(
        plan, str(tmp_path / "empty"), attempt=1) == [explicit]


def test_solve_resumes_before_a_damaged_snapshot(tmp_path):
    """solve_result's fault plan damages the newest snapshot before the
    resume: the run resumes from the one before and still ends at the
    straight run's state."""
    d = str(tmp_path)
    kw = dict(device="cpu", checkpoint_dir=d, checkpoint_every=5)
    solve_result(load_dcop_from_file(_path("graph_coloring_tuto")), "mgm",
                 cycles=15, **kw)
    plan = faults.FaultPlan(faults=[
        faults.Fault(kind="truncate_checkpoint")])
    res = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                       "mgm", cycles=20, resume=True, fault_plan=plan, **kw)
    straight = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                            "mgm", cycles=20, device="cpu")
    assert res.cycle == 20 and res.assignment == straight.assignment
    # 15 was damaged, 10 restored, 15 and 20 written again
    assert [c for c, _ in ckpt.CheckpointManager(d).snapshots()] == \
        [20, 15, 10]


# ---------------------------------------------------------------------------
# the warm solver (schema v3) and the frontier search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["maxsum", "mgm", "dsa"])
def test_warm_solver_restores_its_headroom_layout(algo, tmp_path):
    from pydcop_tpu_torch.runtime.repair import (
        WarmRepairController,
        perturbed_constraint,
    )

    def controller():
        dcop = load_dcop_from_file(_path("coloring_csp"))
        return dcop, WarmRepairController(
            dcop, algo, AlgorithmDef.build_with_default_params(
                algo, _params(algo)),
            seed=3, headroom=1.0, min_free=8, chunk=8, device="cpu")

    dcop, ctl = controller()
    ctl.solver.run(chunk=8, cycles=8)
    name = sorted(dcop.constraints)[0]
    edit = perturbed_constraint(dcop.constraints[name], seed=1)
    ctl.edit_factor(edit)
    ctl.solver.run(chunk=8, cycles=8, resume=True)
    path = str(tmp_path / "warm.npz")
    ckpt.save_checkpoint(path, ctl.solver, cycle=16)
    meta, _ = ckpt.read_state_npz(path)
    assert meta["extra"]["engine"] == "warm"
    assert set(meta["headroom"]) == {"layout", "var_names",
                                     "domain_values", "factor_names"}
    _, ctl2 = controller()
    ckpt.load_checkpoint(path, ctl2.solver)
    assert ctl2.solver.layout.to_meta() == ctl.solver.layout.to_meta()
    for k in ctl.solver.operands:
        a, b = ctl.solver.operands[k], ctl2.solver.operands[k]
        for x, y in zip(ckpt.flatten_state(a), ckpt.flatten_state(b)):
            assert torch.equal(x, y), k
    # the operands stay the solver's own tensors (read in place)
    state_ids = {id(t) for t in ckpt.flatten_state(ctl2.solver._last_state)}
    assert {id(t) for t in ctl2.solver.resident_leaves()} <= state_ids
    # the edit rides in the operands; the second controller's DCOP
    # object (the host's record, which scores a result) never saw it
    r1 = ctl.solver.run(chunk=8, cycles=8, resume=True)
    r2 = ctl2.solver.run(chunk=8, cycles=8, resume=True)
    assert r1.assignment == r2.assignment
    _same_state(ctl.solver, ctl2.solver)


def test_frontier_search_checkpoints(tmp_path):
    """syncbb on the frontier engine: its state dict round-trips and a
    checkpointed run ends at the straight run's proof."""
    d = str(tmp_path)
    kw = dict(device="cpu", algo_params={"engine": "frontier"})
    straight = solve_result(load_dcop_from_file(_path("coloring_csp")),
                            "syncbb", **kw)
    res = solve_result(load_dcop_from_file(_path("coloring_csp")),
                       "syncbb", cycles=50, checkpoint_dir=d,
                       checkpoint_every=1, **kw)
    assert res.cost == straight.cost
    meta, arrays = ckpt.read_state_npz(ckpt.CheckpointManager(d).latest()[1])
    assert meta["extra"]["engine"] == "frontier"
    assert meta["n_leaves"] == len([k for k in arrays if k.startswith(
        "leaf_")]) > 1


def test_frontier_checkpoint_keeps_the_host_stash(tmp_path):
    """A snapshot taken while spilled rows wait in the host stash carries
    them and the best bound: restored into a fresh solver, the search
    goes on as the solver that wrote it does, node for node, and ends
    at the straight run's proof."""
    from test_torch_search import make_dcop, tdc

    from pydcop_tpu_torch.search.solver import FrontierSearchSolver

    dcop = make_dcop(tdc, "dense", 7, n=8, D=3)
    kw = dict(device="cpu", frontier_width=4, ring=4, steps=2, i_bound=1)
    straight = FrontierSearchSolver(dcop, **kw).run()
    first = FrontierSearchSolver(dcop, **kw)
    head = first.run(cycles=6)
    # more rows than one annex quantum: the stash outlives the run
    assert not head.search["optimal"]
    assert first._stash_rows() > first.engine.shape.A
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, first, cycle=6)
    fresh = FrontierSearchSolver(dcop, **kw)
    ckpt.load_checkpoint(path, fresh)
    assert fresh._stash_rows() == first._stash_rows()
    assert fresh._lb_best == first._lb_best
    tail = fresh.run(resume=True)
    on = first.run(resume=True)
    assert tail.cycle == on.cycle and tail.assignment == on.assignment
    for key in ("nodes", "leaves", "pruned", "lost_rows", "lower_bound",
                "spill_rows", "reinjected_rows", "optimal"):
        assert tail.search[key] == on.search[key], key
    assert straight.search["optimal"] and tail.search["optimal"]
    assert tail.cost == straight.cost
    assert tail.search["lower_bound"] == straight.search["lower_bound"]


def test_frontier_checkpoint_stash_of_another_width_refused(tmp_path):
    from test_torch_search import make_dcop, tdc

    from pydcop_tpu_torch.search.solver import FrontierSearchSolver

    kw = dict(device="cpu", frontier_width=4, ring=4, steps=2, i_bound=1)
    small = FrontierSearchSolver(make_dcop(tdc, "dense", 7, n=8), **kw)
    small.run(cycles=6)
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, small, cycle=6)
    meta, arrays = ckpt.read_state_npz(path)
    arrays["host_stash"] = arrays["host_stash"][:, 1:]
    ckpt.write_state_npz(path, arrays, {k: v for k, v in meta.items()
                                        if k not in ("crc", "version")})
    fresh = FrontierSearchSolver(make_dcop(tdc, "dense", 7, n=8), **kw)
    with pytest.raises(ValueError, match="stash"):
        ckpt.load_checkpoint(path, fresh)
    assert fresh._last_state is None and fresh._stash == []


# ---------------------------------------------------------------------------
# solve_result's resilience surface and its refusals
# ---------------------------------------------------------------------------


def test_placement_path_refuses_checkpoints(tmp_path):
    from pydcop_tpu_torch.distribution import Distribution

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    dist = Distribution({"a1": sorted(dcop.variables)
                         + sorted(dcop.constraints)})
    with pytest.raises(ValueError, match="placement"):
        solve_result(dcop, "maxsum", distribution=dist, device="cpu",
                     checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("kw", [
    {"elastic": {}},
    {"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="kill_device", device=0, cycle=3)])},
    {"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="shrink_mesh", devices=2)])},
    {"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="corrupt_slab", operand="q")])},
    {"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="kill_rank", rank=0, cycle=2)])},
], ids=["elastic", "kill_device", "shrink_mesh", "corrupt_slab",
        "kill_rank"])
def test_unported_resilience_refused(kw):
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    with pytest.raises(NotPortedError):
        solve_result(dcop, "maxsum", device="cpu", cycles=3, **kw)


@pytest.mark.parametrize("kw,match", [
    ({"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="kill_agent", agent="a1", cycle=2)])},
     "orchestrator"),
    ({"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="nan_lane")])}, "service"),
    ({"fault_plan": faults.FaultPlan(faults=[
        faults.Fault(kind="corrupt_checkpoint")])}, "resume=True"),
    ({"resume": True}, "checkpoint_dir"),
], ids=["churn", "serve", "no_resume", "resume_alone"])
def test_fault_plan_without_consumer_refused(kw, match):
    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    with pytest.raises(ValueError, match=match):
        solve_result(dcop, "mgm", device="cpu", cycles=3, **kw)
