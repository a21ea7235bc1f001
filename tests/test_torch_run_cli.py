"""The port's resilience and control-plane commands on the CPU, held to
the JAX package's CLI (both run in process):

* ``checkpoint scrub [--fix]``: the same JSON, exit codes and quarantine
  renames as the JAX command on the same tree (after the JAX package's
  ``tests/cli/test_checkpoint_cli.py``);
* ``replica_dist``: the same YAML as the JAX command;
* ``run``: the JAX command's end-metrics keys; with every phase's cycles
  fixed in the test (the orchestrator's ``run(cycles=)``), the command
  equals the library orchestrator; ``--replica_dist``, ``--fault-plan``
  and ``--checkpoint``/``--resume``; ``-m process`` raises the port's
  ``NotPortedError`` JSON;
* ``solve --checkpoint/--checkpoint-every/--resume/--fault-plan`` equal a
  straight solve; ``--uiport`` serves and stops; the elastic flags and
  the device fault kinds raise ``NotPortedError``'s JSON error.
"""
import json
import os
import socket
import time

import numpy as np
import pytest

from pydcop_tpu import cli as jax_cli
from pydcop_tpu.runtime.checkpoint import write_state_npz as jax_write
from pydcop_tpu.runtime.faults import corrupt_checkpoint as jax_corrupt
from pydcop_tpu_torch import cli
from pydcop_tpu_torch.runtime.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")


def _out(capsys):
    return json.loads(capsys.readouterr().out)


@pytest.fixture
def phase_cycles(monkeypatch):
    """``phase_cycles(n)`` fixes every solving phase of the ``run``
    command at ``n`` cycles, through the orchestrator's ``run(cycles=)``:
    a scenario delay otherwise converts to cycles at the measured rate,
    and no two runs would share their cycles."""
    from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator

    real = VirtualOrchestrator.run

    def fix(n):
        monkeypatch.setattr(
            VirtualOrchestrator, "run",
            lambda self, scenario=None, timeout=None, cycles=None:
            real(self, scenario, timeout=timeout, cycles=n))

    return fix


def _make_tree(root):
    """The JAX CLI test's tree: a good snapshot, a corrupt one, a journal
    with a torn tail and one with a bad line in its body."""
    sub = os.path.join(root, "replica-0")
    os.makedirs(sub)
    jax_write(os.path.join(root, "ck_00000001.npz"), {"a": np.arange(8)},
              {"kind": "solver"})
    jax_write(os.path.join(sub, "ck_00000002.npz"), {"a": np.arange(8)},
              {"kind": "solver"})
    jax_corrupt(os.path.join(sub, "ck_00000002.npz"), seed=1)
    with open(os.path.join(root, "journal.jsonl"), "w") as f:
        f.write('{"kind": "job"}\n{"kind": "done"}\ntorn-tail')
    with open(os.path.join(sub, "bad.jsonl"), "w") as f:
        f.write('{"kind": "job"}\nGARBAGE\n{"kind": "done"}\n')


# ---------------------------------------------------------------------------
# checkpoint scrub
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree,fix,rc", [
    ("clean", False, 0), ("damaged", False, 1), ("damaged", True, 0),
    ("missing", False, 1)])
def test_scrub_equals_jax(tree, fix, rc, tmp_path, capsys):
    outs = []
    for pkg, main in (("port", cli.main), ("jax", jax_cli.main)):
        root = str(tmp_path / pkg)
        if tree == "clean":
            os.makedirs(root)
            jax_write(os.path.join(root, "ck_00000001.npz"),
                      {"a": np.arange(4)}, {"kind": "solver"})
        elif tree == "damaged":
            os.makedirs(root)
            _make_tree(root)
        else:
            root = str(tmp_path / "nope")
        got_rc = main(["checkpoint", "scrub", root]
                      + (["--fix"] if fix else []))
        out = _out(capsys)
        assert got_rc == rc
        if "error" in out:
            out["error"] = out["error"].replace(root, "ROOT")
        for c in out.get("corrupt", []):
            c["problems"] = [p.replace(root, "ROOT").split(": ")[0]
                             for p in c["problems"]]
        outs.append((out, sorted(
            os.path.relpath(os.path.join(d, n), root)
            for d, _, names in os.walk(root) for n in names)))
    assert outs[0] == outs[1]


def test_scrub_after_fix_is_clean(tmp_path, capsys):
    _make_tree(str(tmp_path))
    assert cli.main(["checkpoint", "scrub", str(tmp_path), "--fix"]) == 0
    out = _out(capsys)
    assert out["status"] == "OK" and len(out["quarantined"]) == 2
    assert out["torn_tails_tolerated"] == 1
    assert cli.main(["checkpoint", "scrub", str(tmp_path)]) == 0
    assert _out(capsys)["corrupt"] == []
    sub = str(tmp_path / "replica-0")
    assert CheckpointManager(sub).latest_valid_state() is None
    assert CheckpointManager(str(tmp_path)).latest_valid_state()[0] == 1


# ---------------------------------------------------------------------------
# replica_dist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo,k,dist", [("mgm", 2, "adhoc"),
                                         ("maxsum", 1, "adhoc"),
                                         ("maxsum", 3, "oneagent")])
def test_replica_dist_equals_jax(algo, k, dist, tmp_path, capsys):
    texts = []
    for pkg, main in (("port", cli.main), ("jax", jax_cli.main)):
        path = str(tmp_path / f"{pkg}.yaml")
        rc = main(["-o", path, "replica_dist", "-a", algo, "-d", dist,
                   "-k", str(k), TUTO])
        if rc == 0:
            with open(path) as f:
                texts.append(f.read())
        else:
            texts.append(rc)
        capsys.readouterr()
    assert texts[0] == texts[1]


def test_replica_dist_unported_strategy(capsys):
    assert cli.main(["replica_dist", "-a", "mgm", "-d", "ilp_fgdp", "-k",
                     "2", TUTO]) == 1
    out = _out(capsys)
    assert "ilp_fgdp" in out["error"] and "not ported" in out["error"]


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------


SCENARIO = """events:
  - id: w1
    delay: {d}
  - id: e1
    actions:
      - type: remove_agent
        agent: a1
  - id: w2
    delay: {d}
"""


def _scenario(tmp_path, delay):
    path = tmp_path / f"scenario_{delay}.yaml"
    path.write_text(SCENARIO.format(d=delay))
    return str(path)


def test_run_flags_are_jax_s_and_device():
    """The port's ``run`` takes the JAX command's flags and ``--device``,
    no more: a phase's cycles are the library's ``run(cycles=)``."""
    import argparse

    from pydcop_tpu.commands import run as jax_run
    from pydcop_tpu_torch.commands import run as port_run

    def flags(mod):
        parser = mod.set_parser(argparse.ArgumentParser().add_subparsers())
        return {o for a in parser._actions for o in a.option_strings}

    assert flags(port_run) == flags(jax_run) | {"--device"}


def test_run_keys_equal_jax(tmp_path, capsys):
    """The JAX command's phases are delay-driven (no two runs share their
    cycles): the port's end metrics have its keys and its placements."""
    scen = _scenario(tmp_path, 0.1)
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        assert main(["run", "-a", "mgm", "-d", "adhoc", "-s", scen,
                     "--ktarget", "2", *extra, TUTO]) == 0
        outs.append(_out(capsys))
    port, ref = outs
    assert set(port) == set(ref)
    for k in ("distribution", "replicas", "events", "resilience",
              "status"):
        assert port[k] == ref[k], k


def test_run_cycles_equal_the_orchestrator(tmp_path, capsys, phase_cycles):
    from pydcop_tpu_torch.dcop import load_dcop_from_file, \
        load_scenario_from_file
    from pydcop_tpu_torch.runtime.orchestrator import VirtualOrchestrator

    scen = _scenario(tmp_path, 600)
    phase_cycles(7)
    assert cli.main(["run", "-a", "dsa", "-d", "adhoc", "-s", scen,
                     "--ktarget", "2", "--device", "cpu", TUTO]) == 0
    out = _out(capsys)
    orch = VirtualOrchestrator(load_dcop_from_file(TUTO), "dsa",
                               distribution="adhoc", device="cpu")
    orch.deploy_computations()
    orch.start_replication(2)
    res = orch.run(load_scenario_from_file(scen), cycles=7)
    m = orch.end_metrics()
    assert out["cycle"] == res.cycle == 21
    assert out["assignment"] == res.assignment and out["cost"] == res.cost
    assert out["distribution"] == m["distribution"]
    assert out["events"] == m["events"]


def test_run_replica_dist_file(tmp_path, capsys, phase_cycles):
    rd = str(tmp_path / "rd.yaml")
    assert cli.main(["-o", rd, "replica_dist", "-a", "mgm", "-d", "adhoc",
                     "-k", "2", TUTO]) == 0
    capsys.readouterr()
    scen = _scenario(tmp_path, 600)
    phase_cycles(5)
    assert cli.main(["run", "-a", "mgm", "-d", "adhoc", "-s", scen,
                     "--replica_dist", rd, "--device", "cpu", TUTO]) == 0
    out = _out(capsys)
    from pydcop_tpu_torch.replication.yamlformat import \
        load_replica_dist_from_file

    assert out["replicas"] == load_replica_dist_from_file(rd).mapping()


def test_run_fault_plan_and_checkpoints(tmp_path, capsys, phase_cycles):
    plan = tmp_path / "plan.yaml"
    plan.write_text("seed: 2\nfaults:\n  - kind: kill_agent\n"
                    "    agent: a2\n    cycle: 4\n")
    scen = tmp_path / "empty.yaml"
    scen.write_text("events: []\n")
    d = str(tmp_path / "ck")
    phase_cycles(10)
    args = ["run", "-a", "maxsum", "-d", "adhoc", "-s", str(scen),
            "--ktarget", "2", "--device", "cpu", "--fault-plan", str(plan), "--checkpoint", d,
            "--checkpoint-every", "5", TUTO]
    assert cli.main(args) == 0
    out = _out(capsys)
    assert out["resilience"]["faults_injected"] == 1
    assert out["resilience"]["repairs"] == 1
    # phases 4 (the kill), 5, 1: a snapshot once 5 cycles passed (at 9)
    # and the final one
    assert out["resilience"]["checkpoints_saved"] == 2
    assert "a2" not in out["distribution"]
    assert [c for c, _ in CheckpointManager(d).snapshots()] == [10, 9]
    assert cli.main(args[:-1] + ["--resume", TUTO]) == 0
    out = _out(capsys)
    assert out["resilience"]["resumes"] == 1 and out["cycle"] == 20


@pytest.mark.parametrize("flags,what", [
    (["-m", "process"], "process"),
    (["-d", "heur_comhost"], "heur_comhost"),
])
def test_run_unported_refused(flags, what, tmp_path, capsys):
    scen = _scenario(tmp_path, 600)
    rc = cli.main(["run", "-a", "mgm", "-s", scen, "--device", "cpu",
                   *flags, TUTO])
    out = _out(capsys)
    assert rc == 1 and out["status"] == "ERROR"
    assert what in out["error"] and "not ported" in out["error"]


def test_run_unknown_replication_method(tmp_path, capsys):
    scen = _scenario(tmp_path, 600)
    assert cli.main(["run", "-a", "mgm", "-s", scen, "--device", "cpu",
                     "--replication_method", "other", TUTO]) == 1
    assert "replication method" in _out(capsys)["error"]


# ---------------------------------------------------------------------------
# solve's resilience flags
# ---------------------------------------------------------------------------


def test_solve_checkpoint_then_resume(tmp_path, capsys):
    d = str(tmp_path)
    base = ["solve", "-a", "dsa", "--device", "cpu", TUTO]
    assert cli.main(base[:-1] + ["--cycles", "10", "--checkpoint", d,
                                 "--checkpoint-every", "4", TUTO]) == 0
    assert _out(capsys)["cycle"] == 10
    assert CheckpointManager(d).latest()[0] == 10
    assert cli.main(base[:-1] + ["--cycles", "20", "--checkpoint", d,
                                 "--checkpoint-every", "4", "--resume",
                                 TUTO]) == 0
    resumed = _out(capsys)
    assert cli.main(base[:-1] + ["--cycles", "20", TUTO]) == 0
    straight = _out(capsys)
    assert resumed["cycle"] == 20
    assert resumed["assignment"] == straight["assignment"]


def test_solve_fault_plan_damages_before_resume(tmp_path, capsys):
    d = str(tmp_path / "ck")
    plan = tmp_path / "plan.yaml"
    plan.write_text("faults:\n  - kind: corrupt_checkpoint\n")
    base = ["solve", "-a", "mgm", "--device", "cpu", "--checkpoint", d,
            "--checkpoint-every", "5"]
    assert cli.main(base + ["--cycles", "15", TUTO]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--cycles", "20", "--resume", "--fault-plan",
                            str(plan), TUTO]) == 0
    assert _out(capsys)["cycle"] == 20
    assert [c for c, _ in CheckpointManager(d).snapshots()] == [20, 15, 10]


@pytest.mark.parametrize("flags", [
    ["--elastic"], ["--elastic-chunk", "4"], ["--scrub-every", "2"],
    ["--elastic-min-devices", "3"]], ids=lambda f: f[0])
def test_solve_elastic_flags_not_ported(flags, capsys):
    rc = cli.main(["solve", "-a", "mgm", "--device", "cpu", *flags, TUTO])
    out = _out(capsys)
    assert rc == 1 and "not ported" in out["error"]
    assert flags[0] in out["error"]


def test_solve_device_fault_plan_not_ported(tmp_path, capsys):
    plan = tmp_path / "plan.yaml"
    plan.write_text("faults:\n  - kind: kill_device\n    device: 1\n")
    rc = cli.main(["solve", "-a", "maxsum", "--device", "cpu",
                   "--fault-plan", str(plan), TUTO])
    out = _out(capsys)
    assert rc == 1 and "kill_device" in out["error"]
    assert "not ported" in out["error"]


def test_solve_uiport_serves_and_stops(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert cli.main(["solve", "-a", "mgm", "--device", "cpu", "--cycles",
                     "5", "--uiport", str(port), TUTO]) == 0
    assert _out(capsys)["cycle"] == 5
    # both listeners are closed again (the ws accept loop wakes every
    # 0.5 s to see it stopped)
    for p in (port, port + 1):
        deadline = time.time() + 5
        while True:
            with socket.socket() as s:
                s.settimeout(2)
                if s.connect_ex(("127.0.0.1", p)) != 0:
                    break
            assert time.time() < deadline, p
            time.sleep(0.1)


def test_run_uiport_serves_the_orchestrator(tmp_path, capsys, phase_cycles):
    """``run --uiport``: the UI server sees the orchestrator's run (its
    cycle events) and stops with the command; the bus is restored."""
    from pydcop_tpu_torch.runtime import ui as ui_mod
    from pydcop_tpu_torch.runtime.events import event_bus

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen, real = [], ui_mod.UiServer

    class Recording(real):
        def _cb_cycle(self, topic, evt):
            seen.append(evt)
            super()._cb_cycle(topic, evt)

    ui_mod.UiServer = Recording
    was = event_bus.enabled
    phase_cycles(4)
    try:
        assert cli.main(["run", "-a", "mgm", "-d", "adhoc", "-s",
                         _scenario(tmp_path, 600), "--ktarget", "2",
                         "--device", "cpu", "--uiport", str(port),
                         TUTO]) == 0
    finally:
        ui_mod.UiServer = real
    assert _out(capsys)["cycle"] == 12
    assert seen == [4, 8, 12]
    assert event_bus.enabled == was
