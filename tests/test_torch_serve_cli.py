"""The port's ``serve`` command on the CPU, held to the JAX package's
``serve`` command: the same JSON keys (top level, per job and the
``serve`` section), the same seeded Poisson arrival trace, every job
equal to the port's standalone solve, the fleet flags taken (the fleets
are held to the JAX command in ``tests/test_torch_fleet_cli.py``), and
``--uiport`` serving the service's events to a ws client (the memo flags
are held to the JAX command in ``tests/test_torch_memo_cli.py``)."""
import json
import os
import subprocess
import sys

import pytest

from pydcop_tpu_torch import cli
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
FILES = [os.path.join(INSTANCES, n + ".yaml")
         for n in ("graph_coloring_tuto", "coloring_csp")]
ARGS = ["serve", "-a", "mgm", *FILES, "--jobs", "6", "--lanes", "2",
        "--arrival", "poisson", "--rate", "200", "--arrival-seed", "3"]


def _run(module, args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


@pytest.fixture(scope="module")
def outputs():
    return (_run("pydcop_tpu_torch", ARGS + ["--device", "cpu"]),
            _run("pydcop_tpu", ARGS))


def test_the_jax_commands_keys(outputs):
    mine, theirs = outputs
    assert set(mine) == set(theirs)
    assert mine["status"] == theirs["status"] == "FINISHED"
    assert sorted(mine["results"]) == sorted(theirs["results"])
    for jid in mine["results"]:
        assert set(mine["results"][jid]) == set(theirs["results"][jid]), jid
    # the port's serve section adds the bucket runners' calls
    assert set(mine["serve"]) == set(theirs["serve"]) | {"runners"}
    assert set(mine["serve"]["serve"]) == set(theirs["serve"]["serve"])
    assert mine["arrival"] == theirs["arrival"]
    assert mine["rejected"] == theirs["rejected"] == []


def test_every_job_equals_its_standalone_solve(outputs):
    mine, _ = outputs
    for jid, m in mine["results"].items():
        i = int(m["label"].rsplit(":", 1)[1])
        dcop = load_dcop_from_file(FILES[i % len(FILES)])
        spec = adapter_for("mgm").build_spec(BatchItem(dcop, "mgm", seed=i))
        seq = spec.solver.run(max_cycles=2000)
        assert (m["assignment"], m["cost"], m["cycle"], m["status"]) == \
            (seq.assignment, seq.cost, seq.cycle, seq.status), jid
        assert m["serve"]["jid"] == jid and m["resumed"] is False


@pytest.mark.parametrize("flags,what", [
    (["--uiport", "9000"], "--uiport"),
])
def test_unported_flags_are_refused(flags, what, capsys):
    """The UI tier's flag is ported now: ``serve --uiport`` serves the
    service's ``serve.*`` events over the ws protocol for its lifetime,
    and its jobs and JSON are those of a run without it."""
    import socket
    import threading

    from pydcop_tpu_torch.runtime import ui as ui_mod

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flags = [what, str(port)]
    pushed, started = [], threading.Event()
    real = ui_mod.UiServer

    class Recording(real):
        def start(self):
            super().start()
            started.set()

        def _family_cb(self, family):
            cb = super()._family_cb(family)

            def record(topic, evt):
                pushed.append((family, topic))
                cb(topic, evt)

            return record

    ui_mod.UiServer = Recording
    try:
        rc = cli.main(["serve", "-a", "mgm", FILES[0], "--device", "cpu",
                       "--jobs", "2", *flags])
    finally:
        ui_mod.UiServer = real
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["status"] == "FINISHED" and started.is_set()
    assert ("serve", "serve.job.done") in pushed
    assert cli.main(["serve", "-a", "mgm", FILES[0], "--device", "cpu",
                     "--jobs", "2"]) == 0
    plain = json.loads(capsys.readouterr().out)
    assert {j: m["assignment"] for j, m in out["results"].items()} == \
        {j: m["assignment"] for j, m in plain["results"].items()}


@pytest.mark.parametrize("flags", [["--replicas", "2"], ["--processes"]])
def test_fleet_flags_are_taken(flags, capsys):
    """``--replicas 2`` serves through a thread fleet (its ``fleet``
    section in place of ``serve``); ``--processes`` asks for a process
    fleet, which needs ``--journal-dir`` — a JSON error without it."""
    rc = cli.main(["serve", "-a", "mgm", FILES[0], "--device", "cpu",
                   "--jobs", "2", "--lanes", "2", *flags])
    out = json.loads(capsys.readouterr().out)
    if "--processes" in flags:
        assert rc == 1 and "--journal-dir" in out["error"]
        return
    assert rc == 0 and out["status"] == "FINISHED"
    assert "serve" not in out
    assert set(out["fleet"]["replicas"]) == {"replica-0", "replica-1"}
    assert all(m["serve"]["replica"].startswith("replica-")
               for m in out["results"].values())


def test_resume_needs_a_journal(capsys):
    rc = cli.main(["serve", "-a", "mgm", FILES[0], "--device", "cpu",
                   "--resume"])
    assert rc == 1
    assert "--journal-dir" in json.loads(capsys.readouterr().out)["error"]


def test_journal_prewarm_and_admission_control(tmp_path, capsys):
    jd = str(tmp_path / "j")
    rc = cli.main(["serve", "-a", "dsa", FILES[0], "--device", "cpu",
                   "--jobs", "3", "--lanes", "1", "--prewarm",
                   "--journal-dir", jd, "--max-pending", "2"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["serve"]["serve"]["prewarmed_runners"] == 1
    assert len(out["results"]) + len(out["rejected"]) == 3
    assert all(r["error"] == "overloaded" for r in out["rejected"])
    # a second session resumes nothing: every job registered done
    rc = cli.main(["serve", "-a", "dsa", "--device", "cpu", "--resume",
                   "--journal-dir", jd])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["resumed_jobs"] == 0


def test_a_bad_fault_plan_is_a_json_error(tmp_path, capsys):
    p = tmp_path / "plan.yaml"
    p.write_text("faults:\n  - kind: stall_tick\n")
    rc = cli.main(["serve", "-a", "mgm", FILES[0], "--device", "cpu",
                   "--fault-plan", str(p)])
    assert rc == 1
    assert "bad fault plan" in json.loads(capsys.readouterr().out)["error"]
