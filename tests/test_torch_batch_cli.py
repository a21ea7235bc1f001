"""The CLI surface of the port's batched engine on the CPU: ``solve
--batch`` and the ``batch`` sweep command (both engines, the ``JID:``
progress file and resume protocol, ``done_*``, ``--force``), after the
JAX package's ``tests/cli/test_batch_cli.py``.

The commands run in this process through ``pydcop_tpu_torch.cli.main``
(``--engine subprocess`` forks ``python -m pydcop_tpu_torch solve``).
Their JSON has the JAX package's structure; costs are held to the port's
own sequential solves (the JAX test's hard-coded tutorial cost is stale
on the reference itself).
"""
import json
import os

import pytest
import torch
import yaml

from pydcop_tpu.batch import BatchEngine as JaxBatchEngine
from pydcop_tpu.batch.cache import CompileCache as JaxCompileCache
from pydcop_tpu_torch.cli import main
from pydcop_tpu_torch.commands import batch as batch_cmd
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
CSP = os.path.join(INSTANCES, "coloring_csp.yaml")
INTENTION = os.path.join(INSTANCES, "coloring_intention.yaml")
#: a solve result's metrics keys, in the JAX package's batched results
RESULT_KEYS = {"status", "assignment", "cost", "violation", "cycle",
               "msg_count", "msg_size", "time"}


def run(capsys, *argv):
    rc = main(list(argv))
    return rc, capsys.readouterr()


def _seq_cost(path, algo, cycles, seed=0):
    return solve_result(load_dcop_from_file([path]), algo, cycles=cycles,
                        seed=seed, device="cpu").cost


def test_solve_batch_two_files(capsys):
    rc, out = run(capsys, "solve", "--batch", "-a", "mgm", "--cycles",
                  "20", "--device", "cpu", TUTO, CSP)
    assert rc == 0, out.err
    got = json.loads(out.out)
    assert set(got) == {"status", "results", "batch"}
    assert got["status"] == "FINISHED"
    for path in (TUTO, CSP):
        res = got["results"][path]
        assert set(res) == RESULT_KEYS
        assert res["cost"] == _seq_cost(path, "mgm", 20)
        assert res["cycle"] == 20
    want = set(JaxBatchEngine(cache=JaxCompileCache()).metrics())
    assert set(got["batch"]) == want | {"runners", "seconds"}
    assert set(got["batch"]["cache"]) == {"hits", "misses", "entries"}
    assert got["batch"]["buckets_formed"] >= 1
    assert got["batch"]["cache"]["misses"] >= 1


def test_solve_batch_algo_params_and_fallback(capsys):
    rc, out = run(capsys, "solve", "--batch", "-a", "dsa", "-p",
                  "variant:C", "--seed", "3", "--cycles", "12",
                  "--device", "cpu", CSP, INTENTION)
    assert rc == 0, out.err
    got = json.loads(out.out)
    for path in (CSP, INTENTION):
        want = solve_result(load_dcop_from_file([path]), "dsa", cycles=12,
                            seed=3, algo_params={"variant": "C"},
                            device="cpu")
        assert got["results"][path]["assignment"] == want.assignment
    rc, out = run(capsys, "solve", "--batch", "-a", "dpop", "--device",
                  "cpu", TUTO)
    got = json.loads(out.out)
    assert rc == 0 and got["results"][TUTO]["cost"] == 12
    assert got["batch"]["fallback_sequential"] == 1


@pytest.mark.parametrize("extra", [
    ["-d", "oneagent"], ["--run_metrics", "x.csv"], ["--anytime-exact"],
    ["--i-bound", "2"], ["--shard-overlap", "off"]])
def test_solve_batch_refuses_options_it_would_ignore(capsys, extra):
    rc, out = run(capsys, "solve", "--batch", "-a", "mgm", *extra,
                  "--device", "cpu", TUTO, CSP)
    assert rc != 0
    assert "batch" in json.loads(out.out)["error"]


def test_solve_batch_refuses_a_persistent_cache(capsys):
    rc, out = run(capsys, "solve", "--batch", "-a", "mgm",
                  "--compile-cache-dir", "/nonexistent", "--device", "cpu",
                  TUTO)
    assert rc == 1
    assert "not ported" in json.loads(out.out)["error"]


def test_solve_batch_bad_file_is_an_error_line(capsys, tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("not: [a, dcop")
    rc, out = run(capsys, "solve", "--batch", "-a", "mgm", "--cycles", "5",
                  "--device", "cpu", TUTO, str(bad))
    got = json.loads(out.out)
    assert rc == 1 and got["status"] == "ERROR"
    assert got["results"][str(bad)]["status"] == "ERROR"
    assert got["results"][TUTO]["status"] == "FINISHED"


# ---------------------------------------------------------------------------
# the batch command
# ---------------------------------------------------------------------------


def _definition(files=(TUTO, CSP, INTENTION), algos=("mgm", "dsa"),
                cycles=15, iterations=1):
    return {
        "sets": {"smoke": {"path": list(files), "iterations": iterations}},
        "batches": {"sweep": {"command": "solve", "command_options": {
            "algo": list(algos), "cycles": cycles}}},
    }


def _write(tmp_path, definition, name="smoke.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(definition))
    return str(path)


def _outputs(out_dir):
    return sorted(p for p in os.listdir(out_dir) if p.endswith(".json"))


def test_in_process_sweep_two_families(capsys, tmp_path):
    bdef = _write(tmp_path, _definition())
    out_dir = str(tmp_path / "out")
    rc, out = run(capsys, "batch", "--engine", "in-process", "--device",
                  "cpu", "--output_dir", out_dir, bdef)
    assert rc == 0, out.err
    assert "in-process engine solved 6 jobs" in out.out
    assert "batch: ran 6, skipped 0, failed 0" in out.out
    outputs = _outputs(out_dir)
    assert len(outputs) == 6
    for p in outputs:
        with open(os.path.join(out_dir, p)) as f:
            m = json.load(f)
        assert m["status"] == "FINISHED"
        assert m["batch_engine"] == "in-process"
        assert m["cycle"] == 15
        algo = "mgm" if "algomgm" in p else "dsa"
        path = next(f for f in (TUTO, CSP, INTENTION)
                    if os.path.basename(f) in p)
        assert m["cost"] == _seq_cost(path, algo, 15)
    done = [p for p in os.listdir(out_dir) if p.startswith("done_")]
    assert len(done) == 1
    with open(os.path.join(out_dir, done[0])) as f:
        assert len([ln for ln in f if ln.startswith("JID: ")]) == 6


def test_resume_skips_done_jobs_and_force_reruns(capsys, tmp_path):
    bdef = _write(tmp_path, _definition(algos=("mgm",)))
    out_dir = str(tmp_path / "out")
    run(capsys, "batch", "--engine", "in-process", "--device", "cpu",
        "--output_dir", out_dir, bdef)
    # completed (done_*): outputs are trusted, nothing re-runs
    rc, out = run(capsys, "batch", "--engine", "in-process", "--device",
                  "cpu", "--output_dir", out_dir, bdef)
    assert rc == 0 and "ran 0, skipped 3" in out.out
    rc, out = run(capsys, "batch", "--engine", "in-process", "--device",
                  "cpu", "--force", "--output_dir", out_dir, bdef)
    assert rc == 0 and "ran 3, skipped 0" in out.out


def test_progress_file_is_authoritative(capsys, tmp_path):
    """An interrupted sweep: jobs with a ``JID:`` line are skipped, an
    output without one (a killed job) is run again."""
    bdef = _write(tmp_path, _definition(algos=("mgm",)))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    jobs = list(batch_cmd._iter_jobs(_definition(algos=("mgm",)),
                                     str(out_dir)))
    assert batch_cmd.estimate_jobs(_definition(algos=("mgm",))) == 3
    (out_dir / "progress_smoke").write_text(
        f"smoke_x\nJID: {jobs[0][0]}\n")
    with open(jobs[1][1], "w") as f:
        f.write("{truncated")
    rc, out = run(capsys, "batch", "--engine", "in-process", "--device",
                  "cpu", "--output_dir", str(out_dir), bdef)
    assert rc == 0 and "ran 2, skipped 1" in out.out
    with open(jobs[1][1]) as f:
        assert json.load(f)["status"] == "FINISHED"


def test_simulate_prints_the_port_commands(capsys, tmp_path):
    bdef = _write(tmp_path, _definition(files=(TUTO,), algos=("mgm",)))
    rc, out = run(capsys, "batch", "--simulate", "--device", "cpu",
                  "--output_dir", str(tmp_path / "o"), bdef)
    assert rc == 0
    (line,) = [ln for ln in out.out.splitlines() if "-m" in ln]
    assert "-m pydcop_tpu_torch --output" in line
    assert line.endswith(f"--seed 0 --device cpu {TUTO}")
    assert not os.path.exists(tmp_path / "o" / "progress_smoke")


def test_batch_refuses_a_persistent_cache(capsys, tmp_path):
    bdef = _write(tmp_path, _definition())
    rc, out = run(capsys, "batch", "--compile-cache-dir", "/nonexistent",
                  "--device", "cpu", "--output_dir", str(tmp_path / "o"),
                  bdef)
    assert rc == 1
    assert "not ported" in json.loads(out.out)["error"]


def test_in_process_matches_subprocess_output(capsys, tmp_path):
    """Same job, both engines → same metrics JSON (modulo wall time and
    the engine tag)."""
    bdef = _write(tmp_path, {
        "sets": {"s": {"path": [CSP], "iterations": 1}},
        "batches": {"b": {"command": "solve", "command_options": {
            "algo": ["dsa"], "cycles": 15}}},
    }, "one.yaml")
    outs = {}
    for engine in ("in-process", "subprocess"):
        out_dir = str(tmp_path / engine)
        rc, out = run(capsys, "batch", "--engine", engine, "--device",
                      "cpu", "--output_dir", out_dir, bdef)
        assert rc == 0, out.err
        (job,) = _outputs(out_dir)
        with open(os.path.join(out_dir, job)) as f:
            outs[engine] = json.load(f)
    for key in ("assignment", "cost", "violation", "cycle", "msg_count",
                "msg_size", "status"):
        assert outs["in-process"][key] == outs["subprocess"][key], key
