"""The CLI surface of the port's replicated solve fleet —
``pydcop_tpu_torch serve --replicas N`` — on the CPU, after the JAX
package's ``tests/cli/test_fleet_cli.py``, case for case:

* a seeded Poisson burst through a 2-replica fleet, every job
  completing with the standalone solve's exact cost/cycle/assignment and
  the output JSON carrying the ``fleet`` section (router state,
  per-replica counters) with the JAX fleet's keys;
* the flag errors: ``--processes`` without ``--journal-dir``,
  ``--resume`` with replicas, and no ``--device`` on a machine with no
  GPU (a loud error, never a CPU run);
* the kill smoke (JAX ``slow``-marked, small enough here): a
  ``kill_replica`` mid-trace — every job still completes
  bit-identically, the orphans re-seated on the peer, with a finite
  recovery-time objective and the whole handoff in ``fleet.jsonl``.

The process fleet's command line runs in ``tests/test_torch_procfleet.py``
(the tests that spawn children are kept to two).
"""
import json
import os

import pytest
import torch

from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.serve import SolveFleet as JaxSolveFleet
from pydcop_tpu_torch import cli
from pydcop_tpu_torch.batch.engine import BatchItem, adapter_for
from pydcop_tpu_torch.dcop import load_dcop_from_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
TUTO = os.path.join(INSTANCES, "graph_coloring_tuto.yaml")
CSP = os.path.join(INSTANCES, "coloring_csp.yaml")


def run(capsys, *args):
    rc = cli.main(["serve", *args])
    return rc, json.loads(capsys.readouterr().out)


def _standalone(fn, algo, seed, limit=2000):
    spec = adapter_for(algo).build_spec(
        BatchItem(load_dcop_from_file(fn), algo, seed=seed))
    return spec.solver.run(max_cycles=limit)


def _check_equal(out, algo):
    for jid, m in out["results"].items():
        assert m["status"] == "FINISHED", (jid, m)
        fn, seed = m["label"].rsplit(":", 1)
        seq = _standalone(fn, algo, int(seed))
        assert m["cost"] == seq.cost, (jid, m)
        assert m["cycle"] == seq.cycle, (jid, m)
        assert m["assignment"] == seq.assignment, (jid, m)


class TestFleetSmoke:
    def test_two_replica_fleet_serves_bit_identical(self, capsys):
        rc, out = run(capsys, "-a", "mgm", "--jobs", "6", "--replicas",
                      "2", "--arrival", "poisson", "--rate", "50",
                      "--arrival-seed", "7", "--lanes", "2",
                      "--max-cycles", "2000", "--prewarm", "--device",
                      "cpu", TUTO, CSP)
        assert rc == 0, out
        assert out["status"] == "FINISHED"
        assert len(out["results"]) == 6
        _check_equal(out, "mgm")
        for m in out["results"].values():
            assert m["serve"]["replica"].startswith("replica-")
        fleet = out["fleet"]
        assert fleet["fleet"]["jobs_routed"] == 6
        assert set(fleet["replicas"]) == {"replica-0", "replica-1"}
        assert all(r["up"] for r in fleet["replicas"].values())

    def test_fleet_section_has_the_jax_fleets_keys(self, capsys):
        """The ``fleet`` section is ``SolveFleet.metrics()``: its keys,
        the router's, a replica's and its counters' are the JAX
        fleet's."""
        rc, out = run(capsys, "-a", "mgm", "--replicas", "2", "--lanes",
                      "2", "--max-cycles", "63", "--device", "cpu", TUTO)
        assert rc == 0
        jf = JaxSolveFleet(replicas=2, lanes=2, max_cycles=63)
        jid = jf.submit(jax_load([TUTO]), "mgm", seed=0)
        for _ in range(200):
            if not jf.tick():
                break
        jf.result(jid, timeout=1)
        want = json.loads(json.dumps(jf.metrics()))
        got = out["fleet"]
        assert set(got) == set(want)
        assert set(got["fleet"]) == set(want["fleet"])
        assert set(got["router"]) == set(want["router"])
        assert set(got["router"]["replica-0"]) == \
            set(want["router"]["replica-0"])
        mine, theirs = got["replicas"]["replica-0"], \
            want["replicas"]["replica-0"]
        assert set(mine) == set(theirs)
        assert set(mine["serve"]) == set(theirs["serve"])

    def test_processes_requires_journal_dir(self, capsys):
        rc, out = run(capsys, "-a", "dsa", "--replicas", "2",
                      "--processes", "--device", "cpu", TUTO)
        assert rc == 1
        assert "journal-dir" in out["error"]

    def test_resume_rejected_with_replicas(self, capsys, tmp_path):
        rc, out = run(capsys, "-a", "mgm", "--replicas", "2", "--resume",
                      "--journal-dir", str(tmp_path / "x"), "--device",
                      "cpu", TUTO)
        assert rc == 1
        assert "fleet" in out["error"]

    def test_fleet_defaults_to_cuda(self, capsys):
        """No --device: a fleet runs on cuda; on a machine with no GPU
        the command fails loudly, it never serves on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a GPU is visible: the fleet would run on it")
        rc, out = run(capsys, "-a", "mgm", "--replicas", "2", TUTO)
        assert rc == 1 and out["status"] == "ERROR"
        assert "CUDA" in out["error"] and "results" not in out


class TestFleetKillSmoke:
    """The chaos pin through the CLI: a thread-hosted kill -9 of
    replica-0 mid-trace; every job still completes bit-identically."""

    def test_kill_replica_midtrace_all_complete_bit_identical(
        self, capsys, tmp_path
    ):
        plan = tmp_path / "plan.yaml"
        # every replica's first tick wedges 0.5 s, and replica-0 is
        # killed one supervisor pass (0.05 s) in: it holds its share of
        # the burst, admitted or not, and completes none of it
        plan.write_text(
            "seed: 7\n"
            "faults:\n"
            "  - kind: stall_tick\n"
            "    cycle: 1\n"
            "    duration: 0.5\n"
            "  - kind: kill_replica\n"
            "    replica: 0\n"
            "    cycle: 2\n"
        )
        journal = str(tmp_path / "fleet")
        rc, out = run(capsys, "-a", "dsa", "--jobs", "8", "--replicas",
                      "2", "--lanes", "1", "--max-cycles", "2000",
                      "--journal-dir", journal, "--fault-plan", str(plan),
                      "--device", "cpu", TUTO, CSP)
        assert rc == 0, out
        assert out["status"] == "FINISHED"
        assert len(out["results"]) == 8
        _check_equal(out, "dsa")
        fleet = out["fleet"]["fleet"]
        assert fleet["replicas_down"] == 1
        assert fleet["faults_injected"] == 1
        assert fleet["jobs_reseated"] >= 1
        recov = out["fleet"]["recoveries"]
        assert recov and recov[0]["rto_s"] is not None
        assert recov[0]["rto_s"] > 0
        # the dead replica served nothing to completion
        assert all(m["serve"]["replica"] == "replica-1"
                   for m in out["results"].values())
        # the fleet journal streamed the whole handoff
        with open(os.path.join(journal, "fleet.jsonl"),
                  encoding="utf-8") as f:
            kinds = [json.loads(line)["kind"] for line in f
                     if line.strip()]
        assert kinds.count("done") == 8
        assert kinds.count("job") == 8
        assert kinds.count("reseat") == fleet["jobs_reseated"]
