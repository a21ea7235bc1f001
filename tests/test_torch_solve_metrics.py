"""``solve``'s metrics surface on the CPU, against the JAX package's CLI:
``--run_metrics`` (one ``RUNNING`` line a cycle of the history) and
``--end_metrics`` (the end line) write the JAX package's CSV header and
rows, every column but ``time`` equal on a deterministic instance
(maxsum at noise 0); ``-c cycle_change`` turns ``collect_cycles`` on;
``--uiport`` is refused with ``NotPortedError``; the placement path and
the exact-search family collect too."""
import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from pydcop_tpu.commands._utils import CSV_COLUMNS as JAX_CSV_COLUMNS
from pydcop_tpu_torch.cli import main, make_parser
from pydcop_tpu_torch.commands import solve as solve_cmd
from pydcop_tpu_torch.commands._utils import CSV_COLUMNS, add_csvline
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def _cli(package, args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", package, *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=cwd, env=env)
    return out


def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


def test_csv_columns_equal_jax(tmp_path):
    assert CSV_COLUMNS == JAX_CSV_COLUMNS
    f = tmp_path / "m.csv"
    add_csvline(str(f), "value_change", {"cycle": 3, "cost": 1.5,
                                         "status": "RUNNING", "extra": 9})
    add_csvline(str(f), "value_change", {"cycle": 4})
    assert _rows(f) == [JAX_CSV_COLUMNS, ["", "3", "1.5", "", "", "",
                                          "RUNNING"],
                        ["", "4", "", "", "", "", ""]]


@pytest.mark.parametrize("name", ["graph_coloring_tuto", "ising_grid"])
def test_run_and_end_metrics_equal_the_jax_cli(tmp_path, name):
    rows = {}
    for package in ("pydcop_tpu", "pydcop_tpu_torch"):
        d = tmp_path / package
        d.mkdir()
        args = ["solve", "-a", "maxsum", "-p", "noise:0", "--run_metrics",
                str(d / "run.csv"), "--end_metrics", str(d / "end.csv"),
                _path(name)]
        if package == "pydcop_tpu_torch":
            args[1:1] = ["--device", "cpu"]
        out = _cli(package, args, ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout)["status"] == "FINISHED"
        rows[package] = (_rows(d / "run.csv"), _rows(d / "end.csv"))
    (got_run, got_end), (ref_run, ref_end) = (rows["pydcop_tpu_torch"],
                                              rows["pydcop_tpu"])
    assert got_run[0] == ref_run[0] == CSV_COLUMNS
    assert got_end[0] == ref_end[0] == CSV_COLUMNS
    assert len(got_run) == len(ref_run) > 2
    assert len(got_end) == len(ref_end) == 2
    t, c = CSV_COLUMNS.index("time"), CSV_COLUMNS.index("cost")
    # integer costs (the tutorial) are equal to the last digit; ising's
    # float32 history sums add in another order, so its per-cycle cost
    # is held at the port's tolerance, atol=1e-4
    exact = name == "graph_coloring_tuto"

    def strip(row):
        return [v for i, v in enumerate(row)
                if i != t and (exact or i != c)]

    assert [strip(r) for r in got_run] == [strip(r) for r in ref_run]
    assert [strip(r) for r in got_end] == [strip(r) for r in ref_end]
    for g, r in zip(got_run[1:] + got_end[1:], ref_run[1:] + ref_end[1:]):
        assert float(g[c]) == pytest.approx(float(r[c]), abs=1e-4)
    assert {r[-1] for r in got_run[1:]} == {"RUNNING"}
    assert [int(r[1]) for r in got_run[1:]] == list(
        range(1, len(got_run)))


def _args(*argv):
    return make_parser().parse_args(["solve", "--device", "cpu", *argv])


def test_collect_on_cycle_change_turns_collect_on(monkeypatch, capsys):
    import pydcop_tpu_torch.runtime as rt

    seen = []
    real = rt.solve_result

    def spy(*a, **k):
        seen.append(k["collect_cycles"])
        return real(*a, **k)

    monkeypatch.setattr(rt, "solve_result", spy)
    tuto = _path("graph_coloring_tuto")
    for argv, want in ((["-a", "mgm", tuto], False),
                       (["-a", "mgm", "-c", "cycle_change", tuto], True),
                       (["-a", "mgm", "-c", "period", "--period", "0.5",
                         tuto], False),
                       (["-a", "mgm", "-m", "process", "--delay", "0.1",
                         tuto], False)):
        assert solve_cmd.run_cmd(_args(*argv)) == 0
        assert seen[-1] is want
    assert "--mode process" in capsys.readouterr().err


def test_run_metrics_turn_collect_on(tmp_path):
    f = tmp_path / "run.csv"
    assert solve_cmd.run_cmd(_args("-a", "dba", "--cycles", "9",
                                   "--run_metrics", str(f),
                                   _path("coloring_csp"))) == 0
    rows = _rows(f)
    assert rows[0] == CSV_COLUMNS and len(rows) == 10
    assert [r[1] for r in rows[1:]] == [str(c) for c in range(1, 10)]


def test_uiport_is_not_ported(capsys):
    with pytest.raises(NotPortedError, match="uiport"):
        solve_cmd.run_cmd(_args("-a", "maxsum", "--uiport", "8000",
                                _path("graph_coloring_tuto")))
    assert main(["solve", "--device", "cpu", "-a", "maxsum", "--uiport",
                 "8000", _path("graph_coloring_tuto")]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "ERROR" and "uiport" in out["error"]


def test_failed_solve_prints_an_error(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("name: x\nvariables: [\n")
    assert solve_cmd.run_cmd(_args("-a", "maxsum", str(bad))) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "ERROR" and out["error"]


def test_placement_path_collects_each_cycle(tmp_path):
    from pydcop_tpu_torch.distribution import Distribution

    dcop = load_dcop_from_file(_path("graph_coloring_tuto"))
    agents = sorted(dcop.agents)
    names = sorted(dcop.variables) + sorted(dcop.constraints)
    dist = Distribution({a: [n for i, n in enumerate(names)
                             if i % len(agents) == k]
                         for k, a in enumerate(agents)})
    res = solve_result(dcop, "maxsum", distribution=dist, cycles=6,
                       n_shards=2, collect_cycles=True,
                       algo_params={"noise": 0}, device="cpu")
    assert [h["cycle"] for h in res.history] == list(range(1, 7))
    assert res.history[-1]["cost"] == pytest.approx(res.cost, abs=1e-4)
    plain = solve_result(dcop, "maxsum", distribution=dist, cycles=6,
                         n_shards=2, algo_params={"noise": 0}, device="cpu")
    assert plain.history is None and plain.assignment == res.assignment


@pytest.mark.parametrize("algo,params", [
    ("dpop", None), ("syncbb", None), ("ncbb", None),
    ("syncbb", {"engine": "frontier"}), ("dpop", {"engine": "frontier"})])
def test_exact_family_accepts_collect(tmp_path, algo, params):
    f = tmp_path / "run.csv"
    argv = ["-a", algo, "--run_metrics", str(f), "--end_metrics",
            str(tmp_path / "end.csv")]
    for k, v in (params or {}).items():
        argv += ["-p", f"{k}:{v}"]
    assert solve_cmd.run_cmd(_args(*argv, _path("graph_coloring_tuto"))) \
        == 0
    assert _rows(tmp_path / "end.csv")[1][CSV_COLUMNS.index("cost")] \
        == "12.0"
    res = solve_result(load_dcop_from_file(_path("graph_coloring_tuto")),
                       algo, algo_params=params, collect_cycles=True,
                       device="cpu")
    if res.history:
        assert len(_rows(f)) == len(res.history) + 1
        assert res.history[-1]["cost"] == res.cost == 12
    else:
        assert not f.exists()
