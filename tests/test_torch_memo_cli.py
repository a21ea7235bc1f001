"""The port's ``serve --memo`` held to the JAX package's command on the
CPU, after JAX's ``tests/cli/test_memo_cli.py`` (in process, through each
package's ``cli.main``):

* the same duplicate trace (``--jobs 4 --seed-period 1`` on the
  tutorial instance: four copies of one job) served twice, the second
  pass a fresh service that ``--resume``-s the journal and rehydrates the
  persisted cache: its hit counts (``serve.memo``) equal the JAX
  command's, exact hits only, and every hit equals its first pass's
  result; in the first pass, whose split between misses and hits
  depends on completion timing, both packages count every job once and
  cache every miss.  (With two seeds a job of the second seed may match
  the first seed's entry as a 0-edit variant, or miss, as the first
  copy has or has not finished: the counts would depend on timing in
  both packages.)
* ``--memo-ttl`` and ``--memo-max-edits`` have JAX's defaults and reach
  the cache's config; every job carries its ``memo`` provenance;
* without ``--memo`` there is no ``memo`` section.
"""
import json
import os

import pytest

from pydcop_tpu import cli as jax_cli
from pydcop_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTO = os.path.join(ROOT, "tests", "instances", "graph_coloring_tuto.yaml")
TRACE = ["serve", "-a", "mgm", "--jobs", "4", "--seed-period", "1",
         "--lanes", "2", "--memo"]


def _run(main, args, out_path):
    """One command through ``main``, its JSON read from ``--output``."""
    rc = main(["--output", str(out_path), *args])
    with open(out_path) as f:
        out = json.load(f)
    assert rc == 0, out
    return out


def _passes(main, tmp, extra=()):
    journal = str(tmp / "journal")
    first = _run(main, [*TRACE, "--journal-dir", journal, *extra, TUTO],
                 tmp / "first.json")
    second = _run(main, [*TRACE, "--journal-dir", journal, "--resume",
                         *extra, TUTO], tmp / "second.json")
    return first, second


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    mine = _passes(cli.main, tmp_path_factory.mktemp("port"),
                   ("--device", "cpu"))
    theirs = _passes(jax_cli.main, tmp_path_factory.mktemp("jax"))
    return mine, theirs


def test_second_pass_hit_counts_equal_jax(both):
    (_, mine), (_, theirs) = both
    assert mine["serve"]["memo"] == theirs["serve"]["memo"]
    m = mine["serve"]["memo"]
    assert m["rehydrated"] == 1 and m["hits_exact"] == 4
    assert m["misses"] == 0 and m["inserts"] == 0
    assert mine["status"] == theirs["status"] == "FINISHED"


def test_first_pass_counts_every_job_and_caches_every_miss(both):
    for first, _ in both:
        m = first["serve"]["memo"]
        assert m["hits_exact"] + m["misses"] == 4
        assert m["inserts"] == m["misses"] >= 1
        assert m["hits_variant"] == 0


def test_every_hit_equals_its_first_pass(both):
    (first, second), _ = both
    by_label = {m["label"]: m for m in first["results"].values()}
    for m in second["results"].values():
        assert m["memo"]["hit"] == "exact"
        twin = by_label[m["label"]]
        assert (m["assignment"], m["cost"], m["cycle"]) == \
            (twin["assignment"], twin["cost"], twin["cycle"])
    for m in first["results"].values():
        assert m["memo"]["hit"] in ("miss", "exact")


def test_memo_flags_defaults_and_config(monkeypatch, tmp_path):
    from pydcop_tpu_torch.serve import service as svc_mod

    mine = cli.make_parser().parse_args(["serve", "-a", "mgm", TUTO])
    theirs = jax_cli.make_parser().parse_args(["serve", "-a", "mgm", TUTO])
    assert (mine.memo, mine.memo_ttl, mine.memo_max_edits) == \
        (theirs.memo, theirs.memo_ttl, theirs.memo_max_edits) == \
        (False, 3600.0, 8)
    seen = []
    real = svc_mod.SolveService.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("memo"))
        real(self, *a, **kw)

    monkeypatch.setattr(svc_mod.SolveService, "__init__", spy)
    out = _run(cli.main, ["serve", "-a", "mgm", TUTO, "--device", "cpu",
                          "--memo", "--memo-ttl", "60",
                          "--memo-max-edits", "3"], tmp_path / "a.json")
    assert (seen[0].ttl_s, seen[0].max_edits) == (60.0, 3)
    assert set(out["serve"]["memo"]) >= {"hits_exact", "misses"}
    (job,) = out["results"].values()
    assert job["memo"]["hit"] == "miss"
    out = _run(cli.main, ["serve", "-a", "mgm", TUTO, "--device", "cpu"],
               tmp_path / "b.json")
    assert "memo" not in out["serve"]
