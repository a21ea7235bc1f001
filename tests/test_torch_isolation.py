"""The PyTorch package stands alone: it imports neither JAX nor anything
of the JAX package (``pydcop_tpu``), not even its JAX-free modules.

The test process itself has JAX loaded (``tests/conftest.py`` imports
it), so the import check runs in a fresh interpreter: it imports the
port (its sharded engines, K3's wrapper and the serve modules included),
solves the tutorial instance on the CPU (maxsum, dpop, maxsum and amaxsum
sharded by a placement, one maxsum job and a one-edit variant of it
served by a SolveService with its solution cache, the variant by a warm
repair, one mgm job through a two-replica SolveFleet, and one dsa job
through the process fleet's child body — the ``serve-replica`` command's
ReplicaWorker, hosted on a thread over a real socket journal, with a
runner artifact store) and reports every
JAX or JAX-package module that got loaded.  A source scan backs it up for code
paths a single solve does not reach."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pydcop_tpu_torch"

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import pydcop_tpu_torch
from pydcop_tpu_torch.cli import make_parser
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import cuda_build, packed_dpop, packed_maxsum
from pydcop_tpu_torch.ops import packed_sharded, permute
from pydcop_tpu_torch.algorithms import amaxsum
from pydcop_tpu_torch.distribution import Distribution, load_dist, yaml_dist
from pydcop_tpu_torch.parallel import ShardedLocalSearch, build_mesh
from pydcop_tpu_torch.parallel import boundary, collectives, packed_mesh
from pydcop_tpu_torch.runtime import solve_result
from pydcop_tpu_torch.runtime import checkpoint, faults
from pydcop_tpu_torch.serve import SolveService, errors, scheduler, service
from pydcop_tpu_torch.commands import serve as serve_cmd
from pydcop_tpu_torch.ops import headroom
from pydcop_tpu_torch.algorithms import warm
from pydcop_tpu_torch.runtime import repair
from pydcop_tpu_torch.dcop import canonical
from pydcop_tpu_torch.portfolio import features
from pydcop_tpu_torch.serve import memo
from pydcop_tpu_torch.serve import ProcessFleet, SolveFleet, artifacts
from pydcop_tpu_torch.serve import fleet, procfleet, router, wire
from pydcop_tpu_torch.commands import serve_replica
import tempfile, threading, time
make_parser()
dcop = load_dcop_from_file([sys.argv[2]])
fl = SolveFleet(replicas=2, lanes=2, device="cpu")
fj = fl.submit(dcop, "mgm", seed=0)
for _ in range(200):
    if not fl.tick():
        break
fleet_cost = fl.result(fj, timeout=10).cost
recs = []
hub = wire.JournalHub(on_record=lambda client, body: recs.append(body))
worker = procfleet.ReplicaWorker(("127.0.0.1", hub.port), "w0",
                                 artifact_dir=tempfile.mkdtemp(),
                                 device="cpu")
wt = threading.Thread(target=worker.run, daemon=True)
wt.start()
hub.send("w0", {"cmd": "submit", "jid": "job-000001", "algo": "dsa",
                "algo_params": {}, "seed": 0, "source_file": sys.argv[2]})
deadline = time.monotonic() + 60
while time.monotonic() < deadline and not any(
        r.get("evt") == "complete" for r in recs):
    hub.pump(0.02)
hub.send("w0", {"cmd": "stop"})
while wt.is_alive() and time.monotonic() < deadline:
    hub.pump(0.02)
hub.stop()
child = [r["result"]["status"] for r in recs if r.get("evt") == "complete"]
res = solve_result(dcop, "maxsum", device="cpu")
exact = solve_result(dcop, "dpop", device="cpu")
comps = sorted(dcop.variables) + sorted(dcop.constraints)
dist = load_dist(yaml_dist(Distribution(
    {"a0": comps[0::2], "a1": comps[1::2]})))
sharded = solve_result(dcop, "maxsum", distribution=dist, n_shards=2,
                       device="cpu")
asharded = solve_result(dcop, "amaxsum", distribution=dist, n_shards=2,
                        cycles=40, device="cpu")
svc = SolveService(lanes=2, device="cpu", memo=True)
jid = svc.submit(dcop, "maxsum", seed=0)
for _ in range(200):
    if not svc.tick():
        break
served = svc.result(jid, timeout=10)
# a one-edit variant: served by a warm repair (features, canonical
# hashes, the warm solver and its controller)
name = sorted(dcop.constraints)[0]
dcop.constraints[name] = repair.perturbed_constraint(
    dcop.constraints[name], seed=1)
jid = svc.submit(dcop, "maxsum", seed=0)
for _ in range(200):
    if not svc.tick():
        break
variant = svc.result(jid, timeout=10).metrics()["memo"]["hit"]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pydcop_tpu"))
print(json.dumps({"cost": res.cost, "dpop_cost": exact.cost,
                  "sharded_cost": sharded.cost, "served_cost": served.cost,
                  "amaxsum_status": asharded.status, "variant": variant,
                  "fleet_cost": fleet_cost, "child": child, "bad": bad}))
"""


def test_port_runs_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-I", "-c", CHILD, str(ROOT),
         str(ROOT / "tests" / "instances" / "graph_coloring_tuto.yaml")],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["cost"] == 12 and got["dpop_cost"] == 12
    assert got["sharded_cost"] == 12
    assert got["served_cost"] == 12
    assert got["amaxsum_status"] == "FINISHED"
    assert got["variant"] == "variant"
    assert got["fleet_cost"] == 12
    assert got["child"] == ["FINISHED"]
    assert got["bad"] == []


#: a module path of the JAX package: ``pydcop_tpu`` not followed by
#: ``_torch`` (a repository path such as ``pydcop_tpu/ops/x.py``, naming
#: the kernel a port replaces, is not an import and is allowed)
JAX_PKG = re.compile(r"\bpydcop_tpu(?![\w/])")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _non_doc_strings(tree):
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_the_jax_package(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax(lib)?\b", src, re.M)
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "pydcop_tpu"), m
    for s in _non_doc_strings(tree):
        assert not JAX_PKG.search(s), s
        assert not re.search(r"^jax(\.|$)", s), s
