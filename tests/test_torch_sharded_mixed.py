"""The port's sharded engines on mixed-arity graphs (``parallel/mesh.py``:
``ShardedMaxSum``, ``ShardedLocalSearch`` mgm/dsa/adsa, ``solve -d``)
against the JAX package on its 8-device virtual CPU mesh
(``tests/conftest.py``), on the CPU (the per-shard kernels' plain
versions, mixed branches).

The JAX side runs its generic sharded engine (``use_packed=False``,
dense collectives), the engine JAX picks on a CPU mesh; its per-shard
Pallas kernels are held to the port's in
``tests/test_torch_sharded_mixed_kernels.py``.  Both packages run on the
same compiled arrays with the same factor→shard assignment.  The
instances are the JAX package's own mixed sharded cases
(``tests/unit/test_packed_mesh.py::TestMixedPackedSharded``: SECPs of 30
and 40 lights, arity up to 3 or 4), at the damping (0.5) and cycle count
(8) where it pins its packed mixed engine equal to its generic one:
values, costs and stop cycles exactly.  (At damping 0 SECP's tied
beliefs leave the argmin to the last bit of the cross-shard sum, whose
order the JAX psum does not fix: on secp4 at 8 shards JAX's own packed
and generic engines differ in one value at cycle 3.)  Local search starts from JAX's
``random_valid_values(PRNGKey(seed + 17))`` and, for DSA/ADSA, takes the
coins JAX's generic engine draws (as ``tests/test_torch_sharded.py``).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.algorithms._local_search import random_valid_values
from pydcop_tpu.dcop import dcop_yaml
from pydcop_tpu.dcop import load_dcop as jax_load_dcop
from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.distribution.objects import Distribution as JaxDistribution
from pydcop_tpu.generators.secp import generate_secp
from pydcop_tpu.ops.compile import compile_constraint_graph as \
    jax_compile_cg
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.parallel.mesh import ShardedLocalSearch as JaxLocalSearch
from pydcop_tpu.parallel.mesh import ShardedMaxSum as JaxMaxSum
from pydcop_tpu.parallel.mesh import build_mesh as jax_build_mesh
from pydcop_tpu.parallel.partition import partition_factors as \
    jax_partition
from pydcop_tpu.runtime import solve_result as jax_solve_result
from pydcop_tpu_torch.dcop import load_dcop, load_dcop_from_file
from pydcop_tpu_torch.distribution import Distribution, yaml_dist
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.parallel import (
    ShardedLocalSearch,
    ShardedMaxSum,
    build_mesh,
)
from pydcop_tpu_torch.runtime import solve_result

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INST = os.path.join(ROOT, "tests", "instances")


def _secp(seed=3, **kw):
    kw.setdefault("n_lights", 30)
    kw.setdefault("n_models", 10)
    kw.setdefault("n_rules", 6)
    kw.setdefault("max_model_size", 2)
    return generate_secp(seed=seed, **kw)


GRAPHS = {
    "secp3": lambda: _secp(),
    "secp4": lambda: _secp(max_model_size=3),
    "sparse_ternary": lambda: _secp(seed=5, n_lights=40, n_models=4,
                                    n_rules=2),
    "secp_ls": lambda: _secp(seed=4),
}


def _cpu(n):
    return build_mesh(n, "cpu")


def _full_distribution(dcop, n_agents, cls):
    """Round-robin placement of all computations (vars + constraints),
    as ``tests/test_torch_sharded.py`` places them."""
    comps = sorted(dcop.variables) + sorted(dcop.constraints)
    agents = [f"a{i:02d}" for i in range(n_agents)]
    mapping = {a: [] for a in agents}
    for i, c in enumerate(comps):
        mapping[agents[i % n_agents]].append(c)
    return cls(mapping)


def _jax_coins(rule, V, cycles, seed):
    """The generic engine's per-cycle draws, in variable order (as
    ``tests/test_torch_sharded.py`` takes them)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), cycles)
    if rule == "dsa":
        return np.stack([np.asarray(jax.random.uniform(k, (V,)))
                         for k in keys])
    wake, move = [], []
    for k in keys:
        k_wake, k_move = jax.random.split(k)
        wake.append(np.asarray(jax.random.uniform(k_wake, (V,))))
        move.append(np.asarray(jax.random.uniform(k_move, (V,))))
    return np.stack(wake), np.stack(move)


def _maxsum_pair(name, n_shards, own_partition=False, damping=0.5):
    jt = jax_compile(GRAPHS[name]())
    vis = [np.asarray(b.var_idx) for b in jt.buckets]
    assigns = (None if own_partition
               else jax_partition(vis, jt.n_vars, n_shards))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    port = ShardedMaxSum(t, _cpu(n_shards), damping=damping,
                         assigns=assigns)
    jax_engine = JaxMaxSum(jt, jax_build_mesh(n_shards), damping=damping,
                           assigns=port.packs.assigns, use_packed=False,
                           overlap="off")
    return jax_engine, port


@pytest.mark.parametrize("own_partition", [False, True])
@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("name", ["secp3", "secp4", "sparse_ternary"])
def test_mixed_maxsum_values_equal_jax(name, n_shards, own_partition):
    jax_engine, port = _maxsum_pair(name, n_shards, own_partition)
    assert port.packs.mixed
    jv, _, _ = jax_engine.run(cycles=8)
    v, q, r = port.run(cycles=8)
    assert np.array_equal(v, np.asarray(jv))
    # chunked continuation: 4 + 4 cycles through the state == 8 cycles
    v4, q4, r4 = port.run(cycles=4)
    v44, _, _ = port.run(cycles=4, q=q4, r=r4)
    assert np.array_equal(v44, v)


def test_every_shard_takes_the_mixed_layout():
    """Shards with unary factors only, and empty shards, on a mixed
    graph: the former take the mixed layout, the latter launch
    nothing."""
    _, port = _maxsum_pair("sparse_ternary", 8)
    kinds = [sorted(sh.slot_of) for sh in port.packs.shards]
    assert [1] in kinds and any(3 in k for k in kinds)
    assert all(sh.mixed is not None for sh in port.packs.shards if sh.N)
    before = K.shard_fused_ba.mixed_launches
    port.run(cycles=2)
    assert K.shard_fused_ba.mixed_launches == before  # CPU: plain versions


def _ls_pair(name, n_shards, rule, **kw):
    jt = jax_compile_cg(GRAPHS[name]())
    jax_engine = JaxLocalSearch(jt, jax_build_mesh(n_shards), rule=rule,
                                use_packed=False, overlap="off", **kw)
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    return jt, jax_engine, ShardedLocalSearch(t, _cpu(n_shards), rule=rule,
                                              **kw)


LS_CASES = {
    "mgm": dict(rule="mgm"),
    "dsa": dict(rule="dsa"),
    "adsa_B": dict(rule="adsa"),
    "adsa_C_p1_a1": dict(rule="adsa", probability=1.0,
                         algo_params={"variant": "C", "activation": 1.0}),
}


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("case", sorted(LS_CASES))
@pytest.mark.parametrize("name", ["secp_ls", "secp4"])
def test_mixed_local_search_equals_jax(name, case, n_shards):
    kw = dict(LS_CASES[case])
    rule = kw.pop("rule")
    jt, jax_engine, port = _ls_pair(name, n_shards, rule, **kw)
    assert port.packs.mixed
    seed, cycles = 3, 8
    jv, _, _ = jax_engine.run_chunked(cycles, seed=seed)
    x0 = np.asarray(random_valid_values(jt, jax.random.PRNGKey(seed + 17)))
    coins = (None if rule == "mgm"
             else _jax_coins(rule, jt.n_vars, cycles, seed))
    v, x, _ = port.run_chunked(cycles, x=port.state_from_values(x0),
                               coins=coins)
    assert np.array_equal(v, np.asarray(jv))
    if rule == "mgm":  # 3 + 5 cycles through the state == 8 cycles
        _, x3, aux = port.run_chunked(3, x=port.state_from_values(x0))
        v35, _, _ = port.run_chunked(5, x=x3, aux=aux)
        assert np.array_equal(v35, v)


PLACEMENT = {
    "secp_small": lambda: jax_load(os.path.join(INST, "secp_small.yaml")),
    "secp3": lambda: _secp(),
    "secp4": lambda: _secp(max_model_size=3),
}


@pytest.mark.parametrize("name", sorted(PLACEMENT))
def test_mixed_placement_solve_equals_jax(name):
    """``solve -d`` on a SECP, 8 cycles (on secp_small JAX's own packed
    and generic sharded engines part at 25 cycles, by one value); both
    packages load the same YAML text."""
    cycles = 8
    text = dcop_yaml(PLACEMENT[name]())
    jd, d = jax_load_dcop(text), load_dcop(text)
    want = jax_solve_result(
        jd, "maxsum", distribution=_full_distribution(jd, 5,
                                                      JaxDistribution),
        cycles=cycles)
    got = solve_result(d, "maxsum",
                       distribution=_full_distribution(d, 5, Distribution),
                       cycles=cycles, n_shards=8, device="cpu")
    assert got.assignment == want.assignment
    assert got.cost == want.cost and got.cycle == want.cycle
    assert got.status == want.status == "FINISHED"
    assert got.msg_count == want.msg_count
    assert got.metrics()["config"] == want.metrics()["config"] | {
        "chunk": got.config["chunk"]}


def test_cli_mixed_distribution_file(tmp_path):
    jd = PLACEMENT["secp4"]()
    prob = tmp_path / "prob.yaml"
    prob.write_text(dcop_yaml(jd))
    d = load_dcop_from_file([str(prob)])
    dist = _full_distribution(d, 4, Distribution)
    dist_f = tmp_path / "dist.yaml"
    dist_f.write_text(yaml_dist(dist))
    out = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "--device", "cpu", "--cycles", "12", "-d", str(dist_f), str(prob)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(out.stdout)
    want = solve_result(d, "maxsum", distribution=dist, cycles=12,
                        device="cpu")
    assert data["assignment"] == want.assignment
    assert data["cost"] == want.cost and data["cycle"] == 12


def _wide_ternary():
    """A ternary factor over D = 6: out of the mixed packer's scope."""
    return load_dcop("""
name: wide
objective: min
domains: {d: {values: [0, 1, 2, 3, 4, 5]}}
variables:
  x: {domain: d}
  y: {domain: d}
  z: {domain: d}
constraints:
  c: {type: intention, function: "x + y - z"}
agents: [a1]
""")


def test_out_of_scope_mixed_graphs_refuse():
    from pydcop_tpu_torch.ops.compile import compile_factor_graph

    t = compile_factor_graph(_wide_ternary(), device="cpu")
    with pytest.raises(NotPortedError, match="D <= 5"):
        ShardedMaxSum(t, _cpu(2))
    with pytest.raises(NotPortedError, match="D <= 5"):
        ShardedLocalSearch(t, _cpu(2))
