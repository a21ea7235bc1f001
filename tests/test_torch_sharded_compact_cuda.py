"""The compact collective modes and the generic sharded engine on the card:
K7, K8 and K9 in ``overlap="exact"|"stale"`` and ``exchange=True``, every
shard in one group (the launches combine the shards) and in two (the
launches write partials and the boundary columns cross), equal to the
dense run and to the CPU run; the generic engine equal to its CPU run and
launching no kernel of the port.

``cuda``-marked; each test skips where no GPU is visible (the kernels
have no CPU mode).  No JAX here: on the card the port is held to itself.
Run on a machine with a card with
``python -m pytest tests/test_torch_sharded_compact_cuda.py -m cuda``."""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.generators import generate_secp
from pydcop_tpu_torch.ops import read_launch_counters, reset_launch_counters
from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
    compile_constraint_graph, compile_factor_graph
from pydcop_tpu_torch.parallel import ShardedLocalSearch, ShardedMaxSum, \
    build_mesh, packed_mesh

pytestmark = pytest.mark.cuda

MODES = {"off": ("off", None), "exact": ("exact", False),
         "stale": ("stale", None), "exchange": ("exact", True)}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _split(devices):
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


def _grouping(groups):
    return (mock.patch.object(packed_mesh, "_device_groups", _split)
            if groups == 2 else contextlib.nullcontext())


def _ring(device, V=600, D=3, seed=2):
    """A ring lattice (edges i, i+1 and i, i+2): its locality cut is
    pairwise, so the exchange runs."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([np.arange(V), np.arange(V)])
    ej = np.concatenate([(np.arange(V) + 1) % V, (np.arange(V) + 2) % V])
    mats = rng.uniform(0, 5, (ei.size, D, D)).astype(np.float32)
    return compile_binary_from_arrays(ei, ej, mats, V, device=device)


def _secp(device):
    return compile_factor_graph(generate_secp(
        n_lights=60, n_models=20, n_rules=8, max_model_size=3, seed=1),
        device=device)


GRAPHS = {"ring": _ring, "secp4": _secp}


def _maxsum(t, device, mode, activation=None):
    overlap, exchange = MODES[mode]
    eng = ShardedMaxSum(t, build_mesh(8, device), overlap=overlap,
                        exchange=exchange, activation=activation)
    values, q, _ = eng.run(cycles=20, seed=1)
    return eng, values, eng.beliefs(q).cpu()


@pytest.mark.parametrize("activation", [None, 0.7])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_maxsum_compact_on_the_card(graph, mode, groups, activation):
    _need_gpu()
    if mode == "exchange" and graph == "secp4":
        pytest.skip("the SECP's cut is not pairwise")
    with _grouping(groups):
        reset_launch_counters()
        eng, v, bel = _maxsum(GRAPHS[graph]("cuda"), "cuda", mode,
                              activation)
        counts = {k: n for k, n in read_launch_counters().items() if n}
        _, vc, belc = _maxsum(GRAPHS[graph]("cpu"), "cpu", mode, activation)
        _, vd, beld = _maxsum(GRAPHS[graph]("cuda"), "cuda", "off",
                              activation)
    assert sum(counts.values()) == 20 * groups
    assert np.array_equal(v, vc) and torch.equal(bel, belc)
    if mode != "stale":
        assert np.array_equal(v, vd) and torch.equal(bel, beld)
    assert eng.comm.compact == (mode != "off")


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("rule", ["mgm", "dsa", "adsa"])
def test_local_search_compact_on_the_card(rule, mode, groups):
    _need_gpu()
    out = {}
    for device in ("cuda", "cpu"):
        for m in {mode, "off"}:
            overlap, exchange = MODES[m]
            with _grouping(groups):
                eng = ShardedLocalSearch(
                    _ring(device), build_mesh(8, device), rule=rule,
                    overlap=overlap, exchange=exchange)
                reset_launch_counters()
                out[device, m] = eng.run(cycles=20, seed=2)
                counts = read_launch_counters()
            if device == "cuda":
                assert counts["device_tables"] == 20 * groups
                if rule == "mgm":
                    assert counts["device_mgm_move"] == \
                        20 * (1 if groups == 1 else 4)
    assert np.array_equal(out["cuda", mode], out["cpu", mode])
    if mode != "stale":
        assert np.array_equal(out["cuda", mode], out["cuda", "off"])


@pytest.mark.parametrize("mode", ["off", "exact", "stale"])
@pytest.mark.parametrize("algo", ["maxsum", "mgm", "dba", "gdba"])
def test_generic_engine_on_the_card(algo, mode):
    _need_gpu()
    from pydcop_tpu_torch.dcop import load_dcop

    src = ["name: ring", "objective: min",
           "domains: {d: {values: [0, 1, 2]}}", "variables:"]
    src += [f"  v{i:03d}: {{domain: d}}" for i in range(120)]
    src += ["constraints:"]
    src += [f"  c{i:03d}: {{type: intention, function: \"1 if v{i:03d} == "
            f"v{(i + k) % 120:03d} else 0\"}}"
            for i in range(120) for k in (1,)]
    src += [f"  e{i:03d}: {{type: intention, function: \"1 if v{i:03d} == "
            f"v{(i + 2) % 120:03d} else 0\"}}" for i in range(120)]
    src.append("agents: [a1]")
    dcop = load_dcop("\n".join(src) + "\n")
    out = []
    for device in ("cuda", "cpu"):
        t = compile_constraint_graph(dcop, device=device)
        mesh = build_mesh(8, device)
        reset_launch_counters()
        if algo == "maxsum":
            eng = ShardedMaxSum(t, mesh, use_packed=False, overlap=mode)
            values, q, r = eng.run(cycles=30)
            state = eng.state_to_host(q, r)
        else:
            eng = ShardedLocalSearch(t, mesh, rule=algo, use_packed=False,
                                     overlap=mode)
            values, _, aux = eng.run_chunked(30, seed=1)
            state = {i: w for i, w in enumerate(eng.aux_numpy(aux))}
        assert eng.st is not None
        assert not any(read_launch_counters().values())
        out.append((values, state))
    (vg, sg), (vc, sc) = out
    assert np.array_equal(vg, vc)
    assert all(np.array_equal(sg[k], sc[k]) for k in sg)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [3, 5])
def test_exchange_on_an_odd_ring_of_shards_on_the_card(S, groups):
    """An odd ring of shards puts a pair's two sends in different rounds
    (ROADMAP C-f8): the exchange still equals the dense run, values and
    beliefs, with K7 on the card."""
    _need_gpu()
    out = {}
    with _grouping(groups):
        for mode in ("off", "exchange"):
            overlap, exchange = MODES[mode]
            eng = ShardedMaxSum(_ring("cuda"), build_mesh(S, "cuda"),
                                overlap=overlap, exchange=exchange)
            v, q, _ = eng.run(cycles=20, seed=1)
            out[mode] = (v, eng.beliefs(q).cpu())
    where = {p: r for r, pairs in enumerate(eng.comm.rounds) for p in pairs}
    assert any(where[(a, b)] != where[(b, a)] for a, b in where)
    assert np.array_equal(out["off"][0], out["exchange"][0])
    assert torch.equal(out["off"][1], out["exchange"][1])
