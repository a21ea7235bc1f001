"""K8 as one launch per device (``ops/packed_sharded.py::device_mgm_move``),
on the CPU through its plain version.

What the CUDA kernel must equal is held here: the device-level plain
version equals the per-shard plain composition the engine ran before —
``shard_route_gains_plain`` per shard, the ordered ``all_max``, the clamp
at 0, ``tiebreak_idx_partial`` per shard, the ordered ``all_min``,
``mgm_decision`` — bit for bit (``torch.equal``), on binary and mixed
graphs of ``tests/instances`` at 1, 4 and 8 shards with an empty shard,
for gains with exact ties, with ties within EPS and all zero; its "max"
and "min" modes, with the shards in two groups as on two cards, combine
to the same values; and the sharded MGM engine runs 200 cycles to the
assignment of that composition.  The per-shard plain versions are held to
the JAX package in ``tests/test_torch_sharded*_kernels.py``, the engine to
the JAX package's 8-device virtual mesh in ``tests/test_torch_sharded*.py``,
and the kernel to the plain version on the card (``chip_smoke.py`` and the
tests marked ``cuda`` there).
"""
import functools
import os

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.ops import packed_sharded as K
from pydcop_tpu_torch.ops.compile import compile_binary_from_arrays, \
    compile_constraint_graph
from pydcop_tpu_torch.parallel import ShardedLocalSearch, packed_mesh
from pydcop_tpu_torch.parallel.collectives import all_max, all_min
from pydcop_tpu_torch.parallel.partition import partition_factors

torch.set_num_threads(1)
INST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "instances")
CPU = torch.device("cpu")


def _instance(name):
    return compile_constraint_graph(
        load_dcop_from_file([os.path.join(INST, name + ".yaml")]),
        device="cpu")


def _random_binary(V=60, F=150, D=3, seed=0):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    mats = rng.uniform(0, 5, (F, D, D)).astype(np.float32)
    return compile_binary_from_arrays(ei, ej, mats, V, device="cpu")


GRAPHS = {
    # binary: a 4-valued meeting scheduling, a 60-variable random graph
    "meeting_scheduling": lambda: _instance("meeting_scheduling"),
    "random_60": _random_binary,
    # mixed: unary + binary factors, and arity 1-4
    "ising_grid": lambda: _instance("ising_grid"),
    "secp_small": lambda: _instance("secp_small"),
}
SHARDS = [1, 4, 8]
GAINS = ["spread", "exact_ties", "eps_ties", "zero"]


@functools.lru_cache(maxsize=None)
def _graph(name):
    return GRAPHS[name]()


def _assigns(t, n_shards):
    """The locality partition with shard 1 emptied into shard 0 (an empty
    shard at every S > 1)."""
    vis = [np.asarray(b.var_idx) for b in t.buckets]
    parts = partition_factors(vis, t.n_vars, n_shards)
    return [np.where(np.asarray(a) == 1, 0, a) for a in parts]


def _packs(name, n_shards):
    t = _graph(name)
    packs = packed_mesh.build_shard_packs(t, [CPU] * n_shards,
                                          _assigns(t, n_shards))
    if n_shards > 1:
        assert packs.shards[1].N == 0
    return packs


def _gain(kind, Vp, seed=0):
    """Non-negative gains [Vp]: spread values with zeros and exact ties;
    two values only (exact ties everywhere); values 0.4e-9 apart, below
    2.5e-9, so that neighbours' gains tie within EPS without being equal;
    all zero."""
    rng = np.random.default_rng(seed)
    vals = {"spread": [0.0, 0.5, 1.0, 1.0, 2.0, 3.25],
            "exact_ties": [1.0, 2.0],
            "eps_ties": [0.0, 1.2e-9, 1.6e-9, 2.0e-9, 2.4e-9],
            "zero": [0.0]}[kind]
    return torch.as_tensor(rng.choice(vals, Vp).astype(np.float32))


def _composition(shards, gain, idx_row):
    """The engine's arbitration before K8 launched once per device, over
    ``shards`` (a mesh's, in shard order): (combined max, clamped
    neigh_max, idx_at_max, move)."""
    devs = [CPU] * len(shards)
    nm_parts, gns = [], []
    for sh in shards:
        if sh.N:
            nm, *gn = K.shard_route_gains_plain(sh, gain)
        else:
            nm, gn = torch.zeros_like(gain), None
        nm_parts.append(nm)
        gns.append(gn)
    maxed = all_max(nm_parts, devs)[0]
    neigh_max = torch.clamp_min(maxed, 0.0)
    idx = all_min([K.tiebreak_idx_partial(sh, neigh_max, *gn) if sh.N
                   else torch.full_like(gain, K.BIG_IDX)
                   for sh, gn in zip(shards, gns)], devs)[0]
    return maxed, neigh_max, idx, K.mgm_decision(gain, idx_row, neigh_max,
                                                 idx)


@pytest.mark.parametrize("kind", GAINS)
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_plain_equals_per_shard_composition(name, n_shards, kind):
    packs = _packs(name, n_shards)
    g = packs.groups[0]
    assert g.whole and g.mixed == (name in ("ising_grid", "secp_small"))
    gain = _gain(kind, packs.Vp, seed=n_shards)
    row = packs.common_on(CPU)[2]
    maxed, neigh_max, idx, move = _composition(packs.shards, gain, row)
    for fn in (K.device_mgm_move, K.device_mgm_move_plain):
        got = fn(g, gain, row)
        assert got.dtype == torch.bool and torch.equal(got, move)
        assert torch.equal(fn(g, gain, mode="max"), maxed)
        assert torch.equal(fn(g, gain, mode="min", neigh_max=neigh_max),
                           idx)
    if kind == "zero":
        assert not move.any()
    if kind == "eps_ties":  # some column's gain ties its max within EPS
        tie = ((gain - neigh_max).abs() <= K.EPS) & (gain != neigh_max)
        assert bool((tie & (gain > 0)).any())


def _round_robin(devices):
    """Two groups on the CPU, as on two cards: even and odd shards."""
    n = len(devices)
    return [list(range(0, n, 2)), list(range(1, n, 2))]


@pytest.mark.parametrize("kind", GAINS)
@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("name", ["random_60", "secp_small"])
def test_two_groups_modes_combine_to_the_composition(name, n_shards, kind,
                                                     monkeypatch):
    """The shards in two groups: each group's "max" is the ordered max of
    its shards' partials, each group's "min" the ordered min of its
    shards' tie-break partials at the combined max, and combined across
    the groups with the decision after them they give the whole mesh's
    composition; the engine's arbitration runs the same steps."""
    whole = _packs(name, n_shards)
    gain = _gain(kind, whole.Vp, seed=n_shards + 1)
    row = whole.common_on(CPU)[2]
    maxed, neigh_max, idx, move = _composition(whole.shards, gain, row)
    monkeypatch.setattr(packed_mesh, "_device_groups", _round_robin)
    packs = _packs(name, n_shards)
    assert [g.whole for g in packs.groups] == [False, False]
    devs = [CPU, CPU]
    parts = [K.device_mgm_move(g, gain, mode="max") for g in packs.groups]
    for g, part in zip(packs.groups, parts):
        want = all_max([K.shard_route_gains_plain(sh, gain)[0] if sh.N
                        else torch.zeros_like(gain) for sh in g.shards],
                       [CPU] * len(g.shards))[0]
        assert torch.equal(part, want)
    assert torch.equal(all_max(parts, devs)[0], maxed)
    parts = [K.device_mgm_move(g, gain, mode="min", neigh_max=neigh_max)
             for g in packs.groups]
    assert torch.equal(all_min(parts, devs)[0], idx)
    assert torch.equal(K.mgm_decision(gain, row, neigh_max,
                                      all_min(parts, devs)[0]), move)
    eng = ShardedLocalSearch(_graph(name), [CPU] * n_shards, rule="mgm")
    assert [g.whole for g in eng.groups] == [False, False]
    assert all(torch.equal(m, move) for m in eng._mgm_move([gain, gain]))
    with pytest.raises(ValueError):
        K.device_mgm_move(packs.groups[0], gain, row)  # not a whole group


def _parent_mgm_move(eng, gains):
    """The engine's ``_mgm_move`` before K8 launched once per device: the
    per-shard composition over every group's shards."""
    shards = [sh for g in eng.groups for sh in g.shards]
    order = [s for g in eng.groups for s in g.index]
    shards = [sh for _, sh in sorted(zip(order, shards))]
    move = _composition(shards, gains[0], eng.packs.common_on(CPU)[2])[3]
    return [move] * len(eng.groups)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_engine_200_cycles_equal_the_per_shard_composition(name, split,
                                                           monkeypatch):
    t = _graph(name)
    if split:
        monkeypatch.setattr(packed_mesh, "_device_groups", _round_robin)
    # the dense combine: the composition below replicates group 0's
    # gains, which the compact modes' per-group views are not
    eng = ShardedLocalSearch(t, [CPU] * 8, rule="mgm", overlap="off")
    got = eng.run(200, seed=3)
    monkeypatch.setattr(eng, "_mgm_move",
                        functools.partial(_parent_mgm_move, eng))
    assert np.array_equal(got, eng.run(200, seed=3))
    # and the default (compact at a low cut) is the same run
    assert np.array_equal(
        got, ShardedLocalSearch(t, [CPU] * 8, rule="mgm").run(200, seed=3))


def test_wrapper_checks_its_modes():
    packs = _packs("secp_small", 4)
    g = packs.groups[0]
    gain, row = torch.zeros(packs.Vp), packs.common_on(CPU)[2]
    for kwargs in (dict(mode="sum"), dict(idx_row=None),
                   dict(mode="max", idx_row=row),
                   dict(mode="min"), dict(mode="max", neigh_max=gain),
                   dict(idx_row=row, neigh_max=gain)):
        with pytest.raises(ValueError):
            K.device_mgm_move(g, gain, **kwargs)
    with pytest.raises(TypeError):
        K.device_mgm_move(g, gain.double(), row)
    with pytest.raises(ValueError):
        K.device_mgm_move(g, gain, row[:-1])
