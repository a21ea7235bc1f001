"""The port's partitioner (``parallel/partition.py``, its BFS region growing
a numpy/Python copy of ``native/partition.cc``) against the JAX package's
``parallel/partition.py`` with its C++ library: the same factor→shard
assignments on both paths (``use_native=True`` and ``False``), the same
``partition_stats`` and ``assigns_from_distribution``, and the same
refusal of a placement that misses a computation.  All comparisons are
exact (integer arrays, and floats computed from the same counts)."""
import os

import numpy as np
import pytest

from pydcop_tpu import native
from pydcop_tpu.dcop import load_dcop_from_file as jax_load
from pydcop_tpu.distribution.objects import Distribution as JaxDistribution
from pydcop_tpu.distribution.objects import \
    ImpossibleDistributionException as JaxImpossible
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.parallel import partition as jax_partition
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.distribution import (
    Distribution,
    ImpossibleDistributionException,
    load_dist,
    yaml_dist,
)
from pydcop_tpu_torch.ops.compile import compile_factor_graph
from pydcop_tpu_torch.parallel import partition

INST = os.path.join(os.path.dirname(__file__), "instances")
INSTANCES = sorted(f[:-5] for f in os.listdir(INST) if f.endswith(".yaml"))


def _random_binary(V, F, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, V, F)
    ej = (ei + 1 + rng.integers(0, V - 1, F)) % V
    return [np.stack([ei, ej], axis=1).astype(np.int32)], V


def _star(leaves=300):
    vi = np.stack([np.zeros(leaves, np.int64), np.arange(1, leaves + 1)], 1)
    return [vi.astype(np.int32)], leaves + 1


def _islands(seed=4):
    # three disconnected components and isolated variables: the BFS
    # leaves a remainder for the least-loaded fill
    rng = np.random.default_rng(seed)
    blocks = []
    for off, n in ((0, 30), (40, 25), (80, 12)):
        ei = rng.integers(0, n, 2 * n) + off
        ej = (ei - off + 1 + rng.integers(0, n - 1, 2 * n)) % n + off
        blocks.append(np.stack([ei, ej], 1))
    return [np.concatenate(blocks).astype(np.int32)], 100


def _instance_buckets(name):
    t = jax_compile(jax_load(os.path.join(INST, name + ".yaml")))
    return [np.asarray(b.var_idx) for b in t.buckets], t.n_vars


GRAPHS = {
    "random_200_500": lambda: _random_binary(200, 500, 0),
    "random_1000_3000": lambda: _random_binary(1000, 3000, 1),
    "star_300": _star,
    "islands": _islands,
    **{f"instance_{n}": (lambda n=n: _instance_buckets(n))
       for n in INSTANCES},
}


def test_the_jax_native_library_loads():
    # the use_native=True comparisons below are against the C++ path
    assert native.native_available()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partition_equals_jax(graph, n_shards, use_native):
    buckets, V = GRAPHS[graph]()
    want = jax_partition.partition_factors(buckets, V, n_shards,
                                           use_native=use_native)
    got = partition.partition_factors(buckets, V, n_shards,
                                      use_native=use_native)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        assert np.array_equal(g, w)
    assert partition.partition_stats(buckets, got, n_shards) == \
        jax_partition.partition_stats(buckets, want, n_shards)


@pytest.mark.parametrize("seed", range(4))
def test_bfs_growing_equals_the_cpp_partitioner(seed):
    rng = np.random.default_rng(seed)
    V, E, parts = 300, 700, 2 + seed
    u = rng.integers(0, V, E)
    v = rng.integers(0, V, E)  # self-loops and repeats included
    want = native.partition_vertices(u, v, V, parts)
    assert np.array_equal(partition.bfs_growing(u, v, V, parts), want)


def _full_distribution(dcop, n_agents, cls):
    """Round-robin placement of every variable and constraint."""
    comps = sorted(dcop.variables) + sorted(dcop.constraints)
    agents = [f"a{i:02d}" for i in range(n_agents)]
    mapping = {a: [] for a in agents}
    for i, c in enumerate(comps):
        mapping[agents[i % n_agents]].append(c)
    return cls(mapping)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("name", INSTANCES)
def test_assigns_from_distribution_equal_jax(name, n_shards):
    path = os.path.join(INST, name + ".yaml")
    jd, d = jax_load(path), load_dcop_from_file([path])
    want = jax_partition.assigns_from_distribution(
        _full_distribution(jd, 5, JaxDistribution), jax_compile(jd),
        n_shards)
    dist = _full_distribution(d, 5, Distribution)
    # the YAML round trip of the port's copy keeps the placement
    assert load_dist(yaml_dist(dist)) == dist
    got = partition.assigns_from_distribution(
        dist, compile_factor_graph(d, device="cpu"), n_shards)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_missing_computation_fails_as_in_jax():
    path = os.path.join(INST, "graph_coloring_tuto.yaml")
    jd, d = jax_load(path), load_dcop_from_file([path])
    with pytest.raises(JaxImpossible) as want:
        jax_partition.assigns_from_distribution(
            JaxDistribution({"a0": ["v1"]}), jax_compile(jd), 4)
    with pytest.raises(ImpossibleDistributionException) as got:
        partition.assigns_from_distribution(
            Distribution({"a0": ["v1"]}),
            compile_factor_graph(d, device="cpu"), 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ImpossibleDistributionException, match="no agents"):
        partition.assigns_from_distribution(
            Distribution({}), compile_factor_graph(d, device="cpu"), 4)
