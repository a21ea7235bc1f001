"""The port's compile step against the JAX package's, on every test
instance: the compiled arrays must be EXACTLY equal (same layout, same
padding, same float32 values), and ``tensors_from_numpy`` must carry a
compiled graph across packages and back without change."""
import os

import numpy as np
import pytest
import torch

from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu_torch.dcop import load_dcop_from_file
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import (
    compile_factor_graph,
    numpy_fields,
    tensors_from_numpy,
)

torch.set_num_threads(1)

INSTANCES = os.path.join(os.path.dirname(__file__), "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]


def _path(name):
    return os.path.join(INSTANCES, name + ".yaml")


def assert_fields_equal(a, b):
    """Exact equality of two ``numpy_fields`` dicts."""
    assert a["var_names"] == b["var_names"]
    assert a["domain_values"] == b["domain_values"]
    assert a["factor_names"] == b["factor_names"]
    assert a["sign"] == b["sign"]
    for k in ("domain_sizes", "domain_mask", "unary_costs", "edge_var",
              "initial_values", "has_initial"):
        assert np.array_equal(a[k], b[k]), k
    assert len(a["buckets"]) == len(b["buckets"])
    for ba, bb in zip(a["buckets"], b["buckets"]):
        assert ba["arity"] == bb["arity"]
        assert ba["edge_offset"] == bb["edge_offset"]
        assert ba["tensors"].dtype == bb["tensors"].dtype == np.float32
        for k in ("tensors", "var_idx", "factor_ids"):
            assert np.array_equal(ba[k], bb[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_compile_matches_jax_exactly(name):
    ref = numpy_fields(jax_compile(jax_load_dcop(_path(name))))
    got = numpy_fields(
        compile_factor_graph(load_dcop_from_file(_path(name)), device="cpu"))
    assert_fields_equal(ref, got)


@pytest.mark.parametrize("name", NAMES)
def test_tensors_from_numpy_round_trips(name):
    ref = numpy_fields(jax_compile(jax_load_dcop(_path(name))))
    t = tensors_from_numpy(ref, device="cpu")
    assert t.device.type == "cpu"
    assert_fields_equal(ref, numpy_fields(t))
    # and back through the port's own fields
    assert_fields_equal(numpy_fields(t),
                        numpy_fields(tensors_from_numpy(numpy_fields(t),
                                                        device="cpu")))


def test_unported_tiers_are_refused():
    fields = numpy_fields(
        compile_factor_graph(load_dcop_from_file(_path("graph_coloring_tuto")),
                             device="cpu"))
    with pytest.raises(NotPortedError):
        tensors_from_numpy(dict(fields, sbuckets=[object()]), device="cpu")
    b0 = dict(fields["buckets"][0], qscale=np.ones(1, np.float32))
    with pytest.raises(NotPortedError):
        tensors_from_numpy(dict(fields, buckets=[b0]), device="cpu")


def test_structured_constraints_are_refused():
    from pydcop_tpu_torch.dcop import load_dcop

    with pytest.raises(NotPortedError):
        load_dcop("""
name: s
objective: min
domains: {d: {values: [0, 1]}}
variables: {x: {domain: d}, y: {domain: d}}
constraints:
  c: {type: structured, variables: [x, y], params: {kind: sum}}
agents: [a1]
""")


@pytest.mark.parametrize("name", NAMES)
def test_total_cost_matches_jax(name):
    import jax.numpy as jnp

    from pydcop_tpu.ops.compile import total_cost as jax_total_cost
    from pydcop_tpu_torch.ops.compile import total_cost

    jt = jax_compile(jax_load_dcop(_path(name)))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(3):
        x = (rng.uniform(0, 1, t.n_vars) * t.domain_sizes).astype(np.int64)
        ref = float(jax_total_cost(jt, jnp.asarray(x)))
        got = float(total_cost(t, torch.from_numpy(x)))
        # float32 sums over a few dozen factors, in another order
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-4)
