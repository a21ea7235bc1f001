"""The port's generic MaxSum engine against the JAX package's
``maxsum_cycle``, on every test instance (the mixed-arity ``ising_grid``
and ``secp_small`` included).  Both packages run on the very same
compiled arrays (compiled once by the JAX package and carried over with
``tensors_from_numpy``) and the same random initial messages, for 5
cycles at damping 0.5.  Tolerance: messages and beliefs within atol 1e-4
(float32 sums taken in another order), values exactly."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.dcop import load_dcop_from_file as jax_load_dcop
from pydcop_tpu.ops.compile import compile_factor_graph as jax_compile
from pydcop_tpu.ops.maxsum_kernels import maxsum_cycle as jax_maxsum_cycle
from pydcop_tpu_torch.ops.compile import numpy_fields, tensors_from_numpy
from pydcop_tpu_torch.ops.maxsum_kernels import init_messages, maxsum_cycle
from pydcop_tpu_torch.ops.segments import masked_argmin, segment_sum

torch.set_num_threads(1)

INSTANCES = os.path.join(os.path.dirname(__file__), "instances")
NAMES = ["coloring_csp", "coloring_intention", "graph_coloring_tuto",
         "ising_grid", "meeting_scheduling", "secp_small"]


@pytest.mark.parametrize("name", NAMES)
def test_generic_cycles_match_jax(name):
    jt = jax_compile(jax_load_dcop(os.path.join(INSTANCES, name + ".yaml")))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    rng = np.random.default_rng(11)
    E, D = t.n_edges, t.max_domain_size
    mask = t.domain_mask[t.edge_var].numpy()
    q0 = (rng.normal(0, 1, (E, D)) * mask).astype(np.float32)
    r0 = (rng.normal(0, 1, (E, D)) * mask).astype(np.float32)
    jq, jr = jnp.asarray(q0), jnp.asarray(r0)
    q, r = torch.from_numpy(q0), torch.from_numpy(r0)
    for _ in range(5):
        jq, jr, jbel, jvals = jax_maxsum_cycle(jt, jq, jr, damping=0.5)
        q, r, bel, vals = maxsum_cycle(t, q, r, damping=0.5)
    assert np.allclose(q.numpy(), np.asarray(jq), atol=1e-4)
    assert np.allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    assert np.allclose(bel.numpy(), np.asarray(jbel), atol=1e-4)
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


def test_init_messages_are_zero_and_separate():
    jt = jax_compile(jax_load_dcop(
        os.path.join(INSTANCES, "graph_coloring_tuto.yaml")))
    t = tensors_from_numpy(numpy_fields(jt), device="cpu")
    q, r = init_messages(t)
    assert q.shape == (t.n_edges, t.max_domain_size)
    assert not q.any() and not r.any()
    assert q.data_ptr() != r.data_ptr()


def test_masked_argmin_takes_first_of_equal_minima():
    # jnp.argmin's tie rule: the first index among equal minima
    x = torch.tensor([[1.0, 0.0, 0.0], [2.0, 2.0, 2.0], [5.0, 3.0, -1.0]])
    mask = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 0.0]])
    assert masked_argmin(x, mask).tolist() == [1, 0, 1]


def test_segment_sum_adds_rows_per_segment():
    data = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([2, 0, 2, 1])
    out = segment_sum(data, ids, 4)
    assert out.tolist() == [[3, 4, 5], [9, 10, 11], [6, 8, 10], [0, 0, 0]]
