"""The port's content addressing (``dcop/canonical.py``) and structural
featurizer (``portfolio/features.py``) held to the JAX package's on the
CPU.

* ``canonical_bytes``/``canonical_hash``, ``shape_signature``,
  ``constraint_digest(s)`` and ``params_key`` equal JAX's strings byte
  for byte on all six test instances, on copies with every section
  declared in another order, on copies with a table edited, a constraint
  added or removed, and on seeded colourings — a persisted memo entry
  is keyed by them, so either package must find the other's;
* ``factor_diff`` equals JAX's on those edits;
* the determinism contracts of JAX's ``tests/unit/test_memo.py``
  (``TestCanonicalDeterminism``) hold in the port: no global RNG
  consulted, declaration order and the instance name excluded, distinct
  instances never collide, a table edit changes the hash but not the
  shape;
* ``featurize`` / ``featurize_detail`` equal JAX's vectors and info
  dicts on all six instances and the colourings, exactly (tolerance 0:
  the same float64 arithmetic, cast once to float32).
"""
import os
import random

import numpy as np
import pytest

import pydcop_tpu.dcop as jdc
import pydcop_tpu_torch.dcop as tdc
from pydcop_tpu.dcop import canonical as jc
from pydcop_tpu.portfolio import features as jf
from pydcop_tpu_torch.dcop import canonical as tc
from pydcop_tpu_torch.portfolio import features as tf
from pydcop_tpu_torch.runtime.repair import perturbed_constraint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANCES = os.path.join(ROOT, "tests", "instances")
NAMES = ["graph_coloring_tuto", "coloring_csp", "coloring_intention",
         "ising_grid", "meeting_scheduling", "secp_small"]


def _colouring_yaml(n=10, seed=3):
    from pydcop_tpu.dcop.yamldcop import dcop_yaml
    from pydcop_tpu.generators import generate_graph_coloring

    return dcop_yaml(generate_graph_coloring(
        n_variables=n, n_colors=3, n_edges=2 * n - 2, soft=True,
        seed=seed))


def _pair(name=None, yaml=None):
    if name is not None:
        path = os.path.join(INSTANCES, name + ".yaml")
        return jdc.load_dcop_from_file(path), tdc.load_dcop_from_file(path)
    return jdc.load_dcop(yaml), tdc.load_dcop(yaml)


def _same_strings(j, t):
    assert tc.canonical_bytes(t) == jc.canonical_bytes(j)
    assert tc.canonical_hash(t) == jc.canonical_hash(j)
    assert tc.shape_signature(t) == jc.shape_signature(j)
    assert tc.constraint_digests(t) == jc.constraint_digests(j)
    for name in t.constraints:
        assert tc.constraint_fingerprint(t.constraints[name]) == \
            jc.constraint_fingerprint(j.constraints[name])


def _permuted(dcop, seed=5):
    """The same DCOP with every name-keyed section declared in a
    shuffled order."""
    out = type(dcop)(dcop.name, objective=dcop.objective,
                     description=dcop.description)
    rnd = random.Random(seed)
    for attr in ("domains", "variables", "external_variables",
                 "constraints", "agents"):
        items = list(getattr(dcop, attr).items())
        rnd.shuffle(items)
        getattr(out, attr).update(items)
    out.dist_hints = dcop.dist_hints
    return out


class TestHashesEqualJax:
    @pytest.mark.parametrize("name", NAMES)
    def test_instance_strings(self, name):
        j, t = _pair(name)
        _same_strings(j, t)
        assert tc.canonical_hash(_permuted(t)) == jc.canonical_hash(j)

    @pytest.mark.parametrize("name", NAMES)
    def test_edited_copies(self, name):
        j, t = _pair(name)
        jn, tn = sorted(j.constraints), sorted(t.constraints)
        assert jn == tn
        k = tn[len(tn) // 2]
        t.constraints[k] = perturbed_constraint(t.constraints[k], seed=7)
        from pydcop_tpu.runtime.repair import perturbed_constraint as jp

        j.constraints[k] = jp(j.constraints[k], seed=7)
        removed = tn[0]
        del t.constraints[removed], j.constraints[removed]
        _same_strings(j, t)
        j0, t0 = _pair(name)
        jd = jc.factor_diff(jc.constraint_digests(j0), j)
        td = tc.factor_diff(tc.constraint_digests(t0), t)
        assert vars(td) == vars(jd)
        assert td.as_dict() == jd.as_dict()
        assert td.removed == [removed] and k in td.changed

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_colourings(self, seed):
        j, t = _pair(yaml=_colouring_yaml(seed=seed))
        _same_strings(j, t)

    def test_params_key(self):
        for params in (None, {}, {"noise": 0.0, "damping": 0.5},
                       {"variant": "B", "probability": 0.7}):
            assert tc.params_key(params) == jc.params_key(params)


class TestCanonicalDeterminism:
    def test_byte_identical_under_rng_poisoning(self):
        y = _colouring_yaml()
        random.seed(13)
        np.random.seed(7)
        b1 = tc.canonical_bytes(tdc.load_dcop(y))
        random.seed(7919 * 2 + 13)
        np.random.seed(104729 * 2 + 7)
        assert tc.canonical_bytes(tdc.load_dcop(y)) == b1

    def test_yaml_round_trip_and_name_excluded(self):
        d = tdc.load_dcop(_colouring_yaml())
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        assert tc.canonical_hash(tdc.load_dcop(dcop_yaml(d))) == \
            tc.canonical_hash(d)
        d2 = tdc.load_dcop(_colouring_yaml())
        d2.name = "a-completely-different-label"
        assert tc.canonical_hash(d2) == tc.canonical_hash(d)

    def test_different_instances_never_collide(self):
        seen = {tc.canonical_hash(tdc.load_dcop(_colouring_yaml(seed=s)))
                for s in range(6)}
        assert len(seen) == 6

    def test_single_table_edit_changes_hash_not_shape(self):
        d = tdc.load_dcop(_colouring_yaml())
        v = tdc.load_dcop(_colouring_yaml())
        name = sorted(v.constraints)[2]
        v.constraints[name] = perturbed_constraint(v.constraints[name],
                                                   seed=9)
        assert tc.canonical_hash(d) != tc.canonical_hash(v)
        assert tc.shape_signature(d) == tc.shape_signature(v)
        diff = tc.factor_diff(tc.constraint_digests(d), v)
        assert diff.changed == [name] and diff.edits == 1

    def test_factor_diff_added_removed(self):
        d = tdc.load_dcop(_colouring_yaml())
        v = tdc.load_dcop(_colouring_yaml())
        name = sorted(v.constraints)[0]
        c = v.constraints.pop(name)
        diff = tc.factor_diff(tc.constraint_digests(d), v)
        assert diff.removed == [name] and diff.edits == 1
        v.constraints[name] = c
        assert tc.factor_diff(tc.constraint_digests(v), d).edits == 0


class TestFeaturizerEqualsJax:
    @pytest.mark.parametrize("name", NAMES)
    def test_instances(self, name):
        j, t = _pair(name)
        jv, ji = jf.featurize_detail(j)
        tv, ti = tf.featurize_detail(t)
        assert tv.dtype == np.float32 and tv.shape == (tf.N_FEATURES,)
        assert np.array_equal(tv, jv)
        assert ti == ji
        assert np.array_equal(tf.featurize(t), jf.featurize(j))

    @pytest.mark.parametrize("n", [10, 60])
    def test_colourings(self, n):
        j, t = _pair(yaml=_colouring_yaml(n=n, seed=n))
        assert np.array_equal(tf.featurize(t), jf.featurize(j))

    def test_names_and_structural_buckets(self):
        assert tf.FEATURE_NAMES == jf.FEATURE_NAMES
        assert tf.REFERENCE_SHARDS == jf.REFERENCE_SHARDS
        j, t = _pair("secp_small")
        jb, jn = jf.structural_buckets(j)
        tb, tn = tf.structural_buckets(t)
        assert jn == tn and len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert np.array_equal(a, b)

    def test_quant_threshold_is_the_jax_constant(self):
        from pydcop_tpu.ops.compile import QUANT_THRESHOLD

        assert tf.QUANT_THRESHOLD == QUANT_THRESHOLD
