"""Structural instance featurizer (the learned portfolio's, and the
solution cache's variant ranking).

The port of the featurizer half of the JAX package's
``portfolio/features.py``: ``FEATURE_NAMES``, ``structural_buckets``,
``featurize_detail`` and ``featurize``, numpy only.  One fixed-length
feature vector per DCOP instance, computed WITHOUT building any cost or
util table: everything here is derived from the problem's *shape* —
variable/factor counts, domain sizes, the arity histogram, degree
statistics, the pseudo-tree's induced width and separator-size profile
(``graph/pseudotree.py``), the reference-partition boundary/cut
fractions (``parallel/boundary.py::analyze_boundary`` over an 8-shard
locality partition, ``parallel/partition.py::partition_factors``) and
the DPOP planner's byte estimates
(``ops/dpop_shard.py::estimate_sweep_bytes``, itself a pure shape pass).
The serve tier's memo (``serve/memo.py``) ranks cached instances by the
distance between these vectors.

The port's loader refuses structured (table-free) constraints, so their
three features (the structured fraction and the two structured byte
totals) read 0 and the dense byte total counts every factor's table.
The config encoding (``encode_config``, ``pair_vector``) waits for the
rest of the portfolio (ROADMAP A9).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

#: reference shard count for the boundary/cut features: the partition
#: quality signal must be comparable across instances, so it is always
#: measured against the same hypothetical mesh width (the boundary
#: analysis is a pure host shape pass — no device mesh is built)
REFERENCE_SHARDS = 8

#: cost at or above which a table entry is a hard constraint (the JAX
#: package's ``ops/compile.py::QUANT_THRESHOLD``): the int8 routing
#: signal is False for a table that holds one
QUANT_THRESHOLD = 1e4

FEATURE_NAMES: Tuple[str, ...] = (
    "log1p_n_vars",
    "log1p_n_factors",
    "log1p_n_agents",
    "factor_var_ratio",
    "dom_min",
    "dom_mean",
    "dom_max",
    "arity1_frac",
    "arity2_frac",
    "arity3p_frac",
    "max_arity",
    "deg_mean",
    "log1p_deg_max",
    "tree_depth_frac",
    "induced_width",
    "sep_mean",
    "sep_p90",
    "log10_sweep_bytes",
    "log10_max_node_entries",
    "cut_fraction_8",
    "boundary_fraction_8",
    "objective_is_max",
    "structured_frac",
    "log10_dense_table_bytes",
    "log10_structured_dense_bytes",
)

N_FEATURES = len(FEATURE_NAMES)

def structural_buckets(dcop) -> Tuple[List[np.ndarray], int]:
    """Arity-bucketed factor scopes as variable-index arrays — the
    SAME shape the partitioner and boundary analysis consume, built
    straight from the constraint scopes (no table extraction).
    Returns ``(var_idx_per_bucket, n_vars)``; each bucket is an
    ``[n_factors, arity]`` int32 array."""
    var_index = {name: i for i, name in enumerate(dcop.variables)}
    by_arity: Dict[int, List[List[int]]] = {}
    for c in dcop.constraints.values():
        idx = [
            var_index[v.name] for v in c.dimensions
            if v.name in var_index
        ]
        if idx:
            by_arity.setdefault(len(idx), []).append(idx)
    buckets = [
        np.asarray(rows, dtype=np.int32)
        for _, rows in sorted(by_arity.items())
    ]
    return buckets, len(var_index)


def featurize_detail(dcop, n_shards: int = REFERENCE_SHARDS):
    """Compute the feature vector AND the raw structural numbers the
    selection policy needs (planner byte estimates, induced width,
    cut fraction, ...).  Returns ``(vector [N_FEATURES] float32,
    info dict)``.  Never builds a cost or util table."""
    from pydcop_tpu_torch.graph import pseudotree as pt
    from pydcop_tpu_torch.ops.dpop_shard import estimate_sweep_bytes
    from pydcop_tpu_torch.parallel.boundary import analyze_boundary
    from pydcop_tpu_torch.parallel.partition import partition_factors

    n_vars = len(dcop.variables)
    n_factors = len(dcop.constraints)
    n_agents = len(dcop.agents)

    # table-free structure census: the port has no structured
    # constraints (its loader refuses them), so the structured counts
    # stay 0 and every factor adds its dense table's ANALYTIC bytes —
    # pure arithmetic on domain sizes
    n_structured = 0
    structured_kinds: Dict[str, int] = {}
    dense_table_bytes = 0.0
    structured_dense_bytes = 0.0
    structured_over_cap = False
    # int8 routing signal: per-factor quantization is
    # LOSSLESS exactly when every table is integer-valued with its
    # value range inside the 253 usable code levels (scale <= 1 →
    # round-trip error < 0.5 → argmins preserved) and free of
    # hard/BIG entries, which would pin to the saturation code.
    # Anything unknown — a structured constraint, a relation type
    # that exposes no materialized matrix — keeps the signal False:
    # the `solve --auto` mask is conservative by construction.
    # Scans only matrices the relations ALREADY hold; builds nothing.
    int8_safe = True
    for c in dcop.constraints.values():
        b = 4.0
        for v in c.dimensions:
            b *= len(v.domain)
        dense_table_bytes += b
        if int8_safe:
            m = getattr(c, "matrix", None)
            if m is None:
                int8_safe = False
            else:
                m = np.asarray(m, dtype=np.float64)
                if (m.size == 0
                        or not np.all(np.isfinite(m))
                        or float(m.max()) >= QUANT_THRESHOLD
                        or not np.allclose(
                            m, np.round(m), atol=1e-6)
                        or float(m.max() - m.min()) > 253.0):
                    int8_safe = False

    dom_sizes = np.asarray(
        [len(v.domain) for v in dcop.variables.values()] or [1],
        dtype=np.float64,
    )

    arities = np.zeros(3, dtype=np.float64)  # [1, 2, 3+]
    max_arity = 0
    degree = np.zeros(max(1, n_vars), dtype=np.int64)
    buckets, _nv = structural_buckets(dcop)
    for b in buckets:
        a = int(b.shape[1])
        max_arity = max(max_arity, a)
        arities[min(a, 3) - 1] += b.shape[0]
        np.add.at(degree, b.reshape(-1), 1)
    total_f = max(1.0, float(arities.sum()))

    tree = pt.build_computation_graph(dcop)
    sep = tree.separators()
    sep_sizes = np.asarray(
        [len(s) for s in sep.values()] or [0], dtype=np.float64
    )
    induced_width = float(sep_sizes.max())
    est = estimate_sweep_bytes(tree)

    cut_fraction = 0.0
    boundary_fraction = 0.0
    if buckets and n_vars:
        assigns = partition_factors(buckets, n_vars, n_shards)
        info_b = analyze_boundary(buckets, assigns, n_vars, n_shards)
        cut_fraction = float(info_b.cut_fraction)
        boundary_fraction = float(info_b.boundary_fraction)

    vec = np.asarray([
        np.log1p(n_vars),
        np.log1p(n_factors),
        np.log1p(n_agents),
        n_factors / max(1, n_vars),
        float(dom_sizes.min()),
        float(dom_sizes.mean()),
        float(dom_sizes.max()),
        arities[0] / total_f,
        arities[1] / total_f,
        arities[2] / total_f,
        float(max_arity),
        float(degree.mean()),
        np.log1p(float(degree.max())),
        (tree.height + 1) / max(1, n_vars),
        induced_width,
        float(sep_sizes.mean()),
        float(np.percentile(sep_sizes, 90)),
        np.log10(max(4.0, float(est["bytes"]))),
        np.log10(max(1.0, float(est["max_node_entries"]))),
        cut_fraction,
        boundary_fraction,
        1.0 if dcop.objective == "max" else 0.0,
        n_structured / max(1, n_factors),
        np.log10(max(4.0, dense_table_bytes)),
        np.log10(max(4.0, structured_dense_bytes)),
    ], dtype=np.float32)
    assert vec.shape == (N_FEATURES,)

    info = {
        "n_vars": n_vars,
        "n_factors": n_factors,
        "max_arity": max_arity,
        "max_domain": int(dom_sizes.max()),
        "induced_width": int(induced_width),
        "sweep_bytes": int(est["bytes"]),
        "max_node_entries": int(est["max_node_entries"]),
        "cut_fraction": float(cut_fraction),
        "boundary_fraction": float(boundary_fraction),
        "objective": dcop.objective,
        "n_structured": n_structured,
        "structured_kinds": structured_kinds,
        "structured_frac": n_structured / max(1, n_factors),
        "dense_table_bytes": float(dense_table_bytes),
        "structured_dense_bytes": float(structured_dense_bytes),
        "structured_over_table_cap": structured_over_cap,
        "int8_safe": bool(int8_safe and n_factors > 0),
    }
    return vec, info


def featurize(dcop, n_shards: int = REFERENCE_SHARDS) -> np.ndarray:
    """The fixed-length instance feature vector (float32,
    ``N_FEATURES`` entries, always finite)."""
    vec, _ = featurize_detail(dcop, n_shards=n_shards)
    return vec
