"""Canonical byte form + content addressing for DCOP instances.

The port of the JAX package's ``dcop/canonical.py``, without its
structured branch (the port's loader refuses ``type: structured``).  The
cross-request solution cache (:mod:`pydcop_tpu_torch.serve.memo`) keys
entries on *content*, not on the submitted object, so two requests
carrying the same problem hit the same cache line no matter how the
instance was built, named, or ordered.  Every hash here equals the JAX
package's byte for byte: a persisted cache entry is keyed by them, and
either package reads the other's entries.  Three layers of identity,
from strict to loose:

* :func:`canonical_hash` — sha256 over a deterministic JSON form of
  the full instance (objective, sorted domain/variable/external/agent
  sections, per-constraint content digests).  Declaration order never
  leaks in (every section is name-sorted), the instance ``name`` /
  ``description`` metadata never leaks in, and no global RNG is
  consulted — the exact-duplicate key.
* :func:`shape_signature` — the same digest restricted to the
  variable/domain skeleton (objective + domains + variables +
  externals).  Two instances with equal shape signatures differ only
  in their factor set, which is precisely the precondition for the
  warm-mutation replay — the variant-feasibility gate.
* :func:`factor_diff` — the factor-level delta between a cached
  instance (its stored name→digest map) and a fresh one: which
  constraints changed content, appeared, or vanished.  The memo layer
  replays this as an EditFactor/AddFactor/RemoveFactor mutation
  stream, so a k-edit variant costs k warm repairs.

Constraint digests prefer the cheapest exact content form available:
intentional constraints hash their expression string, and only plain
extensional tables hash the dense float64 tensor bytes.  Distinct
forms deliberately hash distinct — a semantically-equal table and
expression missing each other only costs a cache miss, never a wrong
hit.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP

__all__ = [
    "FactorDiff",
    "canonical_bytes",
    "canonical_hash",
    "constraint_digest",
    "constraint_digests",
    "constraint_fingerprint",
    "factor_diff",
    "params_key",
    "shape_signature",
]


def _jsonable(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (tuple, set, frozenset)):
        return sorted(o) if isinstance(o, (set, frozenset)) else list(o)
    raise TypeError(f"not canonicalizable: {type(o).__name__}")


#: ``json.dumps(obj, sort_keys=True, separators=(",", ":"),
#: default=_jsonable)``, built once: ``dumps`` builds an encoder a call,
#: and a digest a table made that a third of a request's hashing
_ENCODER = json.JSONEncoder(sort_keys=True, separators=(",", ":"),
                            default=_jsonable)


def _dumps(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace, numpy coerced."""
    return _ENCODER.encode(obj)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def params_key(algo_params) -> str:
    """Canonical string form of an algo-params dict (order-free)."""
    return _dumps(dict(algo_params or {}))


# ---------------------------------------------------------------------------
# constraint content
# ---------------------------------------------------------------------------


def constraint_fingerprint(c) -> bytes:
    """Canonical byte form of ONE constraint's content.

    Scope order is preserved (it defines the table's axis order — a
    transposed table is a different constraint); the containing
    instance's declaration order is not this function's concern.
    """
    expr = getattr(c, "expression", None)
    if expr is not None:
        body = {
            "form": "intention",
            "scope": list(c.scope_names),
            "expr": str(expr),
        }
    else:
        t = np.ascontiguousarray(
            np.asarray(c.to_tensor(), dtype=np.float64))
        body = {
            "form": "table",
            "scope": list(c.scope_names),
            "shape": list(t.shape),
            "sha": _sha(t.tobytes()),
        }
    return _dumps(body).encode("utf-8")


def constraint_digest(c) -> str:
    """sha256 hex digest of :func:`constraint_fingerprint`."""
    return _sha(constraint_fingerprint(c))


def constraint_digests(dcop: DCOP) -> Dict[str, str]:
    """name → content digest for every constraint of ``dcop``."""
    return {name: constraint_digest(c)
            for name, c in dcop.constraints.items()}


# ---------------------------------------------------------------------------
# instance skeleton + full canonical form
# ---------------------------------------------------------------------------


def _skeleton(dcop: DCOP) -> Dict[str, Any]:
    """The variable/domain skeleton sections (sorted by name)."""
    from pydcop_tpu_torch.dcop.objects import (
        VariableNoisyCostFunc,
        VariableWithCostFunc,
    )
    from pydcop_tpu_torch.utils.expressions import ExpressionFunction

    variables: Dict[str, Any] = {}
    for v in dcop.variables.values():
        vd: Dict[str, Any] = {"domain": v.domain.name}
        if v.initial_value is not None:
            vd["initial_value"] = v.initial_value
        if isinstance(v, VariableWithCostFunc) and isinstance(
            v.cost_func, ExpressionFunction
        ):
            vd["cost_function"] = v.cost_func.expression
        if isinstance(v, VariableNoisyCostFunc):
            vd["noise_level"] = v.noise_level
        variables[v.name] = vd
    return {
        "objective": dcop.objective,
        "domains": {
            d.name: {"type": d.type, "values": list(d.values)}
            for d in dcop.domains.values()
        },
        "variables": variables,
        "external": {
            v.name: {"domain": v.domain.name, "value": v.value}
            for v in dcop.external_variables.values()
        },
    }


def shape_signature(dcop: DCOP) -> str:
    """Digest of the variable/domain skeleton — the warm-replay
    feasibility gate: equal signatures ⇒ the instances differ only in
    factors, so a cached assignment is a valid seed and the factor
    diff is expressible as fixed-shape mutations."""
    return _sha(_dumps(_skeleton(dcop)).encode("utf-8"))


def canonical_bytes(dcop: DCOP,
                    digests: Optional[Dict[str, str]] = None) -> bytes:
    """Deterministic byte form of the full instance content.

    Name-sorted sections (via ``sort_keys``) make declaration-order
    permutations byte-identical; ``name``/``description`` metadata is
    excluded — it does not change the problem being solved.
    ``digests`` (:func:`constraint_digests` of ``dcop``, already computed
    by the caller) saves hashing every table again.
    """
    if digests is None:
        digests = constraint_digests(dcop)
    body = _skeleton(dcop)
    body["constraints"] = {
        name: {"scope": list(c.scope_names), "digest": digests[name]}
        for name, c in dcop.constraints.items()
    }
    body["agents"] = {
        a.name: ({"capacity": a.capacity}
                 if a.capacity is not None else {})
        for a in dcop.agents.values()
    }
    return _dumps(body).encode("utf-8")


def canonical_hash(dcop: DCOP,
                   digests: Optional[Dict[str, str]] = None) -> str:
    """sha256 hex of :func:`canonical_bytes` — the exact-duplicate key."""
    return _sha(canonical_bytes(dcop, digests))


# ---------------------------------------------------------------------------
# factor-level diff
# ---------------------------------------------------------------------------


@dataclass
class FactorDiff:
    """Factor delta between a cached instance and a fresh submission.

    ``changed``/``added``/``removed`` are constraint names relative to
    the NEW instance (``changed`` = same name, different content
    digest; ``added`` = only in new; ``removed`` = only in cached).
    """

    changed: List[str] = field(default_factory=list)
    added: List[str] = field(default_factory=list)
    removed: List[str] = field(default_factory=list)

    @property
    def edits(self) -> int:
        return len(self.changed) + len(self.added) + len(self.removed)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "edits": self.edits,
            "changed": len(self.changed),
            "added": len(self.added),
            "removed": len(self.removed),
        }


def factor_diff(old_digests: Dict[str, str], new_dcop: DCOP,
                new_digests: Dict[str, str] = None) -> FactorDiff:
    """Diff a cached instance's name→digest map against ``new_dcop``."""
    if new_digests is None:
        new_digests = constraint_digests(new_dcop)
    diff = FactorDiff()
    for name in sorted(new_digests):
        if name not in old_digests:
            diff.added.append(name)
        elif old_digests[name] != new_digests[name]:
            diff.changed.append(name)
    diff.removed = sorted(n for n in old_digests if n not in new_digests)
    return diff
