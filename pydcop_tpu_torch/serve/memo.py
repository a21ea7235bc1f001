"""Cross-request solution cache with embedding-matched warm starts.

The port of the JAX package's ``serve/memo.py``, whole; a fleet shares
entries between its replicas through ``on_insert`` (the thread fleet
adopts the entry into every peer's cache, the process fleet sends its
file's path to every peer).  Users do not submit only *novel* DCOPs — they submit
duplicates and k-edit variants, and every request would otherwise pay a
full solve.  This layer sits ABOVE the runner cache (which only reuses
*shapes*) and makes repeated traffic structurally cheaper:

* **exact hit** — the submitted instance is canonicalized
  (:mod:`pydcop_tpu_torch.dcop.canonical`, the JAX package's hashes byte
  for byte) and content-hashed; a hash match within the (tenant, algo,
  params, seed) namespace replays the cached result bit-identically,
  with no device work.
* **variant hit** — on a miss the instance is matched to the nearest
  cached solved instance (by the structural featurizer's vectors,
  :mod:`pydcop_tpu_torch.portfolio.features`, computed only when a
  candidate passes the gate) under a feasibility gate: identical
  variable/domain skeleton
  (:func:`~pydcop_tpu_torch.dcop.canonical.shape_signature`) and a
  factor diff of at most ``max_edits``.  The diff is replayed as an
  EditFactor/AddFactor/RemoveFactor mutation stream through the warm
  repair machinery (``runtime/repair.py::WarmRepairController``), the
  cached assignment seeds the solver state, and the repair converges
  in a handful of cycles — a k-edit variant costs k warm repairs
  instead of a cold solve.
* **never-worse guarantee** — a warm-started result is served only
  when its final cost is no worse than the cached seed assignment
  evaluated on the new problem; otherwise the caller falls back to a
  cold solve, so a cache hit can never degrade solution quality.  The
  warm path's own refusals — a :class:`~pydcop_tpu_torch.ops.headroom.
  HeadroomExhausted` beyond the controller's one repack, the
  ``ValueError``/``KeyError`` of a rejected mutation — are cold
  fallbacks too, counted.  Anything else (a CUDA error,
  ``torch.cuda.OutOfMemoryError``, ``DeviceUnavailableError``) is not
  the cache's to hide: it propagates, and the serve tier ends the job
  ERROR instead of quietly solving it cold.

Entries live in memory and — when a cache directory is configured —
as CRC'd npz containers (``runtime/checkpoint.py::write_state_npz``, the
JAX package's container, so either package reads the other's entries)
beside the job journal, so ``SolveService.resume()`` rehydrates the
cache after a crash; a corrupt entry is skipped-and-counted
(``corrupt_cache_entry`` fault kind), never served.  Results expire
after ``ttl_s`` and a churn event drops the affected tenant's namespace
outright.

Lock discipline: completion taps, the scheduler thread and adoption
callbacks all touch one cache, so every mutable map lives behind
``self._lock``; the expensive work (canonicalization, featurizing, the
warm repair itself) runs outside the lock on purpose.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.dcop.canonical import (
    FactorDiff,
    canonical_hash,
    constraint_digests,
    factor_diff,
    params_key,
    shape_signature,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.runtime.events import send_memo
from pydcop_tpu_torch.runtime.stats import MemoCounters

__all__ = ["MemoCache", "MemoConfig", "MemoEntry", "MemoProbe"]

#: cache directory name under a service's journal dir
MEMO_SUBDIR = "memo"


@dataclass
class MemoConfig:
    """Solution-cache policy knobs (docs/serving.rst)."""

    #: entry time-to-live; expired entries are dropped lazily at the
    #: next lookup (0 disables expiry)
    ttl_s: float = 3600.0
    #: variant feasibility gate: max factor-diff size replayed warm
    max_edits: int = 8
    #: LRU capacity (per cache = per service)
    max_entries: int = 512
    #: skip the featurizer embedding above this many variables (exact
    #: hits still work; variants rank by diff size only)
    featurize_max_vars: int = 20000
    #: warm-solver build knobs (ops/headroom seeding)
    warm_headroom: float = 0.25
    warm_min_free: int = 4
    #: cycle budget for the warm repair run
    warm_max_cycles: int = 300
    #: numeric slack for the never-worse cost gate
    cost_slack: float = 1e-6


@dataclass
class MemoEntry:
    """One cached solved instance (content-addressed)."""

    key: str                    # exact-hit key (hashed namespace+content)
    tenant: str
    algo: str
    pkey: str                   # canonical algo-params string
    seed: int
    chash: str                  # canonical instance hash
    shape_sig: str              # variable/domain skeleton digest
    digests: Dict[str, str]     # constraint name → content digest
    assignment: Dict[str, Any]
    status: str
    cost: Optional[float]
    violation: Optional[int]
    cycle: int
    msg_count: int
    msg_size: float
    yaml: str                   # cached instance, canonical YAML (""
                                # for an in-memory entry: see _parsed)
    features: Optional[np.ndarray]
    created_at: float
    last_used: float = 0.0
    path: Optional[str] = None  # on-disk npz (None = memory only)
    owned: bool = True          # False for entries adopted from a peer
    #: lazily-cached parse of ``yaml`` (memory only, never persisted)
    _parsed: Optional[DCOP] = field(default=None, repr=False)
    #: False while ``features`` is still to compute (an in-memory entry
    #: is featurized only when a variant ranking needs it)
    _features_done: bool = field(default=True, repr=False)

    def parsed_dcop(self) -> DCOP:
        """Parse the cached canonical YAML once, then hand out a
        shallow clone per serve: the warm controller rebinds
        constraint/variable slots on its instance, so sharing the
        parse across serves would drift it.  The Variable/Domain/
        Constraint objects themselves are immutable under replay and
        safe to share — this turns the dominant per-variant cost
        (re-parsing a multi-hundred-KB YAML) into a dict copy."""
        if self._parsed is None:
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop

            self._parsed = load_dcop(self.yaml)
        src = self._parsed
        clone = DCOP(src.name, objective=src.objective,
                     description=src.description)
        clone.domains = dict(src.domains)
        clone.variables = dict(src.variables)
        clone.constraints = dict(src.constraints)
        clone.agents = dict(src.agents)
        clone.external_variables = dict(src.external_variables)
        clone.dist_hints = src.dist_hints
        return clone

    def meta_dict(self) -> Dict[str, Any]:
        """JSON-safe persistence form (the npz ``__meta__`` payload)."""
        return {
            "key": self.key, "tenant": self.tenant, "algo": self.algo,
            "pkey": self.pkey, "seed": int(self.seed),
            "chash": self.chash, "shape_sig": self.shape_sig,
            "digests": dict(self.digests),
            "assignment": dict(self.assignment),
            "status": self.status,
            "cost": None if self.cost is None else float(self.cost),
            "violation": (None if self.violation is None
                          else int(self.violation)),
            "cycle": int(self.cycle),
            "msg_count": int(self.msg_count),
            "msg_size": float(self.msg_size),
            "yaml": self.yaml,
            "created_at": float(self.created_at),
            "has_features": self.features is not None,
        }


@dataclass
class MemoProbe:
    """One lookup's verdict + the canonicalization artifacts, so a
    later :meth:`MemoCache.memoize` never recomputes them."""

    kind: str                   # "exact" | "variant" | "miss"
    tenant: str
    algo: str
    pkey: str
    seed: int
    chash: str
    key: str
    shape_sig: Optional[str] = None
    digests: Optional[Dict[str, str]] = None
    features: Optional[np.ndarray] = None
    entry: Optional[MemoEntry] = None
    diff: Optional[FactorDiff] = None
    distance: Optional[float] = None
    #: a variant hit whose warm repair was discarded (never-worse
    #: guarantee) — the job was solved cold instead
    cold_fallback: bool = False

    def provenance(self) -> Dict[str, Any]:
        """The ``metrics()["memo"]`` seed for this lookup."""
        out: Dict[str, Any] = {"hit": self.kind}
        if self.cold_fallback:
            out["cold_fallback"] = True
        if self.entry is not None:
            out["key"] = self.entry.key[:16]
        if self.diff is not None:
            out.update(self.diff.as_dict())
        if self.distance is not None and np.isfinite(self.distance):
            out["distance"] = round(float(self.distance), 6)
        return out

    def decorate(self, res) -> None:
        """Attach this lookup's provenance to a result that does not
        already carry one (cache-served results are stamped richer at
        serve time — don't overwrite)."""
        if res.memo is None:
            res.memo = self.provenance()


def _exact_key(tenant: str, algo: str, pkey: str, seed: int,
               chash: str) -> str:
    import hashlib

    blob = "\x1f".join([tenant, algo, pkey, str(int(seed)), chash])
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class MemoCache:
    """Content-addressed solution cache (one per service).

    Thread-safe: probe/insert/adopt/invalidate run under ``_lock``;
    :meth:`serve_variant` (the warm repair) deliberately touches no
    shared state beyond counters.
    """

    def __init__(
        self,
        config: Optional[MemoConfig] = None,
        directory: Optional[str] = None,
        counters: Optional[MemoCounters] = None,
        device: DeviceLike = None,
        on_insert: Optional[Callable[[MemoEntry], None]] = None,
    ):
        self.config = config or MemoConfig()
        #: device of the warm repairs (cuda unless ``device="cpu"``;
        #: resolved when a variant is served, so an exact-hit-only cache
        #: never touches a device)
        self.device = device
        self.directory = directory
        self.counters = counters or MemoCounters()
        #: fleet-sharing tap: called (outside the lock) with every
        #: locally-inserted entry after it is persisted
        self.on_insert = on_insert
        self._lock = threading.Lock()
        self._entries: Dict[str, MemoEntry] = {}
        #: content hash → feature vector (insertion order, bounded)
        self._features: Dict[str, np.ndarray] = {}
        #: (tenant, algo, pkey, shape_sig) → [exact keys] — the
        #: variant candidate index
        self._buckets: Dict[Tuple[str, str, str, str], List[str]] = {}
        if directory:
            os.makedirs(directory, exist_ok=True)

    # -- canonicalization helpers (no shared state) -------------------------

    def _features_of(self, dcop: DCOP,
                     chash: Optional[str] = None) -> Optional[np.ndarray]:
        """The featurizer's vector, kept by content hash (at most
        ``max_entries``): a duplicate that misses — its first copy still
        solving — does not featurize the same content again."""
        if len(dcop.variables) > self.config.featurize_max_vars:
            return None
        with self._lock:
            feats = self._features.get(chash)
        if feats is not None:
            return feats
        from pydcop_tpu_torch.portfolio.features import featurize

        feats = np.asarray(featurize(dcop), dtype=np.float32)
        if chash is not None:
            with self._lock:
                self._features[chash] = feats
                while len(self._features) > self.config.max_entries:
                    self._features.pop(next(iter(self._features)))
        return feats

    # -- lookup --------------------------------------------------------------

    def canonicalize(self, dcop: DCOP) -> Tuple[Dict[str, str], str, str]:
        """The content artifacts a :meth:`probe` reads: the constraint
        digests (the tables hashed once: the exact key and the variant
        diff both read them), the canonical hash and the shape signature.
        Pure functions of ``dcop``, so a caller may compute them off its
        hot thread and pass them to :meth:`probe` (the serve tier does,
        on its prep threads)."""
        digs = constraint_digests(dcop)
        return digs, canonical_hash(dcop, digs), shape_signature(dcop)

    def probe(self, dcop: DCOP, algo: str, algo_params=None,
              seed: int = 0, tenant: str = "default",
              artifacts=None) -> MemoProbe:
        """Classify one submission: exact / variant / miss.

        Heavy canonicalization happens before the lock (or before the
        call: ``artifacts`` from :meth:`canonicalize`); the lock only
        covers the index lookups and TTL sweep.
        """
        pkey = params_key(algo_params)
        if artifacts is None:
            digs = constraint_digests(dcop)
            chash = canonical_hash(dcop, digs)
        else:
            digs, chash = artifacts[:2]
        key = _exact_key(tenant, algo, pkey, seed, chash)
        now = time.time()
        with self._lock:
            self._expire_locked(now)
            hit = self._entries.get(key)
            if hit is not None:
                hit.last_used = now
                self.counters.inc("hits_exact")
                send_memo("hit.exact", {"tenant": tenant,
                                        "key": key[:16]})
                return MemoProbe("exact", tenant, algo, pkey, seed,
                                 chash, key, entry=hit)
        # exact miss: build the variant-match artifacts outside the lock
        ssig = shape_signature(dcop) if artifacts is None else artifacts[2]
        probe = MemoProbe("miss", tenant, algo, pkey, seed, chash, key,
                          shape_sig=ssig, digests=digs)
        from pydcop_tpu_torch.algorithms.warm import WARM_ALGOS

        if algo in WARM_ALGOS:
            self._match_variant(probe, dcop, now)
        if probe.kind == "miss":
            self.counters.inc("misses")
            send_memo("miss", {"tenant": tenant, "key": key[:16]})
        return probe

    def _entry_features(self, e: MemoEntry) -> Optional[np.ndarray]:
        if not e._features_done:
            e.features = self._features_of(e.parsed_dcop(), e.chash)
            e._features_done = True
        return e.features

    def _match_variant(self, probe: MemoProbe, dcop: DCOP,
                       now: float) -> None:
        """The JAX cache's match: the bucket's entries ranked by feature
        distance (entries without features last, the stable sort keeping
        insertion order among equals), the first whose factor diff passes
        the gate wins, and every candidate ranked before it counts as
        refused.  The gate is checked first: when no candidate passes,
        the ranking cannot change the outcome, so nothing is featurized
        (all candidates are refused, as in the JAX scan)."""
        with self._lock:
            bucket = self._buckets.get(
                (probe.tenant, probe.algo, probe.pkey, probe.shape_sig))
            entries = [
                e for e in (self._entries.get(k) for k in bucket or ())
                if e is not None
            ]
        if not entries:
            return
        diffs = [factor_diff(e.digests, None, probe.digests)
                 for e in entries]
        passing = [d.edits <= self.config.max_edits for d in diffs]
        if not any(passing):
            with self._lock:
                self.counters.inc("variant_rejected_gate", len(entries))
            return
        probe.features = self._features_of(dcop, probe.chash)
        feats = [self._entry_features(e) for e in entries]
        # ONE [B, F] distance computation; entries lacking features rank
        # last at +inf, the STABLE argsort keeps insertion order among
        # equal distances
        dists = np.full(len(entries), np.inf, dtype=np.float64)
        if probe.features is not None:
            with_f = [i for i, f in enumerate(feats) if f is not None]
            if with_f:
                mat = np.stack([feats[i].astype(np.float32)
                                for i in with_f])
                delta = mat - probe.features[None, :]
                dists[with_f] = np.sqrt(
                    np.sum(np.square(delta, dtype=np.float64), axis=1)
                )
        order = [int(i) for i in np.argsort(dists, kind="stable")]
        refused = 0
        for i in order:
            if passing[i]:
                break
            refused += 1
        e, diff, d = entries[i], diffs[i], float(dists[i])
        with self._lock:
            if refused:
                self.counters.inc("variant_rejected_gate", refused)
            e.last_used = now
            probe.kind = "variant"
            probe.entry, probe.diff, probe.distance = e, diff, d
            self.counters.inc("hits_variant")
        send_memo("hit.variant", {
            "tenant": probe.tenant, "key": e.key[:16],
            "edits": diff.edits,
            "distance": None if not np.isfinite(d) else round(d, 6),
        })

    # -- serving -------------------------------------------------------------

    def result_from_entry(self, entry: MemoEntry, probe: MemoProbe):
        """A fresh SolveResult replaying ``entry`` bit-identically."""
        from pydcop_tpu_torch.algorithms.base import SolveResult

        return SolveResult(
            status=entry.status,
            assignment=dict(entry.assignment),
            cost=entry.cost,
            violation=entry.violation,
            cycle=entry.cycle,
            msg_count=entry.msg_count,
            msg_size=entry.msg_size,
            time=0.0,
            memo=probe.provenance(),
        )

    def serve_variant(self, probe: MemoProbe, dcop: DCOP,
                      algo_params=None, max_cycles: Optional[int] = None,
                      device: DeviceLike = None):
        """Warm-repair the cached nearest instance into ``dcop``, on
        ``device`` (the cache's own device by default: cuda unless it
        was built with ``device="cpu"``).

        Returns a SolveResult (with ``memo`` provenance) or ``None``
        when the warm path cannot uphold the never-worse guarantee or
        refuses the diff — the caller then solves cold.  A device fault
        propagates (module docstring).
        """
        import torch

        from pydcop_tpu_torch.algorithms import (
            DEFAULT_INFINITY,
            AlgorithmDef,
        )
        from pydcop_tpu_torch.ops.headroom import HeadroomExhausted
        from pydcop_tpu_torch.runtime.repair import WarmRepairController

        entry, diff = probe.entry, probe.diff
        cfg = self.config
        dev = self.device if device is None else device
        old = entry.parsed_dcop()
        algo_def = AlgorithmDef.build_with_default_params(
            probe.algo, dict(algo_params or {}), mode=old.objective)
        ctrl = WarmRepairController(
            old, probe.algo, algo_def=algo_def, seed=probe.seed,
            headroom=cfg.warm_headroom, min_free=cfg.warm_min_free,
            device=dev)
        solver = ctrl.solver
        # seed the cached assignment into the warm state (the
        # repack_solver by-slot value-copy pattern)
        state = solver.initial_state()
        cur = solver.values_of(state)
        vals = cur.cpu().numpy().copy()
        for name, val in entry.assignment.items():
            if name in old.variables:
                slot = solver.layout.var_slot(name)
                vals[slot] = old.variables[name].domain.index(val)
        seeded = torch.as_tensor(vals, dtype=cur.dtype, device=cur.device)
        if len(state) == 4:      # WarmMaxSumSolver (q, r, vals, ops)
            state = (state[0], state[1], seeded, state[3])
        else:                    # WarmLocalSearchSolver (x, ops)
            state = (seeded, state[1])
        solver._last_state = state
        # replay the factor diff as a warm mutation stream; the
        # controller absorbs HeadroomExhausted with ONE repack.  Only
        # the replay's own refusals fall back cold: an error of the
        # build above or of the run below ends the job
        try:
            for name in diff.changed:
                ctrl.edit_factor(dcop.constraints[name])
            for name in diff.added:
                ctrl.add_constraint(dcop.constraints[name])
            for name in diff.removed:
                ctrl.remove_constraint(name)
        except (HeadroomExhausted, ValueError, KeyError) as e:
            self.counters.inc("variant_cold_fallbacks")
            send_memo("fallback.cold", {"key": entry.key[:16],
                                        "reason": repr(e)})
            return None
        res = ctrl.solver.run(
            max_cycles=max_cycles or cfg.warm_max_cycles, resume=True)
        repacks = ctrl.counters.counts.get("headroom_exhausted_repacks", 0)
        if repacks:
            self.counters.inc("variant_repacks", repacks)
        # never-worse gate: final cost must not regress the cached
        # assignment evaluated on the NEW problem (the warm seed)
        viol_seed, c_seed = dcop.solution_cost(
            dict(entry.assignment), DEFAULT_INFINITY)
        ok = res.cost is not None and np.isfinite(res.cost)
        if ok:
            if dcop.objective == "max":
                ok = res.cost >= c_seed - cfg.cost_slack
            else:
                ok = res.cost <= c_seed + cfg.cost_slack
        if ok and res.violation is not None:
            ok = res.violation <= viol_seed
        if not ok:
            self.counters.inc("variant_cold_fallbacks")
            send_memo("fallback.cold", {
                "key": entry.key[:16],
                "reason": f"converged worse than seed "
                          f"(cost={res.cost} seed={c_seed})",
            })
            return None
        res.memo = probe.provenance()
        res.memo["seed_cost"] = float(c_seed)
        res.memo["repacks"] = int(repacks)
        return res

    # -- insertion / persistence ---------------------------------------------

    def memoize(self, probe: MemoProbe, dcop: DCOP,
                res) -> Optional[MemoEntry]:
        """Cache one solved instance (miss or variant-served lookups;
        exact hits are already present).  Named ``memoize`` rather
        than ``insert`` deliberately: the race lint counts mutator
        verbs through a held attribute as writes to the holder."""
        if probe.kind == "exact" or not res.assignment:
            return None
        if res.cost is None or not np.isfinite(res.cost):
            return None
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        now = time.time()
        entry = MemoEntry(
            key=probe.key, tenant=probe.tenant, algo=probe.algo,
            pkey=probe.pkey, seed=probe.seed, chash=probe.chash,
            shape_sig=probe.shape_sig or shape_signature(dcop),
            digests=probe.digests or constraint_digests(dcop),
            assignment=dict(res.assignment), status=res.status,
            cost=float(res.cost), violation=res.violation,
            cycle=res.cycle, msg_count=res.msg_count,
            msg_size=res.msg_size,
            # the YAML is rendered only for a persisted entry: an
            # in-memory one serves from the instance itself (_parsed)
            yaml=dcop_yaml(dcop) if self.directory else "",
            # featurized now only when persisted (the file carries the
            # vector); in memory, when a ranking first needs it
            features=(probe.features if probe.features is not None
                      or not self.directory
                      else self._features_of(dcop, probe.chash)),
            _features_done=(probe.features is not None
                            or bool(self.directory)),
            created_at=now, last_used=now,
            # the solved instance doubles as the parse cache: a later
            # variant serve clones it instead of re-parsing the YAML
            # (rehydrated/adopted entries still parse lazily, once)
            _parsed=dcop,
        )
        if self.directory:
            entry.path = os.path.join(self.directory,
                                      f"{entry.key[:24]}.npz")
            self._write_entry(entry)
        evicted = self._adopt(entry, counter="inserts")
        send_memo("insert", {"tenant": entry.tenant,
                             "key": entry.key[:16],
                             "cost": entry.cost})
        for old in evicted:
            self._unlink(old)
        if self.on_insert is not None:
            self.on_insert(entry)
        return entry

    def _write_entry(self, entry: MemoEntry) -> None:
        from pydcop_tpu_torch.runtime.checkpoint import write_state_npz

        feats = (entry.features if entry.features is not None
                 else np.zeros(0, dtype=np.float32))
        write_state_npz(entry.path, {"features": feats},
                        {"memo": entry.meta_dict()})

    def _adopt(self, entry: MemoEntry, counter: str) -> List[MemoEntry]:
        """Index ``entry``; returns LRU-evicted entries (files are the
        caller's to unlink, outside the lock)."""
        evicted: List[MemoEntry] = []
        with self._lock:
            prior = self._entries.get(entry.key)
            if prior is not None:
                self._unindex_locked(prior)
            self._entries[entry.key] = entry
            self._buckets.setdefault(
                (entry.tenant, entry.algo, entry.pkey, entry.shape_sig),
                []).append(entry.key)
            self.counters.inc(counter)
            while len(self._entries) > self.config.max_entries:
                lru = min(self._entries.values(),
                          key=lambda e: e.last_used)
                self._unindex_locked(lru)
                self.counters.inc("evicted_lru")
                evicted.append(lru)
        return evicted

    def _unindex_locked(self, entry: MemoEntry) -> None:
        self._entries.pop(entry.key, None)
        bucket = self._buckets.get(
            (entry.tenant, entry.algo, entry.pkey, entry.shape_sig))
        if bucket and entry.key in bucket:
            bucket.remove(entry.key)

    def _unlink(self, entry: MemoEntry) -> None:
        if entry.path and entry.owned:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    # -- invalidation ---------------------------------------------------------

    def _expire_locked(self, now: float) -> None:
        ttl = self.config.ttl_s
        if not ttl:
            return
        dead = [e for e in self._entries.values()
                if now - e.created_at > ttl]
        for e in dead:
            self._unindex_locked(e)
            self._unlink(e)
            self.counters.inc("expired_ttl")
        if dead:
            send_memo("invalidate", {"reason": "ttl",
                                     "dropped": len(dead)})

    def churn_event(self, tenant: Optional[str] = None) -> int:
        """A churn event makes cached results stale: drop the
        tenant's namespace (or everything when ``tenant`` is None)."""
        with self._lock:
            dead = [e for e in self._entries.values()
                    if tenant is None or e.tenant == tenant]
            for e in dead:
                self._unindex_locked(e)
                self._unlink(e)
            self.counters.inc("invalidated_churn", len(dead))
        if dead:
            send_memo("invalidate", {"reason": "churn",
                                     "tenant": tenant,
                                     "dropped": len(dead)})
        return len(dead)

    # -- persistence: rehydrate / adoption ------------------------------------

    def _load_file(self, path: str) -> MemoEntry:
        """Read + verify one npz entry (ValueError on any corruption)."""
        from pydcop_tpu_torch.runtime.checkpoint import read_state_npz

        meta, arrays = read_state_npz(path)
        m = meta.get("memo")
        if not isinstance(m, dict):
            raise ValueError(f"{path!r} is not a memo entry")
        feats = None
        if m.get("has_features"):
            feats = np.asarray(arrays["features"], dtype=np.float32)
        return MemoEntry(
            key=m["key"], tenant=m["tenant"], algo=m["algo"],
            pkey=m["pkey"], seed=int(m["seed"]), chash=m["chash"],
            shape_sig=m["shape_sig"], digests=dict(m["digests"]),
            assignment=dict(m["assignment"]), status=m["status"],
            cost=m["cost"], violation=m["violation"],
            cycle=int(m["cycle"]), msg_count=int(m["msg_count"]),
            msg_size=float(m["msg_size"]), yaml=m["yaml"],
            features=feats, created_at=float(m["created_at"]),
            last_used=float(m["created_at"]), path=path,
        )

    def rehydrate(self) -> int:
        """Reload persisted entries (the ``resume()`` path).  Corrupt
        files are skipped-and-counted — never served."""
        if not self.directory or not os.path.isdir(self.directory):
            return 0
        n = 0
        for fn in sorted(os.listdir(self.directory)):
            if not fn.endswith(".npz"):
                continue
            path = os.path.join(self.directory, fn)
            try:
                entry = self._load_file(path)
            except ValueError as e:
                self.counters.inc("corrupt_skipped")
                send_memo("corrupt.skipped", {"path": path,
                                              "reason": str(e)})
                continue
            for old in self._adopt(entry, counter="rehydrated"):
                self._unlink(old)
            n += 1
        return n

    def adopt_file(self, path: str) -> bool:
        """Adopt a peer's persisted entry (a JAX-written one too).  The
        peer keeps ownership of the file; corrupt frames are
        skipped-and-counted."""
        try:
            entry = self._load_file(path)
        except ValueError as e:
            self.counters.inc("corrupt_skipped")
            send_memo("corrupt.skipped", {"path": path,
                                          "reason": str(e)})
            return False
        entry.owned = False
        return self.adopt_entry(entry)

    def adopt_entry(self, entry: MemoEntry) -> bool:
        """Adopt an in-memory entry from a peer."""
        with self._lock:
            if entry.key in self._entries:
                return False
        clone = MemoEntry(**{**entry.__dict__})
        clone.owned = False
        for old in self._adopt(clone, counter="adopted"):
            self._unlink(old)
        return True

    # -- fault injection / introspection --------------------------------------

    def corrupt_entry(self, key: Optional[str] = None) -> Optional[str]:
        """Flip bytes in one persisted entry (the
        ``corrupt_cache_entry`` fault): models silent disk corruption —
        the CRC check at rehydrate/adopt time must refuse it."""
        with self._lock:
            victims = [e for e in self._entries.values()
                       if e.path and (key is None or e.key == key)]
            victim = max(victims, key=lambda e: e.created_at,
                         default=None)
            path = victim.path if victim is not None else None
        if path is None or not os.path.exists(path):
            return None
        with open(path, "r+b") as f:
            f.seek(max(0, os.path.getsize(path) // 2))
            f.write(b"\xde\xad\xbe\xef")
        return path

    def entry(self, key: str) -> Optional[MemoEntry]:
        with self._lock:
            return self._entries.get(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        """The ``metrics()["memo"]`` scorecard."""
        with self._lock:
            out = self.counters.as_dict()
            out["entries"] = len(self._entries)
            out["tenants"] = len({e.tenant
                                  for e in self._entries.values()})
        return out
