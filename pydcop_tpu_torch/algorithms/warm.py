"""Warm-repair solvers: survive live mutations without a cold restart.

The port of the JAX package's ``algorithms/warm.py``.  The warm solvers
carry every mutable tensor — cost tables, scope indices, domain masks,
unary costs, the edge→variable map, and this package's fixed-shape sum
plans and neighbour pairs (``ops/headroom.py``) — as the tail leaves of
their state, built at a fixed **capacity** shape with seeded inert
headroom.  Where the JAX package's rule is "zero retraces", this
package's is **no re-capture**:

* the operand tensors are the solver's :meth:`resident_leaves`: the
  fixed-shape chunk runner (``algorithms/capture.py::ChunkRunner``)
  takes them as its own static buffers, so a captured chunk reads them
  in place, a replay copies none of them in, and a run keeps them
  uncloned in its final state;
* a mutation (:meth:`_WarmMixin.apply_mutations`) is a handful of
  in-place writes on those tensors, in proportion to the rows it
  touches: over a stream of table edits, adds and removes
  ``trace_count()`` (captures) stays at its value after warm-up;
* solver state (messages/assignment/coin stream) carries across the
  mutation for every untouched variable; only the dirtied
  neighbourhood's messages are re-initialized, in place;
* when headroom runs out, :func:`repack_solver` rebuilds ONCE at a
  fresh capacity, carrying all per-entity state by name — exactly one
  more capture, counted and evented by the repair controller
  (``runtime/repair.py``).

Supported rules: maxsum (the generic engine) and the mgm/dsa/adsa move
rules on the generic engine (``use_packed=False``), as in the JAX
package.  The weighted breakout variants (dba/gdba) and the packed
engines (the hand-written kernels) keep the cold path — out of scope
here, the repack fallback covers them.  The initial values and the DSA
coins come from the port's CPU generators (``algorithms/_local_search.py``
states the deviation), so warm dsa and adsa are held to the port's own
CPU run, warm mgm and maxsum (noise 0) to the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    LocalSearchSolver,
    random_valid_values,
)
from pydcop_tpu_torch.algorithms.adsa import adsa_cycle
from pydcop_tpu_torch.algorithms.dsa import dsa_cycle
from pydcop_tpu_torch.algorithms.maxsum import MaxSumSolver
from pydcop_tpu_torch.algorithms.mgm import mgm_cycle
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import local_cost_tables
from pydcop_tpu_torch.ops.headroom import (
    Dirty,
    EditFactor,
    HeadroomLayout,
    apply_mutation,
    make_operands,
    operand_leaves,
    operand_view,
    reserve_headroom,
)
from pydcop_tpu_torch.ops.maxsum_kernels import init_messages
from pydcop_tpu_torch.ops.segments import masked_argmin

#: algorithms the warm layer can host at a fixed shape; anything else
#: takes the cold repack path
WARM_ALGOS = ("maxsum", "maxsum_dynamic", "mgm", "dsa", "adsa")


class _WarmMixin:
    """Shared warm plumbing: operands-in-state, fixed-shape mutations in
    place, metrics attachment."""

    #: set by the repair controller; attached to every SolveResult
    repair_counters = None

    def checkpoint_engine(self) -> str:
        """The layout of the state leaves (``runtime/checkpoint.py``):
        the capacity layout with its operands."""
        return "warm"

    def _init_warm(self, layout: HeadroomLayout, seed: int) -> None:
        self.layout = layout
        self.seed = seed
        self.operands = make_operands(self.tensors)
        # the solver's graph IS the operand view: the kernels read the
        # operand tensors, and every mutation writes into them
        self.tensors = operand_view(self.tensors, self.operands)
        self._leaves = operand_leaves(self.operands)

    def resident_leaves(self) -> tuple:
        return self._leaves

    def _fresh_row_values(self, slots: Sequence[int],
                          values: torch.Tensor) -> None:
        """Re-initialize the dirtied slots' value entries in place: keep
        the current value when still valid, else the slot's masked-argmin
        greedy value (new variables, shrunk domains)."""
        if not slots:
            return
        ops = self.operands
        idx = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                              device=values.device)
        mask = ops["mask"][idx]
        greedy = masked_argmin(ops["unary"][idx], mask)
        cur = values[idx]
        valid = torch.gather(mask, 1, cur.long()[:, None])[:, 0] > 0
        values[idx] = torch.where(valid, cur.long(), greedy).to(values.dtype)

    def apply_mutations(self, muts: Sequence) -> List[Dirty]:
        """Apply mutations as fixed-shape writes in place; warm-carry all
        untouched state.  Raises HeadroomExhausted (caller repacks) or
        ValueError (invalid mutation) with nothing half-applied for the
        failing mutation (those before it stay applied, on the device
        and on the host mirror alike)."""
        dirties: List[Dirty] = []
        try:
            for m in muts:
                _, d = apply_mutation(self.tensors, self.layout,
                                      self.operands, m)
                dirties.append(d)
        finally:
            if self._last_state is not None and dirties:
                self._dirty_reset(self._last_state, dirties)
        return dirties

    def _dirty_reset(self, state, dirties: Sequence[Dirty]) -> None:
        raise NotImplementedError

    def restore_headroom_meta(self, hmeta: Dict) -> None:
        """Re-adopt a checkpoint's headroom layout (the JAX package's
        schema v3): the mutated operand tensors were restored with the
        state leaves; this restores the claimed/free slot maps and the
        capacity host metadata so they are addressable by name.  Called
        by ``runtime/checkpoint.py::load_checkpoint``."""
        self.layout = HeadroomLayout.from_meta(hmeta["layout"])
        t = self.tensors
        t.layout = self.layout
        t.var_names = list(hmeta["var_names"])
        t.domain_values = [tuple(v) for v in hmeta["domain_values"]]
        t.domain_sizes = np.array(
            [len(d) for d in t.domain_values], dtype=np.int32
        )
        t.factor_names = list(hmeta["factor_names"])
        for b, vi in zip(t.buckets, self.operands["var_idx"]):
            b.var_idx[:] = vi.cpu().numpy().astype(np.int32)

    # -- maxsum_dynamic compatibility: the orchestrator's change_factor /
    # set_external actions land here as fixed-shape edits -----------------

    def change_factor_function(self, new_constraint) -> None:
        ext = {
            ev.name: ev.value
            for ev in self.dcop.external_variables.values()
        }
        sliced = (
            new_constraint.slice(ext)
            if any(n in ext for n in new_constraint.scope_names)
            else new_constraint
        )
        self.apply_mutations([EditFactor(sliced)])
        self.dcop.constraints[new_constraint.name] = new_constraint

    def on_external_change(self, ext_name: str, value) -> None:
        self.dcop.external_variables[ext_name].value = value
        ext = {
            ev.name: ev.value
            for ev in self.dcop.external_variables.values()
        }
        muts = []
        for name, c in self.dcop.constraints.items():
            if ext_name in c.scope_names and self.layout.has_factor(name):
                muts.append(EditFactor(c.slice(ext)))
        if muts:
            self.apply_mutations(muts)

    def run(self, *args, **kwargs):
        res = super().run(*args, **kwargs)
        if self.repair_counters is not None:
            res.repair = self.repair_counters.as_dict()
        return res


class WarmMaxSumSolver(_WarmMixin, MaxSumSolver):
    """MaxSum at capacity: state = (q, r, values, operand leaves)."""

    def __init__(self, dcop, cap_tensors, layout, algo_def, seed=0):
        super().__init__(dcop, cap_tensors, algo_def, seed,
                         use_packed=False)
        self._init_warm(layout, seed)

    def initial_state(self):
        q, r = init_messages(self.tensors)
        values = masked_argmin(self.operands["unary"],
                               self.operands["mask"])
        return q, r, values, self._leaves

    def step(self, state, coins):
        q, r, values = super().step(state[:3], coins)
        return q, r, values, state[3]

    def _dirty_reset(self, state, dirties):
        q, r, values, _ = state
        slots: List[int] = []
        for d in dirties:
            if d.edge_hi > d.edge_lo:
                q[d.edge_lo:d.edge_hi] = 0.0
                r[d.edge_lo:d.edge_hi] = 0.0
            slots.extend(d.var_slots)
        self._fresh_row_values(slots, values)


class WarmLocalSearchSolver(_WarmMixin, LocalSearchSolver):
    """mgm / dsa / adsa at capacity: state = (x, operand leaves).

    The neighbour arbitration pairs are operands derived from the
    var_idx operands (``ops/headroom.py::derived_pairs``, rewritten in
    place by a mutation), so adding or removing a factor rewires the MGM
    neighbourhood without touching any static index list.
    """

    RULES = ("mgm", "dsa", "adsa")

    def __init__(self, dcop, cap_tensors, layout, algo_def, seed=0):
        super().__init__(dcop, cap_tensors, algo_def, seed,
                         use_packed=False)
        rule = algo_def.algo
        if rule not in self.RULES:
            raise ValueError(
                f"warm local search supports {self.RULES}, not {rule!r}"
            )
        self.rule = rule
        self.probability = float(self.params.get("probability", 0.7))
        self.variant = self.params.get("variant", "B")
        self.activation = float(self.params.get("activation", 0.5))
        # a first run that resumes a seeded state (a memo variant) starts
        # the coin stream at the seed, as the JAX solver's key does
        self.coins.manual_seed(self.seed)
        self._init_warm(layout, seed)

    def initial_state(self):
        return (random_valid_values(self.tensors, self.seed + 17),
                self._leaves)

    def draw_chunk_coins(self, n: int):
        k = {"mgm": 0, "dsa": 1, "adsa": 2}[self.rule]
        return tuple(self.draw_uniforms(n) for _ in range(k))

    def cycle(self, x, coins):
        view = self.tensors
        tables = local_cost_tables(view, x)
        if self.rule == "mgm":
            return mgm_cycle(view, x, tables=tables)
        if self.rule == "dsa":
            return dsa_cycle(view, x, coins[0], self.probability,
                             self.variant, tables=tables)
        wake_u, move_u = coins
        return adsa_cycle(view, x, wake_u, move_u, self.probability,
                          self.variant, self.activation, tables=tables)

    def step(self, state, coins):
        return self.cycle(state[0], coins), state[1]

    def _dirty_reset(self, state, dirties):
        slots: List[int] = []
        for d in dirties:
            slots.extend(d.var_slots)
        self._fresh_row_values(slots, state[0])


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _graph_for(algo: str) -> str:
    return "factor" if algo in ("maxsum", "maxsum_dynamic") else "constraint"


def build_warm_solver(
    dcop: DCOP,
    algo: str = "maxsum",
    algo_def: Optional[AlgorithmDef] = None,
    seed: int = 0,
    headroom: float = 0.25,
    min_free: int = 4,
    tensors=None,
    device: DeviceLike = None,
):
    """Build a warm-repair solver at capacity for a supported algo, on
    ``device`` (cuda unless the caller asks for the CPU; the device of
    ``tensors`` when a pre-compiled base graph is given)."""
    if algo not in WARM_ALGOS:
        raise ValueError(
            f"algorithm {algo!r} has no warm engine; supported: "
            f"{WARM_ALGOS}"
        )
    if algo_def is None:
        algo_def = AlgorithmDef.build_with_default_params(
            algo, mode=dcop.objective if dcop is not None else "min",
        )
    graph = _graph_for(algo)
    cap, layout = reserve_headroom(
        dcop, graph=graph, headroom=headroom, min_free=min_free,
        tensors=tensors, device=device,
    )
    if graph == "factor":
        return WarmMaxSumSolver(dcop, cap, layout, algo_def, seed=seed)
    return WarmLocalSearchSolver(dcop, cap, layout, algo_def, seed=seed)


def repack_solver(old, headroom: Optional[float] = None,
                  min_free: int = 4):
    """ONE cold repack that re-reserves headroom: rebuild the capacity
    layout from the (mutated) DCOP and carry every claimed entity's
    state — assignment/values and per-edge messages by NAME, unary
    rows (including the symmetry-breaking noise) by slot, the coin
    stream — so the new solver continues from exactly where the old one
    stood.  Its runner is built anew: exactly one more capture."""
    algo = old.algo_def.algo
    new = build_warm_solver(
        old.dcop, algo=algo, algo_def=old.algo_def, seed=old.seed,
        headroom=old.layout.headroom if headroom is None else headroom,
        min_free=min_free, device=old.device,
    )
    old_ops, new_ops = old.operands, new.operands
    old_lay, new_lay = old.layout, new.layout

    state = new.initial_state()
    mask = new_ops["mask"].cpu().numpy().copy()
    unary = new_ops["unary"].cpu().numpy().copy()
    old_mask = old_ops["mask"].cpu().numpy()
    old_unary = old_ops["unary"].cpu().numpy()
    old_state = old._last_state
    old_vals = (old.values_of(old_state).cpu().numpy()
                if old_state is not None else None)
    vals = new.values_of(state).cpu().numpy().copy()
    for name in old_lay.claimed_vars:
        os_, ns_ = old_lay.var_slot(name), new_lay.var_slot(name)
        mask[ns_] = old_mask[os_]
        unary[ns_] = old_unary[os_]
        if old_vals is not None:
            vals[ns_] = old_vals[os_]
    new_ops["mask"].copy_(torch.as_tensor(mask))
    new_ops["unary"].copy_(torch.as_tensor(unary))
    dev = new.device

    if isinstance(new, WarmMaxSumSolver):
        q, r, _, leaves = state
        q, r = q.cpu().numpy().copy(), r.cpu().numpy().copy()
        if old_state is not None:
            oq, orr = (old_state[0].cpu().numpy(),
                       old_state[1].cpu().numpy())
            for b, names in enumerate(old_lay.fac_names):
                for k, fname in enumerate(names):
                    if fname is None or not new_lay.has_factor(fname):
                        continue
                    nb, nk = new_lay.factor_slot(fname)
                    a = old_lay.arities[b]
                    olo = old.tensors.buckets[b].edge_offset + k * a
                    nlo = new.tensors.buckets[nb].edge_offset + nk * a
                    q[nlo:nlo + a] = oq[olo:olo + a]
                    r[nlo:nlo + a] = orr[olo:olo + a]
        new_state = (torch.as_tensor(q, device=dev),
                     torch.as_tensor(r, device=dev),
                     torch.as_tensor(vals, device=dev), leaves)
    else:
        new_state = (torch.as_tensor(vals.astype(np.int32), device=dev),
                     state[1])
        new.coins.set_state(old.coins.get_state())
    new._last_state = new_state
    new.repair_counters = old.repair_counters
    return new
