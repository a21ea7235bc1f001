"""Shared machinery for the local-search algorithm family
(dsa / adsa / dsatuto / mgm / mgm2 / mixeddsa, and the breakout
algorithms dba / gdba, which run the generic engine only).

All of these run on the constraints hypergraph and share one per-cycle
primitive, the **local cost table**: for every variable, the cost of each
candidate value given its neighbours' current values
(:func:`pydcop_tpu_torch.ops.compile.local_cost_tables`).  On top of it
they differ only in the move rule (and dba/gdba in the breakout weights
they carry in their state and feed to the tables).

Two engines, chosen as MaxSum's are:

* packed (the graphs MaxSum packs: all-binary, or mixed arity 1-4): the
  kernels of :mod:`pydcop_tpu_torch.ops.packed_local_search` on a GPU,
  their plain versions on the CPU — by default an all-binary graph on
  every device and a mixed-arity graph on CUDA only; ``use_packed``
  True / False packs whatever packs / never packs, as the JAX solvers'
  flag (see :mod:`pydcop_tpu_torch.algorithms.maxsum`);
* generic (any arity): plain PyTorch over the compiled buckets
  (:func:`local_cost_tables`, :func:`gains_and_best`,
  :func:`neighborhood_winner`), deterministic on every device.  dba and
  gdba run only this one, as the JAX package's (their weighted tables
  have no packed form).

Stated deviations from the JAX package, as MaxSum's noise: the initial
values come from a CPU ``torch.Generator`` seeded with ``seed + 17`` and
the DSA-family coins from one seeded with ``seed``, drawn per chunk as
``[n, V]`` uniforms on the CPU and copied to the device.  A CPU run and a
GPU run of this package thus take the same random choices, but not the
numbers of the JAX package's ``jax.random`` stream.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.algorithms.base import SynchronousTensorSolver
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.ops.compile import (
    ConstraintGraphTensors,
    local_cost_tables,
)
from pydcop_tpu_torch.ops.packed_local_search import (
    pack_from_pg,
    pack_uniforms,
    pack_x,
    unpack_x,
)
from pydcop_tpu_torch.ops.packed_maxsum import solver_layout
from pydcop_tpu_torch.ops.segments import (
    masked_argmin,
    segment_max,
    segment_min,
)

#: costs at or above this threshold are hard-constraint violations
#: ("conflicts") — the reference's serializable infinity
HARD_THRESHOLD = 10000.0


def random_valid_values(tensors: ConstraintGraphTensors,
                        seed: int) -> torch.Tensor:
    """Random initial value index per variable (uniform over its valid
    values), drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and moved to the tensors' device; variables with an explicit
    initial_value keep it.  int32 [V]."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mask = tensors.domain_mask.cpu()
    u = torch.rand(mask.shape, generator=gen)
    # masked argmax of random scores = uniform choice among valid values
    pick = torch.argmax(torch.where(mask > 0, u, -1.0), dim=1)
    init = torch.as_tensor(tensors.initial_values, dtype=torch.int64)
    has_init = torch.as_tensor(tensors.has_initial, dtype=torch.bool)
    x = torch.where(has_init, init, pick).to(torch.int32)
    return x.to(tensors.device)


def gains_and_best(
    tensors: ConstraintGraphTensors,
    x: torch.Tensor,
    tables: Optional[torch.Tensor] = None,
    prefer_change: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(current_cost [V], best_value [V], gain [V], tables [V, D]).

    gain = current local cost − best achievable local cost (≥ 0).  With
    ``prefer_change`` 1e-6 is ADDED to the current value's entry before
    the argmin (DSA B/C lateral moves): in float32 the add vanishes once
    |t| ≥ 32, so on hard-constraint tables the first index decides."""
    if tables is None:
        tables = local_cost_tables(tensors, x)
    V = tensors.n_vars
    rows = torch.arange(V, device=x.device)
    xl = x.long()
    cur = tables[rows, xl]
    pick_from = tables
    if prefer_change:
        eps = torch.zeros_like(tables)
        eps[rows, xl] = 1e-6
        pick_from = tables + eps
    best_val = masked_argmin(pick_from, tensors.domain_mask)
    gain = cur - tables[rows, best_val]
    return cur, best_val.to(torch.int32), torch.clamp_min(gain, 0.0), tables


def neighborhood_winner(tensors: ConstraintGraphTensors,
                        gain: torch.Tensor) -> torch.Tensor:
    """MGM-style arbitration: True where a variable's gain is the strict
    maximum of its neighbourhood, lexical (index-order) tie-break — two
    segment reductions over the directed neighbour pairs."""
    V = tensors.n_vars
    src, dst = tensors.neighbor_src, tensors.neighbor_dst
    if src.shape[0] == 0:
        return gain > 0
    eps = gain.new_tensor(1e-9)
    neigh_max = segment_max(gain[src], dst, V)
    neigh_max = torch.clamp_min(neigh_max, 0.0)  # isolated vars: -inf
    # lowest index among neighbours achieving the max (lexic tie-break)
    at_max = gain[src] >= neigh_max[dst] - eps
    idx_at_max = segment_min(
        torch.where(at_max, src, torch.full_like(src, V)), dst, V)
    me = torch.arange(V, device=gain.device)
    return (gain > 0) & (
        (gain > neigh_max + eps)
        | (((gain - neigh_max).abs() <= eps) & (me < idx_at_max))
    )


def conflicted(tensors: ConstraintGraphTensors, x: torch.Tensor,
               tables: torch.Tensor) -> torch.Tensor:
    """True for variables whose current local cost crosses the hard
    threshold (involved in ≥1 violated hard constraint)."""
    cur = tables[torch.arange(tensors.n_vars, device=x.device), x.long()]
    return cur >= HARD_THRESHOLD


def dsa_move(x, best_val, gain, in_conflict, activate, variant):
    """The DSA variants' move rule (A: improve; B: also lateral in
    conflict; C: also lateral) under the ``activate`` coins."""
    improving = gain > gain.new_tensor(1e-9)
    lateral = (gain <= gain.new_tensor(1e-9)) & (best_val != x)
    if variant == "A":
        want = improving
    elif variant == "B":
        want = improving | (lateral & in_conflict)
    else:
        want = improving | lateral
    return torch.where(want & activate, best_val, x).to(torch.int32)


class LocalSearchSolver(SynchronousTensorSolver):
    """Base for local-search solvers: state = (x [V] int32,).

    The packed engine runs where the layout of
    :func:`~pydcop_tpu_torch.ops.packed_maxsum.solver_layout` packs
    (``self.packed`` is not None), the generic one otherwise.
    Subclasses implement :meth:`cycle` (one generic cycle from x and this
    cycle's coins) and :meth:`packed_run` (n packed cycles on the
    column-order x), and :meth:`chunk_coins` when they draw coins."""

    def __init__(self, dcop, tensors: ConstraintGraphTensors,
                 algo_def: AlgorithmDef, seed: int = 0,
                 use_packed: Optional[bool] = None):
        super().__init__(dcop, tensors, algo_def)
        precision = self.params.get("precision") or "f32"
        if precision != "f32":
            raise NotPortedError(
                f"{algo_def.algo} precision={precision!r} is not ported to "
                f"the PyTorch package yet; run precision=f32"
            )
        self.seed = seed
        # one value message to each neighbour per cycle (reference
        # parity: mgm/dsa broadcast their value each cycle)
        self.msgs_per_cycle = tensors.n_pairs
        self.msg_size_per_msg = 1.0
        self.packed = pack_from_pg(solver_layout(tensors, use_packed))
        self.coins = torch.Generator(device="cpu")

    def run(self, cycles=None, timeout=None):
        # every run replays the same coins, as the JAX package restarts
        # its key at PRNGKey(seed)
        self.coins.manual_seed(self.seed)
        return super().run(cycles=cycles, timeout=timeout)

    def initial_state(self):
        return (random_valid_values(self.tensors, self.seed + 17),)

    def values_of(self, state):
        return state[0]

    def draw_uniforms(self, n: int) -> torch.Tensor:
        """[n, V] float32 coins for the next n cycles, on the CPU."""
        return torch.rand((n, self.tensors.n_vars), generator=self.coins)

    def chunk_coins(self, n: int):
        """The coins of the next n cycles on the device, or None."""
        return None

    def cycle(self, x: torch.Tensor, coins) -> torch.Tensor:
        raise NotImplementedError

    def packed_run(self, x_col: torch.Tensor, n: int, coins):
        raise NotImplementedError

    def run_cycles(self, state, n: int):
        (x,) = state
        coins = self.chunk_coins(n)
        if self.packed is not None:
            x_col = self.packed_run(pack_x(self.packed, x), n, coins)
            return (unpack_x(self.packed, x_col),)
        for i in range(n):
            x = self.cycle(x, None if coins is None
                           else tuple(c[i] for c in coins))
        return (x,)


class StochasticSolver(LocalSearchSolver):
    """The DSA family: coins = (move,) per cycle, or (wake, move) for
    adsa (``wake_coins``), each chunk's [n, V] arrays drawn in that
    order."""

    wake_coins = False

    def chunk_coins(self, n: int):
        draws = [self.draw_uniforms(n)
                 for _ in range(2 if self.wake_coins else 1)]
        coins = tuple(d.to(self.device) for d in draws)
        if self.packed is not None:
            coins = tuple(pack_uniforms(self.packed, c) for c in coins)
        return coins


def quiet_neighborhood(tensors: ConstraintGraphTensors,
                       gain: torch.Tensor) -> torch.Tensor:
    """True where neither a variable nor any neighbour can improve:
    ``max(gain, neighbourhood max of gain) <= 1e-9`` — the breakout
    algorithms' quasi-local minimum."""
    src, dst = tensors.neighbor_src, tensors.neighbor_dst
    if src.shape[0] > 0:
        neigh_max = torch.clamp_min(
            segment_max(gain[src], dst, tensors.n_vars), 0.0)
    else:
        neigh_max = torch.zeros_like(gain)
    return torch.maximum(gain, neigh_max) <= gain.new_tensor(1e-9)


class BreakoutSolver(LocalSearchSolver):
    """Base of dba and gdba: state = (x [V] int32, breakout weights), the
    generic engine only (``use_packed=False``, as the JAX solvers), no
    coins.  Subclasses implement :meth:`initial_weights` and
    :meth:`cycle` (one cycle from the whole state)."""

    def __init__(self, dcop, tensors: ConstraintGraphTensors,
                 algo_def: AlgorithmDef, seed: int = 0):
        super().__init__(dcop, tensors, algo_def, seed, use_packed=False)
        # an ok and an improve message per directed neighbour pair
        self.msgs_per_cycle = 2 * tensors.n_pairs

    def initial_weights(self):
        raise NotImplementedError

    def initial_state(self):
        return (random_valid_values(self.tensors, self.seed + 17),
                self.initial_weights())

    def run_cycles(self, state, n: int):
        for _ in range(n):
            state = self.cycle(state)
        return state
