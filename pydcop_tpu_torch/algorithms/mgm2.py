"""MGM-2 — 2-coordinated Maximum Gain Message.

Equivalent capability to the reference's pydcop/algorithms/mgm2.py
(Mgm2Computation :398, Value/Offer/Response/Gain/Go messages :146-365,
params :138-142): on top of MGM's best-gain arbitration, variables can pair
up and make *coordinated two-variable moves*, escaping local minima a single
move cannot.

Protocol per cycle (reference's 5 message rounds → batched array ops):

1. value round — implicit (x is global state);
2. offer round — each variable is an *offerer* with probability
   ``threshold``; offerers pick one random incident binary constraint whose
   other end is a non-offerer and compute the joint cost table of the pair;
3. response round — each receiver takes its best positive-joint-gain
   offer (segment-max over offered edges, lowest edge id on ties) and
   commits iff that joint gain beats its own unilateral gain — or ties
   it, as arbitrated by ``favor``: ``coordinated`` commits on ties,
   ``no`` flips a coin, ``unilateral`` (default) stays solo (reference
   mgm2.py:812-821);
4. gain round — committed pairs advertise the joint gain, everyone else
   their unilateral MGM gain;
5. go round — a pair moves iff BOTH ends win their neighborhoods (partners
   share a tie-break id so they do not block each other); unpaired winners
   do the MGM move.

Deviations from the reference (documented): parallel constraints between
the same pair are not merged when excluding the shared constraint from the
joint table.  Only binary constraints participate in pairing (the
reference's offers are pairwise by construction).

Engines, as for MGM: the packed one runs the kernels of ``csrc/mgm2.cu``
on a GPU and their plain version on the CPU
(:mod:`pydcop_tpu_torch.ops.packed_mgm2`, the arithmetic of the JAX
package's Pallas kernel, both branches); the generic one
(:meth:`Mgm2Solver.cycle`, any arity) is plain PyTorch with the JAX
generic cycle's arithmetic.  The engine is chosen as for the rest of the
local-search family (:func:`~pydcop_tpu_torch.ops.packed_maxsum.solver_layout`):
an all-binary graph packs on every device, a mixed-arity graph (arity
1-4) on CUDA only unless ``use_packed=True``; ``use_packed=False`` never
packs, and a graph without a binary factor runs the generic engine.  The
two engines differ by float32 reassociation of the joint table
(``A_i + (A_j + M)`` against ``(A_i + A_j) + M``), as the JAX package's
two engines do.

Coins: per chunk three ``[n, V]`` uniforms (offer, pick, favor, in that
order, all three whatever ``favor`` is) from the solver's CPU
``torch.Generator(seed)``, copied to the device — the port's stated
deviation from the ``jax.random`` stream, as for DSA.
"""
from __future__ import annotations

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.algorithms._local_search import (
    LocalSearchSolver,
    gains_and_best,
    neighborhood_winner,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike
from pydcop_tpu_torch.ops.compile import PAD_COST, compile_constraint_graph
from pydcop_tpu_torch.ops.packed_mgm2 import (
    FAVORS,
    pack_mgm2_from_pls,
    packed_mgm2_cycles,
)
from pydcop_tpu_torch.ops.segments import segment_max, segment_min

GRAPH_TYPE = "constraints_hypergraph"

algo_params = [
    AlgoParameterDef("threshold", "float", None, 0.5),
    AlgoParameterDef(
        "favor", "str", ["unilateral", "no", "coordinated"], "unilateral"
    ),
    AlgoParameterDef("stop_cycle", "int", None, 0),
    AlgoParameterDef("precision", "str", ["f32", "bf16", "int8"], "f32"),
]


class Mgm2Solver(LocalSearchSolver):
    """State = (x,).  Coins per cycle = (u_off, u_pick, u_fav)."""

    def __init__(self, dcop, tensors, algo_def, seed=0, use_packed=None):
        super().__init__(dcop, tensors, algo_def, seed, use_packed)
        self.threshold = float(self.params.get("threshold", 0.5))
        self.favor = str(self.params.get("favor", "unilateral"))
        if self.favor not in FAVORS:
            raise ValueError(
                f"mgm2: unsupported favor mode {self.favor!r} "
                "(use unilateral, no or coordinated)"
            )
        # 5 rounds per cycle, one message per neighbor pair each
        self.msgs_per_cycle = 5 * tensors.n_pairs
        self._build_pair_structures()
        self.packed_mgm2 = pack_mgm2_from_pls(self.packed)
        if self.packed_mgm2 is None:
            # no binary factor to pair on: the generic engine runs
            self.packed = None

    def _build_pair_structures(self):
        """Static pair-edge arrays from the arity-2 bucket.  ``n_pairs``
        counts pair edges (binary constraints), as in the JAX package."""
        t = self.tensors
        b2 = next((b for b in t.buckets if b.arity == 2), None)
        if b2 is None or b2.n_factors == 0:
            self.n_pairs = 0
            return
        self.n_pairs = b2.n_factors
        self.pair_bucket = b2
        vi = np.asarray(b2.var_idx, dtype=np.int64)
        dev = self.device
        self.pe_i = torch.as_tensor(vi[:, 0], device=dev)
        self.pe_j = torch.as_tensor(vi[:, 1], device=dev)
        # incidence: var → padded list of (edge, side), edges in id
        # order, side 0 before side 1 (the order the pick indexes)
        V = t.n_vars
        inc = [[] for _ in range(V)]
        for e in range(self.n_pairs):
            inc[vi[e, 0]].append((e, 0))
            inc[vi[e, 1]].append((e, 1))
        maxdeg = max((len(l) for l in inc), default=0)
        self.pair_deg = torch.as_tensor(
            np.array([len(l) for l in inc], dtype=np.int32), device=dev)
        inc_e = np.full((V, max(maxdeg, 1)), self.n_pairs, dtype=np.int64)
        inc_s = np.zeros((V, max(maxdeg, 1)), dtype=np.int64)
        for v, l in enumerate(inc):
            for k, (e, s) in enumerate(l):
                inc_e[v, k] = e
                inc_s[v, k] = s
        self.inc_e = torch.as_tensor(inc_e, device=dev)
        self.inc_s = torch.as_tensor(inc_s, device=dev)

    def draw_chunk_coins(self, n: int):
        return tuple(self.draw_uniforms(n) for _ in range(3))

    def packed_run(self, x_col, n, coins):
        return packed_mgm2_cycles(self.packed_mgm2, x_col, *coins,
                                  self.threshold, self.favor)

    def cycle(self, x, coins):
        """One generic cycle (JAX ``Mgm2Solver.cycle``) from x and this
        cycle's [V] coins (u_off, u_pick, u_fav)."""
        t = self.tensors
        V, D = t.n_vars, t.max_domain_size
        dev = x.device
        me = torch.arange(V, device=dev)
        cur, best_val, own_gain, tables = gains_and_best(
            t, x, tables=self.local_tables(x))
        eps = 1e-9

        if self.n_pairs == 0:
            move = neighborhood_winner(t, own_gain)
            return torch.where(move, best_val, x).to(torch.int32)

        P = self.n_pairs
        u_off, u_pick, u_fav = coins
        offerer = u_off < self.threshold

        # --- offer round: each offerer picks one random incident pair edge
        pick = torch.floor(
            u_pick * torch.clamp_min(self.pair_deg, 1).float()).long()
        k = torch.clamp_max(pick, self.inc_e.shape[1] - 1)
        chosen_e = self.inc_e[me, k]
        chosen_s = self.inc_s[me, k]
        valid_offer = offerer & (self.pair_deg > 0)
        # scatter into [P + 1]: the last slot is the dropped sentinel (an
        # index_fill_ of the scalar: an indexed assignment would copy it
        # from the host, which no CUDA graph may hold)
        drop = torch.full_like(chosen_e, P)
        sel0 = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill_(
            0, torch.where(valid_offer & (chosen_s == 0), chosen_e, drop),
            True)
        sel1 = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill_(
            0, torch.where(valid_offer & (chosen_s == 1), chosen_e, drop),
            True)
        offered0 = sel0[:P] & ~offerer[self.pe_j]  # i offers, j receives
        offered1 = sel1[:P] & ~offerer[self.pe_i]  # j offers, i receives
        offered = offered0 | offered1
        receiver = torch.where(offered0, self.pe_j, self.pe_i)

        # --- joint gain per pair edge
        M = self.pair_bucket.tensors  # [P, D, D]
        xl = x.long()
        xi, xj = xl[self.pe_i], xl[self.pe_j]
        ep = torch.arange(P, device=dev)
        m_row = M[ep, :, xj]  # [P, D]: M[e, d, xj]
        m_col = M[ep, xi, :]  # [P, D]: M[e, xi, d]
        ti_excl = tables[self.pe_i] - m_row
        tj_excl = tables[self.pe_j] - m_col
        joint = (ti_excl[:, :, None] + tj_excl[:, None, :]) + M
        pair_mask = (t.domain_mask[self.pe_i][:, :, None]
                     * t.domain_mask[self.pe_j][:, None, :])
        joint = torch.where(pair_mask > 0, joint, PAD_COST)
        cur_joint = (cur[self.pe_i] + cur[self.pe_j]) - M[ep, xi, xj]
        flat = joint.reshape(P, D * D)
        best_flat = torch.argmin(flat, dim=1)  # first index of the minimum
        best_joint = flat[ep, best_flat]
        jg = torch.clamp_min(cur_joint - best_joint, 0.0)
        di_star = (best_flat // D).to(torch.int32)
        dj_star = (best_flat % D).to(torch.int32)

        # --- response round: receiver takes its best positive offer and
        # commits iff the joint gain beats its own unilateral gain (ties
        # arbitrated by favor — reference mgm2.py:812-821)
        pos = offered & (jg > eps)
        seg_rec = torch.where(pos, receiver, torch.full_like(receiver, V))
        rec_max = segment_max(torch.where(offered, jg, -1.0), seg_rec,
                              V + 1)[:V]
        at_best = pos & (jg >= rec_max[receiver] - eps)
        first_e = segment_min(torch.where(at_best, ep, torch.full_like(
            ep, P)), seg_rec, V + 1)[:V]
        beats = rec_max > own_gain + eps
        ties = (rec_max - own_gain).abs() <= eps
        if self.favor == "coordinated":
            commits = beats | ties
        elif self.favor == "no":
            commits = beats | (ties & (u_fav > 0.5))
        else:  # unilateral
            commits = beats
        accepted = at_best & (ep == first_e[receiver]) & commits[receiver]

        # --- committed vars, pair targets, pair gains: writes into
        # [V + 1] buffers whose last slot is the dropped sentinel
        gi = torch.where(accepted, self.pe_i, torch.full_like(ep, V))
        gj = torch.where(accepted, self.pe_j, torch.full_like(ep, V))

        def scatter(base, vi, vj):
            out = torch.cat([base, base[:1]])
            out[gi] = vi
            out[gj] = vj
            return out[:V]

        committed = torch.zeros(V + 1, dtype=torch.bool, device=dev)
        committed = committed.index_fill_(0, gi, True).index_fill_(
            0, gj, True)[:V]
        pair_target = scatter(x.to(torch.int32), di_star, dj_star)
        pair_gain = scatter(torch.zeros(V, device=dev), jg, jg)
        partner = scatter(me, self.pe_j, self.pe_i)

        # --- gain & go rounds: neighborhood arbitration where partners
        # share a tie-break id so they don't block each other
        gain = torch.where(committed, pair_gain, own_gain)
        pid = torch.where(committed, torch.minimum(me, partner), me)
        src, dst = t.neighbor_src, t.neighbor_dst
        neigh_max = torch.clamp_min(segment_max(gain[src], dst, V), 0.0)
        at_max = gain[src] >= neigh_max[dst] - eps
        idx_at_max = segment_min(
            torch.where(at_max, pid[src], torch.full_like(src, V)), dst, V)
        winner = (gain > eps) & (
            (gain > neigh_max + eps)
            | (((gain - neigh_max).abs() <= eps) & (pid <= idx_at_max))
        )
        pair_go = committed & winner & winner[partner]
        x2 = torch.where(pair_go, pair_target, x.to(torch.int32))
        solo_move = ~committed & winner
        return torch.where(solo_move, best_val, x2).to(torch.int32)


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None,
                 use_packed=None) -> Mgm2Solver:
    algo_def = algo_def or AlgorithmDef.build_with_default_params(
        "mgm2", parameters_definitions=algo_params
    )
    tensors = compile_constraint_graph(dcop, device=device)
    return Mgm2Solver(dcop, tensors, algo_def, seed, use_packed)


def computation_memory(node) -> float:
    return float(len(node.neighbors)) * 2


def communication_load(node, target: str = None) -> float:
    # offers carry a D×D table in the worst case
    if hasattr(node, "variable"):
        return float(len(node.variable.domain)) ** 2
    return 1.0
