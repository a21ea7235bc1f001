"""The frontier step and chunk runner of the anytime branch and bound.

One *step* expands the best-first prefix of the live slab one level
along the search order: every expanded row produces ``Dmax`` children
whose cost increments and mini-bucket lower bounds are gathered from
the plan's flat tables, leaf children update the device-resident
incumbent (value + argmin assignment), children at or above the
incumbent are pruned on arrival, and the survivor pool — unexpanded
rows + children + a ring pop + host-reinjected rows — is sorted once by
``f = g + h`` so the best ``B`` stay in the slab and the overflow is
pushed back (ring first, then the spill annex).  Expansion is
capacity-throttled so no node is ever dropped: when slab + ring + annex
are full the step stalls (expands nothing) until the host drains the
annex at the next chunk boundary — the counted spill fallback.

The JAX package's ``search/frontier.py`` written as PyTorch tensor code
on an explicit device (the JAX engine has no Pallas kernel, so neither
has this one).  A *chunk* is ``steps`` calls of the step function on
state tensors that stay on the device; its host-visible output is ONE
``[2]`` float32 vector, ``[incumbent, bound]``.  The bound is NaN when
annex rows await draining (an exact sentinel, see
``plan.SPILL_SENTINEL``: such chunks publish no bound and the previous
one stays valid).  The search is finished when ``bound >= incumbent``,
which is the optimality proof.

What keeps it equal to the JAX engine, choice for choice:

* every sort is stable (``torch.sort``/``torch.argsort(stable=True)``),
  as ``jnp.argsort(stable=True)`` is;
* ``jax.lax.top_k`` in the beam dive keeps the lower index on ties, which
  ``torch.topk`` does not promise: the dive takes the first ``W`` rows of
  a stable ascending sort instead;
* ``argmin`` returns the first minimum in both libraries;
* out-of-range gathers clamp, as JAX's gathers do (a padded value's
  offsets can run past a flat table; such children are pruned by their
  ``PAD_COST`` unary anyway);
* the state keeps JAX's dtypes (int32 assignments, depths, counts and
  counters; float32 costs; bool liveness); indices become int64 only
  for a gather.

A step keeps every shape static and never reads the device from the
host: no boolean-mask indexing, no ``nonzero``, no ``.item()``, so a
chunk runs with ``torch.cuda.set_sync_debug_mode("error")``.  The JAX
engine's ``ProgramBudget`` and trace count belong to the program auditor,
which this package does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.search.plan import BIG, SearchPlan


@dataclasses.dataclass
class FrontierShape:
    """Fixed shapes of one engine instance."""

    B: int        # slab rows (frontier width)
    R: int        # ring rows (device spill)
    A: int        # annex/inject rows (host spill quantum)
    steps: int    # expand steps per chunk


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 with the index clamped into range, as a
    JAX gather clamps it."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


class FrontierEngine:
    """Device half of the frontier search over a :class:`SearchPlan`: the
    step, the chunk runner and the beam dive, on one device.  Driving
    (the anytime loop, the spill drain) lives in ``search.solver``.  The
    plan's cardinality slabs are empty in this package (no structured
    constraints), so the step adds no cardinality increment."""

    def __init__(self, plan: SearchPlan, frontier_width: int = 256,
                 ring: int = 0, steps: int = 16,
                 device: torch.device = torch.device("cpu")):
        B = max(2, int(frontier_width))
        D = max(1, plan.Dmax)
        self.plan = plan
        self.device = device
        # annex scales with the slab: a chunk whose spills outrun the
        # annex stalls expansion until the next host drain, so a
        # too-small quantum turns sustained pressure into idle steps
        self.shape = FrontierShape(
            B=B,
            R=int(ring) if ring else 8 * B,
            A=max(B // 4, D, 8),
            steps=max(1, int(steps)),
        )

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        p = plan
        i32, f32 = torch.int32, torch.float32
        self._t = {
            "unary": put(p.unary, f32),
            "c_flat": put(p.c_flat, f32),
            "c_base": put(p.c_base, i32),
            "c_valid": put(p.c_valid, f32),
            "c_pos": put(p.c_pos, i32),
            "c_stride": put(p.c_stride, i32),
            "c_own": put(p.c_own_stride, i32),
            "h_flat": put(p.h_flat, f32),
            "m_base": put(p.m_base, i32),
            "m_valid": put(p.m_valid, f32),
            "m_pos": put(p.m_pos, i32),
            "m_stride": put(p.m_stride, i32),
            "h_const": put(p.h_const, f32),
            "dom": (put(p.dom_sizes, i32) if p.n
                    else torch.ones((1,), dtype=i32, device=device)),
        }

    # -- state --------------------------------------------------------------

    def initial_state(self) -> Dict[str, torch.Tensor]:
        p, s, dev = self.plan, self.shape, self.device
        n = max(p.n, 1)

        def rows(m):
            return {
                "assign": torch.zeros((m, n), dtype=torch.int32, device=dev),
                "g": torch.zeros((m,), dtype=torch.float32, device=dev),
                "f": torch.full((m,), BIG, dtype=torch.float32, device=dev),
                "depth": torch.zeros((m,), dtype=torch.int32, device=dev),
            }

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        front = rows(s.B)
        # the root row: empty prefix, f = the global MBE bound
        front["f"][0] = float(np.float32(p.root_bound))
        state = {"f_" + k: v for k, v in front.items()}
        live = torch.zeros((s.B,), dtype=torch.bool, device=dev)
        live[0] = p.n > 0
        state["f_live"] = live
        # ring and annex carry one extra "dump" row absorbing the
        # masked scatter lanes, so a genuine push never collides with
        # a no-op write
        for pre, m in (("r_", s.R + 1), ("x_", s.A + 1), ("j_", s.A)):
            for k, v in rows(m).items():
                state[pre + k] = v
        for k in ("r_count", "x_count", "j_count"):
            state[k] = scalar(0, torch.int32)
        state["incumbent"] = scalar(BIG, torch.float32)
        state["best_assign"] = torch.zeros((n,), dtype=torch.int32,
                                           device=dev)
        for k in ("nodes", "leaves", "pruned", "lost"):
            state[k] = scalar(0, torch.int32)
        return state

    # -- gather kernels -----------------------------------------------------

    def inc_rows(self, assign: torch.Tensor, k: torch.Tensor
                 ) -> torch.Tensor:
        """``[rows, Dmax]`` cost increments of assigning ``order[k]``
        under each row's prefix — one gather-sum over the flat tables.
        ``assign`` is ``[rows, n]`` int32, ``k`` ``[rows]``."""
        t, D = self._t, self.plan.Dmax
        # a dead row may sit at depth n: clamp, as the JAX gathers do
        kl = k.long().clamp(0, t["c_base"].shape[0] - 1)
        rows = assign.shape[0]
        c_pos = t["c_pos"][kl]                          # [rows, C, A]
        C, Am = c_pos.shape[1], c_pos.shape[2]
        got = torch.gather(assign, 1, c_pos.reshape(rows, -1).long())
        base = t["c_base"][kl].long() + torch.sum(
            t["c_stride"][kl].long() * got.reshape(rows, C, Am).long(),
            dim=-1)                                     # [rows, C]
        offs = base[:, :, None] + (
            torch.arange(D, device=self.device)[None, None, :]
            * t["c_own"][kl].long()[:, :, None])        # [rows, C, D]
        vals = _take(t["c_flat"], offs.reshape(-1)).reshape(rows, C, D)
        return t["unary"][kl] + torch.sum(
            t["c_valid"][kl][:, :, None] * vals, dim=1)

    def h_rows(self, child: torch.Tensor, d: torch.Tensor
               ) -> torch.Tensor:
        """Mini-bucket lower bound of the suffix below depth ``d[b]`` for
        every child ``child[b, j]`` (``[rows, Dmax, n]``): ``[rows,
        Dmax]``."""
        t = self._t
        rows, Dm, n = child.shape
        dl = d.long().clamp(0, t["m_base"].shape[0] - 1)
        m_pos = t["m_pos"][dl]                          # [rows, M, H]
        M, H = m_pos.shape[1], m_pos.shape[2]
        idx = m_pos.reshape(rows, 1, M * H).expand(rows, Dm, M * H).long()
        got = torch.gather(child, 2, idx).reshape(rows, Dm, M, H)
        base = t["m_base"][dl].long()[:, None, :] + torch.sum(
            t["m_stride"][dl].long()[:, None, :, :] * got.long(),
            dim=-1)                                     # [rows, Dm, M]
        vals = _take(t["h_flat"], base.reshape(-1)).reshape(rows, Dm, M)
        return t["h_const"][dl][:, None] + torch.sum(
            t["m_valid"][dl][:, None, :] * vals, dim=-1)

    def _children(self, assign: torch.Tensor, k: torch.Tensor
                  ) -> torch.Tensor:
        """``[rows, Dmax, n]``: each row with ``order[k]`` set to every
        value index."""
        n = assign.shape[1]
        D = self.plan.Dmax
        vals = torch.arange(D, dtype=torch.int32, device=self.device)
        at_k = (torch.arange(n, device=self.device)[None, None, :]
                == k.long()[:, None, None])
        return torch.where(at_k, vals[None, :, None], assign[:, None, :])

    # -- step ---------------------------------------------------------------

    def step(self, st: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        p, s, dev = self.plan, self.shape, self.device
        n = max(p.n, 1)
        D = p.Dmax
        B, R, A = s.B, s.R, s.A
        INF = float("inf")
        i32 = torch.int32

        U = st["incumbent"]
        # rows at/above the incumbent can never improve it: dead
        live = st["f_live"] & (st["f_f"] < U)
        live_count = torch.sum(live)
        stored = (live_count + st["r_count"] + st["x_count"]
                  + st["j_count"])
        slack = (B + R + A) - stored
        E = torch.clamp(torch.div(slack, max(D - 1, 1),
                                  rounding_mode="floor"), 0, B)

        # best-first choice of the E rows to expand; equal-f ties break
        # toward DEEPER rows, as in the JAX engine
        deep = torch.argsort(-st["f_depth"], stable=True)
        keys = torch.where(live, st["f_f"], INF)
        by_f = deep[torch.argsort(keys[deep], stable=True)]
        rank = torch.argsort(by_f, stable=True)
        expand = live & (rank < E)

        k = st["f_depth"]                               # [B]
        inc = self.inc_rows(st["f_assign"], k)          # [B, D]
        g_c = st["f_g"][:, None] + inc
        vals = torch.arange(D, dtype=i32, device=dev)
        child_assign = self._children(st["f_assign"], k)  # [B, D, n]
        d_child = torch.clamp(k + 1, max=p.n)
        h_c = self.h_rows(child_assign, d_child)        # [B, D]
        f_c = g_c + h_c

        is_leaf = (k + 1 == p.n)                        # [B]
        val_ok = vals[None, :] < self._t["dom"][
            torch.clamp(k, 0, n - 1).long()][:, None]
        leaf_g = torch.where(
            expand[:, None] & is_leaf[:, None] & val_ok, g_c, INF)
        # argmin returns the first minimum, in both libraries
        best_flat = torch.argmin(leaf_g.reshape(-1)).reshape(1)
        leaf_min = leaf_g.reshape(-1).index_select(0, best_flat)[0]
        improved = leaf_min < U
        U2 = torch.where(improved, leaf_min, U)
        best_assign = torch.where(
            improved,
            child_assign.reshape(-1, n).index_select(0, best_flat)[0],
            st["best_assign"],
        )

        opened = expand[:, None] & (~is_leaf)[:, None]
        child_open = opened & (f_c < U2)
        n_pruned = torch.sum(opened & val_ok & (f_c >= U2))

        # ---- pool: survivors + children + ring pop + inject
        pop_idx = st["r_count"] - 1 - torch.arange(B, dtype=i32,
                                                   device=dev)
        pop_ok = pop_idx >= 0
        pop_at = torch.clamp(pop_idx, 0, R - 1).long()
        inj_ok = torch.arange(A, dtype=i32, device=dev) < st["j_count"]

        pool_assign = torch.cat([
            st["f_assign"], child_assign.reshape(-1, n),
            st["r_assign"][pop_at], st["j_assign"]])
        pool_g = torch.cat([st["f_g"], g_c.reshape(-1),
                            st["r_g"][pop_at], st["j_g"]])
        pool_f = torch.cat([st["f_f"], f_c.reshape(-1),
                            st["r_f"][pop_at], st["j_f"]])
        pool_depth = torch.cat([
            st["f_depth"], (k[:, None] + 1).expand(B, D).reshape(-1),
            st["r_depth"][pop_at], st["j_depth"]])
        pool_ok = torch.cat([
            live & ~expand, child_open.reshape(-1), pop_ok, inj_ok,
        ]) & (pool_f < U2)

        # same deeper-first tie-break as the expansion choice, so equal-f
        # children outrank their parents in the slab
        pdeep = torch.argsort(-pool_depth, stable=True)
        order = pdeep[torch.argsort(
            torch.where(pool_ok, pool_f, INF)[pdeep], stable=True)]
        pool_assign = pool_assign[order]
        pool_g = pool_g[order]
        pool_f = pool_f[order]
        pool_depth = pool_depth[order]
        pool_ok = pool_ok[order]

        n_valid = torch.sum(pool_ok).to(i32)
        r_count = torch.clamp(st["r_count"] - torch.sum(pop_ok).to(i32),
                              min=0)
        n_push = torch.clamp(n_valid - B, min=0)
        to_ring = torch.minimum(n_push, R - r_count)
        to_annex = torch.minimum(n_push - to_ring, A - st["x_count"])
        lost = n_push - to_ring - to_annex

        P = pool_f.shape[0]
        ov = torch.arange(P, dtype=i32, device=dev) - B  # overflow rank
        pushing = pool_ok & (ov >= 0)
        # ring pushes go in REVERSE priority order so the stack top
        # (popped first next step) holds the best overflow row
        ring_slot = r_count + (to_ring - 1 - ov)
        ring_idx = torch.where(pushing & (ov < to_ring), ring_slot,
                               R).long()
        annex_slot = st["x_count"] + (ov - to_ring)
        annex_idx = torch.where(
            pushing & (ov >= to_ring) & (ov < to_ring + to_annex),
            annex_slot, A).long()

        def push(buf, idx, vals_, cap):
            # the ring/annex buffers carry one extra dump row (index
            # cap) that absorbs the non-pushed lanes: every lane aimed
            # at it writes the dump row's own value back
            at = torch.clamp(idx, 0, cap)
            keep = (idx < cap).reshape((-1,) + (1,) * (vals_.dim() - 1))
            out = buf.clone()
            out[at] = torch.where(keep, vals_, buf[at])
            return out

        return {
            "f_assign": pool_assign[:B],
            "f_g": pool_g[:B],
            "f_f": pool_f[:B],
            "f_depth": pool_depth[:B],
            "f_live": pool_ok[:B],
            "r_assign": push(st["r_assign"], ring_idx, pool_assign, R),
            "r_g": push(st["r_g"], ring_idx, pool_g, R),
            "r_f": push(st["r_f"], ring_idx, pool_f, R),
            "r_depth": push(st["r_depth"], ring_idx, pool_depth, R),
            "r_count": (r_count + to_ring).to(i32),
            "x_assign": push(st["x_assign"], annex_idx, pool_assign, A),
            "x_g": push(st["x_g"], annex_idx, pool_g, A),
            "x_f": push(st["x_f"], annex_idx, pool_f, A),
            "x_depth": push(st["x_depth"], annex_idx, pool_depth, A),
            "x_count": (st["x_count"] + to_annex).to(i32),
            "j_assign": st["j_assign"], "j_g": st["j_g"],
            "j_f": st["j_f"], "j_depth": st["j_depth"],
            "j_count": torch.zeros_like(st["j_count"]),
            "incumbent": U2,
            "best_assign": best_assign,
            "nodes": (st["nodes"] + torch.sum(expand)).to(i32),
            "leaves": (st["leaves"] + torch.sum(expand & is_leaf)).to(i32),
            "pruned": (st["pruned"] + n_pruned).to(i32),
            "lost": (st["lost"] + lost).to(i32),
        }

    def beam_dive(self, width: int = 64) -> Tuple[np.ndarray, float]:
        """Depth-synchronous beam rollout: carry ``width`` partial rows
        from the empty prefix to the leaves, keeping the best ``width``
        children by f = g + h at every depth.  Returns ``(assign, cost)``
        of the best leaf — a true upper bound usable as an initial
        incumbent (a beam survives tight feasibility structure that a
        lone greedy rollout paints itself into).  The host reads the
        result once, after the last depth."""
        p, dev = self.plan, self.device
        if not p.n:
            return np.zeros((0,), np.int32), 0.0
        n, D = p.n, p.Dmax
        W = max(int(width), 1)
        INF = float("inf")
        assign = torch.zeros((W, n), dtype=torch.int32, device=dev)
        g = torch.zeros((W,), dtype=torch.float32, device=dev)
        ok = torch.zeros((W,), dtype=torch.bool, device=dev)
        ok[0] = True
        vals = torch.arange(D, dtype=torch.int32, device=dev)
        for k in range(n):
            ks = torch.full((W,), k, dtype=torch.int32, device=dev)
            g_c = g[:, None] + self.inc_rows(assign, ks)      # [W, D]
            child = self._children(assign, ks)                # [W, D, n]
            h = self.h_rows(child, torch.clamp(ks + 1, max=n))
            f = torch.where(
                ok[:, None] & (vals[None, :] < int(p.dom_sizes[k])),
                g_c + h, INF).reshape(-1)
            # jax.lax.top_k(-f, W) keeps the lower index on ties: the
            # first W of a stable ascending sort
            idx = torch.argsort(f, stable=True)[:W]
            assign = child.reshape(-1, n)[idx]
            g = g_c.reshape(-1)[idx]
            ok = f[idx] < INF
        leaf_g = torch.where(ok, g, INF)
        best = torch.argmin(leaf_g).reshape(1)
        out = torch.cat([assign.index_select(0, best)[0].float(),
                         leaf_g.index_select(0, best)]).cpu().numpy()
        return out[:n].astype(np.int32), float(out[n])

    def lower_bound(self, st: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Global bound: min over every open row's f, clamped by the
        incumbent, in the JAX engine's order."""
        INF = float("inf")
        s, dev = self.shape, self.device

        def open_min(f, count, m):
            held = torch.arange(m, dtype=torch.int32, device=dev) < count
            return torch.min(torch.where(held, f, INF))

        lb = torch.minimum(
            torch.min(torch.where(st["f_live"], st["f_f"], INF)),
            open_min(st["r_f"], st["r_count"], s.R + 1))
        lb = torch.minimum(lb, open_min(st["x_f"], st["x_count"], s.A + 1))
        lb = torch.minimum(lb, open_min(st["j_f"], st["j_count"], s.A))
        return torch.minimum(st["incumbent"], lb)

    def run_chunk(self, state: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """``shape.steps`` expand steps on the device; returns ``(state,
        [incumbent, bound'])``, the two scalars the only steady-state
        host traffic (bound' is NaN while the annex waits to be
        drained).  Nothing here reads the device from the host."""
        for _ in range(self.shape.steps):
            state = self.step(state)
        lb = self.lower_bound(state)
        # NaN = "annex needs draining": an exact sentinel — an additive
        # flag offset would cost the bound up to an f32 ulp of the
        # offset (enough to fake a proof)
        enc = torch.where(state["x_count"] > 0, float("nan"), lb)
        return state, torch.stack([state["incumbent"], enc])
