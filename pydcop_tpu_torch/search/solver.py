"""Anytime driver of the frontier-batched exact search.

:class:`FrontierSearchSolver` is the solve-path face of the engine: it
owns the chunk loop (ONE ``[2]`` incumbent+bound read per chunk),
decodes the spill flag and drains/reinjects the annex at chunk
boundaries (the counted host fallback), keeps the anytime ``lower <=
optimum <= upper`` sandwich in ``history`` (``collect_cycles=True``),
and terminates with an optimality PROOF when the bound meets the
incumbent.  It speaks the same surface as every other solver —
``run(cycles=, timeout=, collect_cycles=, resume=)`` returning a
:class:`SolveResult` — and a *cycle* is one device chunk.  It publishes
``search.bounds`` (each chunk), ``search.spill.drain`` and
``search.done`` on the event bus (``runtime/events.py``).

The JAX package's ``search/solver.py`` on this package's engine.  Not
ported with it: the program auditor's budget and trace count.
``resume=True`` continues from the previous run's device state, in
process or restored from a solver checkpoint (``solve_result``'s
``checkpoint_dir``: ``runtime/checkpoint.py`` saves the state dict, its
leaves by sorted key, and the host half beside it: the stashed rows and
the best bound, without which a resumed run could lose frontier nodes
and claim a proof it does not have).
"""
from __future__ import annotations

from time import perf_counter
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from pydcop_tpu_torch.algorithms import DEFAULT_INFINITY, AlgorithmDef
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.runtime.events import send_search
from pydcop_tpu_torch.search.frontier import FrontierEngine
from pydcop_tpu_torch.search.plan import (
    BIG,
    SearchPlan,
    compile_search_plan,
)

#: safety cap on open-ended runs (a *proof* loop, not a convergence
#: heuristic — hitting it means the instance needs a wider i-bound)
DEFAULT_MAX_CHUNKS = 100_000


class FrontierSearchSolver:
    """Device-resident anytime branch-and-bound over one DCOP, on
    ``device`` (cuda unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        dcop,
        tree=None,
        algo_def: Optional[AlgorithmDef] = None,
        seed: int = 0,
        algo: str = "syncbb",
        frontier_width: int = 0,
        ring: int = 0,
        steps: int = 0,
        i_bound: int = 0,
        bound_budget_bytes: Optional[int] = None,
        max_chunks: int = DEFAULT_MAX_CHUNKS,
        seed_incumbent: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.dcop = dcop
        self.mode = dcop.objective
        self.seed = seed
        self.infinity = DEFAULT_INFINITY
        params = dict(algo_def.params) if (
            algo_def is not None and algo_def.params
        ) else {}
        self.algo_name = algo_def.algo if algo_def is not None else algo
        self.algo_def = algo_def or AlgorithmDef(
            self.algo_name, {}, dcop.objective
        )
        B = int(frontier_width or params.get("frontier_width") or 0)
        R = int(ring or params.get("ring") or 0)
        S = int(steps or params.get("search_chunk") or 0)
        ib = int(i_bound or params.get("i_bound") or 0)
        budget_mb = float(params.get("budget_mb") or 0.0)
        self.seed_incumbent = bool(
            params.get("seed_incumbent", seed_incumbent))
        if bound_budget_bytes is None and budget_mb > 0:
            bound_budget_bytes = int(budget_mb * 2**20)
        self.max_chunks = int(max_chunks)

        self.n = len(dcop.variables)
        self.plan: Optional[SearchPlan] = None
        self.engine: Optional[FrontierEngine] = None
        if self.n:
            self.plan = compile_search_plan(
                dcop, tree=tree, i_bound=ib,
                bound_budget_bytes=bound_budget_bytes,
            )
            self.engine = FrontierEngine(
                self.plan,
                frontier_width=B or min(256, max(32, 2 * self.n)),
                ring=R,
                steps=S or 8,
                device=self.device,
            )
        self._last_state: Optional[Dict[str, Any]] = None
        self._stash: List[np.ndarray] = []   # [rows, n+3] packed f64
        self._lb_best = -np.inf              # sign-space, monotone
        #: rows waiting in the device inject buffer: every step clears
        #: it, so it is 0 after any chunk (a host mirror of ``j_count``)
        self._injected = 0

    def initial_state(self) -> Dict[str, Any]:
        assert self.engine is not None
        return self.engine.initial_state()

    # -- spill fallback -----------------------------------------------------

    def _drain_annex(self, state, counters) -> Dict[str, Any]:
        """Pull the annex rows to the host stash and clear the count —
        the counted fallback behind the bound scalar's spill flag."""
        xc = int(state["x_count"].cpu())
        counters["spill_drains"] += 1
        if xc > 0:
            rows = np.concatenate([
                state["x_assign"][:xc].cpu().numpy().astype(np.float64),
                state["x_g"][:xc, None].cpu().numpy().astype(np.float64),
                state["x_f"][:xc, None].cpu().numpy().astype(np.float64),
                state["x_depth"][:xc, None].cpu().numpy().astype(
                    np.float64),
            ], axis=1)
            self._stash.append(rows)
            counters["spill_rows"] += xc
        return {**state, "x_count": torch.zeros_like(state["x_count"])}

    def _reinject(self, state, counters) -> Dict[str, Any]:
        """Move up to one annex-quantum of stashed rows back into the
        device inject buffer (consumed by the next chunk's first
        step)."""
        if not self._stash or self._injected > 0:
            return state
        rows = np.concatenate(self._stash, axis=0)
        A = self.engine.shape.A
        take, rest = rows[:A], rows[A:]
        self._stash = [rest] if rest.size else []
        m, n = take.shape[0], max(self.n, 1)
        ja = np.zeros((A, n), np.int32)
        jg = np.zeros((A,), np.float32)
        jf = np.full((A,), BIG, np.float32)
        jd = np.zeros((A,), np.int32)
        ja[:m] = take[:, :n].astype(np.int32)
        jg[:m] = take[:, n].astype(np.float32)
        jf[:m] = take[:, n + 1].astype(np.float32)
        jd[:m] = take[:, n + 2].astype(np.int32)
        counters["reinjected_rows"] += m
        self._injected = m
        dev = self.device
        return {
            **state,
            "j_assign": torch.as_tensor(ja, device=dev),
            "j_g": torch.as_tensor(jg, device=dev),
            "j_f": torch.as_tensor(jf, device=dev),
            "j_depth": torch.as_tensor(jd, device=dev),
            "j_count": torch.tensor(m, dtype=torch.int32, device=dev),
        }

    def _stash_min_f(self) -> float:
        n = max(self.n, 1)
        if not self._stash:
            return np.inf
        return float(min(r[:, n + 1].min() for r in self._stash
                         if r.size))

    def _stash_rows(self) -> int:
        return int(sum(r.shape[0] for r in self._stash))

    def checkpoint_engine(self) -> str:
        """The layout of the state leaves (``runtime/checkpoint.py``)."""
        return "frontier"

    def checkpoint_host_arrays(self) -> Dict[str, np.ndarray]:
        """The host half of the search state, which a checkpoint carries
        beside the device leaves: the stashed rows the annex has not
        taken back yet, and the best bound published so far."""
        n = max(self.n, 1)
        rows = (np.concatenate(self._stash, axis=0) if self._stash
                else np.zeros((0, n + 3), np.float64))
        return {"stash": rows,
                "lb_best": np.asarray(self._lb_best, np.float64)}

    def restore_checkpoint_host(self, arrays: Dict[str, np.ndarray]) -> None:
        """Adopt :meth:`checkpoint_host_arrays`' output; a stash of
        another width raises ``ValueError`` before anything changes."""
        rows = np.asarray(arrays["stash"], np.float64)
        width = max(self.n, 1) + 3
        if rows.ndim != 2 or rows.shape[1] != width:
            raise ValueError(
                f"checkpoint stash rows have shape {rows.shape}, this "
                f"search stashes rows of {width} — different problem?")
        self._stash = [rows] if rows.size else []
        self._lb_best = float(arrays["lb_best"])
        self._injected = 0

    # -- run ----------------------------------------------------------------

    def run(self, cycles: Optional[int] = None,
            timeout: Optional[float] = None,
            collect_cycles: bool = False, resume: bool = False,
            **_kwargs) -> SolveResult:
        from pydcop_tpu_torch.runtime.stats import SearchCounters, \
            resolved_config

        t0 = perf_counter()
        if self.engine is None:  # no variables: trivially optimal
            violation, cost = self.dcop.solution_cost({}, self.infinity)
            return SolveResult("FINISHED", {}, cost, violation, 0, 0,
                               0.0, perf_counter() - t0)
        plan = self.plan
        warm = resume and self._last_state is not None
        state = self._last_state if warm else self.initial_state()
        if not warm:
            self._stash = []
            self._lb_best = -np.inf
            self._injected = 0
        if not warm and self.seed_incumbent:
            # seed the incumbent with one beam rollout: pruning starts on
            # the first chunk, and the anytime answer is a real leaf even
            # if best-first never reaches one; the width grows with n
            dive_assign, dive_g = self.engine.beam_dive(
                width=max(64, 4 * self.n))
            if dive_g < BIG / 2:
                state = {
                    **state,
                    "incumbent": torch.tensor(
                        dive_g, dtype=torch.float32, device=self.device),
                    "best_assign": torch.as_tensor(
                        dive_assign.astype(np.int32), device=self.device),
                }
        counters = SearchCounters()
        history: List[Dict[str, Any]] = []
        status = "FINISHED"
        proved = False
        limit = cycles if cycles is not None else self.max_chunks
        chunks = 0
        U = BIG
        lb_true = upper_true = None
        while chunks < limit:
            state, stats = self.engine.run_chunk(state)
            self._injected = 0
            su = stats.cpu().numpy()  # the per-chunk 2-scalar read
            counters["chunks"] += 1
            counters["scalar_reads"] += int(su.size)
            chunks += 1
            U = float(su[0])
            enc = float(su[1])
            # NaN bound = annex pending: the chunk publishes no bound
            # (the previous one remains valid); anything else is the
            # exact device bound, tightened by the host stash
            spilled = bool(np.isnan(enc))
            if spilled:
                state = self._drain_annex(state, counters)
                send_search("spill.drain", {
                    "chunk": chunks,
                    "stash_rows": self._stash_rows(),
                })
            else:
                lb = min(enc, self._stash_min_f(), U)
                self._lb_best = max(self._lb_best, lb)
                state = self._reinject(state, counters)
            # report in TRUE cost space: for max problems the engine's
            # sign-space sandwich flips orientation.  Until the first
            # clean (non-spill) chunk no bound has been published
            s = plan.sign
            incumbent_true = s * U if U < BIG / 2 else None
            if np.isfinite(self._lb_best):
                lo, hi = sorted((s * U, s * self._lb_best))
                lb_true, upper_true = lo, hi
                gap = max(0.0, float(U - self._lb_best))
            else:
                lo = hi = None
                gap = None
            if collect_cycles:
                history.append({
                    "cycle": chunks,
                    "cost": incumbent_true,
                    "lower_bound": lo,
                    "upper_bound": hi,
                    "gap": gap,
                    "time": perf_counter() - t0,
                })
            send_search("bounds", {
                "chunk": chunks,
                "incumbent": incumbent_true,
                "lower_bound": lo,
                "upper_bound": hi,
                "gap": gap,
                "proved": bool(self._lb_best >= U),
            })
            if self._lb_best >= U:
                proved = True
                break
            if timeout is not None and perf_counter() - t0 > timeout:
                status = "TIMEOUT"
                break
        # park any host-stashed rows back on the device so that a resumed
        # run finds them
        state = self._reinject(state, counters)
        self._last_state = state

        # single end-of-run state read: incumbent assignment + counts
        tail = torch.cat([
            state["best_assign"],
            torch.stack([state["nodes"], state["leaves"], state["pruned"],
                         state["lost"]]),
        ]).cpu().numpy()
        best = tail[:max(self.n, 1)]
        nodes, leaves, pruned, lost = (int(v) for v in tail[-4:])
        assignment: Dict[str, Any] = {}
        for i, name in enumerate(plan.order):
            dom = plan.domain_values[i]
            idx = int(best[i]) if U < BIG / 2 else 0
            assignment[name] = dom[min(idx, len(dom) - 1)]
        violation, cost = self.dcop.solution_cost(
            assignment, self.infinity
        )
        wall = perf_counter() - t0
        search = dict(plan.info())
        search.update(
            frontier_width=self.engine.shape.B,
            ring=self.engine.shape.R,
            steps_per_chunk=self.engine.shape.steps,
            nodes=nodes,
            leaves=leaves,
            pruned=pruned,
            lost_rows=lost,
            nodes_per_s=round(nodes / wall, 1) if wall > 0 else 0.0,
            lower_bound=lb_true,
            upper_bound=upper_true,
            gap=(
                max(0.0, float(U - self._lb_best))
                if lb_true is not None else None
            ),
            optimal=proved,
            stash_rows=self._stash_rows(),
            **counters.as_dict(),
        )
        send_search("done", {
            "status": status, "optimal": proved, "chunks": chunks,
            "nodes": nodes, "cost": cost,
        })
        return SolveResult(
            status=status,
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=chunks,
            msg_count=nodes,
            msg_size=float(nodes * plan.n),
            time=wall,
            history=history if collect_cycles else None,
            search=search,
            config=resolved_config(
                self.algo_name, "frontier", i_bound=plan.i_bound
            ),
        )


def build_frontier_solver(dcop, computation_graph=None, algo_def=None,
                          seed: int = 0, algo: str = "syncbb",
                          device: DeviceLike = None,
                          **overrides) -> FrontierSearchSolver:
    """Shared constructor for the syncbb/ncbb ``engine=frontier`` route
    and DPOP's ``engine=frontier``; ``computation_graph`` is reused when
    it already is a pseudo-tree."""
    tree = (
        computation_graph
        if computation_graph is not None
        and hasattr(computation_graph, "roots")
        else None
    )
    return FrontierSearchSolver(
        dcop, tree=tree, algo_def=algo_def, seed=seed, algo=algo,
        device=device, **overrides,
    )
