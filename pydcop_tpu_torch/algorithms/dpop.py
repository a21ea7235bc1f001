"""DPOP — Dynamic Programming Optimization Protocol (complete inference on a
pseudo-tree).

Equivalent capability to the reference's pydcop/algorithms/dpop.py
(DpopAlgo :115, UTIL phase :239-365, VALUE phase :375-425): leaves send UTIL
tables up — each node joins its children's tables with its own constraints
and projects itself out — then VALUE assignments flow down from the root.

UTIL tables are dense tensors; joins are broadcast adds and projections
axis reductions (ops/dpop_kernels), sequenced by the pseudo-tree's level
schedule.  The engines, in the order the ``auto`` ladder tries them:

* ``wholesweep`` — on CUDA, the hand-written whole-sweep kernel
  (ops/packed_dpop, ``csrc/dpop_sweep.cu``) for every plan whose
  separators are all the parent (width 1);
* ``sweep`` — the batched level scan (ops/dpop_sweep), everything padded
  to the tree-wide separator width;
* ``sweep_perlevel`` — the same, each level padded to its own width;
* ``pernode`` — the per-node host/device loop.

Message counts and sizes are tracked per UTIL table for metric parity
(DpopMessage.size, dpop.py:98-104).  Routing goes by plan shape only:
a kernel that fails to build or launch raises.  ``engine=frontier`` runs
the anytime exact search (:mod:`pydcop_tpu_torch.search`) over the same
pseudo-tree.  The engine this package has not ported (``sharded``) raises
:class:`~pydcop_tpu_torch.errors.NotPortedError` wherever the JAX ladder
would take it — and so the auto ladder never reaches its frontier tier,
which the JAX ladder tries only after the sharded one.
"""
from __future__ import annotations

from time import perf_counter
from typing import Dict, Optional

import numpy as np

from pydcop_tpu_torch.algorithms import (
    AlgoParameterDef,
    AlgorithmDef,
    DEFAULT_INFINITY,
)
from pydcop_tpu_torch.algorithms.base import SolveResult
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.errors import NotPortedError
from pydcop_tpu_torch.graph import pseudotree as pt_module
from pydcop_tpu_torch.graph.pseudotree import (
    ComputationPseudoTree,
    PseudoTreeNode,
)
from pydcop_tpu_torch.ops.dpop_kernels import (
    Dims,
    argopt_value,
    join_t,
    project_t,
    slice_t,
    table_size,
)
from pydcop_tpu_torch.ops.dpop_shard import (
    UtilTableTooLarge,
    estimate_sweep_bytes,
    minibucket_solve,
    suggest_i_bound,
)

GRAPH_TYPE = "pseudotree"

# reference: no parameters (dpop.py:45).  `engine` and the rest are the
# JAX package's, with its names, values and defaults: "auto" walks the
# ladder above; "sweep" forces the level scan; "wholesweep" the
# whole-sweep kernel (its plain version on the CPU); "minibucket" the
# bounded approximation; "frontier" the anytime exact search;
# "sharded" is not ported and raises.  `budget_mb` is the per-device table budget the auto tier
# routes on (0 = engine caps), `i_bound` the mini-bucket width bound
# (0 = off); `prune` and `shards` configure the sharded sweep, so any
# value but their defaults raises.
algo_params = [
    AlgoParameterDef("engine", "str",
                     ["auto", "sweep", "wholesweep", "sharded",
                      "frontier", "minibucket"], "auto"),
    AlgoParameterDef("budget_mb", "float", None, 0.0),
    AlgoParameterDef("i_bound", "int", None, 0),
    AlgoParameterDef("prune", "bool", None, True),
    AlgoParameterDef("shards", "int", None, 0),
]


def _not_ported(engine: str, why: str) -> NotPortedError:
    return NotPortedError(
        f"dpop engine {engine!r} is not ported to the PyTorch package "
        f"({why}); it runs the single-device sweeps, the whole-sweep "
        f"kernel and the mini-bucket fallback only"
    )


class DpopSolver:
    """Two tree sweeps; not round-based, so it implements run() directly."""

    #: refuse UTIL tables beyond this many entries: DPOP is exponential in
    #: the pseudo-tree's induced width, and a clear error beats an
    #: out-of-memory hang on high-width graphs.  The refusal is typed
    #: (ops/dpop_shard.UtilTableTooLarge)
    max_table_entries: int = 100_000_000

    #: engine used by the last run(): "wholesweep", "sweep",
    #: "sweep_perlevel", "pernode", "minibucket" or "frontier"
    last_engine: str = ""

    def __init__(self, dcop: DCOP, tree: Optional[ComputationPseudoTree] =
                 None, algo_def: Optional[AlgorithmDef] = None, seed: int = 0,
                 device: DeviceLike = None):
        # this package's YAML loader refuses structured constraints, so
        # the JAX solver's lowering of them has nothing to do here
        self.device = resolve_device(device)
        self.dcop = dcop
        self.mode = dcop.objective
        self.tree = tree or pt_module.build_computation_graph(dcop)
        self.infinity = DEFAULT_INFINITY
        self.msg_count = 0
        self.msg_size = 0
        params = (
            algo_def.params
            if algo_def is not None and algo_def.params else {}
        )
        self.engine = params.get("engine", "auto")
        budget_mb = float(params.get("budget_mb") or 0.0)
        #: per-DEVICE byte budget for util tables (None = engine caps)
        self.budget_bytes = (
            int(budget_mb * 2**20) if budget_mb > 0 else None
        )
        self.i_bound = int(params.get("i_bound") or 0)
        if params.get("prune", True) is not True:
            raise _not_ported("sharded", "prune:false sets its wire pruning")
        if int(params.get("shards") or 0) != 0:
            raise _not_ported("sharded", "shards sets its mesh size")

    def _node_constraint_table(self, node: PseudoTreeNode):
        """Join the node's own constraints + its variable costs into one
        table (dims include the node's variable)."""
        v = node.variable
        dims: Dims = [(v.name, len(v.domain))]
        ext = {
            ev.name: ev.value for ev in self.dcop.external_variables.values()
        }
        # tables start on the host; join_t moves them to the device once
        # they cross DEVICE_THRESHOLD entries
        t = np.asarray(v.cost_vector(), dtype=np.float32)
        for c in node.constraints:
            if any(n in ext for n in c.scope_names):
                c = c.slice(ext)
            c_dims = [(d.name, len(d.domain)) for d in c.dimensions]
            c_t = np.asarray(c.to_tensor(), dtype=np.float32)
            t, dims = join_t(t, dims, c_t, c_dims, device=self.device)
        return t, dims

    def _resolved_config(self, i_bound: Optional[int] = None):
        """Canonical executed-config record (metrics()['config']):
        engine = the tier the auto routing actually landed on, not the
        requested parameter."""
        from pydcop_tpu_torch.runtime.stats import resolved_config

        return resolved_config(
            "dpop",
            self.last_engine or self.engine,
            dpop_budget_mb=(
                self.budget_bytes / 2**20 if self.budget_bytes else 0.0
            ),
            i_bound=self.i_bound if i_bound is None else int(i_bound),
        )

    def run(self, cycles=None, timeout=None, **_kwargs) -> SolveResult:
        # the JAX ladder: (1) global batched sweep (the whole-sweep
        # kernel for width-1 plans on CUDA), (2) per-level sweep, (3)
        # per-node loop; and, when the tables exceed one device (planner
        # byte estimate vs budget_mb or the engine caps), (4) the
        # separator-sharded mesh sweep, (5) the frontier search and (6)
        # the mini-bucket fallback.  (4) is not ported: where the JAX
        # ladder would take it this one raises — it never skips ahead
        # to (5) or (6).  A forced engine="frontier" runs (5)
        from pydcop_tpu_torch.ops.dpop_sweep import (
            compile_sweep,
            compile_sweep_perlevel,
        )

        if self.engine == "frontier":
            return self._run_frontier()
        if self.engine == "minibucket":
            return self._run_minibucket()
        if self.engine == "sharded":
            raise _not_ported("sharded", "the multi-GPU sweep")
        if self.engine == "auto" and self.budget_bytes is not None:
            est = estimate_sweep_bytes(self.tree)
            if est["bytes"] > self.budget_bytes:
                raise _not_ported(
                    "sharded",
                    f"the sweep needs ~{est['bytes'] / 2**20:.1f} MiB, "
                    f"over the {self.budget_bytes / 2**20:.1f} MiB "
                    f"budget, where the ladder tiles it over the mesh")
        plan = compile_sweep(self.tree, self.dcop, self.mode,
                             device=self.device)
        perlevel = False
        if plan is None:
            plan = compile_sweep_perlevel(self.tree, self.dcop, self.mode,
                                          device=self.device)
            perlevel = True
        if plan is not None:
            return self._run_sweep(plan, perlevel=perlevel)
        if self.engine == "auto":
            est = estimate_sweep_bytes(self.tree)
            if est["max_node_entries"] > self.max_table_entries:
                raise _not_ported(
                    "sharded",
                    "both batched sweeps refused the plan and the "
                    "per-node path would exceed its table cap")
        return self._run_pernode()

    def _run_frontier(self) -> SolveResult:
        """``engine="frontier"``: exact anytime search over the same
        pseudo-tree, bound tables sized to the per-device budget, run
        open-ended to its optimality proof (the JAX solver's
        ``_run_frontier(forced=True)``)."""
        from pydcop_tpu_torch.search.solver import (
            DEFAULT_MAX_CHUNKS,
            FrontierSearchSolver,
        )

        solver = FrontierSearchSolver(
            self.dcop, tree=self.tree, seed=0, algo="dpop",
            i_bound=self.i_bound,
            bound_budget_bytes=self.budget_bytes,
            max_chunks=DEFAULT_MAX_CHUNKS,
            device=self.device,
        )
        res = solver.run()
        self.last_engine = "frontier"
        res.config = self._resolved_config(
            i_bound=res.search.get("i_bound", self.i_bound)
        )
        res.config["engine"] = "frontier"
        return res

    def _run_sweep(self, plan, perlevel: bool = False) -> SolveResult:
        from pydcop_tpu_torch.ops.dpop_sweep import (
            run_sweep,
            run_sweep_perlevel,
        )
        from pydcop_tpu_torch.ops.packed_dpop import (
            pack_sweep,
            whole_sweep_values,
        )

        t0 = perf_counter()
        self.last_engine = "sweep_perlevel" if perlevel else "sweep"
        # the kernel builds once in seconds and is cached, so on CUDA
        # "auto" takes it for every plan it packs; "wholesweep" forces it
        # (its plain version on the CPU)
        want_whole = not perlevel and (
            self.engine == "wholesweep"
            or (self.engine == "auto" and self.device.type == "cuda"))
        ps = pack_sweep(plan) if want_whole else None
        if ps is not None:
            assign_idx = whole_sweep_values(ps).cpu().numpy()
            self.last_engine = "wholesweep"
        elif perlevel:
            assign_idx, _ = run_sweep_perlevel(plan)
        else:
            assign_idx, _ = run_sweep(plan)
        return self._finish_sweep_result(
            assign_idx, plan.gid_to_name, plan.sep_size, t0
        )

    def _fill_missing(self, assignment: Dict) -> None:
        """Variables absent from the tree (no constraint at all) take
        their best unary value."""
        for name, v in self.dcop.variables.items():
            if name not in assignment:
                costs = v.cost_vector()
                idx = int(
                    np.argmin(costs) if self.mode == "min" else
                    np.argmax(costs)
                )
                assignment[name] = v.domain[idx]

    def _finish_sweep_result(self, assign_idx, gid_to_name, sep_size,
                             t0) -> SolveResult:
        """Shared tail of the batched engines: assignment from the gid
        vector, min-cost fill for variables absent from a partial tree,
        and the UTIL/VALUE message metrics (parity with DpopMessage.size,
        ref dpop.py:98-104): one UTIL message per non-root node, sized by
        its true (unpadded) separator domains; VALUE messages as in the
        per-node path."""
        tree = self.tree
        assignment = {}
        for gidx, name in enumerate(gid_to_name):
            v = tree.computation(name).variable
            assignment[name] = v.domain[int(assign_idx[gidx])]
        self._fill_missing(assignment)
        self.msg_count = 0
        self.msg_size = 0
        n_assigned = 0
        for level in tree.nodes_by_depth():
            for node in level:
                n_assigned += 1
                if node.parent is not None:
                    self.msg_count += 1
                    self.msg_size += sep_size[node.name]
                self.msg_count += len(node.children)
                self.msg_size += len(node.children) * max(1, n_assigned)
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
        return SolveResult(
            status="FINISHED",
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=tree.height + 1,
            msg_count=self.msg_count,
            msg_size=float(self.msg_size),
            time=perf_counter() - t0,
            config=self._resolved_config(),
        )

    def _run_minibucket(self) -> SolveResult:
        """Bounded mini-bucket fallback: buckets split at ``i_bound``,
        result carries the lower ≤ optimum ≤ upper sandwich in
        metrics()["dpop"] instead of refusing the instance."""
        t0 = perf_counter()
        i_bound = self.i_bound
        if i_bound <= 0:
            # engine forced without an explicit bound: pick the widest
            # bucket the budget (or engine cap) fits
            Dmax = max(
                (len(v.domain) for v in self.dcop.variables.values()),
                default=2,
            )
            i_bound = suggest_i_bound(Dmax, self.budget_bytes)
        assignment_idx, relax, info = minibucket_solve(
            self.tree, self.dcop, self.mode, i_bound, device=self.device
        )
        self.last_engine = "minibucket"
        assignment = {
            name: self.tree.computation(name).variable.domain[idx]
            for name, idx in assignment_idx.items()
        }
        self._fill_missing(assignment)
        violation, cost = self.dcop.solution_cost(
            assignment, self.infinity
        )
        # the relaxation bounds the optimum from below (min) / above
        # (max); the decoded assignment's true cost from the other side
        lower = relax if self.mode == "min" else cost
        upper = cost if self.mode == "min" else relax
        dpop_info = dict(
            info,
            lower_bound=lower,
            upper_bound=upper,
            gap=max(0.0, upper - lower),
        )
        self.msg_count = info["msg_count"]
        self.msg_size = float(info["msg_entries"])
        return SolveResult(
            status="FINISHED",
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=self.tree.height + 1,
            msg_count=self.msg_count,
            msg_size=self.msg_size,
            time=perf_counter() - t0,
            dpop=dpop_info,
            config=self._resolved_config(i_bound=i_bound),
        )

    def _run_pernode(self) -> SolveResult:
        t0 = perf_counter()
        self.last_engine = "pernode"
        self.msg_count = 0
        self.msg_size = 0
        tree = self.tree
        levels = tree.nodes_by_depth()

        # ---- UTIL phase: bottom-up over levels
        util_from: Dict[str, tuple] = {}  # child name -> (table, dims)
        joined: Dict[str, tuple] = {}  # node name -> joined table pre-VALUE
        for level in reversed(levels):
            for node in level:
                t, dims = self._node_constraint_table(node)
                for child in node.children:
                    ct, cdims = util_from.pop(child)
                    have = {n for n, _ in dims}
                    out_dims = dims + [d for d in cdims if d[0] not in have]
                    est = table_size(out_dims)
                    if est > self.max_table_entries:
                        Dmax = max(sz for _, sz in out_dims)
                        raise UtilTableTooLarge(
                            estimated_bytes=est * 4,
                            budget_bytes=self.budget_bytes,
                            n_shards=1,
                            suggested_i_bound=suggest_i_bound(
                                Dmax, self.budget_bytes
                            ),
                            detail=(
                                f"UTIL table at {node.name} needs "
                                f"{est:.2e} entries in the per-node "
                                f"path (induced width too high)"
                            ),
                        )
                    t, dims = join_t(t, dims, ct, cdims,
                                     device=self.device)
                joined[node.name] = (t, dims)
                if node.parent is not None:
                    ut, udims = project_t(t, dims, node.name, self.mode)
                    util_from[node.name] = (ut, udims)
                    self.msg_count += 1
                    self.msg_size += table_size(udims)

        # ---- VALUE phase: top-down
        assignment_idx: Dict[str, int] = {}
        for level in levels:
            for node in level:
                t, dims = joined[node.name]
                fixed = {
                    n: assignment_idx[n]
                    for n, _ in dims
                    if n in assignment_idx
                }
                st, sdims = slice_t(t, dims, fixed)
                assignment_idx[node.name] = argopt_value(
                    st, sdims, node.name, self.mode
                )
                self.msg_count += len(node.children)
                self.msg_size += len(node.children) * max(
                    1, len(assignment_idx)
                )

        assignment = {
            name: tree.computation(name).variable.domain[idx]
            for name, idx in assignment_idx.items()
        }
        self._fill_missing(assignment)
        violation, cost = self.dcop.solution_cost(assignment, self.infinity)
        return SolveResult(
            status="FINISHED",
            assignment=assignment,
            cost=cost,
            violation=violation,
            cycle=tree.height + 1,
            msg_count=self.msg_count,
            msg_size=float(self.msg_size),
            time=perf_counter() - t0,
            config=self._resolved_config(),
        )


def build_solver(dcop: DCOP, computation_graph=None, algo_def=None, seed=0,
                 device: DeviceLike = None) -> DpopSolver:
    tree = (
        computation_graph
        if isinstance(computation_graph, ComputationPseudoTree)
        else None
    )
    return DpopSolver(dcop, tree, algo_def, seed, device=device)


def computation_memory(node) -> float:
    """UTIL table size bound: product of separator domain sizes × own domain
    (the reference leaves this NotImplemented, dpop.py:80-85; we provide the
    standard bound)."""
    if not hasattr(node, "variable"):
        return 0.0
    size = float(len(node.variable.domain))
    seps = set(node.pseudo_parents)
    if node.parent:
        seps.add(node.parent)
    return size * max(1, 2 ** len(seps))


def communication_load(node, target: str = None) -> float:
    if not hasattr(node, "variable"):
        return 1.0
    return float(len(node.variable.domain))
