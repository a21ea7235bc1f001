"""Host-side compile pass of the frontier-batched exact search.

Everything the device engine needs is flattened here into fixed-shape
gather tables, once per problem:

* a **search order** — the pseudo-tree DFS preorder (deterministic,
  the same heuristic the DPOP family roots on), with every constraint
  attached at its DEEPEST variable in the order, so a constraint is
  scored exactly once: at the step that assigns its last open variable;
* **increment tables** — per depth ``k``, the constraints attached
  there as one flat f32 buffer plus (offset, stride, scope-position)
  index arrays, so the cost added by every candidate value of
  ``order[k]`` under a batch of prefixes is a masked gather-sum
  (the vectorized pass SyncBB did per node, now for the whole slab);
* **bound tables** — a static mini-bucket elimination (Kask & Dechter)
  along the REVERSE search order: each bucket's items are partitioned
  into mini-buckets of separator scope <= ``i_bound``, joined and
  projected separately, and the resulting messages are laid out per
  depth so the admissible heuristic ``h_d(prefix)`` — the sum of all
  messages crossing the assigned/unassigned boundary — is one more
  gather-sum.  With ``i_bound >= induced width`` nothing splits and
  ``h`` is the exact DPOP conditional optimum (best-first search then
  proves optimality almost immediately); smaller bounds trade
  tightness for the same typed table-memory budget the DPOP engines
  route on.

Pure numpy; consumed at plan time by ``search.frontier``.  A copy of
the JAX package's ``search/plan.py`` without its structured branch: this
package does not load structured constraints (``dcop/yamldcop.py``
refuses ``type: structured``), so every constraint is a table here and
the cardinality slabs (``s_*``) keep the shapes the JAX plan gives a
DCOP with no structured constraint — one safe slot, nothing valid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: +inf stand-in shared with the DPOP sweeps (survives f32 sums)
BIG = 1e9
#: padding cost of values beyond a variable's true domain: dominates
#: every reachable f so padded children are pruned on arrival
PAD_COST = 4 * BIG
#: the bound scalar of the per-chunk stats vector is NaN when the
#: spill annex holds rows the host must drain — an EXACT sentinel (an
#: additive flag offset would round the bound away in f32: at 2e9 the
#: ulp is 256, enough to fake an optimality proof), so the
#: steady-state chunk read stays two scalars and spill chunks simply
#: publish no bound (the previous one remains valid)
SPILL_SENTINEL = float("nan")

#: default byte budget for the mini-bucket bound tables (matches the
#: portfolio's AUTO_DPOP_BUDGET_MB scale)
DEFAULT_BOUND_BUDGET_BYTES = 64 * 2**20
#: hard cap on the auto-chosen i-bound (tables stay seconds-cheap)
MAX_AUTO_I_BOUND = 12


def suggest_search_i_bound(Dmax: int,
                           budget_bytes: Optional[int] = None) -> int:
    """Largest ``i`` whose widest mini-bucket table
    (``Dmax^(i+1)`` f32 entries) fits the bound-table budget, capped
    at :data:`MAX_AUTO_I_BOUND`; at least 1."""
    cap = (budget_bytes or DEFAULT_BOUND_BUDGET_BYTES) // 4
    d = max(2, int(Dmax))
    i = 1
    while i < MAX_AUTO_I_BOUND and d ** (i + 2) <= max(cap, d * d):
        i += 1
    return i


# ---------------------------------------------------------------------------
# positioned tables (numpy, scope = sorted order positions)
# ---------------------------------------------------------------------------


def _join_pos(t1: np.ndarray, s1: Tuple[int, ...],
              t2: np.ndarray, s2: Tuple[int, ...]):
    """Join two tables whose axes follow their sorted position scopes."""
    scope = tuple(sorted(set(s1) | set(s2)))

    def expand(t, s):
        shape = [1] * len(scope)
        for ax, p in enumerate(s):
            shape[scope.index(p)] = t.shape[ax]
        return t.reshape(shape)

    return expand(t1, s1) + expand(t2, s2), scope


def _project_pos(t: np.ndarray, scope: Tuple[int, ...], p: int):
    """Min-project position ``p`` out of a positioned table."""
    ax = scope.index(p)
    return np.min(t, axis=ax), tuple(q for q in scope if q != p)


@dataclasses.dataclass
class _Msg:
    """One mini-bucket message: created eliminating ``src``, scoped on
    positions all < ``src`` whose deepest is ``dest`` (-1 = constant)."""

    src: int
    dest: int
    scope: Tuple[int, ...]
    table: np.ndarray  # scalar () when dest == -1


@dataclasses.dataclass
class SearchPlan:
    """Flattened gather tables of one problem's frontier search."""

    order: List[str]
    dom_sizes: np.ndarray          # [n] int32, true domain sizes
    domain_values: List[list]      # decode index -> value per position
    sign: float                    # +1 min / -1 max (engine minimizes)
    n: int
    Dmax: int
    unary: np.ndarray              # [n, Dmax] f32, PAD_COST beyond dom
    # constraints attached per depth (deepest scope position = depth):
    c_flat: np.ndarray             # [sum entries] f32
    c_base: np.ndarray             # [n, Cmax] i32 offsets into c_flat
    c_valid: np.ndarray            # [n, Cmax] f32 0/1
    c_pos: np.ndarray              # [n, Cmax, Amax] i32 scope positions
    c_stride: np.ndarray           # [n, Cmax, Amax] i32 (0 = padding)
    c_own_stride: np.ndarray       # [n, Cmax] i32
    # table-free cardinality increments (structured constraints): at the
    # depth of each scope position, g grows by the telescoping delta
    # s_flat[base + cnt + 1] - s_flat[base + cnt] when the candidate
    # value is the counted one (cnt = counted positions already
    # assigned).  Sum over depths = count_cost[final count], exactly.
    s_flat: np.ndarray             # [sum curves] f32 (normalized, [0]=0)
    s_base: np.ndarray             # [n, Smax] i32 offsets into s_flat
    s_valid: np.ndarray            # [n, Smax] f32 0/1
    s_cnt: np.ndarray              # [n, Smax] i32 counted value idx here
    s_pri_pos: np.ndarray          # [n, Smax, Kmax] i32 earlier positions
    s_pri_cnt: np.ndarray          # [n, Smax, Kmax] i32 their counted idx
    s_pri_valid: np.ndarray        # [n, Smax, Kmax] f32 0/1
    # mini-bucket bound messages, laid out per child depth d in [0, n]:
    i_bound: int
    exact_heuristic: bool          # no mini-bucket ever split
    h_flat: np.ndarray             # [sum entries] f32
    m_base: np.ndarray             # [n+1, Mmax] i32
    m_valid: np.ndarray            # [n+1, Mmax] f32 0/1
    m_pos: np.ndarray              # [n+1, Mmax, Hmax] i32
    m_stride: np.ndarray           # [n+1, Mmax, Hmax] i32
    h_const: np.ndarray            # [n+1] f32 (constant messages)
    root_bound: float              # h at depth 0 — the global MBE bound
    bucket_splits: int
    table_bytes: int               # c_flat + h_flat + index arrays

    def info(self) -> Dict[str, object]:
        """The static half of ``metrics()["search"]``."""
        return {
            "engine": "frontier",
            "n_vars": self.n,
            "max_domain": int(self.Dmax),
            "i_bound": self.i_bound,
            "bound_source": (
                "dpop-exact" if self.exact_heuristic else "minibucket"
            ),
            "bucket_splits": self.bucket_splits,
            "root_bound": float(self.sign * self.root_bound),
            "table_bytes": self.table_bytes,
        }


def estimate_search_bytes(n: int, Dmax: int, i_bound: int,
                          frontier_width: int, ring: int) -> int:
    """Cheap shape-pass byte estimate of the engine's resident state:
    the slab, ring and annex rows plus a worst-case bound-table bucket
    per variable — the number the portfolio feasibility mask and the
    dpop auto ladder route on before anything is built."""
    rows = frontier_width * (Dmax + 2) + ring
    state = rows * (n + 4) * 4
    tables = n * (max(2, Dmax) ** min(i_bound + 1, MAX_AUTO_I_BOUND)) * 4
    return int(state + tables)


def _dfs_preorder(tree) -> List[str]:
    """Deterministic DFS preorder of the pseudo-tree forest (children
    in tree order, roots in tree order)."""
    order: List[str] = []
    for root in tree.roots:
        stack = [root]
        while stack:
            name = stack.pop()
            order.append(name)
            node = tree.computation(name)
            stack.extend(reversed(node.children))
    return order


def compile_search_plan(
    dcop,
    tree=None,
    i_bound: int = 0,
    bound_budget_bytes: Optional[int] = None,
) -> SearchPlan:
    """Compile a DCOP (+ optional prebuilt pseudo-tree) into a
    :class:`SearchPlan`.  ``i_bound=0`` auto-sizes the bound tables to
    ``bound_budget_bytes`` (default 64 MiB) via
    :func:`suggest_search_i_bound`, additionally capped by the induced
    width + 1 (beyond which the heuristic is already exact)."""
    from pydcop_tpu_torch.graph import pseudotree as pt_module

    if tree is None or not hasattr(tree, "roots"):
        tree = pt_module.build_computation_graph(dcop)
    order = _dfs_preorder(tree)
    n = len(order)
    pos = {name: i for i, name in enumerate(order)}
    sign = 1.0 if dcop.objective == "min" else -1.0
    ext = {ev.name: ev.value for ev in dcop.external_variables.values()}

    variables = [dcop.variables[name] for name in order]
    dom_sizes = np.asarray([len(v.domain) for v in variables], np.int32)
    domain_values = [list(v.domain) for v in variables]
    Dmax = int(dom_sizes.max()) if n else 1

    unary = np.full((max(n, 1), Dmax), PAD_COST, np.float32)
    for k, v in enumerate(variables):
        unary[k, : dom_sizes[k]] = (
            sign * np.asarray(v.cost_vector(), np.float64)
        ).astype(np.float32)

    # ---- constraints, positioned and attached at their deepest var
    per_depth: List[List[Tuple[np.ndarray, Tuple[int, ...]]]] = [
        [] for _ in range(max(n, 1))
    ]
    # the cardinality increments of structured constraints: none here
    card_depth: List[List[Tuple[int, int, List[Tuple[int, int]]]]] = [
        [] for _ in range(max(n, 1))
    ]
    s_chunks: List[np.ndarray] = [np.zeros(2, np.float32)]  # safe slot 0/1
    card_lb_by_last: List[Tuple[int, float]] = []  # (last scope pos, lb)
    has_card = False
    for c in dcop.constraints.values():
        if any(nm in ext for nm in c.scope_names):
            c = c.slice(ext)
        scope_pos = [pos[v.name] for v in c.dimensions if v.name in pos]
        if not scope_pos:
            continue
        t = (sign * np.asarray(c.to_tensor(), np.float64)).astype(
            np.float32
        )
        perm = np.argsort(np.asarray(scope_pos, np.int64), kind="stable")
        t = np.ascontiguousarray(np.transpose(t, tuple(perm)))
        scope = tuple(sorted(scope_pos))
        per_depth[scope[-1]].append((t, scope))

    s_flat = np.concatenate(s_chunks)
    Smax = max((len(es) for es in card_depth), default=0) or 1
    Kmax = max(
        (len(pr) for es in card_depth for _b, _c, pr in es), default=0
    ) or 1
    s_base = np.zeros((max(n, 1), Smax), np.int32)
    s_valid = np.zeros((max(n, 1), Smax), np.float32)
    s_cnt = np.zeros((max(n, 1), Smax), np.int32)
    s_pri_pos = np.zeros((max(n, 1), Smax, Kmax), np.int32)
    s_pri_cnt = np.zeros((max(n, 1), Smax, Kmax), np.int32)
    s_pri_valid = np.zeros((max(n, 1), Smax, Kmax), np.float32)
    for k, es in enumerate(card_depth):
        for ei, (base, ci, priors) in enumerate(es):
            s_base[k, ei] = base
            s_valid[k, ei] = 1.0
            s_cnt[k, ei] = ci
            for j, (p, pc) in enumerate(priors):
                s_pri_pos[k, ei, j] = p
                s_pri_cnt[k, ei, j] = pc
                s_pri_valid[k, ei, j] = 1.0

    Cmax = max((len(cs) for cs in per_depth), default=0) or 1
    Amax = max(
        (len(s) - 1 for cs in per_depth for _t, s in cs), default=0
    ) or 1
    c_chunks: List[np.ndarray] = [np.zeros(1, np.float32)]  # safe slot 0
    c_off = 1
    c_base = np.zeros((max(n, 1), Cmax), np.int32)
    c_valid = np.zeros((max(n, 1), Cmax), np.float32)
    c_pos = np.zeros((max(n, 1), Cmax, Amax), np.int32)
    c_stride = np.zeros((max(n, 1), Cmax, Amax), np.int32)
    c_own = np.zeros((max(n, 1), Cmax), np.int32)
    for k, cs in enumerate(per_depth):
        for ci, (t, scope) in enumerate(cs):
            strides = np.asarray(t.strides, np.int64) // t.itemsize
            c_base[k, ci] = c_off
            c_valid[k, ci] = 1.0
            c_own[k, ci] = int(strides[-1])
            for j, p in enumerate(scope[:-1]):
                c_pos[k, ci, j] = p
                c_stride[k, ci, j] = int(strides[j])
            c_chunks.append(t.reshape(-1))
            c_off += t.size
    c_flat = np.concatenate(c_chunks) if c_chunks else np.zeros(
        1, np.float32
    )

    # ---- static mini-bucket elimination along the reverse order
    if i_bound <= 0:
        i_bound = suggest_search_i_bound(Dmax, bound_budget_bytes)
    induced = int(getattr(tree, "induced_width", n))
    i_bound = max(1, min(i_bound, induced + 1))
    dom_of = [int(d) for d in dom_sizes]

    buckets: List[List[Tuple[np.ndarray, Tuple[int, ...]]]] = [
        list(per_depth[k]) for k in range(n)
    ]
    for k in range(n):
        buckets[k].append((unary[k, : dom_of[k]].copy(), (k,)))
    msgs: List[_Msg] = []
    const_by_src = np.zeros(max(n, 1), np.float64)
    n_splits = 0
    for j in range(n - 1, -1, -1):
        items = buckets[j]
        # greedy first-fit-decreasing on separator scope, like
        # ops.dpop_shard.minibucket_solve
        items.sort(key=lambda it: -len([p for p in it[1] if p != j]))
        mini: List[Tuple[set, List[Tuple[np.ndarray, Tuple[int, ...]]]]]
        mini = []
        for t, scope in items:
            sep = {p for p in scope if p != j}
            placed = False
            for sc, members in mini:
                if len(sc | sep) <= i_bound:
                    sc |= sep
                    members.append((t, scope))
                    placed = True
                    break
            if not placed:
                mini.append((set(sep), [(t, scope)]))
        n_splits += max(0, len(mini) - 1)
        for _sc, members in mini:
            t, scope = members[0]
            for t2, s2 in members[1:]:
                t, scope = _join_pos(t, scope, t2, s2)
            t, scope = _project_pos(t, scope, j)
            if not scope:
                const_by_src[j] += float(t)
            else:
                dest = scope[-1]
                msgs.append(_Msg(j, dest, scope,
                                 np.ascontiguousarray(t)))
                buckets[dest].append((t, scope))

    # ---- per-depth layout: message m is live at child depth d iff
    # dest < d <= src (scope fully assigned, source still open)
    h_chunks: List[np.ndarray] = [np.zeros(1, np.float32)]
    h_off = 1
    m_offset = {}
    for m in msgs:
        m_offset[id(m)] = h_off
        h_chunks.append(m.table.astype(np.float32).reshape(-1))
        h_off += m.table.size
    h_flat = np.concatenate(h_chunks)
    by_depth: List[List[_Msg]] = [
        [m for m in msgs if m.dest < d <= m.src] for d in range(n + 1)
    ]
    Mmax = max((len(ms) for ms in by_depth), default=0) or 1
    Hmax = max(
        (len(m.scope) for ms in by_depth for m in ms), default=0
    ) or 1
    m_base = np.zeros((n + 1, Mmax), np.int32)
    m_valid = np.zeros((n + 1, Mmax), np.float32)
    m_pos = np.zeros((n + 1, Mmax, Hmax), np.int32)
    m_stride = np.zeros((n + 1, Mmax, Hmax), np.int32)
    h_const = np.zeros(n + 1, np.float32)
    for d in range(n + 1):
        h_const[d] = float(const_by_src[d:].sum()) if n else 0.0
        # admissible slack for still-open cardinality curves: the worst
        # remaining count-cost delta (0 for monotone min-mode curves —
        # capacity penalties only grow with count)
        h_const[d] += sum(
            lb for last, lb in card_lb_by_last if d <= last
        )
        for mi, m in enumerate(by_depth[d]):
            strides = (
                np.asarray(m.table.strides, np.int64) // m.table.itemsize
            )
            m_base[d, mi] = m_offset[id(m)]
            m_valid[d, mi] = 1.0
            for j, p in enumerate(m.scope):
                m_pos[d, mi, j] = p
                m_stride[d, mi, j] = int(strides[j])

    table_bytes = int(
        c_flat.nbytes + h_flat.nbytes + c_base.nbytes + c_pos.nbytes
        + c_stride.nbytes + m_base.nbytes + m_pos.nbytes
        + m_stride.nbytes + unary.nbytes
        + s_flat.nbytes + s_base.nbytes + s_cnt.nbytes
        + s_pri_pos.nbytes + s_pri_cnt.nbytes + s_pri_valid.nbytes
    )
    return SearchPlan(
        order=order, dom_sizes=dom_sizes, domain_values=domain_values,
        sign=sign, n=n, Dmax=Dmax, unary=unary,
        c_flat=c_flat, c_base=c_base, c_valid=c_valid, c_pos=c_pos,
        c_stride=c_stride, c_own_stride=c_own,
        s_flat=s_flat, s_base=s_base, s_valid=s_valid, s_cnt=s_cnt,
        s_pri_pos=s_pri_pos, s_pri_cnt=s_pri_cnt,
        s_pri_valid=s_pri_valid,
        i_bound=i_bound, exact_heuristic=(n_splits == 0 and not has_card),
        h_flat=h_flat, m_base=m_base, m_valid=m_valid, m_pos=m_pos,
        m_stride=m_stride, h_const=h_const,
        root_bound=float(h_const[0]), bucket_splits=n_splits,
        table_bytes=table_bytes,
    )
