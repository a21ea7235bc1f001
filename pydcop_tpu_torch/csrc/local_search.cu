// Local-search cycle kernels on the packed layouts, for Hopper (sm_90a):
// each entry has a binary branch (all-binary graphs) and a mixed branch
// (`_mixed` entries: unary, binary, ternary and quaternary factors).
// Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a shared
// library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_local_search.py.
//
// Replaces (both branches of each):
//   * ls_tables  <- pydcop_tpu/ops/pallas_maxsum.py::packed_local_tables
//                   (and the tables/_cur_best_gain phase of the two below;
//                   mixed: _mixed_contrib via _contrib_for_values);
//   * mgm_move   <- the arbitration half of
//                   pydcop_tpu/ops/pallas_local_search.py::packed_mgm_cycles
//                   (_routed_gains, _neigh_max_partial,
//                   _tiebreak_idx_partial, _mgm_decision);
//   * dsa_cycle  <- pydcop_tpu/ops/pallas_local_search.py::packed_dsa_cycles
//                   (variants A/B/C, probability_hard, awake/activation).
//
// Layout (pack_for_gpu's var-grouped slots): column c is one variable; its
// k-th slot is col_slot0[c] + k * col_stride[c].  Binary: cost_rows is
// [D*D, N], other-value-major: row j*D + i of slot s = cost(other
// endpoint = j, this endpoint = i).  Mixed: one cost array per arity a,
// [D^a, N_a] over that arity's slots (column cost_idx[s]), rows
// other-values-major ((x1*D + x2)*D + i for a ternary slot whose siblings
// hold x1 and x2), and the slot's siblings' columns mate_col, mate2_col,
// mate3_col (-1 where the factor has no such sibling; a unary slot has
// none).  mate_idx[s] (mate2_idx, mate3_idx) is a sibling column's
// original variable index (the static MGM tie-break).  x is int32 [Vp] in
// column order.  The Pallas kernels' Clos routing becomes the indexed
// load x[mate_col[s]], and their 128-lane padding, hub split and VMEM
// budget are gone.
//
// One thread owns one column.  Arithmetic, in the plain PyTorch versions'
// order and with -fmad=false so both round alike:
//   acc[d]  = 0 + sum over slots k in order of the slot's cost row at its
//             siblings' values (binary: cost_rows[x_mate*D + d, s])
//   t[d]    = mask[d,c] > 0 ? unary[d,c] + acc[d] : PAD_COST
//   cur     = t[x_c];  pick[d] = t[d] (+ 1e-6f at d == x_c when
//             prefer_change: an add, so it vanishes once |t| >= 32)
//   best    = first d of the strict minimum of pick;
//   gain    = max(cur - t[best], 0)
// The unary cost is added after the slot sum, as the Pallas K2 kernel
// does.  Every constant compared with a float is a float (1e-9f,
// 10000.0f, probabilities passed as float), as in the JAX code, whose
// Python scalars are weakly typed f32.  MGM's neighbourhood max and
// tie-break run over every sibling of every slot of the column.
//
// MGM reads its neighbours' gains of the SAME cycle, which needs a
// grid-wide barrier: one MGM cycle is two launches, ls_tables (gain,
// best) then mgm_move (x double-buffered).  DSA reads only the previous
// cycle's x across columns: one dsa_cycle launch per cycle, x
// double-buffered.
//
// Bound: memory.  Per cycle the function must read x (4 B a column),
// the D selected cost floats, the sibling columns (and for MGM their
// gains and variable indices) per slot, the unary and mask columns and
// the three column arrays, and write its outputs: at the 10k-variable /
// 30k-constraint coloring (N = 60k slots, D = 3) about 1.4 MB for
// ls_tables, 0.8 MB for mgm_move and 1.3 MB for dsa_cycle, i.e.
// 0.25-0.45 us at 3.35 TB/s — far below a launch, so the launch and the
// dependent x[mate_col[s]] loads set the pace.  The design answers the
// bound only by reading each operand once, coalesced except for the
// sibling gathers; no shared-memory staging.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kPadCost = 1e30f;
constexpr float kHard = 10000.0f;
constexpr float kEps = 1e-9f;
constexpr float kNudge = 1e-6f;
constexpr int kThreads = 128;

struct Layout {
  const float* cost;      // [D*D, N]
  const float* unary;     // [D, Vp] unary * mask
  const float* mask;      // [D, Vp]
  const int* mate_col;    // [N]
  const int* col_deg;     // [Vp]
  const int* col_slot0;   // [Vp]
  const int* col_stride;  // [Vp]
  int N;
  int Vp;
};

// the mixed layout's per-arity cost arrays and per-slot arrays
struct Mixed {
  const float* cost[4];  // cost1 [D, n1] .. cost4 [D^4, n4]
  size_t n[4];
  const int* arity;      // [N]
  const int* cost_idx;   // [N] column of the slot in its arity's array
  const int* mate2_col;  // [N] second sibling's column, -1 below arity 3
  const int* mate3_col;  // [N] third sibling's column, -1 below arity 4
};

// tables of column c at assignment x, then (cur, best, gain); kMixed
// reads each slot's cost row through its arity (M), else the binary
// cost_rows
template <int D, bool kMixed>
__device__ __forceinline__ void column_tables(const Layout& L,
                                              const Mixed& M, const int* x,
                                              int c, int prefer_change,
                                              float t[D], float* cur,
                                              int* best, float* gain) {
  const int deg = L.col_deg[c];
  const size_t s0 = static_cast<size_t>(L.col_slot0[c]);
  const size_t stride = static_cast<size_t>(L.col_stride[c]);
  const size_t n = static_cast<size_t>(L.N);
  const size_t vp = static_cast<size_t>(L.Vp);
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    if constexpr (kMixed) {
      // row of the siblings' values: 0, x1, x1*D + x2, (x1*D + x2)*D + x3
      const int a = M.arity[s];
      size_t row = 0;
      if (a >= 2) row = static_cast<size_t>(x[L.mate_col[s]]);
      if (a >= 3) row = row * D + static_cast<size_t>(x[M.mate2_col[s]]);
      if (a >= 4) row = row * D + static_cast<size_t>(x[M.mate3_col[s]]);
      // a switch, not M.cost[a - 1]: a runtime index into the struct's
      // arrays would put them in local memory
      const float* cost = M.cost[0];
      size_t na = M.n[0];
      switch (a) {
        case 2: cost = M.cost[1]; na = M.n[1]; break;
        case 3: cost = M.cost[2]; na = M.n[2]; break;
        case 4: cost = M.cost[3]; na = M.n[3]; break;
        default: break;
      }
      const size_t ci = static_cast<size_t>(M.cost_idx[s]);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += cost[(row * D + d) * na + ci];
    } else {
      const size_t row = static_cast<size_t>(x[L.mate_col[s]]) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += L.cost[(row + d) * n + s];
    }
  }
  const int xc = x[c];
  float cv = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t o = static_cast<size_t>(d) * vp + c;
    t[d] = L.mask[o] > 0.0f ? L.unary[o] + acc[d] : kPadCost;
    if (d == xc) cv = t[d];
  }
  float bc = t[0];
  if (prefer_change) bc = t[0] + (xc == 0 ? kNudge : 0.0f);
  int bi = 0;
#pragma unroll
  for (int d = 1; d < D; ++d) {
    float p = t[d];
    if (prefer_change) p = t[d] + (xc == d ? kNudge : 0.0f);
    if (p < bc) {
      bc = p;
      bi = d;
    }
  }
  float tb = t[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    if (d == bi) tb = t[d];
  *cur = cv;
  *best = bi;
  *gain = fmaxf(cv - tb, 0.0f);
}

template <int D, bool kMixed>
__global__ void ls_tables_kernel(Layout L, Mixed M,
                                 const int* __restrict__ x,
                                 float* __restrict__ tables,
                                 float* __restrict__ cur,
                                 int* __restrict__ best,
                                 float* __restrict__ gain,
                                 int prefer_change) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L.Vp) return;
  float t[D];
  float cv, g;
  int b;
  column_tables<D, kMixed>(L, M, x, c, prefer_change, t, &cv, &b, &g);
#pragma unroll
  for (int d = 0; d < D; ++d)
    tables[static_cast<size_t>(d) * L.Vp + c] = t[d];
  cur[c] = cv;
  best[c] = b;
  gain[c] = g;
}

// MGM arbitration (neighborhood_winner): move iff own gain is the strict
// maximum of the neighbourhood, ties to the smallest original index.  A
// degree-0 column has neighbourhood max 0 and tie-break sentinel INT_MAX,
// so it moves on any positive gain.  kSibs is the number of sibling arrays
// a slot reads: 1 on the binary layout (mate_col, mate_idx; every slot
// has its sibling, so no -1 test), 3 on the mixed one (a -1 column is no
// sibling).
template <int kSibs>
__global__ void mgm_move_kernel(
    const int* __restrict__ x_in, int* __restrict__ x_out,
    const int* __restrict__ best, const float* __restrict__ gain,
    const int* __restrict__ mate_col, const int* __restrict__ mate2_col,
    const int* __restrict__ mate3_col, const int* __restrict__ mate_idx,
    const int* __restrict__ mate2_idx, const int* __restrict__ mate3_idx,
    const int* __restrict__ col_var, const int* __restrict__ col_deg,
    const int* __restrict__ col_slot0, const int* __restrict__ col_stride,
    int Vp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Vp) return;
  const int* cols[3] = {mate_col, mate2_col, mate3_col};
  const int* idxs[3] = {mate_idx, mate2_idx, mate3_idx};
  const int deg = col_deg[c];
  const size_t s0 = static_cast<size_t>(col_slot0[c]);
  const size_t stride = static_cast<size_t>(col_stride[c]);
  float nm = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      const int mc = cols[r][s];
      if (kSibs == 1 || mc >= 0) nm = fmaxf(nm, gain[mc]);
    }
  }
  const float thr = nm - kEps;
  int idx = INT_MAX;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      const int mc = cols[r][s];
      if ((kSibs == 1 || mc >= 0) && gain[mc] >= thr)
        idx = min(idx, idxs[r][s]);
    }
  }
  const float g = gain[c];
  const bool move =
      (g > 0.0f) &&
      ((g > nm + kEps) || ((fabsf(g - nm) <= kEps) && (col_var[c] < idx)));
  x_out[c] = move ? best[c] : x_in[c];
}

// One DSA-family cycle.  variant 0/1/2 = A/B/C.
template <int D, bool kMixed>
__global__ void dsa_cycle_kernel(Layout L, Mixed M,
                                 const int* __restrict__ x_in,
                                 int* __restrict__ x_out,
                                 const float* __restrict__ u,
                                 const float* __restrict__ awake_u,
                                 int variant, float probability,
                                 float probability_hard, int use_hard,
                                 float activation) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= L.Vp) return;
  float t[D];
  float cv, g;
  int b;
  column_tables<D, kMixed>(L, M, x_in, c, variant != 0, t, &cv, &b, &g);
  const int xc = x_in[c];
  const bool conflict = cv >= kHard;
  const bool improving = g > kEps;
  const bool lateral = (g <= kEps) && (b != xc);
  bool want = improving;
  if (variant == 1) want = improving || (lateral && conflict);
  if (variant == 2) want = improving || lateral;
  const float p = (use_hard && conflict) ? probability_hard : probability;
  bool move = want && (u[c] < p);
  if (awake_u != nullptr) move = move && (awake_u[c] < activation);
  x_out[c] = move ? b : xc;
}

inline int blocks_for(int Vp) { return (Vp + kThreads - 1) / kThreads; }

Layout make_layout(const float* cost, const float* unary, const float* mask,
                   const int* mate_col, const int* col_deg,
                   const int* col_slot0, const int* col_stride, int N,
                   int Vp) {
  Layout L;
  L.cost = cost;
  L.unary = unary;
  L.mask = mask;
  L.mate_col = mate_col;
  L.col_deg = col_deg;
  L.col_slot0 = col_slot0;
  L.col_stride = col_stride;
  L.N = N;
  L.Vp = Vp;
  return L;
}

Mixed make_mixed(const float* cost1, const float* cost2, const float* cost3,
                 const float* cost4, int n1, int n2, int n3, int n4,
                 const int* arity, const int* cost_idx, const int* mate2_col,
                 const int* mate3_col) {
  Mixed M;
  M.cost[0] = cost1;
  M.cost[1] = cost2;
  M.cost[2] = cost3;
  M.cost[3] = cost4;
  M.n[0] = static_cast<size_t>(n1);
  M.n[1] = static_cast<size_t>(n2);
  M.n[2] = static_cast<size_t>(n3);
  M.n[3] = static_cast<size_t>(n4);
  M.arity = arity;
  M.cost_idx = cost_idx;
  M.mate2_col = mate2_col;
  M.mate3_col = mate3_col;
  return M;
}

}  // namespace

#define LS_D_SWITCH(D, CASE) \
  switch (D) {               \
    CASE(1)                  \
    CASE(2)                  \
    CASE(3)                  \
    CASE(4)                  \
    CASE(5)                  \
    CASE(6)                  \
    CASE(7)                  \
    CASE(8)                  \
    default:                 \
      return static_cast<int>(cudaErrorInvalidValue); \
  }

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); D outside [1, 8] returns
// cudaErrorInvalidValue without launching.

extern "C" int ls_tables(const int* x, float* tables, float* cur, int* best,
                         float* gain, const float* cost, const float* unary,
                         const float* mask, const int* mate_col,
                         const int* col_deg, const int* col_slot0,
                         const int* col_stride, int D, int N, int Vp,
                         int prefer_change, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(cost, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
#define LS_TABLES_CASE(DD)                                                  \
  case DD:                                                                  \
    ls_tables_kernel<DD, false><<<blocks_for(Vp), kThreads, 0, st>>>(       \
        L, Mixed{}, x, tables, cur, best, gain, prefer_change);             \
    break;
  LS_D_SWITCH(D, LS_TABLES_CASE)
#undef LS_TABLES_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgm_move(const int* x_in, int* x_out, const int* best,
                        const float* gain, const int* mate_col,
                        const int* mate_idx, const int* col_var,
                        const int* col_deg, const int* col_slot0,
                        const int* col_stride, int Vp, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mgm_move_kernel<1><<<blocks_for(Vp), kThreads, 0, st>>>(
      x_in, x_out, best, gain, mate_col, nullptr, nullptr, mate_idx, nullptr,
      nullptr, col_var, col_deg, col_slot0, col_stride, Vp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsa_cycle(const int* x_in, int* x_out, const float* u,
                         const float* awake_u, const float* cost,
                         const float* unary, const float* mask,
                         const int* mate_col, const int* col_deg,
                         const int* col_slot0, const int* col_stride, int D,
                         int N, int Vp, int variant, float probability,
                         float probability_hard, int use_hard,
                         float activation, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(cost, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
#define DSA_CYCLE_CASE(DD)                                                  \
  case DD:                                                                  \
    dsa_cycle_kernel<DD, false><<<blocks_for(Vp), kThreads, 0, st>>>(       \
        L, Mixed{}, x_in, x_out, u, awake_u, variant, probability,          \
        probability_hard, use_hard, activation);                            \
    break;
  LS_D_SWITCH(D, DSA_CYCLE_CASE)
#undef DSA_CYCLE_CASE
  return static_cast<int>(cudaGetLastError());
}

// The mixed branches.  cost1..cost4 are the per-arity cost arrays of
// widths n1..n4, arity and cost_idx the per-slot arrays, mate_col,
// mate2_col and mate3_col the sibling columns (-1 where absent).

extern "C" int ls_tables_mixed(
    const int* x, float* tables, float* cur, int* best, float* gain,
    const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const float* unary, const float* mask, const int* col_deg,
    const int* col_slot0, const int* col_stride, int D, int N, int Vp, int n1,
    int n2, int n3, int n4, int prefer_change, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(nullptr, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Mixed M = make_mixed(cost1, cost2, cost3, cost4, n1, n2, n3, n4,
                             arity, cost_idx, mate2_col, mate3_col);
#define LS_TABLES_MIXED_CASE(DD)                                            \
  case DD:                                                                  \
    ls_tables_kernel<DD, true><<<blocks_for(Vp), kThreads, 0, st>>>(        \
        L, M, x, tables, cur, best, gain, prefer_change);                   \
    break;
  LS_D_SWITCH(D, LS_TABLES_MIXED_CASE)
#undef LS_TABLES_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mgm_move_mixed(
    const int* x_in, int* x_out, const int* best, const float* gain,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const int* mate_idx, const int* mate2_idx, const int* mate3_idx,
    const int* col_var, const int* col_deg, const int* col_slot0,
    const int* col_stride, int Vp, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mgm_move_kernel<3><<<blocks_for(Vp), kThreads, 0, st>>>(
      x_in, x_out, best, gain, mate_col, mate2_col, mate3_col, mate_idx,
      mate2_idx, mate3_idx, col_var, col_deg, col_slot0, col_stride, Vp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsa_cycle_mixed(
    const int* x_in, int* x_out, const float* u, const float* awake_u,
    const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const float* unary, const float* mask, const int* col_deg,
    const int* col_slot0, const int* col_stride, int D, int N, int Vp, int n1,
    int n2, int n3, int n4, int variant, float probability,
    float probability_hard, int use_hard, float activation, void* stream) {
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (variant < 0 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(nullptr, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Mixed M = make_mixed(cost1, cost2, cost3, cost4, n1, n2, n3, n4,
                             arity, cost_idx, mate2_col, mate3_col);
#define DSA_CYCLE_MIXED_CASE(DD)                                            \
  case DD:                                                                  \
    dsa_cycle_kernel<DD, true><<<blocks_for(Vp), kThreads, 0, st>>>(        \
        L, M, x_in, x_out, u, awake_u, variant, probability,                \
        probability_hard, use_hard, activation);                            \
    break;
  LS_D_SWITCH(D, DSA_CYCLE_MIXED_CASE)
#undef DSA_CYCLE_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}
