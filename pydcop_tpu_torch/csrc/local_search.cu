// Local-search cycle kernels on the packed all-binary layout, for Hopper
// (sm_90a).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_local_search.py.
//
// Replaces (all-binary branches; the mixed-arity branches are not ported):
//   * ls_tables  <- pydcop_tpu/ops/pallas_maxsum.py::packed_local_tables
//                   (and the tables/_cur_best_gain phase of the two below);
//   * mgm_move   <- the arbitration half of
//                   pydcop_tpu/ops/pallas_local_search.py::packed_mgm_cycles
//                   (_routed_gains, _neigh_max_partial,
//                   _tiebreak_idx_partial, _mgm_decision);
//   * dsa_cycle  <- pydcop_tpu/ops/pallas_local_search.py::packed_dsa_cycles
//                   (variants A/B/C, probability_hard, awake/activation).
//
// Layout (pack_for_gpu's var-grouped slots): column c is one variable; its
// k-th slot is col_slot0[c] + k * col_stride[c].  cost_rows is [D*D, N],
// other-value-major: row j*D + i of slot s = cost(other endpoint = j,
// this endpoint = i).  mate_col[s] is the column of slot s's other
// endpoint and mate_idx[s] that column's original variable index (the
// static MGM tie-break).  x is int32 [Vp] in column order.  The Pallas
// kernels' Clos routing becomes the indexed load x[mate_col[s]], and
// their 128-lane padding, hub split and VMEM budget are gone.
//
// One thread owns one column.  Arithmetic, in the plain PyTorch versions'
// order and with -fmad=false so both round alike:
//   acc[d]  = 0 + sum over slots k in order of cost_rows[x_mate*D + d, s]
//   t[d]    = mask[d,c] > 0 ? unary[d,c] + acc[d] : PAD_COST
//   cur     = t[x_c];  pick[d] = t[d] (+ 1e-6f at d == x_c when
//             prefer_change: an add, so it vanishes once |t| >= 32)
//   best    = first d of the strict minimum of pick;
//   gain    = max(cur - t[best], 0)
// The unary cost is added after the slot sum, as the Pallas K2 kernel
// does.  Every constant compared with a float is a float (1e-9f,
// 10000.0f, probabilities passed as float), as in the JAX code, whose
// Python scalars are weakly typed f32.
//
// MGM reads its neighbours' gains of the SAME cycle, which needs a
// grid-wide barrier: one MGM cycle is two launches, ls_tables (gain,
// best) then mgm_move (x double-buffered).  DSA reads only the previous
// cycle's x across columns: one dsa_cycle launch per cycle, x
// double-buffered.
//
// Bound: memory.  Per cycle the function must read x (4 B a column),
// the D selected cost floats, mate_col (and for MGM gain of the mate and
// mate_idx) per slot, the unary and mask columns and the three column
// arrays, and write its outputs: at the 10k-variable / 30k-constraint
// coloring (N = 60k slots, D = 3) about 1.4 MB for ls_tables, 0.8 MB for
// mgm_move and 1.3 MB for dsa_cycle, i.e. 0.25-0.45 us at 3.35 TB/s —
// far below a launch, so the launch and the dependent x[mate_col[s]]
// loads set the pace.  The design answers the bound only by reading each
// operand once, coalesced except for the mate gathers; no shared-memory
// staging.
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

// tables of column c at assignment x, then (cur, best, gain)
template <int D>
__device__ __forceinline__ void column_tables(const Layout& L, const int* x,
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
    const size_t row = static_cast<size_t>(x[L.mate_col[s]]) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += L.cost[(row + d) * n + s];
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

template <int D>
__global__ void ls_tables_kernel(Layout L, const int* __restrict__ x,
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
  column_tables<D>(L, x, c, prefer_change, t, &cv, &b, &g);
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
// so it moves on any positive gain.
__global__ void mgm_move_kernel(const int* __restrict__ x_in,
                                int* __restrict__ x_out,
                                const int* __restrict__ best,
                                const float* __restrict__ gain,
                                const int* __restrict__ mate_col,
                                const int* __restrict__ mate_idx,
                                const int* __restrict__ col_var,
                                const int* __restrict__ col_deg,
                                const int* __restrict__ col_slot0,
                                const int* __restrict__ col_stride, int Vp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Vp) return;
  const int deg = col_deg[c];
  const size_t s0 = static_cast<size_t>(col_slot0[c]);
  const size_t stride = static_cast<size_t>(col_stride[c]);
  float nm = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    nm = fmaxf(nm, gain[mate_col[s]]);
  }
  const float thr = nm - kEps;
  int idx = INT_MAX;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    if (gain[mate_col[s]] >= thr) idx = min(idx, mate_idx[s]);
  }
  const float g = gain[c];
  const bool move =
      (g > 0.0f) &&
      ((g > nm + kEps) || ((fabsf(g - nm) <= kEps) && (col_var[c] < idx)));
  x_out[c] = move ? best[c] : x_in[c];
}

// One DSA-family cycle.  variant 0/1/2 = A/B/C.
template <int D>
__global__ void dsa_cycle_kernel(Layout L, const int* __restrict__ x_in,
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
  column_tables<D>(L, x_in, c, variant != 0, t, &cv, &b, &g);
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
    ls_tables_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(              \
        L, x, tables, cur, best, gain, prefer_change);                      \
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
  mgm_move_kernel<<<blocks_for(Vp), kThreads, 0, st>>>(
      x_in, x_out, best, gain, mate_col, mate_idx, col_var, col_deg,
      col_slot0, col_stride, Vp);
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
    dsa_cycle_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(              \
        L, x_in, x_out, u, awake_u, variant, probability, probability_hard, \
        use_hard, activation);                                              \
    break;
  LS_D_SWITCH(D, DSA_CYCLE_CASE)
#undef DSA_CYCLE_CASE
  return static_cast<int>(cudaGetLastError());
}
