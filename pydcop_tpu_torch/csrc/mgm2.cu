// MGM-2 cycles on the packed layouts, for Hopper (sm_90a): a binary
// branch (all-binary graphs, mgm2_cycles) and a mixed branch (unary to
// quaternary factors, mgm2_cycles_mixed).  Built by
// pydcop_tpu_torch/ops/cuda_build.py with nvcc into a shared library with a
// plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_mgm2.py.
//
// Replaces (both branches):
//   pydcop_tpu/ops/pallas_mgm2.py::packed_mgm2_cycles (_mgm2_cycle; the
//   mixed branch with mixed= and gmask1, :182-191 and :329-360).
//
// Layout (pack_for_gpu's var-grouped slots, as csrc/local_search.cu):
// column c is one variable; its k-th slot is col_slot0[c] + k *
// col_stride[c].  cost_rows is [D*D, N], other-value-major: row j*D + i
// of slot s = cost(other endpoint = j, this endpoint = i).  mate[s] is
// the slot of the other endpoint, mate_col[s] its column, mate_idx[s]
// that column's original variable; col_var[c] is column c's own.
// pick_rank[s] is slot s's index in its variable's incidence order (pair
// edges by id, side 0 before side 1: the order the offer pick indexes),
// edge_id[s] its pair-edge id.  x is int32 [Vp] in column order; the
// coins u_off / u_pick / u_fav are float32 [n, Vp], one row per cycle.
//
// The mixed layout (as local_search.cu's _mixed entries) keeps one cost
// array per arity a, [D^a, n_a] over that arity's slots (column
// cost_idx[s]), and each slot's siblings' columns mate_col, mate2_col and
// mate3_col (-1 where the factor has no such sibling; a unary slot has
// none).  Pairing stays binary-only: pick_rank and edge_id are INT_MAX
// off the binary slots, pair_deg[c] counts a column's binary slots (the
// range of the offer pick), and the joint tables read the binary array
// cost2 at column cost_idx[s].  Only three rounds differ from the binary
// branch: T sums every arity's slot costs, O reads cost2 through
// cost_idx, and W takes every sibling of every slot into the
// neighbourhood max and the tie-break; R only skips a slot without a
// sibling.  The binary instantiation keeps none of those tests.
//
// A Pallas cycle is one kernel with the protocol's five rounds in VMEM.
// A CUDA grid has no barrier between rounds, and every round reads what
// the round before wrote for a neighbour, so one cycle is six dependent
// launches on one stream, one thread per column:
//   T tables:   tables [D, Vp], cur, best (first minimum), own gain;
//   O offer:    an offerer (u_off < threshold) picks the slot whose
//               pick_rank is floor(u_pick * max(pair deg, 1)); if the mate is
//               no offerer it records (slot, joint gain, du*, dw*);
//   R response: a column takes the largest joint gain offered to it
//               (> 1e-9), then the lowest edge id within 1e-9, and
//               accepts it by the favor rule; it records the slot;
//   C commit:   an offerer learns whether its offer came back accepted;
//               every column writes its gain and tie-break id
//               (pid = min(own, partner) when paired);
//   W winner:   neighbourhood max of the gains, lowest pid at the max,
//               winner = strict max or tie with pid <= that pid;
//   G go:       a pair moves iff both ends win, a lone winner makes
//               MGM's move; x double-buffered.
// All n cycles of a chunk go out from one host call (mgm2_cycles).  The
// scratch between rounds is per column (the offer and acceptance records
// replace the Pallas kernel's per-slot routed rows): one float workspace
// [(D + 4) * Vp] and one int workspace [9 * Vp], allocated by the
// wrapper.
//
// Arithmetic, in the plain PyTorch version's order and the Pallas
// kernel's, with -fmad=false so all round alike:
//   A[du]   = tables[du, c] - cost[x_m*D + du, s]  (own table without
//             this edge's contribution); Am[dw] likewise at the mate's
//             slot t = mate[s]: tables[dw, m] - cost[x_c*D + dw, t]
//   M(du,dw)= cost[dw*D + du, s]
//   rowmin[du] = A[du] + fold_min over dw from 0 of (Am[dw] + M(du, dw))
//   du*     = first minimum of rowmin; dw* = first minimum over dw of
//             (A[du*] + Am[dw]) + M(du*, dw)
//   jg      = max((cur_c + cur_m) - cost[x_m*D + x_c, s] - best, 0)
// Every constant compared with a float is a float (1e-9f, 0.5f, the
// threshold passed as float), as the JAX code's weakly typed scalars.
//
// The mixed tables are local_search.cu's column_tables<D, true> without
// its nudge: the slot costs from 0 in slot order, then + unary.
//
// Bound: memory and launches.  Per cycle the function must read x, the
// three coins, the unary and mask columns, the column arrays, the slot
// arrays and D cost floats a slot (D*D more at an offered slot), and
// write x': about 2.6 MB at the 10k-variable / 30k-constraint colouring
// (60k slots), 0.8 us at 3.35 TB/s.  Six dependent launches of a few us
// each set the pace; the design answers the bound only by reading each
// operand once, coalesced except for the mate gathers.  The mixed branch
// reads, per slot, D floats of its arity's cost array and up to three
// sibling columns, and per offered slot D*D floats of cost2: at the
// 3,900-variable SECP (6,333 slots, D = 5, 95 binary factors) a few
// hundred kB, under 0.2 us; the launches set its pace too.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr float kPadCost = 1e30f;
constexpr float kEps = 1e-9f;
constexpr int kThreads = 128;

struct Graph {
  const float* cost;      // binary: cost_rows [D*D, N]; mixed: cost2
  size_t pitch;           // row length of `cost`: N, or n2 on the mixed layout
  const float* unary;     // [D, Vp] unary * mask
  const float* mask;      // [D, Vp]
  const int* mate;        // [N] slot of the (first) other endpoint
  const int* mate_col;    // [N] its column (mixed: -1 on unary slots)
  const int* mate_idx;    // [N]
  const int* col_var;     // [Vp]
  const int* col_deg;     // [Vp]
  const int* col_slot0;   // [Vp]
  const int* col_stride;  // [Vp]
  const int* pick_rank;   // [N]
  const int* edge_id;     // [N]
  int N;
  int Vp;
  // the mixed layout only
  const float* mcost[4];  // cost1 [D, n1] .. cost4 [D^4, n4]
  size_t n[4];
  const int* arity;       // [N]
  const int* cost_idx;    // [N] column of the slot in its arity's array
  const int* mate2_col;   // [N] second sibling's column, -1 below arity 3
  const int* mate3_col;   // [N] third sibling's column, -1 below arity 4
  const int* pair_deg;    // [Vp] binary slots of each column
};

// Per-column scratch between the rounds of one cycle.
struct Work {
  float* tables;    // [D, Vp]
  float* cur;       // [Vp] current local cost
  float* own_gain;  // [Vp] unilateral gain
  float* off_jg;    // [Vp] joint gain of my offer
  float* gain;      // [Vp] gain advertised in the gain round
  int* best;        // [Vp] unilateral best value
  int* off_slot;    // [Vp] slot of my offer, -1 without one
  int* off_du;      // [Vp] my value in the offer's joint optimum
  int* off_dw;      // [Vp] the mate's value in it
  int* acc_slot;    // [Vp] slot of the offer I accepted, -1 without one
  int* pid;         // [Vp] tie-break id of the gain round
  int* pair_col;    // [Vp] partner column, -1 when not paired
  int* target;      // [Vp] my value in the pair move
  int* winner;      // [Vp] 1 = won the neighbourhood
};

__device__ __forceinline__ size_t slot_of(const Graph& g, int c, int k) {
  return static_cast<size_t>(g.col_slot0[c]) +
         static_cast<size_t>(k) * static_cast<size_t>(g.col_stride[c]);
}

// column of binary slot s in `cost`: the slot itself, or cost_idx[s]
template <bool kMixed>
__device__ __forceinline__ size_t cost_col(const Graph& g, size_t s) {
  if constexpr (kMixed) return static_cast<size_t>(g.cost_idx[s]);
  return s;
}

__device__ __forceinline__ float cost_at(const Graph& g, int row,
                                         size_t col) {
  return g.cost[static_cast<size_t>(row) * g.pitch + col];
}

// T: tables, cur, best, own gain (the Pallas kernel's local tables and
// _rowmin_argfirst; the slot sum from 0, then + unary, as K2).  The same
// arithmetic as local_search.cu's column_tables without the nudge, kept
// in this file because the build caches a library by its source's hash.
template <int D, bool kMixed>
__global__ void mgm2_tables_kernel(Graph g, Work w,
                                   const int* __restrict__ x) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  const int deg = g.col_deg[c];
  for (int k = 0; k < deg; ++k) {
    const size_t s = slot_of(g, c, k);
    if constexpr (kMixed) {
      // row of the siblings' values: 0, x1, x1*D + x2, (x1*D + x2)*D + x3
      const int a = g.arity[s];
      size_t row = 0;
      if (a >= 2) row = static_cast<size_t>(x[g.mate_col[s]]);
      if (a >= 3) row = row * D + static_cast<size_t>(x[g.mate2_col[s]]);
      if (a >= 4) row = row * D + static_cast<size_t>(x[g.mate3_col[s]]);
      // a switch, not g.mcost[a - 1]: a runtime index into the struct's
      // arrays would put them in local memory
      const float* cost = g.mcost[0];
      size_t na = g.n[0];
      switch (a) {
        case 2: cost = g.mcost[1]; na = g.n[1]; break;
        case 3: cost = g.mcost[2]; na = g.n[2]; break;
        case 4: cost = g.mcost[3]; na = g.n[3]; break;
        default: break;
      }
      const size_t ci = static_cast<size_t>(g.cost_idx[s]);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += cost[(row * D + d) * na + ci];
    } else {
      const int row = x[g.mate_col[s]] * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += cost_at(g, row + d, s);
    }
  }
  const int xc = x[c];
  const size_t vp = static_cast<size_t>(g.Vp);
  float t[D];
  float cv = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t o = static_cast<size_t>(d) * vp + c;
    t[d] = g.mask[o] > 0.0f ? g.unary[o] + acc[d] : kPadCost;
    w.tables[o] = t[d];
    if (d == xc) cv = t[d];
  }
  float bc = t[0];
  int bi = 0;
#pragma unroll
  for (int d = 1; d < D; ++d) {
    if (t[d] < bc) {
      bc = t[d];
      bi = d;
    }
  }
  w.cur[c] = cv;
  w.best[c] = bi;
  w.own_gain[c] = fmaxf(cv - bc, 0.0f);
}

// O: the offer and its joint optimum at the offered (binary) slot.
template <int D, bool kMixed>
__global__ void mgm2_offer_kernel(Graph g, Work w, const int* __restrict__ x,
                                  const float* __restrict__ u_off,
                                  const float* __restrict__ u_pick,
                                  float threshold) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  w.off_slot[c] = -1;
  if (!(u_off[c] < threshold)) return;
  const int deg = g.col_deg[c];
  int pair_deg = deg;
  if constexpr (kMixed) pair_deg = g.pair_deg[c];
  const int pick = static_cast<int>(
      floorf(u_pick[c] * fmaxf(static_cast<float>(pair_deg), 1.0f)));
  long long found = -1;
  for (int k = 0; k < deg; ++k) {
    const size_t s = slot_of(g, c, k);
    if (g.pick_rank[s] == pick) {
      found = static_cast<long long>(s);
      break;
    }
  }
  if (found < 0) return;
  const size_t s = static_cast<size_t>(found);
  const int m = g.mate_col[s];
  if (u_off[m] < threshold) return;  // the mate offers too: no offer
  const size_t cs = cost_col<kMixed>(g, s);
  const size_t ct = cost_col<kMixed>(g, static_cast<size_t>(g.mate[s]));
  const int xc = x[c];
  const int xm = x[m];
  const size_t vp = static_cast<size_t>(g.Vp);
  float A[D], Am[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    A[d] = w.tables[static_cast<size_t>(d) * vp + c] -
           cost_at(g, xm * D + d, cs);
    Am[d] = w.tables[static_cast<size_t>(d) * vp + m] -
            cost_at(g, xc * D + d, ct);
  }
  const float cur_joint =
      (w.cur[c] + w.cur[m]) - cost_at(g, xm * D + xc, cs);
  float best = 0.0f;
  int du_star = 0;
#pragma unroll
  for (int du = 0; du < D; ++du) {
    float rm = Am[0] + cost_at(g, du, cs);
#pragma unroll
    for (int dw = 1; dw < D; ++dw)
      rm = fminf(rm, Am[dw] + cost_at(g, dw * D + du, cs));
    const float r = A[du] + rm;
    if (du == 0 || r < best) {
      best = r;
      du_star = du;
    }
  }
  float adu = A[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    if (d == du_star) adu = A[d];
  float bw = 0.0f;
  int dw_star = 0;
#pragma unroll
  for (int dw = 0; dw < D; ++dw) {
    const float v = (adu + Am[dw]) + cost_at(g, dw * D + du_star, cs);
    if (dw == 0 || v < bw) {
      bw = v;
      dw_star = dw;
    }
  }
  w.off_slot[c] = static_cast<int>(s);
  w.off_jg[c] = fmaxf(cur_joint - best, 0.0f);
  w.off_du[c] = du_star;
  w.off_dw[c] = dw_star;
}

// The joint gain offered to me on slot s (0 when no offer arrives there;
// a mixed unary slot has no mate).
template <bool kMixed>
__device__ __forceinline__ float offered_in(const Graph& g, const Work& w,
                                            size_t s) {
  const int m = g.mate_col[s];
  if constexpr (kMixed) {
    if (m < 0) return 0.0f;
  }
  return w.off_slot[m] == g.mate[s] ? w.off_jg[m] : 0.0f;
}

// R: take the best positive offer, lowest edge id on ties, by favor
// (0 unilateral, 1 no, 2 coordinated).
template <bool kMixed>
__global__ void mgm2_response_kernel(Graph g, Work w,
                                     const float* __restrict__ u_fav,
                                     int favor) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  const int deg = g.col_deg[c];
  float rec = -1.0f;
  for (int k = 0; k < deg; ++k) {
    const float jg = offered_in<kMixed>(g, w, slot_of(g, c, k));
    rec = fmaxf(rec, jg > kEps ? jg : -1.0f);
  }
  const float thr = rec - kEps;
  int first_e = INT_MAX;
  int acc = -1;
  for (int k = 0; k < deg; ++k) {
    const size_t s = slot_of(g, c, k);
    const float jg = offered_in<kMixed>(g, w, s);
    if (jg > kEps && jg >= thr && g.edge_id[s] < first_e) {
      first_e = g.edge_id[s];
      acc = static_cast<int>(s);
    }
  }
  const float own = w.own_gain[c];
  const bool beats = rec > own + kEps;
  const bool ties = fabsf(rec - own) <= kEps;
  bool commits = beats;
  if (favor == 2) commits = beats || ties;
  if (favor == 1) commits = beats || (ties && u_fav[c] > 0.5f);
  w.acc_slot[c] = commits ? acc : -1;
}

// C: pairing result, gain and tie-break id of every column.
__global__ void mgm2_commit_kernel(Graph g, Work w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  int partner = -1;
  int partner_idx = INT_MAX;
  int target = 0;
  float pair_gain = 0.0f;
  const int so = w.off_slot[c];
  const int sa = w.acc_slot[c];
  if (so >= 0) {  // my offer: did it come back accepted?
    const int m = g.mate_col[so];
    if (w.acc_slot[m] == g.mate[so]) {
      partner = m;
      partner_idx = g.mate_idx[so];
      target = w.off_du[c];
      pair_gain = w.off_jg[c];
    }
  } else if (sa >= 0) {  // the offer I accepted
    const int m = g.mate_col[sa];
    partner = m;
    partner_idx = g.mate_idx[sa];
    target = w.off_dw[m];
    pair_gain = w.off_jg[m];
  }
  const int me = g.col_var[c];
  if (partner >= 0) {
    w.gain[c] = fmaxf(0.0f, pair_gain);
    w.pid[c] = min(me, partner_idx);
  } else {
    w.gain[c] = w.own_gain[c];
    w.pid[c] = me;
  }
  w.pair_col[c] = partner;
  w.target[c] = target;
}

// W: neighbourhood arbitration with the pair-shared tie-break ids, over
// the one sibling of a binary slot, or up to three on the mixed layout
// (a -1 column is no sibling).
template <bool kMixed>
__global__ void mgm2_winner_kernel(Graph g, Work w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  constexpr int kSibs = kMixed ? 3 : 1;
  const int* cols[3] = {g.mate_col, g.mate2_col, g.mate3_col};
  const int deg = g.col_deg[c];
  float nm = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = slot_of(g, c, k);
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      const int m = cols[r][s];
      if (!kMixed || m >= 0) nm = fmaxf(nm, w.gain[m]);
    }
  }
  const float thr = nm - kEps;
  int idx = INT_MAX;
  for (int k = 0; k < deg; ++k) {
    const size_t s = slot_of(g, c, k);
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      const int m = cols[r][s];
      if ((!kMixed || m >= 0) && w.gain[m] >= thr) idx = min(idx, w.pid[m]);
    }
  }
  const float gc = w.gain[c];
  w.winner[c] = (gc > kEps) &&
                ((gc > nm + kEps) ||
                 ((fabsf(gc - nm) <= kEps) && (w.pid[c] <= idx)));
}

// G: a pair moves iff both ends won; a lone winner takes its best value.
__global__ void mgm2_go_kernel(Graph g, Work w, const int* __restrict__ x_in,
                               int* __restrict__ x_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.Vp) return;
  const int p = w.pair_col[c];
  const bool win = w.winner[c] != 0;
  int v = x_in[c];
  if (p >= 0) {
    if (win && w.winner[p] != 0) v = w.target[c];
  } else if (win) {
    v = w.best[c];
  }
  x_out[c] = v;
}

template <int D, bool kMixed>
int run_cycles(const Graph& g, const Work& w, const int* x_in, int* x_a,
               int* x_b, const float* u_off, const float* u_pick,
               const float* u_fav, int n_cycles, float threshold, int favor,
               cudaStream_t st, int* launched) {
  const int blocks = (g.Vp + kThreads - 1) / kThreads;
  const size_t vp = static_cast<size_t>(g.Vp);
#define MGM2_CHECK()                                        \
  do {                                                      \
    const cudaError_t err = cudaGetLastError();             \
    if (err != cudaSuccess) return static_cast<int>(err);   \
    ++*launched;                                            \
  } while (0)
  const int* x = x_in;
  for (int i = 0; i < n_cycles; ++i) {
    int* out = (i % 2 == 0) ? x_a : x_b;
    const size_t row = static_cast<size_t>(i) * vp;
    mgm2_tables_kernel<D, kMixed><<<blocks, kThreads, 0, st>>>(g, w, x);
    MGM2_CHECK();
    mgm2_offer_kernel<D, kMixed><<<blocks, kThreads, 0, st>>>(
        g, w, x, u_off + row, u_pick + row, threshold);
    MGM2_CHECK();
    mgm2_response_kernel<kMixed><<<blocks, kThreads, 0, st>>>(
        g, w, u_fav + row, favor);
    MGM2_CHECK();
    mgm2_commit_kernel<<<blocks, kThreads, 0, st>>>(g, w);
    MGM2_CHECK();
    mgm2_winner_kernel<kMixed><<<blocks, kThreads, 0, st>>>(g, w);
    MGM2_CHECK();
    mgm2_go_kernel<<<blocks, kThreads, 0, st>>>(g, w, x, out);
    MGM2_CHECK();
    x = out;
  }
#undef MGM2_CHECK
  return 0;
}

// Splits the scratch and runs the cycles of one branch (D in [1, 8]).
template <bool kMixed>
int launch(const Graph& g, const int* x_in, int* x_a, int* x_b,
           const float* u_off, const float* u_pick, const float* u_fav,
           float* fwork, int* iwork, int D, int n_cycles, float threshold,
           int favor, void* stream, int* launched) {
  if (n_cycles < 1 || favor < 0 || favor > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.Vp <= 0) return static_cast<int>(cudaGetLastError());
  const size_t vp = static_cast<size_t>(g.Vp);
  Work w;
  w.tables = fwork;
  w.cur = fwork + static_cast<size_t>(D) * vp;
  w.own_gain = w.cur + vp;
  w.off_jg = w.own_gain + vp;
  w.gain = w.off_jg + vp;
  w.best = iwork;
  w.off_slot = iwork + vp;
  w.off_du = w.off_slot + vp;
  w.off_dw = w.off_du + vp;
  w.acc_slot = w.off_dw + vp;
  w.pid = w.acc_slot + vp;
  w.pair_col = w.pid + vp;
  w.target = w.pair_col + vp;
  w.winner = w.target + vp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define MGM2_CASE(DD)                                                      \
  case DD:                                                                 \
    return run_cycles<DD, kMixed>(g, w, x_in, x_a, x_b, u_off, u_pick,     \
                                  u_fav, n_cycles, threshold, favor, st,   \
                                  launched);
    MGM2_CASE(1)
    MGM2_CASE(2)
    MGM2_CASE(3)
    MGM2_CASE(4)
    MGM2_CASE(5)
    MGM2_CASE(6)
    MGM2_CASE(7)
    MGM2_CASE(8)
#undef MGM2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Graph make_graph(const float* unary, const float* mask, const int* mate,
                 const int* mate_col, const int* mate_idx,
                 const int* col_var, const int* col_deg,
                 const int* col_slot0, const int* col_stride,
                 const int* pick_rank, const int* edge_id, int N, int Vp) {
  Graph g = {};
  g.unary = unary;
  g.mask = mask;
  g.mate = mate;
  g.mate_col = mate_col;
  g.mate_idx = mate_idx;
  g.col_var = col_var;
  g.col_deg = col_deg;
  g.col_slot0 = col_slot0;
  g.col_stride = col_stride;
  g.pick_rank = pick_rank;
  g.edge_id = edge_id;
  g.N = N;
  g.Vp = Vp;
  return g;
}

}  // namespace

// Both entries run n_cycles MGM-2 cycles on `stream` from x_in (left
// unchanged): cycle i writes x_a for even i and x_b for odd i, so the
// result is in x_a when n_cycles is odd and in x_b when it is even.
// fwork holds (D + 4) * Vp floats and iwork 9 * Vp ints of scratch.
// favor: 0 unilateral, 1 no, 2 coordinated.  `launched` lives in HOST
// memory: one is added to it for each kernel launch that went out (six
// per cycle).  Returns 0, or the first launch error (cudaGetLastError
// after each launch) without launching the rest; D outside [1, 8],
// n_cycles < 1 or favor outside [0, 2] return cudaErrorInvalidValue
// without launching.

// The binary branch: cost is cost_rows [D*D, N].
extern "C" int mgm2_cycles(
    const int* x_in, int* x_a, int* x_b, const float* u_off,
    const float* u_pick, const float* u_fav, const float* cost,
    const float* unary, const float* mask, const int* mate,
    const int* mate_col, const int* mate_idx, const int* col_var,
    const int* col_deg, const int* col_slot0, const int* col_stride,
    const int* pick_rank, const int* edge_id, float* fwork, int* iwork,
    int D, int N, int Vp, int n_cycles, float threshold, int favor,
    void* stream, int* launched) {
  Graph g = make_graph(unary, mask, mate, mate_col, mate_idx, col_var,
                       col_deg, col_slot0, col_stride, pick_rank, edge_id,
                       N, Vp);
  g.cost = cost;
  g.pitch = static_cast<size_t>(N);
  return launch<false>(g, x_in, x_a, x_b, u_off, u_pick, u_fav, fwork,
                       iwork, D, n_cycles, threshold, favor, stream,
                       launched);
}

// The mixed branch: cost1..cost4 are the per-arity cost arrays of widths
// n1..n4, arity and cost_idx the per-slot arrays, mate2_col and mate3_col
// the second and third siblings' columns, pair_deg each column's binary
// slots.
extern "C" int mgm2_cycles_mixed(
    const int* x_in, int* x_a, int* x_b, const float* u_off,
    const float* u_pick, const float* u_fav, const float* cost1,
    const float* cost2, const float* cost3, const float* cost4,
    const int* arity, const int* cost_idx, const float* unary,
    const float* mask, const int* mate, const int* mate_col,
    const int* mate2_col, const int* mate3_col, const int* mate_idx,
    const int* col_var, const int* col_deg, const int* col_slot0,
    const int* col_stride, const int* pick_rank, const int* edge_id,
    const int* pair_deg, float* fwork, int* iwork, int D, int N, int Vp,
    int n1, int n2, int n3, int n4, int n_cycles, float threshold,
    int favor, void* stream, int* launched) {
  Graph g = make_graph(unary, mask, mate, mate_col, mate_idx, col_var,
                       col_deg, col_slot0, col_stride, pick_rank, edge_id,
                       N, Vp);
  g.cost = cost2;
  g.pitch = static_cast<size_t>(n2);
  g.mcost[0] = cost1;
  g.mcost[1] = cost2;
  g.mcost[2] = cost3;
  g.mcost[3] = cost4;
  g.n[0] = static_cast<size_t>(n1);
  g.n[1] = static_cast<size_t>(n2);
  g.n[2] = static_cast<size_t>(n3);
  g.n[3] = static_cast<size_t>(n4);
  g.arity = arity;
  g.cost_idx = cost_idx;
  g.mate2_col = mate2_col;
  g.mate3_col = mate3_col;
  g.pair_deg = pair_deg;
  return launch<true>(g, x_in, x_a, x_b, u_off, u_pick, u_fav, fwork,
                      iwork, D, n_cycles, threshold, favor, stream,
                      launched);
}
