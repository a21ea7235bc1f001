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
// A Pallas call is one kernel that runs the n cycles of a chunk, each
// cycle's rounds in VMEM.  Every round reads what the round before wrote
// for a neighbour, so on the card the rounds are six phases separated by
// grid barriers, and one call is ONE cooperative launch
// (cudaLaunchCooperativeKernel: every block resident, or the launch is
// refused) of mgm2_coop_kernel that runs all n cycles.  Each phase is a
// grid-stride loop over the columns, one thread a column, so any grid of
// at least one block gives the same x; the wrapper launches
// min(ceil(Vp / kThreads), capacity) blocks:
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
//   W winner:   neighbourhood max of the gains, lowest pid within 1e-9
//               of it, winner = strict max or tie with pid <= that pid;
//   G go:       a pair moves iff both ends win, a lone winner makes
//               MGM's move; x double-buffered.
// A grid barrier (grid_sync.cuh's word_barrier) stands between
// consecutive phases, G of one cycle and T of the next included: 6n - 1
// a call.  The scratch between phases is per column (the offer and
// acceptance records replace the Pallas kernel's per-slot routed rows):
// one float workspace [(D + 4) * Vp] and one int workspace [9 * Vp],
// allocated by the wrapper.  Everything one block writes and another
// reads in the same launch — the workspaces and x_a / x_b — is read
// through L2 (__ldcg), never through a pointer marked const
// __restrict__: a block's L1 may hold a line another block has written
// since.  A column without slots (an isolated variable) forms no slot
// index: its walks do not start.
//
// The walks over a column's slots (T, O, R, W) take kBatch slots at a
// time and issue their loads with no branch between them, so a batch's
// gathers are in flight together; T, R and W load a batch's layout
// entries while the batch before waits for its gathers.  R and W keep a
// running max and the lowest edge id / pid within 1e-9 of it in one
// walk; only a new max within 1e-9 of the old one (where the candidates
// kept so far may or may not stay within 1e-9 of the final max) walks
// the slots again, so both give the two-pass rule's result exactly.
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
// Bound: memory and latency.  Per cycle the function must read x, the
// three coins, the unary and mask columns, the column arrays, the slot
// arrays and D cost floats a slot (D*D more at an offered slot), and
// write x': about 2.6 MB at the 10k-variable / 30k-constraint colouring
// (60k slots), 0.8 us at 3.35 TB/s.  What sets the pace is the chain of
// six dependent phases a cycle, each a walk through dependent gathers
// (slot -> sibling column -> its value -> cost row), and the grid barrier
// after each; one launch a call takes the six launch gaps of a cycle
// out, the batched walks shorten each phase's chain, and the one-walk R
// and W halve their gathers.  The mixed branch reads, per slot, D floats
// of its arity's cost array and up to three sibling columns, and per
// offered slot D*D floats of cost2: at the 3,900-variable SECP (6,333
// slots, D = 5, 95 binary factors) a few hundred kB, under 0.2 us; the
// phases' chain sets its pace too.
#include <cuda_runtime.h>

#include <climits>

#include "grid_sync.cuh"

namespace {

constexpr float kPadCost = 1e30f;
constexpr float kEps = 1e-9f;
// threads a block of the cooperative kernel
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

// Per-column scratch between the phases of one cycle, written by a
// column's thread and read by its neighbours' (through L2: ld below).
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

// A value written in this launch, possibly by another block: read
// through L2, past this SM's L1.
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldcg(p);
}

// Slots a thread walks at a time.  A batch's loads are issued together,
// with no branch between them (a batch past the column's last slot
// reads that slot again and ignores it), so a walk of deg slots waits
// for ceil(deg / kBatch) chains of dependent loads, not deg.  4 keeps
// the kernel at 80 registers or fewer, so 6 blocks of kThreads fit an SM
// and the 100k-column grid (782 blocks) is resident at once.
constexpr int kBatch = 4;

// A column's slots: slot k is slot0 + k * stride (slot indices are int,
// as the layout's int32 slot arrays).
struct Walk {
  int slot0;
  int stride;
  int deg;
  __device__ __forceinline__ Walk(const Graph& g, int c)
      : slot0(g.col_slot0[c]), stride(g.col_stride[c]), deg(g.col_deg[c]) {}
  // slot k, or the last slot for k past it; only for deg >= 1 (a walk
  // loads nothing of a column without slots)
  __device__ __forceinline__ int slot(int k) const {
    return slot0 + min(k, deg - 1) * stride;
  }
};

// column of binary slot s in `cost`: the slot itself, or cost_idx[s]
template <bool kMixed>
__device__ __forceinline__ int cost_col(const Graph& g, int s) {
  if constexpr (kMixed) return g.cost_idx[s];
  return s;
}

__device__ __forceinline__ float cost_at(const Graph& g, int row, int col) {
  return g.cost[static_cast<size_t>(row) * g.pitch + col];
}

// A batch of a column's slots for T: their layout entries (slot and
// sibling column; on the mixed layout the arity, the sibling columns,
// -1 read as column 0, and the cost column), loaded a batch ahead of
// their use.
template <bool kMixed>
struct TableSlots {
  int s[kBatch], m[kBatch];
  __device__ __forceinline__ void load(const Graph& g, const Walk& walk,
                                       int k0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      s[j] = walk.slot(k0 + j);
      m[j] = g.mate_col[s[j]];
    }
  }
};

template <>
struct TableSlots<true> {
  int a[kBatch], m1[kBatch], m2[kBatch], m3[kBatch], ci[kBatch];
  __device__ __forceinline__ void load(const Graph& g, const Walk& walk,
                                       int k0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = walk.slot(k0 + j);
      a[j] = g.arity[s];
      m1[j] = max(g.mate_col[s], 0);
      m2[j] = max(g.mate2_col[s], 0);
      m3[j] = max(g.mate3_col[s], 0);
      ci[j] = g.cost_idx[s];
    }
  }
};

// T: tables, cur, best, own gain (the Pallas kernel's local tables and
// _rowmin_argfirst; the slot sum from 0 in slot order, then + unary, as
// K2).  The same arithmetic as local_search.cu's column_tables without
// the nudge, kept in this file because the build caches a library by
// its source's hash.
template <int D, bool kMixed>
__device__ __forceinline__ void tables_phase(const Graph& g, const Work& w,
                                             const int* x, int c) {
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  const Walk walk(g, c);
  TableSlots<kMixed> cur;
  if (walk.deg > 0) cur.load(g, walk, 0);
  for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
    float v[kBatch][D];
    if constexpr (kMixed) {
      // row of the siblings' values: 0, x1, x1*D + x2, (x1*D + x2)*D + x3
      int x1[kBatch], x2[kBatch], x3[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x1[j] = ld(x + cur.m1[j]);
        x2[j] = ld(x + cur.m2[j]);
        x3[j] = ld(x + cur.m3[j]);
      }
      TableSlots<kMixed> next;
      next.load(g, walk, k0 + kBatch);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int a = cur.a[j];
        size_t row = a >= 2 ? static_cast<size_t>(x1[j]) : 0;
        if (a >= 3) row = row * D + static_cast<size_t>(x2[j]);
        if (a >= 4) row = row * D + static_cast<size_t>(x3[j]);
        // selects, not g.mcost[a - 1]: a runtime index into the struct's
        // arrays would put them in local memory
        const float* cost = a == 1   ? g.mcost[0]
                            : a == 2 ? g.mcost[1]
                            : a == 3 ? g.mcost[2]
                                     : g.mcost[3];
        const size_t na = a == 1   ? g.n[0]
                          : a == 2 ? g.n[1]
                          : a == 3 ? g.n[2]
                                   : g.n[3];
#pragma unroll
        for (int d = 0; d < D; ++d)
          v[j][d] = cost[(row * D + d) * na + cur.ci[j]];
      }
      cur = next;
    } else {
      int row[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) row[j] = ld(x + cur.m[j]) * D;
      TableSlots<kMixed> next;
      next.load(g, walk, k0 + kBatch);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int d = 0; d < D; ++d)
          v[j][d] = cost_at(g, row[j] + d, cur.s[j]);
      cur = next;
    }
    const int nb = min(kBatch, walk.deg - k0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < nb) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] += v[j][d];
      }
    }
  }
  const int xc = ld(x + c);
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
__device__ __forceinline__ void offer_phase(const Graph& g, const Work& w,
                                            const int* x,
                                            const float* __restrict__ u_off,
                                            const float* __restrict__ u_pick,
                                            float threshold, int c) {
  w.off_slot[c] = -1;
  if (!(u_off[c] < threshold)) return;
  const Walk walk(g, c);
  int pair_deg = walk.deg;
  if constexpr (kMixed) pair_deg = g.pair_deg[c];
  const int pick = static_cast<int>(
      floorf(u_pick[c] * fmaxf(static_cast<float>(pair_deg), 1.0f)));
  int found = -1;  // the picked slot's k (pick ranks are distinct)
  for (int k0 = 0; k0 < walk.deg && found < 0; k0 += kBatch) {
    int rank[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) rank[j] = g.pick_rank[walk.slot(k0 + j)];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (found < 0 && rank[j] == pick) found = min(k0 + j, walk.deg - 1);
  }
  if (found < 0) return;
  const int s = walk.slot(found);
  const int m = g.mate_col[s];
  if (u_off[m] < threshold) return;  // the mate offers too: no offer
  const int cs = cost_col<kMixed>(g, s);
  const int ct = cost_col<kMixed>(g, g.mate[s]);
  const int xc = ld(x + c);
  const int xm = ld(x + m);
  const size_t vp = static_cast<size_t>(g.Vp);
  float A[D], Am[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    A[d] = ld(w.tables + static_cast<size_t>(d) * vp + c) -
           cost_at(g, xm * D + d, cs);
    Am[d] = ld(w.tables + static_cast<size_t>(d) * vp + m) -
            cost_at(g, xc * D + d, ct);
  }
  const float cur_joint =
      (ld(w.cur + c) + ld(w.cur + m)) - cost_at(g, xm * D + xc, cs);
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
  w.off_slot[c] = s;
  w.off_jg[c] = fmaxf(cur_joint - best, 0.0f);
  w.off_du[c] = du_star;
  w.off_dw[c] = dw_star;
}

// A batch of a column's slots for R: their mate columns (-1 read as
// column 0 on the mixed layout), mate slots and edge ids, loaded a
// batch ahead of their use.
struct OfferSlots {
  int m[kBatch], ms[kBatch], edge[kBatch];
  __device__ __forceinline__ void load(const Graph& g, const Walk& walk,
                                       int k0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = walk.slot(k0 + j);
      m[j] = g.mate_col[s];
      ms[j] = g.mate[s];
      edge[j] = g.edge_id[s];
    }
  }
};

// The joint gains offered to me on a batch of slots (0 where no offer
// arrives; a mixed unary slot has no mate).
template <bool kMixed>
__device__ __forceinline__ void offered_in(const Work& w,
                                           const OfferSlots& b,
                                           float (&jg)[kBatch]) {
  int os[kBatch];
  float oj[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int mm = kMixed ? max(b.m[j], 0) : b.m[j];
    os[j] = ld(w.off_slot + mm);
    oj[j] = ld(w.off_jg + mm);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    jg[j] = (!kMixed || b.m[j] >= 0) && os[j] == b.ms[j] ? oj[j] : 0.0f;
}

// R: take the best positive offer, lowest edge id on ties, by favor
// (0 unilateral, 1 no, 2 coordinated).  One walk keeps the running best
// and the lowest edge id within 1e-9 of it (a new best more than 1e-9
// above the old one starts the candidates afresh); a new best within
// 1e-9 of the old one walks the slots again with the final best, so the
// result is the two-pass rule's exactly.
template <bool kMixed>
__device__ __forceinline__ void response_phase(
    const Graph& g, const Work& w, const float* __restrict__ u_fav,
    int favor, int c) {
  const Walk walk(g, c);
  float rec = -1.0f;
  int first_e = INT_MAX;
  int acc = -1;
  bool again = false;
  OfferSlots cur;
  if (walk.deg > 0) cur.load(g, walk, 0);
  for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
    float jg[kBatch];
    offered_in<kMixed>(w, cur, jg);
    OfferSlots next;
    next.load(g, walk, k0 + kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (!(jg[j] > kEps)) continue;
      if (jg[j] > rec) {
        if (jg[j] - kEps > rec) {
          first_e = cur.edge[j];
          acc = walk.slot(k0 + j);
        } else {
          again = true;
        }
        rec = jg[j];
      } else if (jg[j] >= rec - kEps && cur.edge[j] < first_e) {
        first_e = cur.edge[j];
        acc = walk.slot(k0 + j);
      }
    }
    cur = next;
  }
  if (again) {
    const float thr = rec - kEps;
    first_e = INT_MAX;
    acc = -1;
    for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
      OfferSlots b;
      b.load(g, walk, k0);
      float jg[kBatch];
      offered_in<kMixed>(w, b, jg);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (jg[j] > kEps && jg[j] >= thr && b.edge[j] < first_e) {
          first_e = b.edge[j];
          acc = walk.slot(k0 + j);
        }
      }
    }
  }
  const float own = ld(w.own_gain + c);
  const bool beats = rec > own + kEps;
  const bool ties = fabsf(rec - own) <= kEps;
  bool commits = beats;
  if (favor == 2) commits = beats || ties;
  if (favor == 1) commits = beats || (ties && u_fav[c] > 0.5f);
  w.acc_slot[c] = commits ? acc : -1;
}

// C: pairing result, gain and tie-break id of every column.
__device__ __forceinline__ void commit_phase(const Graph& g, const Work& w,
                                             int c) {
  int partner = -1;
  int partner_idx = INT_MAX;
  int target = 0;
  float pair_gain = 0.0f;
  const int so = ld(w.off_slot + c);
  const int sa = ld(w.acc_slot + c);
  if (so >= 0) {  // my offer: did it come back accepted?
    const int m = g.mate_col[so];
    if (ld(w.acc_slot + m) == g.mate[so]) {
      partner = m;
      partner_idx = g.mate_idx[so];
      target = ld(w.off_du + c);
      pair_gain = ld(w.off_jg + c);
    }
  } else if (sa >= 0) {  // the offer I accepted
    const int m = g.mate_col[sa];
    partner = m;
    partner_idx = g.mate_idx[sa];
    target = ld(w.off_dw + m);
    pair_gain = ld(w.off_jg + m);
  }
  const int me = g.col_var[c];
  if (partner >= 0) {
    w.gain[c] = fmaxf(0.0f, pair_gain);
    w.pid[c] = min(me, partner_idx);
  } else {
    w.gain[c] = ld(w.own_gain + c);
    w.pid[c] = me;
  }
  w.pair_col[c] = partner;
  w.target[c] = target;
}

// A batch of a column's slots for W: their siblings' columns (-1: no
// sibling), loaded a batch ahead of their use.
template <int kSibs>
struct SiblingSlots {
  int m[kBatch][kSibs];
  __device__ __forceinline__ void load(const Graph& g, const Walk& walk,
                                       int k0) {
    const int* cols[3] = {g.mate_col, g.mate2_col, g.mate3_col};
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int r = 0; r < kSibs; ++r) m[j][r] = cols[r][walk.slot(k0 + j)];
  }
};

// The gains and tie-break ids of a batch's siblings (a -1 column reads
// column 0).
template <int kSibs>
__device__ __forceinline__ void sibling_gains(const Work& w,
                                              const SiblingSlots<kSibs>& b,
                                              float (&gn)[kBatch][kSibs],
                                              int (&pn)[kBatch][kSibs]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      gn[j][r] = ld(w.gain + max(b.m[j][r], 0));
      pn[j][r] = ld(w.pid + max(b.m[j][r], 0));
    }
}

// W: neighbourhood arbitration with the pair-shared tie-break ids, over
// the one sibling of a binary slot, or up to three on the mixed layout:
// the neighbourhood max from 0, the lowest id among the gains within
// 1e-9 of it.  One walk, as R's: a new max within 1e-9 of the old one
// walks the slots again with the final max.
template <bool kMixed>
__device__ __forceinline__ void winner_phase(const Graph& g, const Work& w,
                                             int c) {
  constexpr int kSibs = kMixed ? 3 : 1;
  const Walk walk(g, c);
  float nm = 0.0f;
  int idx = INT_MAX;
  bool again = false;
  SiblingSlots<kSibs> cur;
  if (walk.deg > 0) cur.load(g, walk, 0);
  for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
    float gn[kBatch][kSibs];
    int pn[kBatch][kSibs];
    sibling_gains<kSibs>(w, cur, gn, pn);
    SiblingSlots<kSibs> next;
    next.load(g, walk, k0 + kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int r = 0; r < kSibs; ++r) {
        if (kMixed && cur.m[j][r] < 0) continue;
        if (gn[j][r] > nm) {
          if (gn[j][r] - kEps > nm)
            idx = pn[j][r];
          else
            again = true;
          nm = gn[j][r];
        } else if (gn[j][r] >= nm - kEps) {
          idx = min(idx, pn[j][r]);
        }
      }
    cur = next;
  }
  if (again) {
    const float thr = nm - kEps;
    idx = INT_MAX;
    for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
      SiblingSlots<kSibs> b;
      b.load(g, walk, k0);
      float gn[kBatch][kSibs];
      int pn[kBatch][kSibs];
      sibling_gains<kSibs>(w, b, gn, pn);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int r = 0; r < kSibs; ++r)
          if ((!kMixed || b.m[j][r] >= 0) && gn[j][r] >= thr)
            idx = min(idx, pn[j][r]);
    }
  }
  const float gc = ld(w.gain + c);
  w.winner[c] = (gc > kEps) &&
                ((gc > nm + kEps) ||
                 ((fabsf(gc - nm) <= kEps) && (ld(w.pid + c) <= idx)));
}

// G: a pair moves iff both ends won; a lone winner takes its best value.
__device__ __forceinline__ void go_phase(const Work& w, const int* x,
                                         int* x_out, int c) {
  const int p = ld(w.pair_col + c);
  const bool win = ld(w.winner + c) != 0;
  int v = ld(x + c);
  if (p >= 0) {
    if (win && ld(w.winner + p) != 0) v = ld(w.target + c);
  } else if (win) {
    v = ld(w.best + c);
  }
  x_out[c] = v;
}

// All n cycles of one call: for each, the six phases, each a grid-stride
// loop over the columns, a grid barrier between consecutive phases.
// Cycle i reads x_in (i = 0) or the previous cycle's buffer and writes
// x_a (even i) or x_b (odd i).
template <int D, bool kMixed>
__global__ void __launch_bounds__(kThreads)
    mgm2_coop_kernel(Graph g, Work w, const int* __restrict__ x_in,
                     int* x_a, int* x_b, const float* __restrict__ u_off,
                     const float* __restrict__ u_pick,
                     const float* __restrict__ u_fav, int n_cycles,
                     float threshold, int favor, unsigned* bar) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  const size_t vp = static_cast<size_t>(g.Vp);
  const int* x = x_in;
  for (int i = 0; i < n_cycles; ++i) {
    int* out = (i % 2 == 0) ? x_a : x_b;
    const size_t row = static_cast<size_t>(i) * vp;
    if (i > 0) word_barrier(bar);
    for (int c = first; c < g.Vp; c += step)
      tables_phase<D, kMixed>(g, w, x, c);
    word_barrier(bar);
    for (int c = first; c < g.Vp; c += step)
      offer_phase<D, kMixed>(g, w, x, u_off + row, u_pick + row, threshold,
                             c);
    word_barrier(bar);
    for (int c = first; c < g.Vp; c += step)
      response_phase<kMixed>(g, w, u_fav + row, favor, c);
    word_barrier(bar);
    for (int c = first; c < g.Vp; c += step) commit_phase(g, w, c);
    word_barrier(bar);
    for (int c = first; c < g.Vp; c += step) winner_phase<kMixed>(g, w, c);
    word_barrier(bar);
    for (int c = first; c < g.Vp; c += step) go_phase(w, x, out, c);
    x = out;
  }
}

// the kernel of one branch at domain size D (nullptr outside [1, 8])
const void* coop_kernel(int D, bool mixed) {
  switch (D) {
#define MGM2_CASE(DD)                                                  \
  case DD:                                                             \
    return mixed                                                       \
               ? reinterpret_cast<const void*>(mgm2_coop_kernel<DD, true>) \
               : reinterpret_cast<const void*>(mgm2_coop_kernel<DD, false>);
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
      return nullptr;
  }
}

// Splits the scratch and makes the one cooperative launch of a call.
int launch(bool mixed, Graph g, const int* x_in, int* x_a, int* x_b,
           const float* u_off, const float* u_pick, const float* u_fav,
           float* fwork, int* iwork, int D, int n_cycles, float threshold,
           int favor, int blocks, unsigned* bar, void* stream) {
  const void* kernel = coop_kernel(D, mixed);
  if (kernel == nullptr || n_cycles < 1 || favor < 0 || favor > 2 ||
      g.Vp <= 0 || blocks < 1 || bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
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
  void* args[] = {&g,      &w,        &x_in,      &x_a,
                  &x_b,    &u_off,    &u_pick,    &u_fav,
                  &n_cycles, &threshold, &favor, &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      const_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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

// The resident-block capacity of the kernel of one branch (mixed 0 or 1)
// at domain size D on the current device (0 when D is outside [1, 8] or
// the device cannot be asked), and its threads a block in *threads: a
// call launches at most that many blocks.
extern "C" int mgm2_capacity(int D, int mixed, int* threads) {
  if (threads) *threads = kThreads;
  const void* kernel = coop_kernel(D, mixed != 0);
  return kernel ? coop_capacity(kernel, kThreads) : 0;
}

// Both entries run n_cycles MGM-2 cycles on `stream` from x_in (left
// unchanged) in ONE cooperative launch of `blocks` blocks (at most
// mgm2_capacity(D, ...)): cycle i writes x_a for even i and x_b for odd
// i, so the result is in x_a when n_cycles is odd and in x_b when it is
// even.  fwork holds (D + 4) * Vp floats and iwork 9 * Vp ints of
// scratch; `bar` is one unsigned int, zero before the launch, which no
// other launch in flight may share.  favor: 0 unilateral, 1 no, 2
// coordinated.  Returns the launch's error (0 on success); D outside
// [1, 8], n_cycles < 1, favor outside [0, 2], Vp < 1, blocks < 1 or no
// `bar` return cudaErrorInvalidValue without launching.

// The binary branch: cost is cost_rows [D*D, N].
extern "C" int mgm2_cycles(
    const int* x_in, int* x_a, int* x_b, const float* u_off,
    const float* u_pick, const float* u_fav, const float* cost,
    const float* unary, const float* mask, const int* mate,
    const int* mate_col, const int* mate_idx, const int* col_var,
    const int* col_deg, const int* col_slot0, const int* col_stride,
    const int* pick_rank, const int* edge_id, float* fwork, int* iwork,
    int D, int N, int Vp, int n_cycles, float threshold, int favor,
    int blocks, unsigned* bar, void* stream) {
  Graph g = make_graph(unary, mask, mate, mate_col, mate_idx, col_var,
                       col_deg, col_slot0, col_stride, pick_rank, edge_id,
                       N, Vp);
  g.cost = cost;
  g.pitch = static_cast<size_t>(N);
  return launch(false, g, x_in, x_a, x_b, u_off, u_pick, u_fav, fwork, iwork,
                D, n_cycles, threshold, favor, blocks, bar, stream);
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
    int favor, int blocks, unsigned* bar, void* stream) {
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
  return launch(true, g, x_in, x_a, x_b, u_off, u_pick, u_fav, fwork, iwork,
                D, n_cycles, threshold, favor, blocks, bar, stream);
}
