// Kernels of the sharded engines for Hopper (sm_90a): the all-binary and
// the mixed-arity (1-4) branches, and MaxSum's activation branch
// (amaxsum).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_sharded.py.
//
// Replaces the Pallas TPU kernels of pydcop_tpu/ops/pallas_sharded.py:
//   device_fused_ba         <- packed_shard_fused_ba    (K7, every branch:
//                              binary or mixed=, activation when `active`
//                              is given)
//   device_tables           <- packed_shard_tables      (K9, binary)
//   device_tables_mixed     <- packed_shard_tables      (K9, mixed=)
//   device_mgm_move         <- packed_shard_route_gains (K8, binary)
//   device_mgm_move_mixed   <- packed_shard_route_gains (K8, consts2/3)
//                              with MGM's arbitration after it
//                              (_tiebreak_idx_partial, _mgm_decision of
//                              pydcop_tpu/ops/pallas_local_search.py)
//
// K7, K8 and K9 launch ONCE PER DEVICE per cycle (K8 twice on a device
// that holds only some shards), over the group of shards the device holds
// (parallel/packed_mesh.py::ShardGroup), where the TPU runs one shard per
// device inside shard_map and psums the partials.
// Each shard keeps its own layout over the common column map (one column
// per variable): its slots are the var-grouped slots of
// ops/packed_maxsum.py built from the shard's degrees.  The group holds
// each operand the kernels read in ONE allocation, the shards' [R, N_s]
// pieces contiguous at R * soff[k]; the descriptor row k (desc, 10
// int64) gives soff[k], N_k, and per arity the element offset and width
// of the shard's piece of that arity's cost slab.  Column c's slots over
// the whole group are listed by shard, then rank, in centry[cptr[c] ..
// cptr[c+1]) (group slots soff[k] + s; cshard the shard of each).  mate[s]
// is the slot of the factor's first sibling, mate_col[s] its column; a
// mixed layout adds mate2/mate3 (the second and third siblings, cyclic
// from the slot's position), their columns, the slot's arity and its
// column cost_idx[s] in its arity's cost piece (cost1 [D, n1], cost2
// [D^2, n2], cost3 [D^3, n3], cost4 [D^4, n4], other-values-major: row
// ((j*D+k)*D+m)*D + i = cost(siblings at j, k, m, this end at i)); the
// binary layout's cost rows are its arity-2 piece, indexed by the slot.
// -1 marks a sibling that does not exist.
//
// The combine.  A whole group (every shard of the mesh on this device)
// writes unary + ((p_0 + p_1) + ... + p_{S-1}), p_k shard k's partial
// (its slots of the column added in rank order from 0; 0 where it has
// none), in shard order: the adds of the ordered all-sum and the unary
// add the engines did on the host before, so the result is bit for bit
// the same.  Otherwise the launch writes each shard's partial, [S, D, Vp],
// and the engine combines the devices' partials in shard order.  The
// order is kept by ownership, not by atomics: one thread owns a column
// across every shard of the group and walks the column's list in its
// order, D sums at once (column_sum), a batch of slots' loads in flight at
// a time.  The threads take the columns by the group's degree, largest
// first, so a warp's threads walk lists of similar length.
//
// K7, two phases in one cooperative launch (cudaLaunchCooperativeKernel:
// every block resident, or the launch is refused).  Phase 1 spreads the
// work over the slots, in arity order (the group's items), so the lanes
// of a warp take neighbouring slots of one arity and read neighbouring
// columns of its cost rows: one thread a unary or binary slot, one
// thread a (slot, value i) of a ternary or quaternary slot, which splits
// its D^(a-1) candidates a value by D.  A thread recomputes the pending
// variable side of the PREVIOUS cycle at each sibling slot m (it needs
// only the launch's inputs bel_g[:, col(m)] and r_u[:, m]), in the Pallas
// order:
//   e[j]   = bel_g[j, col(m)] - r_u[j, m]                   (expand, subtract)
//   mean   = (sum_{j from 0} e[j] * vmask[j, m]) * inv_dcount[m]
//   q[j]   = (e[j] - mean) * vmask[j, m]
//   q[j]   = active[m] > 0 ? q[j] : q_m[j, m]               (activation)
// then this cycle's factor side at value i by arity
// (ops/packed_maxsum.py::_mixed_r_new): unary the cost row; binary the
// min over j from 0 of cost[j*D+i] + q1[j]; ternary the min over (j outer,
// k inner) of (cost3 + q1[j]) + q2[k]; quaternary the min over (j, k, m)
// of (cost4 + (q1[j] + q2[k])) + q3[m]; then
//   r'[i]  = r'[i] * vmask[i, s]
//   r1[i]  = active[s] > 0 ? r_u[i, s] : r_m[i, s]         (activation;
//                                                            else r_u)
//   r'[i]  = damping * r1[i] + (1 - damping) * r'[i]      (damping != 0)
// and stores r' (with activation also q1, the committed q at s, and r1).
// A grid barrier follows.  Phase 2: one thread per column sums the
// column's r' as above.  The factor tables are not staged in shared
// memory: each entry of a slot's rotated table is read once (by the
// thread of its value), so there is nothing to reuse; fminf is exact in
// any order for non-NaN values, so splitting the candidates by value
// changes no result.  On a zero state (bel_g = 0, r_u = 0, q_m = r_m = 0)
// the pending side gives q = 0 whatever the mask, so the first launch
// needs no flag.  r_out never aliases r_u: other threads read r_u at this
// thread's slots as their siblings.
//
// K9, one phase: one thread per column sums the slots' cost rows at their
// siblings' values as above: cost[x1*D + i] binary,
// cost_a[(row*D) + i] with row = x1, x1*D + x2, (x1*D + x2)*D + x3 mixed,
// cost1[i] on a unary slot; a whole group writes where(mask > 0, unary +
// total, pad).
//
// K8, one phase, one thread per column c: MGM's whole neighbourhood
// arbitration.  Where the TPU runs packed_shard_route_gains per shard
// (each slot's siblings' routed gains gn = gain[col(sibling)] * gmask and
// the per-column max over the shard's slots), a pmax, the tie-break
// partial per shard and a pmin, a whole group does it all in the launch:
//   nm       = max(0, max over c's slots and siblings of gn)
//   idx      = min over c's slots and siblings with gn >= nm - EPS of the
//              sibling's variable index, BIG_IDX where none
//   move[c]  = gain[c] > 0 && (gain[c] > nm + EPS ||
//              (|gain[c] - nm| <= EPS && idx_row[c] < idx))
// No grid barrier is needed: every step reads only column c's own slots
// (a slot's own column is c, so the threshold it is held to is c's nm)
// and column c's gain, so the thread that owns c finishes it alone.  Max
// and min are exact in any order; the walk takes the column lists K9
// walks.  A group that holds only some shards (several cards) runs the
// same kernel twice: mode kMax writes its partial nm, the engine takes
// the ordered max across the devices and clamps it at 0, then mode kMin
// writes the partial idx at that nm, the engine takes the ordered min and
// decides (parallel/mesh.py::ShardedLocalSearch._mgm_move).
//
// Built with -fmad=false, so each multiply and add rounds as in the plain
// PyTorch versions (ops/packed_sharded.py *_plain).
//
// Bound: memory.  K7 reads per slot its table (D*D floats binary, D^a
// mixed) and 3*D r_u / vmask / bel_g floats at each sibling, 2*D at the
// slot, writes D r' floats (activation: also reads q_m, r_m at the
// siblings and the slot and writes q1, r1), reads the combined beliefs
// and the unary row once and writes one [D, Vp] result for the whole
// group.  K9 reads a few words a slot and the D selected cost floats.
// What held the per-shard design back (PERF.md, PR 8) was the host: S
// launches a cycle and S ordered adds after them (K7 binary busy 48% at
// 10k/30k, 8 shards), and, in the mixed branch, one thread walking a
// column's quaternary slots' D^4 candidates serially (134 us a launch at
// SECP-39k, 107x its bound).  One launch a device, with the combine
// inside, removes the first; the (slot, value) threads of phase 1 the
// second.  What is left is latency: the dependent gathers of a sibling's
// pending q in phase 1, and the ordered walk of the longest column in
// phase 2 and K9 (kBatch loads in flight at a time).  Shared memory and
// TMA are not used; the sibling gathers are not coalesced.
// K8 reads the gains, each slot's siblings' column, mask and index (12
// bytes a sibling), the walk (corder, cptr, centry) and idx_row once and
// writes one byte a column (chip_smoke.py::sharded_bytes_ops): about 1 MB
// at 10k/30k, 0.3 us at 3.35 TB/s.  Before, 8 launches and ~120 plain
// PyTorch launches of the arbitration a cycle held the MGM cycle to the
// host (PERF.md, PR 9); the one launch leaves the scattered loads of a
// column's walk (centry, then the sibling's column, mask and index, then
// its gain: a 32-byte sector each), the first kCache slots' loads in
// flight together and kept in registers, so the tie-break walk does not
// read them again.
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

constexpr int kThreads = 128;
// threads per block of K7 (a cooperative launch)
constexpr int kCoopThreads = 256;
// ternary and quaternary slots exist only up to this D (the packer's
// limit), so the D^3 / D^4 loops are compiled only there
constexpr int kMaxDNary = 5;
constexpr int kDescCols = 10;
// MGM's gain/tie epsilon and its float-encoded "no neighbour" index, the
// plain versions' EPS and BIG_IDX (ops/packed_sharded.py) as floats
constexpr float kEps = 1e-9f;
constexpr float kBigIdx = 1e9f;

// A read-only load.  NC routes it through the non-coherent (read-only)
// cache, which the struct members below do not get on their own: they
// carry no __restrict__, so the compiler cannot prove that the stores to
// r_out/q1/r1 never alias them.  Measured on the H100 (PERF.md, PR 8), NC
// helps the binary cycle and hurts the activation branch, so only the
// binary cycle without activation takes it.
template <bool NC, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (NC) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// One shard of a group: its slot offset and count, and its descriptor
// row (per arity the element offset and width of its cost piece, read
// where the arity is known).
struct Desc {
  size_t soff;
  size_t n;
  const long long* row;
};

__device__ __forceinline__ Desc desc_of(const long long* desc, int k) {
  Desc d;
  d.row = desc + static_cast<size_t>(k) * kDescCols;
  d.soff = static_cast<size_t>(d.row[0]);
  d.n = static_cast<size_t>(d.row[1]);
  return d;
}

// The kernels' threads' columns, and each column's slots over the group
// (CSR: centry[cptr[c] .. cptr[c+1]), group slots by shard, then rank;
// cshard the shard of each).
struct Walk {
  const int* corder;
  const int* cptr;
  const int* centry;
  const int* cshard;
};

// The ordered sums of column c, one a value: value_of(k, g, v) gives the
// D values of each of the column's slots g (shard k); each shard's slots
// are added from 0 in rank order, the shards' partials in shard order from
// 0 into total.  A shard with no slot in the column adds nothing, which is
// the +0 of its partial: a partial is never -0, so adding +0 changes no
// sum.  With combine = 0 each shard's partials are stored to result[k, :,
// c] instead.  The slots are read a batch at a time, their loads in flight
// together before the ordered adds.
template <int D, class F>
__device__ __forceinline__ void column_sum(const Walk& W, int c, size_t vp,
                                           float* result, int combine,
                                           F value_of, float total[D]) {
  constexpr int kBatch = D <= 4 ? 8 : 4;
  const int lo = W.cptr[c];
  const int hi = W.cptr[c + 1];
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) total[i] = acc[i] = 0.0f;
  int cur = -1;
  auto emit = [&]() {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      if (combine)
        total[i] = total[i] + acc[i];
      else
        result[(static_cast<size_t>(cur) * D + i) * vp + c] = acc[i];
    }
  };
  for (int e0 = lo; e0 < hi; e0 += kBatch) {
    float v[kBatch][D];
    int kk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      kk[u] = -1;
      if (e0 + u < hi) {
        kk[u] = W.cshard[e0 + u];
        value_of(kk[u], W.centry[e0 + u], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (kk[u] < 0) break;
      if (kk[u] != cur) {
        if (cur >= 0) emit();
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] = 0.0f;
        cur = kk[u];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] += v[u][i];
    }
  }
  if (cur >= 0) emit();
}

// The pending variable side's operands and the activation carry: group
// slabs, or (after at_shard) one shard's pieces.
struct Pending {
  const float* bel_g;
  const float* r_u;
  const float* q_m;     // activation only
  const float* r_m;     // activation only
  const float* active;  // activation only
  const float* vmask;
  const float* inv_dcount;
  size_t n;
  size_t vp;
};

struct Out {
  float* r_out;
  float* q1_out;  // activation only
  float* r1_out;  // activation only
  float* result;  // [D, Vp] combined (whole group) or [S, D, Vp] partials
  const float* unary;
  float damping;
  float keep;
  int use_damping;
  int combine;
};

template <int D>
__device__ __forceinline__ Pending at_shard(const Pending& G, const Desc& d) {
  Pending P = G;
  const size_t rows = static_cast<size_t>(D) * d.soff;
  P.r_u = G.r_u + rows;
  if (G.q_m) P.q_m = G.q_m + rows;
  if (G.r_m) P.r_m = G.r_m + rows;
  if (G.active) P.active = G.active + d.soff;
  P.vmask = G.vmask + rows;
  P.inv_dcount = G.inv_dcount + d.soff;
  P.n = d.n;
  return P;
}

template <int D>
__device__ __forceinline__ Out at_shard(const Out& G, const Desc& d) {
  Out O = G;
  const size_t rows = static_cast<size_t>(D) * d.soff;
  O.r_out = G.r_out + rows;
  if (G.q1_out) O.q1_out = G.q1_out + rows;
  if (G.r1_out) O.r1_out = G.r1_out + rows;
  return O;
}

// The previous cycle's committed q at slot m of column cm.
template <int D, bool ACT, bool NC>
__device__ __forceinline__ void pending_q(const Pending& P, int m_i, int cm_i,
                                          float q[D]) {
  const size_t m = static_cast<size_t>(m_i);
  const size_t cm = static_cast<size_t>(cm_i);
  if (ACT && !(ld<NC>(P.active + m) > 0.0f)) {
#pragma unroll
    for (int j = 0; j < D; ++j) q[j] = ld<NC>(P.q_m + j * P.n + m);
    return;
  }
  float e[D];
  float vm[D];
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    vm[j] = ld<NC>(P.vmask + j * P.n + m);
    e[j] = ld<NC>(P.bel_g + j * P.vp + cm) - ld<NC>(P.r_u + j * P.n + m);
    total += e[j] * vm[j];
  }
  const float mean = total * ld<NC>(P.inv_dcount + m);
#pragma unroll
  for (int j = 0; j < D; ++j) q[j] = (e[j] - mean) * vm[j];
}

// vmask, commit and damping of value i of slot s's new message rn, and
// its stores (r', and with activation r1).
template <bool ACT, bool NC>
__device__ __forceinline__ void finish_value(const Pending& P, const Out& O,
                                              size_t s, int i, bool on,
                                              float rn) {
  const size_t at = static_cast<size_t>(i) * P.n + s;
  float v = rn * ld<NC>(P.vmask + at);
  if (ACT) {
    const float r1 = on ? ld<NC>(P.r_u + at) : ld<NC>(P.r_m + at);
    if (O.use_damping) v = O.damping * r1 + O.keep * v;
    O.r1_out[at] = r1;
  } else if (O.use_damping) {
    v = O.damping * ld<NC>(P.r_u + at) + O.keep * v;
  }
  O.r_out[at] = v;
}

struct Mixed {
  const float* cost1;
  const float* cost2;
  const float* cost3;
  const float* cost4;
  const int* arity;
  const int* cost_idx;
  const int* slot_col;
  const int* mate;
  const int* mate2;
  const int* mate3;
  const int* mate_col;
  const int* mate2_col;
  const int* mate3_col;
};

// The group's slots in arity order (phase 1's work list).
struct Items {
  const int* slot;
  const int* shard;
  long long aseg[5];
};

// r' at value i of one slot of arity a (its column ci in its arity's cost
// piece of shard d) before vmask, in _mixed_r_new's order; q1..q3 are its
// siblings' pending q.  The all-binary layout is arity 2 throughout, its
// cost rows the arity-2 piece.
template <int D, bool MIXED>
__device__ __forceinline__ float slot_value(const Mixed& M, const Desc& d,
                                             int a, size_t ci, int i,
                                             const float q1[D],
                                             const float q2[D],
                                             const float q3[D]) {
  const float* cost =
      (a == 1 ? M.cost1 : a == 2 ? M.cost2 : a == 3 ? M.cost3 : M.cost4) +
      static_cast<size_t>(d.row[1 + a]);
  const size_t w = static_cast<size_t>(d.row[5 + a]);
  if (a == 1) return cost[i * w + ci];
  if (a == 2) {
    float best = cost[i * w + ci] + q1[0];
#pragma unroll
    for (int j = 1; j < D; ++j)
      best = fminf(best, cost[(j * D + i) * w + ci] + q1[j]);
    return best;
  }
  if constexpr (MIXED && D <= kMaxDNary) {
    if (a == 3) {
      float best = (cost[i * w + ci] + q1[0]) + q2[0];
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (j == 0 && k == 0) continue;
          const float cand =
              (cost[((j * D + k) * D + i) * w + ci] + q1[j]) + q2[k];
          best = fminf(best, cand);
        }
      }
      return best;
    }
    float best = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float qjk = q1[j] + q2[k];
#pragma unroll
        for (int m = 0; m < D; ++m) {
          const size_t row = static_cast<size_t>(((j * D + k) * D + m) * D);
          const float cand = (cost[(row + i) * w + ci] + qjk) + q3[m];
          best = (j == 0 && k == 0 && m == 0) ? cand : fminf(best, cand);
        }
      }
    }
    return best;
  } else {
    return 0.0f;  // unreachable: no arity-3/4 slot on this layout or D
  }
}

template <int D, bool ACT, bool MIXED>
__global__ void __launch_bounds__(kCoopThreads)
    device_fused_ba_kernel(Pending G, Out GO, Mixed M, Items I,
                           const long long* __restrict__ desc, Walk W,
                           int Vp, unsigned* bar) {
  // the read-only cache only where it measured faster (ld above)
  constexpr bool NC = !ACT && !MIXED;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;

  // phase 1: r' of every slot.  A ternary or quaternary slot gives each
  // value to a thread of its own (its candidate search); a unary or
  // binary slot's values share one thread, which gathers the sibling's
  // pending q once.  Work units of arity a: n_a slots x units(a).
  long long wseg[5];
  wseg[0] = 0;
#pragma unroll
  for (int a = 1; a <= 4; ++a)
    wseg[a] = wseg[a - 1] + (I.aseg[a] - I.aseg[a - 1]) *
                                (MIXED && a >= 3 ? D : 1);
  for (size_t w = tid; w < static_cast<size_t>(wseg[4]); w += nthreads) {
    int seg = 1;
    while (w >= static_cast<size_t>(wseg[seg])) ++seg;
    const int a = MIXED ? seg : 2;
    const bool split = MIXED && a >= 3;
    const size_t base = static_cast<size_t>(I.aseg[seg - 1]);
    const size_t cnt = static_cast<size_t>(I.aseg[seg]) - base;
    const size_t local = w - static_cast<size_t>(wseg[seg - 1]);
    const int i0 = split ? static_cast<int>(local / cnt) : 0;
    const int i1 = split ? i0 + 1 : D;
    const size_t it = base + (split ? local % cnt : local);
    const int k = I.shard[it];
    const size_t s = static_cast<size_t>(I.slot[it]);
    const Desc d = desc_of(desc, k);
    const Pending P = at_shard<D>(G, d);
    const Out O = at_shard<D>(GO, d);
    const size_t g = d.soff + s;  // the slot in the group's int slabs
    float q1[D], q2[D], q3[D];
    if (a >= 2) pending_q<D, ACT, NC>(P, M.mate[g], M.mate_col[g], q1);
    if (MIXED && a >= 3)
      pending_q<D, ACT, NC>(P, M.mate2[g], M.mate2_col[g], q2);
    if (MIXED && a >= 4)
      pending_q<D, ACT, NC>(P, M.mate3[g], M.mate3_col[g], q3);
    // the binary layout's cost rows are indexed by the slot itself
    const size_t ci = MIXED ? static_cast<size_t>(M.cost_idx[g]) : s;
    const bool on = !ACT || P.active[s] > 0.0f;
    for (int i = i0; i < i1; ++i)
      finish_value<ACT, NC>(P, O, s, i, on,
                            slot_value<D, MIXED>(M, d, a, ci, i, q1, q2, q3));
    if (ACT) {
      float qs[D];
      pending_q<D, ACT, NC>(P, static_cast<int>(s), M.slot_col[g], qs);
      for (int i = i0; i < i1; ++i) {
        float qi = qs[0];
#pragma unroll
        for (int j = 1; j < D; ++j)
          if (j == i) qi = qs[j];
        O.q1_out[static_cast<size_t>(i) * d.n + s] = qi;
      }
    }
  }

  grid_barrier(bar);

  // phase 2: each column adds its slots' r' in rank order from 0, and the
  // shards in order, a sum a value
  const size_t vp = static_cast<size_t>(Vp);
  for (size_t w = tid; w < vp; w += nthreads) {
    const int c = W.corder[w];
    float total[D];
    column_sum<D>(
        W, c, vp, GO.result, GO.combine,
        [&](int k, int g, float* v) {
          const size_t so = static_cast<size_t>(desc[k * kDescCols]);
          const size_t n = static_cast<size_t>(desc[k * kDescCols + 1]);
          const float* r =
              GO.r_out + static_cast<size_t>(D) * so + (g - so);
#pragma unroll
          for (int i = 0; i < D; ++i) v[i] = __ldcg(r + i * n);
        },
        total);
    if (GO.combine) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const size_t at = static_cast<size_t>(i) * vp + c;
        GO.result[at] = GO.unary[at] + total[i];
      }
    }
  }
}

// K9's result of column c: where(mask > 0, unary + total, pad) for a
// whole group (combine); the partials are stored by column_sum.
template <int D>
__device__ __forceinline__ void store_table(float* out,
                                            const float* __restrict__ unary,
                                            const float* __restrict__ mask,
                                            int combine, float pad, int c,
                                            size_t vp, const float total[D]) {
  if (!combine) return;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const size_t at = static_cast<size_t>(i) * vp + c;
    out[at] = mask[at] > 0.0f ? unary[at] + total[i] : pad;
  }
}

// One thread per column.
template <int D>
__global__ void device_tables_kernel(const int* __restrict__ x,
                                     float* __restrict__ out,
                                     const float* __restrict__ unary,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ cost_rows,
                                     const int* __restrict__ mate_col,
                                     const long long* __restrict__ desc,
                                     Walk W, int Vp, int combine, float pad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.corder[t];
  const size_t vp = static_cast<size_t>(Vp);
  float total[D];
  column_sum<D>(
      W, c, vp, out, combine,
      [&](int k, int g, float* v) {
        const size_t so = static_cast<size_t>(desc[k * kDescCols]);
        const size_t n = static_cast<size_t>(desc[k * kDescCols + 1]);
        const size_t row = static_cast<size_t>(x[mate_col[g]]) * D;
        const float* cost =
            cost_rows + static_cast<size_t>(D * D) * so + (g - so);
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = cost[(row + i) * n];
      },
      total);
  store_table<D>(out, unary, mask, combine, pad, c, vp, total);
}

template <int D>
__global__ void device_tables_mixed_kernel(
    const int* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ unary, const float* __restrict__ mask, Mixed M,
    const long long* __restrict__ desc, Walk W, int Vp, int combine,
    float pad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.corder[t];
  const size_t vp = static_cast<size_t>(Vp);
  float total[D];
  column_sum<D>(
      W, c, vp, out, combine,
      [&](int k, int g, float* v) {
        const int a = M.arity[g];
        size_t row = 0;  // the siblings' values, other-values-major
        if (a >= 2) row = static_cast<size_t>(x[M.mate_col[g]]);
        if (a >= 3) row = row * D + static_cast<size_t>(x[M.mate2_col[g]]);
        if (a >= 4) row = row * D + static_cast<size_t>(x[M.mate3_col[g]]);
        const long long* dk = desc + k * kDescCols;
        const float* cost = (a == 1   ? M.cost1
                             : a == 2 ? M.cost2
                             : a == 3 ? M.cost3
                                      : M.cost4) +
                            static_cast<size_t>(dk[1 + a]);
        const size_t wid = static_cast<size_t>(dk[5 + a]);
        const size_t ci = static_cast<size_t>(M.cost_idx[g]);
#pragma unroll
        for (int i = 0; i < D; ++i) v[i] = cost[(row * D + i) * wid + ci];
      },
      total);
  store_table<D>(out, unary, mask, combine, pad, c, vp, total);
}

// The gain MGM routes from sibling column col (-1: column 0, which the
// mask zeroes) times the slot's mask, as the plain version's _at * gmask.
__device__ __forceinline__ float routed(const float* __restrict__ gain,
                                        int col, float mask) {
  return gain[col < 0 ? 0 : col] * mask;
}

// K8's operands: the group's slabs of each slot's siblings (row r: the
// first, second and third sibling; the binary layout has the first only)
// and the launch's rows.  mode: kMove (a whole group: the move mask),
// kMax (the group's partial neighbourhood max), kMin (the group's partial
// tie-break index at the combined neigh_max).
enum { kMove = 0, kMax = 1, kMin = 2 };

struct Arbiter {
  const int* col[3];
  const float* mask[3];
  const float* idx[3];
  const float* gain;
  const float* idx_row;    // kMove
  const float* neigh_max;  // kMin
  float* part;             // kMax, kMin: [Vp]
  unsigned char* move;     // kMove: [Vp] bool
};

// One thread per column c (by the group's degree, largest first), over
// c's slots in the group's column lists: the neighbourhood max from 0,
// then the smallest sibling index whose routed gain is within EPS of it,
// then MGM's decision for c.  The first kCache slots' routed gains and
// indices are loaded together and kept in registers for the tie-break,
// so each of them is read once; a longer column reads its other slots
// again in the second walk.
template <int SIBS>
__global__ void device_mgm_move_kernel(Arbiter A, Walk W, int Vp, int mode) {
  constexpr int kCache = SIBS == 1 ? 8 : 4;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.corder[t];
  const int lo = W.cptr[c];
  const int hi = W.cptr[c + 1];
  const int n = hi - lo;
  float gv[kCache][SIBS];
  float iv[kCache][SIBS];
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    if (u < n) {
      const size_t g = static_cast<size_t>(W.centry[lo + u]);
#pragma unroll
      for (int r = 0; r < SIBS; ++r) {
        gv[u][r] = routed(A.gain, A.col[r][g], A.mask[r][g]);
        iv[u][r] = mode == kMax ? kBigIdx : A.idx[r][g];
      }
    }
  }
  float nm = 0.0f;
  if (mode == kMin) {
    nm = A.neigh_max[c];
  } else {
#pragma unroll
    for (int u = 0; u < kCache; ++u) {
      if (u < n) {
#pragma unroll
        for (int r = 0; r < SIBS; ++r) nm = fmaxf(nm, gv[u][r]);
      }
    }
    for (int e = lo + kCache; e < hi; ++e) {
      const size_t g = static_cast<size_t>(W.centry[e]);
#pragma unroll
      for (int r = 0; r < SIBS; ++r)
        nm = fmaxf(nm, routed(A.gain, A.col[r][g], A.mask[r][g]));
    }
    if (mode == kMax) {
      A.part[c] = nm;
      return;
    }
  }
  const float thr = nm - kEps;
  float idx = kBigIdx;
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    if (u < n) {
#pragma unroll
      for (int r = 0; r < SIBS; ++r)
        if (gv[u][r] >= thr) idx = fminf(idx, iv[u][r]);
    }
  }
  for (int e = lo + kCache; e < hi; ++e) {
    const size_t g = static_cast<size_t>(W.centry[e]);
#pragma unroll
    for (int r = 0; r < SIBS; ++r)
      if (routed(A.gain, A.col[r][g], A.mask[r][g]) >= thr)
        idx = fminf(idx, A.idx[r][g]);
  }
  if (mode == kMin) {
    A.part[c] = idx;
    return;
  }
  const float gc = A.gain[c];
  const bool tie = (fabsf(gc - nm) <= kEps) && (A.idx_row[c] < idx);
  A.move[c] = (gc > 0.0f) && ((gc > nm + kEps) || tie);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

inline Walk make_walk(const int* corder, const int* cptr, const int* centry,
                      const int* cshard) {
  Walk W;
  W.corder = corder;
  W.cptr = cptr;
  W.centry = centry;
  W.cshard = cshard;
  return W;
}

inline Pending make_pending(const float* bel_g, const float* r_u,
                            const float* q_m, const float* r_m,
                            const float* active, const float* vmask,
                            const float* inv_dcount, int Vp) {
  Pending P;
  P.bel_g = bel_g;
  P.r_u = r_u;
  P.q_m = q_m;
  P.r_m = r_m;
  P.active = active;
  P.vmask = vmask;
  P.inv_dcount = inv_dcount;
  P.n = 0;  // set per shard
  P.vp = static_cast<size_t>(Vp);
  return P;
}

inline Out make_out(float* r_out, float* q1_out, float* r1_out, float* result,
                    const float* unary, float damping, float keep,
                    int use_damping, int combine) {
  Out O;
  O.r_out = r_out;
  O.q1_out = q1_out;
  O.r1_out = r1_out;
  O.result = result;
  O.unary = unary;
  O.damping = damping;
  O.keep = keep;
  O.use_damping = use_damping;
  O.combine = combine;
  return O;
}

inline Mixed make_mixed(const float* const* costs, const int* arity,
                        const int* cost_idx, const int* slot_col,
                        const int* mate, const int* mate2, const int* mate3,
                        const int* mate_col, const int* mate2_col,
                        const int* mate3_col) {
  Mixed M;
  M.cost1 = costs[0];
  M.cost2 = costs[1];
  M.cost3 = costs[2];
  M.cost4 = costs[3];
  M.arity = arity;
  M.cost_idx = cost_idx;
  M.slot_col = slot_col;
  M.mate = mate;
  M.mate2 = mate2;
  M.mate3 = mate3;
  M.mate_col = mate_col;
  M.mate2_col = mate2_col;
  M.mate3_col = mate3_col;
  return M;
}

template <int D, bool ACT, bool MIXED>
int launch_k7(Pending P, Out O, Mixed M, Items I, const long long* desc,
              Walk W, int Vp, unsigned* bar, cudaStream_t st) {
  auto kernel = device_fused_ba_kernel<D, ACT, MIXED>;
  static int cap = 0;  // asked once per instantiation
  if (cap <= 0)
    cap = coop_capacity(reinterpret_cast<const void*>(kernel), kCoopThreads);
  if (cap <= 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
  }
  const long long work = static_cast<long long>(D) *
                         (I.aseg[4] > Vp ? I.aseg[4] : Vp);
  long long blocks = (work + kCoopThreads - 1) / kCoopThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  void* args[] = {&P, &O, &M, &I, &desc, &W, &Vp, &bar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kCoopThreads), args, 0, st));
}

inline Arbiter make_arbiter(const int* const* cols,
                            const float* const* masks,
                            const float* const* idxs, const float* gain,
                            const float* idx_row, const float* neigh_max,
                            float* part, unsigned char* move) {
  Arbiter A;
  for (int r = 0; r < 3; ++r) {
    A.col[r] = cols[r];
    A.mask[r] = masks[r];
    A.idx[r] = idxs[r];
  }
  A.gain = gain;
  A.idx_row = idx_row;
  A.neigh_max = neigh_max;
  A.part = part;
  A.move = move;
  return A;
}

template <int SIBS>
int launch_k8(const Arbiter& A, const int* corder, const int* cptr,
              const int* centry, int Vp, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < kMove || mode > kMin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  const Walk W = make_walk(corder, cptr, centry, nullptr);
  device_mgm_move_kernel<SIBS><<<blocks_for(Vp), kThreads, 0, st>>>(A, W, Vp,
                                                                  mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches one kernel on `stream` over the group of S shards
// and returns its launch error (0 on success).  D must be in [1, 8] (and
// <= 5 when the group has a ternary or quaternary slot); anything else
// returns cudaErrorInvalidValue without launching.  `keep` is (1 -
// damping), computed by the caller in double precision as the plain
// version does.  K7 runs its activation branch when `active` is not
// null; q_m, r_m, q1_out and r1_out are read or written only then.
// `combine` = 1: result is [D, Vp], unary + the shard-order total (K9:
// where(mask > 0, ..., pad)); 0: result is [S, D, Vp], the partials.

#define D_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// K7, every branch: a cooperative launch (two phases and a grid
// barrier).  mixed = 0: the all-binary layout, whose cost rows come as
// cost2 (cost1/3/4, cost_idx, mate2/3 and their columns are not read).
// items/item_shard/aseg: the group's slots in arity order; bar: two
// unsigned ints, zero before the group's first launch, left with a zero
// count.
extern "C" int device_fused_ba(
    const float* bel_g, const float* r_u, const float* q_m, const float* r_m,
    const float* active, float* r_out, float* q1_out, float* r1_out,
    float* result, const float* unary, const float* cost1,
    const float* cost2, const float* cost3, const float* cost4,
    const int* cost_idx, const int* slot_col, const int* mate,
    const int* mate2, const int* mate3, const int* mate_col,
    const int* mate2_col, const int* mate3_col, const float* vmask,
    const float* inv_dcount, const int* items, const int* item_shard,
    const long long* aseg, const long long* desc, const int* corder,
    const int* cptr, const int* centry, const int* cshard, int D, int Vp,
    int mixed, int nary, float damping, float keep, int use_damping,
    int combine, unsigned* bar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kMaxDNary && nary) return static_cast<int>(cudaErrorInvalidValue);
  const Walk W = make_walk(corder, cptr, centry, cshard);
  const Pending P =
      make_pending(bel_g, r_u, q_m, r_m, active, vmask, inv_dcount, Vp);
  const Out O = make_out(r_out, q1_out, r1_out, result, unary, damping, keep,
                         use_damping, combine);
  const float* costs[4] = {cost1, cost2, cost3, cost4};
  const Mixed M = make_mixed(costs, nullptr, cost_idx, slot_col, mate, mate2,
                             mate3, mate_col, mate2_col, mate3_col);
  Items I;
  I.slot = items;
  I.shard = item_shard;
  for (int a = 0; a < 5; ++a) I.aseg[a] = aseg[a];
  const bool act = active != nullptr;
#define DEVICE_FUSED_BA_CASE(DD)                                            \
  case DD:                                                                  \
    if (mixed)                                                              \
      return act ? launch_k7<DD, true, true>(P, O, M, I, desc, W, Vp,    \
                                             bar, st)                       \
                 : launch_k7<DD, false, true>(P, O, M, I, desc, W, Vp,   \
                                              bar, st);                     \
    return act ? launch_k7<DD, true, false>(P, O, M, I, desc, W, Vp, bar, \
                                            st)                             \
               : launch_k7<DD, false, false>(P, O, M, I, desc, W, Vp,    \
                                             bar, st);
  switch (D) {
    D_CASES(DEVICE_FUSED_BA_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEVICE_FUSED_BA_CASE
}

// K9, binary.
extern "C" int device_tables(const int* x, float* result, const float* unary,
                             const float* mask, const float* cost_rows,
                             const int* mate_col, const long long* desc,
                             const int* corder, const int* cptr,
                             const int* centry, const int* cshard, int D,
                             int Vp, int combine, float pad,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  const Walk W = make_walk(corder, cptr, centry, cshard);
#define DEVICE_TABLES_CASE(DD)                                               \
  case DD:                                                                   \
    device_tables_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(            \
        x, result, unary, mask, cost_rows, mate_col, desc, W, Vp, combine,   \
        pad);                                                                \
    break;
  switch (D) {
    D_CASES(DEVICE_TABLES_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEVICE_TABLES_CASE
  return static_cast<int>(cudaGetLastError());
}

// K9, mixed.
extern "C" int device_tables_mixed(
    const int* x, float* result, const float* unary, const float* mask,
    const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const long long* desc, const int* corder, const int* cptr,
    const int* centry, const int* cshard, int D, int Vp, int nary,
    int combine, float pad, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kMaxDNary && nary) return static_cast<int>(cudaErrorInvalidValue);
  const Walk W = make_walk(corder, cptr, centry, cshard);
  const float* costs[4] = {cost1, cost2, cost3, cost4};
  const Mixed M = make_mixed(costs, arity, cost_idx, nullptr, nullptr,
                             nullptr, nullptr, mate_col, mate2_col,
                             mate3_col);
#define DEVICE_TABLES_MIXED_CASE(DD)                                         \
  case DD:                                                                   \
    device_tables_mixed_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(      \
        x, result, unary, mask, M, desc, W, Vp, combine, pad);               \
    break;
  switch (D) {
    D_CASES(DEVICE_TABLES_MIXED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEVICE_TABLES_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}

// K8, binary: one launch per device per MGM cycle (no value rows, so no D).
// mode 0: move [Vp] bool from gain, idx_row (a whole group); 1: part [Vp]
// the group's partial neighbourhood max; 2: part [Vp] the group's partial
// tie-break index at neigh_max.  Pointers a mode does not use may be null.
extern "C" int device_mgm_move(const float* gain, const float* idx_row,
                               const float* neigh_max, float* part,
                               unsigned char* move, const float* gmask1,
                               const int* mate_col, const float* mate_idx,
                               const int* corder, const int* cptr,
                               const int* centry, int Vp, int mode,
                               void* stream) {
  const int* cols[3] = {mate_col, nullptr, nullptr};
  const float* masks[3] = {gmask1, nullptr, nullptr};
  const float* idxs[3] = {mate_idx, nullptr, nullptr};
  return launch_k8<1>(make_arbiter(cols, masks, idxs, gain, idx_row,
                                   neigh_max, part, move),
                      corder, cptr, centry, Vp, mode, stream);
}

// K8, mixed: every slot's three sibling rows, masked by arity.
extern "C" int device_mgm_move_mixed(
    const float* gain, const float* idx_row, const float* neigh_max,
    float* part, unsigned char* move, const float* gmask1,
    const float* gmask2, const float* gmask3, const int* mate_col,
    const int* mate2_col, const int* mate3_col, const float* mate_idx,
    const float* mate2_idx, const float* mate3_idx, const int* corder,
    const int* cptr, const int* centry, int Vp, int mode, void* stream) {
  const int* cols[3] = {mate_col, mate2_col, mate3_col};
  const float* masks[3] = {gmask1, gmask2, gmask3};
  const float* idxs[3] = {mate_idx, mate2_idx, mate3_idx};
  return launch_k8<3>(make_arbiter(cols, masks, idxs, gain, idx_row,
                                   neigh_max, part, move),
                      corder, cptr, centry, Vp, mode, stream);
}
#undef D_CASES
