// Per-shard kernels of the sharded engines for Hopper (sm_90a): the
// all-binary and the mixed-arity (1-4) branches, and MaxSum's activation
// branch (amaxsum).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc
// into a shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_sharded.py.  Each launch computes ONE
// shard's part of a cycle on that shard's layout and device; the caller
// adds (or maxes, mins) the shards' partials in shard order afterwards.
//
// Replaces the Pallas TPU kernels of pydcop_tpu/ops/pallas_sharded.py:
//   shard_fused_ba          <- packed_shard_fused_ba    (K7, binary;
//                              activation when `active` is given)
//   shard_fused_ba_mixed    <- packed_shard_fused_ba    (K7, mixed=;
//                              activation when `active` is given)
//   shard_route_gains       <- packed_shard_route_gains (K8, binary)
//   shard_route_gains_mixed <- packed_shard_route_gains (K8, consts2/3)
//   shard_tables            <- packed_shard_tables      (K9, binary)
//   shard_tables_mixed      <- packed_shard_tables      (K9, mixed=)
//
// Layout (parallel/packed_mesh.py::ShardLayout): one common column per
// variable; the shard's threads walk the columns sorted by the shard's
// degree, thread t owning column tcol[t], whose k-th slot is
// t_slot0[t] + k * t_stride[t] (the var-grouped slots of
// ops/packed_maxsum.py, built per shard, so the threads of a degree class
// read neighbouring slots).  mate[s] is the slot of the factor's first
// sibling, mate_col[s] its column; a mixed layout adds mate2/mate3 (the
// second and third siblings, cyclic from the slot's position), their
// columns, the slot's arity and its column cost_idx[s] in its arity's cost
// array (cost1 [D, n1], cost2 [D^2, n2], cost3 [D^3, n3], cost4 [D^4, n4],
// other-values-major: row ((j*D+k)*D+m)*D + i = cost(siblings at j, k, m,
// this end at i)).  -1 marks a sibling that does not exist.  Arrays of D
// rows are row-major [D, N] or [D, Vp].  A column the shard does not touch
// has degree 0 and gets partial 0 (fill 0 of the per-column reduction).
//
// K7, one thread per column, no dependency between threads inside a
// launch: for each of its slots s the thread recomputes the pending
// variable side of the PREVIOUS cycle at each sibling slot m (it needs
// only the launch's inputs bel_g[:, col(m)] and r_u[:, m]), in the Pallas
// order:
//   e[j]   = bel_g[j, col(m)] - r_u[j, m]                   (expand, subtract)
//   mean   = (sum_{j from 0} e[j] * vmask[j, m]) * inv_dcount[m]
//   q[j]   = (e[j] - mean) * vmask[j, m]
//   q[j]   = active[m] > 0 ? q[j] : q_m[j, m]               (activation)
// then this cycle's factor side at s, binary:
//   r'[i]  = min_{j from 0}(cost[j*D+i, s] + q[j])
// or by arity on the mixed layout (ops/packed_maxsum.py::_mixed_r_new):
// unary the cost row; binary as above; ternary the min over (j outer, k
// inner) of (cost3 + q1[j]) + q2[k]; quaternary the min over (j, k, m) of
// (cost4 + (q1[j] + q2[k])) + q3[m]; then
//   r'[i]  = r'[i] * vmask[i, s]
//   r1[i]  = active[s] > 0 ? r_u[i, s] : r_m[i, s]         (activation;
//                                                            else r_u)
//   r'[i]  = damping * r1[i] + (1 - damping) * r'[i]      (damping != 0)
//   partial[i, col] = sum over the column's slots in rank order, from 0
// With activation the launch also writes q1 (the committed q at s) and r1.
// On a zero state (bel_g = 0, r_u = 0, q_m = r_m = 0) the pending side
// gives q = 0 whatever the mask, so the first launch needs no flag.
// r_out never aliases r_u: another thread reads r_u at this thread's slots
// as its siblings.
//
// K8: gn[s] = gain[col(mate(s))] * gmask1[s] (mixed: gn2, gn3 from the
// second and third siblings times gmask2, gmask3); nm_part[col] = max over
// the column's slots of max(gn, gn2, gn3), from 0.
// K9: partial[i, col] = sum over the column's slots in rank order, from 0,
// of the slot's cost row at its siblings' values: cost[x1*D + i] binary,
// cost_a[(row*D) + i] with row = x1, x1*D + x2, (x1*D + x2)*D + x3 mixed,
// cost1[i] on a unary slot.
//
// Built with -fmad=false, so each multiply and add rounds as in the plain
// PyTorch versions (ops/packed_sharded.py *_plain).
//
// Bound: memory.  K7 reads per slot its table (D*D floats binary, D^a
// mixed) and 3*D r_u / vmask / bel_g floats at each sibling, 2*D at the
// slot, writes D r' floats (activation: also reads q_m, r_m at the
// siblings and the slot and writes q1, r1), and reads/writes D floats per
// column.  K8 and K9 read a few words a slot (K9 the D selected cost
// floats).  The design answers the bound only by reading each operand
// about once, coalesced within a degree class except the sibling gathers;
// shared memory and TMA are not used.  A ternary or quaternary slot
// recomputes its siblings' pending q (2 or 3 times D floats of bel_g and
// r_u) where the TPU kernel routes q through Clos stages.  Launches are
// host-issued, S per cycle (one per shard).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// ternary and quaternary slots exist only up to this D (the packer's
// limit), so the D^3 / D^4 loops are compiled only there
constexpr int kMaxDNary = 5;

// A read-only load.  NC routes it through the non-coherent (read-only)
// cache, which the struct members below do not get on their own: they
// carry no __restrict__, so the compiler cannot prove that the stores to
// r_out/q1/r1 never alias them.  Measured on the H100 (PERF.md, PR 8), NC
// helps the binary cycle (10.5 us a launch at 10k/30k, 8 shards, against
// 14.3) and hurts the activation and mixed branches (a quaternary
// SECP-39k launch 267 us against 134), so only the binary cycle without
// activation takes it.
template <bool NC, class T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (NC) {
    return __ldg(p);
  } else {
    return *p;
  }
}

struct Walk {
  const int* tcol;
  const int* t_deg;
  const int* t_slot0;
  const int* t_stride;
};

// The pending variable side's operands and the activation carry.
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

struct Out {
  float* r_out;
  float* partial;
  float* q1_out;  // activation only
  float* r1_out;  // activation only
  float damping;
  float keep;
  int use_damping;
};

// vmask, commit, damping and the stores of slot s's new message rn; adds
// it to the column's partial and, with activation, writes q1 and r1 there.
template <int D, bool ACT, bool NC>
__device__ __forceinline__ void finish_slot(const Pending& P, const Out& O,
                                            size_t s, int c, float rn[D],
                                            float acc[D]) {
  const bool on = !ACT || ld<NC>(P.active + s) > 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const size_t at = i * P.n + s;
    float v = rn[i] * ld<NC>(P.vmask + at);
    if (ACT) {
      const float r1 = on ? ld<NC>(P.r_u + at) : ld<NC>(P.r_m + at);
      if (O.use_damping) v = O.damping * r1 + O.keep * v;
      O.r1_out[at] = r1;
    } else if (O.use_damping) {
      v = O.damping * ld<NC>(P.r_u + at) + O.keep * v;
    }
    O.r_out[at] = v;
    acc[i] += v;
  }
  if (ACT) {
    float q[D];
    pending_q<D, ACT, NC>(P, static_cast<int>(s), c, q);
#pragma unroll
    for (int i = 0; i < D; ++i) O.q1_out[i * P.n + s] = q[i];
  }
}

template <int D, bool ACT>
__global__ void shard_fused_ba_kernel(Pending P, Out O,
                                      const float* __restrict__ cost,
                                      const int* __restrict__ mate,
                                      const int* __restrict__ mate_col, Walk W,
                                      int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  const size_t n = P.n;

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;

  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    float q[D];
    pending_q<D, ACT, !ACT>(P, mate[s], mate_col[s], q);
    float rn[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float best = cost[i * n + s] + q[0];
#pragma unroll
      for (int j = 1; j < D; ++j)
        best = fminf(best, cost[(j * D + i) * n + s] + q[j]);
      rn[i] = best;
    }
    finish_slot<D, ACT, !ACT>(P, O, s, c, rn, acc);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) O.partial[i * P.vp + c] = acc[i];
}

struct Mixed {
  const float* cost1;
  const float* cost2;
  const float* cost3;
  const float* cost4;
  const int* arity;
  const int* cost_idx;
  const int* mate;
  const int* mate2;
  const int* mate3;
  const int* mate_col;
  const int* mate2_col;
  const int* mate3_col;
  size_t n1, n2, n3, n4;
};

// r' of one mixed slot before vmask, in _mixed_r_new's order.
template <int D, bool ACT>
__device__ __forceinline__ void mixed_r(const Pending& P, const Mixed& M,
                                        size_t s, float rn[D]) {
  const int a = M.arity[s];
  const size_t ci = static_cast<size_t>(M.cost_idx[s]);
  if (a == 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) rn[i] = M.cost1[i * M.n1 + ci];
    return;
  }
  float q1[D];
  pending_q<D, ACT, false>(P, M.mate[s], M.mate_col[s], q1);
  if (a == 2) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float best = M.cost2[i * M.n2 + ci] + q1[0];
#pragma unroll
      for (int j = 1; j < D; ++j)
        best = fminf(best, M.cost2[(j * D + i) * M.n2 + ci] + q1[j]);
      rn[i] = best;
    }
    return;
  }
  if constexpr (D <= kMaxDNary) {
    float q2[D];
    pending_q<D, ACT, false>(P, M.mate2[s], M.mate2_col[s], q2);
    if (a == 3) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float best = (M.cost3[i * M.n3 + ci] + q1[0]) + q2[0];
#pragma unroll
        for (int j = 0; j < D; ++j) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (j == 0 && k == 0) continue;
            const float cand =
                (M.cost3[((j * D + k) * D + i) * M.n3 + ci] + q1[j]) +
                q2[k];
            best = fminf(best, cand);
          }
        }
        rn[i] = best;
      }
      return;
    }
    float q3[D];
    pending_q<D, ACT, false>(P, M.mate3[s], M.mate3_col[s], q3);
    float best[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float qjk = q1[j] + q2[k];
#pragma unroll
        for (int m = 0; m < D; ++m) {
          const size_t row = static_cast<size_t>(((j * D + k) * D + m) * D);
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const float cand =
                (M.cost4[(row + i) * M.n4 + ci] + qjk) + q3[m];
            best[i] = (j == 0 && k == 0 && m == 0) ? cand
                                                   : fminf(best[i], cand);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) rn[i] = best[i];
  } else {
    // unreachable: the packer gives no arity-3/4 slot at this D
#pragma unroll
    for (int i = 0; i < D; ++i) rn[i] = 0.0f;
  }
}

template <int D, bool ACT>
__global__ void shard_fused_ba_mixed_kernel(Pending P, Out O, Mixed M,
                                            Walk W, int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;

  // unary, binary, ternary, quaternary ranks in turn
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    float rn[D];
    mixed_r<D, ACT>(P, M, s, rn);
    finish_slot<D, ACT, false>(P, O, s, c, rn, acc);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) O.partial[i * P.vp + c] = acc[i];
}

__global__ void shard_route_gains_kernel(
    const float* __restrict__ gain, const float* __restrict__ gmask1,
    float* __restrict__ nm_part, float* __restrict__ gn,
    const int* __restrict__ mate_col, Walk W, int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  float nm = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const float g = gain[mate_col[s]] * gmask1[s];
    gn[s] = g;
    nm = fmaxf(nm, g);
  }
  nm_part[c] = nm;
}

// gain at column col (-1: column 0, which the mask zeroes) times the mask
__device__ __forceinline__ float routed(const float* __restrict__ gain,
                                        int col, float mask) {
  return gain[col < 0 ? 0 : col] * mask;
}

__global__ void shard_route_gains_mixed_kernel(
    const float* __restrict__ gain, const float* __restrict__ gmask1,
    const float* __restrict__ gmask2, const float* __restrict__ gmask3,
    float* __restrict__ nm_part, float* __restrict__ gn,
    float* __restrict__ gn2, float* __restrict__ gn3,
    const int* __restrict__ mate_col, const int* __restrict__ mate2_col,
    const int* __restrict__ mate3_col, Walk W, int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  float nm = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const float g1 = routed(gain, mate_col[s], gmask1[s]);
    const float g2 = routed(gain, mate2_col[s], gmask2[s]);
    const float g3 = routed(gain, mate3_col[s], gmask3[s]);
    gn[s] = g1;
    gn2[s] = g2;
    gn3[s] = g3;
    nm = fmaxf(nm, fmaxf(fmaxf(g1, g2), g3));
  }
  nm_part[c] = nm;
}

template <int D>
__global__ void shard_tables_kernel(const int* __restrict__ x,
                                    float* __restrict__ partial,
                                    const float* __restrict__ cost,
                                    const int* __restrict__ mate_col, Walk W,
                                    int N, int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  const size_t n = static_cast<size_t>(N);
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const size_t row = static_cast<size_t>(x[mate_col[s]]) * D;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] += cost[(row + i) * n + s];
  }
  const size_t vp = static_cast<size_t>(Vp);
#pragma unroll
  for (int i = 0; i < D; ++i) partial[i * vp + c] = acc[i];
}

template <int D>
__global__ void shard_tables_mixed_kernel(const int* __restrict__ x,
                                          float* __restrict__ partial,
                                          Mixed M, Walk W, int Vp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const int a = M.arity[s];
    const size_t ci = static_cast<size_t>(M.cost_idx[s]);
    const float* cost;
    size_t width;
    size_t row = 0;  // the siblings' values, other-values-major
    if (a == 1) {
      cost = M.cost1;
      width = M.n1;
    } else {
      row = static_cast<size_t>(x[M.mate_col[s]]);
      if (a == 2) {
        cost = M.cost2;
        width = M.n2;
      } else {
        row = row * D + static_cast<size_t>(x[M.mate2_col[s]]);
        if (a == 3) {
          cost = M.cost3;
          width = M.n3;
        } else {
          row = row * D + static_cast<size_t>(x[M.mate3_col[s]]);
          cost = M.cost4;
          width = M.n4;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
      acc[i] += cost[(row * D + i) * width + ci];
  }
  const size_t vp = static_cast<size_t>(Vp);
#pragma unroll
  for (int i = 0; i < D; ++i) partial[i * vp + c] = acc[i];
}

inline int blocks_for(int Vp) { return (Vp + kThreads - 1) / kThreads; }

inline Walk make_walk(const int* tcol, const int* t_deg, const int* t_slot0,
                      const int* t_stride) {
  Walk W;
  W.tcol = tcol;
  W.t_deg = t_deg;
  W.t_slot0 = t_slot0;
  W.t_stride = t_stride;
  return W;
}

inline Pending make_pending(const float* bel_g, const float* r_u,
                            const float* q_m, const float* r_m,
                            const float* active, const float* vmask,
                            const float* inv_dcount, int N, int Vp) {
  Pending P;
  P.bel_g = bel_g;
  P.r_u = r_u;
  P.q_m = q_m;
  P.r_m = r_m;
  P.active = active;
  P.vmask = vmask;
  P.inv_dcount = inv_dcount;
  P.n = static_cast<size_t>(N);
  P.vp = static_cast<size_t>(Vp);
  return P;
}

inline Out make_out(float* r_out, float* partial, float* q1_out,
                    float* r1_out, float damping, float keep,
                    int use_damping) {
  Out O;
  O.r_out = r_out;
  O.partial = partial;
  O.q1_out = q1_out;
  O.r1_out = r1_out;
  O.damping = damping;
  O.keep = keep;
  O.use_damping = use_damping;
  return O;
}

inline Mixed make_mixed(const float* cost1, const float* cost2,
                        const float* cost3, const float* cost4,
                        const int* arity, const int* cost_idx,
                        const int* mate_col, const int* mate2_col,
                        const int* mate3_col, const int* mate,
                        const int* mate2, const int* mate3, int n1, int n2,
                        int n3, int n4) {
  Mixed M;
  M.cost1 = cost1;
  M.cost2 = cost2;
  M.cost3 = cost3;
  M.cost4 = cost4;
  M.arity = arity;
  M.cost_idx = cost_idx;
  M.mate = mate;
  M.mate2 = mate2;
  M.mate3 = mate3;
  M.mate_col = mate_col;
  M.mate2_col = mate2_col;
  M.mate3_col = mate3_col;
  M.n1 = static_cast<size_t>(n1);
  M.n2 = static_cast<size_t>(n2);
  M.n3 = static_cast<size_t>(n3);
  M.n4 = static_cast<size_t>(n4);
  return M;
}

}  // namespace

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  D must be in [1, 8] (and <= 5 when
// the shard has a ternary or quaternary slot); anything else returns
// cudaErrorInvalidValue without launching.  `keep` is (1 - damping),
// computed by the caller in double precision as the plain version does.
// K7 runs its activation branch when `active` is not null; q_m, r_m,
// q1_out and r1_out are read or written only then.

#define D_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

// K7, binary.
extern "C" int shard_fused_ba(const float* bel_g, const float* r_u,
                              const float* q_m, const float* r_m,
                              const float* active, float* r_out,
                              float* partial, float* q1_out, float* r1_out,
                              const float* cost, const float* vmask,
                              const float* inv_dcount, const int* mate,
                              const int* mate_col, const int* tcol,
                              const int* t_deg, const int* t_slot0,
                              const int* t_stride, int D, int N, int Vp,
                              float damping, float keep, int use_damping,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  const Walk W = make_walk(tcol, t_deg, t_slot0, t_stride);
  const Pending P =
      make_pending(bel_g, r_u, q_m, r_m, active, vmask, inv_dcount, N, Vp);
  const Out O =
      make_out(r_out, partial, q1_out, r1_out, damping, keep, use_damping);
  const bool act = active != nullptr;
#define SHARD_FUSED_BA_CASE(DD)                                              \
  case DD:                                                                   \
    if (act)                                                                 \
      shard_fused_ba_kernel<DD, true><<<blocks_for(Vp), kThreads, 0, st>>>(   \
          P, O, cost, mate, mate_col, W, Vp);                                \
    else                                                                     \
      shard_fused_ba_kernel<DD, false><<<blocks_for(Vp), kThreads, 0, st>>>(  \
          P, O, cost, mate, mate_col, W, Vp);                                \
    break;
  switch (D) {
    D_CASES(SHARD_FUSED_BA_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_FUSED_BA_CASE
  return static_cast<int>(cudaGetLastError());
}

// K7, mixed.  n1..n4 are the widths of the per-arity cost arrays.
extern "C" int shard_fused_ba_mixed(
    const float* bel_g, const float* r_u, const float* q_m, const float* r_m,
    const float* active, float* r_out, float* partial, float* q1_out,
    float* r1_out, const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const int* mate, const int* mate2, const int* mate3, const float* vmask,
    const float* inv_dcount, const int* tcol, const int* t_deg,
    const int* t_slot0, const int* t_stride, int D, int N, int Vp, int n1,
    int n2, int n3, int n4, float damping, float keep, int use_damping,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kMaxDNary && (n3 > 0 || n4 > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk W = make_walk(tcol, t_deg, t_slot0, t_stride);
  const Pending P =
      make_pending(bel_g, r_u, q_m, r_m, active, vmask, inv_dcount, N, Vp);
  const Out O =
      make_out(r_out, partial, q1_out, r1_out, damping, keep, use_damping);
  const Mixed M =
      make_mixed(cost1, cost2, cost3, cost4, arity, cost_idx, mate_col,
                 mate2_col, mate3_col, mate, mate2, mate3, n1, n2, n3, n4);
  const bool act = active != nullptr;
#define SHARD_FUSED_BA_MIXED_CASE(DD)                                        \
  case DD:                                                                   \
    if (act)                                                                 \
      shard_fused_ba_mixed_kernel<DD, true>                                  \
          <<<blocks_for(Vp), kThreads, 0, st>>>(P, O, M, W, Vp);              \
    else                                                                     \
      shard_fused_ba_mixed_kernel<DD, false>                                 \
          <<<blocks_for(Vp), kThreads, 0, st>>>(P, O, M, W, Vp);              \
    break;
  switch (D) {
    D_CASES(SHARD_FUSED_BA_MIXED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_FUSED_BA_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}

// K8, binary (no value rows, so no D).
extern "C" int shard_route_gains(const float* gain, float* nm_part,
                                 float* gn, const float* gmask1,
                                 const int* mate_col, const int* tcol,
                                 const int* t_deg, const int* t_slot0,
                                 const int* t_stride, int N, int Vp,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  (void)N;
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  shard_route_gains_kernel<<<blocks_for(Vp), kThreads, 0, st>>>(
      gain, gmask1, nm_part, gn, mate_col,
      make_walk(tcol, t_deg, t_slot0, t_stride), Vp);
  return static_cast<int>(cudaGetLastError());
}

// K8, mixed.
extern "C" int shard_route_gains_mixed(
    const float* gain, float* nm_part, float* gn, float* gn2, float* gn3,
    const float* gmask1, const float* gmask2, const float* gmask3,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const int* tcol, const int* t_deg, const int* t_slot0,
    const int* t_stride, int N, int Vp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  (void)N;
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  shard_route_gains_mixed_kernel<<<blocks_for(Vp), kThreads, 0, st>>>(
      gain, gmask1, gmask2, gmask3, nm_part, gn, gn2, gn3, mate_col,
      mate2_col, mate3_col, make_walk(tcol, t_deg, t_slot0, t_stride), Vp);
  return static_cast<int>(cudaGetLastError());
}

// K9, binary.
extern "C" int shard_tables(const int* x, float* partial, const float* cost,
                            const int* mate_col, const int* tcol,
                            const int* t_deg, const int* t_slot0,
                            const int* t_stride, int D, int N, int Vp,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  const Walk W = make_walk(tcol, t_deg, t_slot0, t_stride);
#define SHARD_TABLES_CASE(DD)                                                \
  case DD:                                                                   \
    shard_tables_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(             \
        x, partial, cost, mate_col, W, N, Vp);                                \
    break;
  switch (D) {
    D_CASES(SHARD_TABLES_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_TABLES_CASE
  return static_cast<int>(cudaGetLastError());
}

// K9, mixed.
extern "C" int shard_tables_mixed(
    const int* x, float* partial, const float* cost1, const float* cost2,
    const float* cost3, const float* cost4, const int* arity,
    const int* cost_idx, const int* mate_col, const int* mate2_col,
    const int* mate3_col, const int* tcol, const int* t_deg,
    const int* t_slot0, const int* t_stride, int D, int Vp, int n1, int n2,
    int n3, int n4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kMaxDNary && (n3 > 0 || n4 > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk W = make_walk(tcol, t_deg, t_slot0, t_stride);
  const Mixed M =
      make_mixed(cost1, cost2, cost3, cost4, arity, cost_idx, mate_col,
                 mate2_col, mate3_col, nullptr, nullptr, nullptr, n1, n2, n3,
                 n4);
#define SHARD_TABLES_MIXED_CASE(DD)                                          \
  case DD:                                                                   \
    shard_tables_mixed_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(       \
        x, partial, M, W, Vp);                                               \
    break;
  switch (D) {
    D_CASES(SHARD_TABLES_MIXED_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_TABLES_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}
#undef D_CASES
