// One synchronous MaxSum cycle on the packed layouts, for Hopper (sm_90a):
// the all-binary layout (packed_maxsum_cycle) and the mixed-arity layout
// of unary, binary, ternary and quaternary factors
// (packed_maxsum_mixed_cycle).  Built by pydcop_tpu_torch/ops/cuda_build.py
// with nvcc into a shared library with a plain C interface, bound with
// ctypes by pydcop_tpu_torch/ops/packed_maxsum.py::packed_cycles.
//
// Replaces: pydcop_tpu/ops/pallas_maxsum.py::packed_cycles, the Pallas TPU
// kernel that runs n fused cycles with the mate exchange routed through
// Clos plans — its all-binary branch (_cycle_body without _mixed_r_new)
// and its mixed branch (_cycle_body with _mixed_r_new).
//
// Math (identical to the Pallas kernel; binary slots also to the generic
// engine):
//   binary:     r'[i,s] = min_j(cost[j*D+i, s] + q[j, mate[s]])
//   unary:      r'[i,s] = cost1[i, s]
//   ternary:    r'[i,s] = min_{j,k}((cost3[(j*D+k)*D+i, s] + q1[j]) + q2[k])
//   quaternary: r'[i,s] = min_{j,k,m}((cost4[((j*D+k)*D+m)*D+i, s]
//                                      + (q1[j] + q2[k])) + q3[m])
//     (q1/q2/q3 = q of the slots mate/mate2/mate3, the factor's other
//     endpoints taken cyclically from the slot's position; the minima
//     run j outer, k, m inner, from the first candidate)
//   r'      = vmask[i,s] * r'
//   r'      = damping * r + (1 - damping) * r'          (when damping != 0)
//   b[i,c]  = unary[i,c] + sum_{k < deg(c)} r'[i, slot(c, k)]
//   q'[i,s] = (b[i,col(s)] - r'[i,s] - mean_valid_i(...)) * vmask[i,s]
//
// Layout (var-grouped slots, built by pack_for_gpu): the columns are the
// variables sorted by degree (mixed: by their per-arity degree tuple);
// the columns of one class share a block of slots, and column c's k-th
// slot is col_slot0[c] + k * col_stride[c].  A mixed column's slots run
// unary, binary, ternary, quaternary, so the threads of a class block
// meet the same arity at the same rank.  The mixed layout keeps one cost
// array per arity, [D^a, N_a] over that arity's slots only, and each
// slot's column in it (cost_idx); slots of a class block at one rank have
// neighbouring cost_idx, so those loads coalesce too.  One thread owns
// one column: at each rank k the threads of a warp touch neighbouring
// slots (coalesced), and a thread stops at its column's true degree, so a
// hub of any degree is one longer loop (no hub splitting, no padding to
// a degree class).
//
// One launch per cycle: the only reads across columns are q_in at the
// sibling slots, of the PREVIOUS cycle.  Everything after them — r' of
// the column's slots, its belief and q' of its slots — is owned by the
// column's thread.  So q is double-buffered across launches (q_in and
// q_out never alias), while r may be updated in place (r_in == r_out):
// each r element is read and then written by its owner thread only.
//
// Bound: memory.  Binary: per slot per cycle D*D cost floats, D gathered
// q floats, 2*D r floats, D q floats, D vmask floats, the mate index and
// inv_dcount: ~104 B at D=3, ~6.2 MB a cycle at 60k slots (the
// 10k-variable / 30k-constraint coloring) — about 2 us at 3.35 TB/s.
// Mixed: an arity-a slot reads D^a cost floats and (a-1)*D gathered q
// floats (the SECP instances: D=5, so a ternary slot reads 500 B of
// cost, a quaternary slot 2.5 kB); the D^a candidate loops stay in
// registers.  The design answers the bound only by reading each operand
// once and coalescing all but the sibling gathers; shared-memory staging
// and TMA are not used.
#include <cuda_runtime.h>

namespace {

template <int D>
__global__ void packed_maxsum_cycle_kernel(
    const float* __restrict__ q_in, float* __restrict__ q_out,
    const float* r_in, float* r_out, float* __restrict__ beliefs,
    const float* __restrict__ cost, const float* __restrict__ unary,
    const float* __restrict__ vmask, const float* __restrict__ inv_dcount,
    const int* __restrict__ mate, const int* __restrict__ col_deg,
    const int* __restrict__ col_slot0, const int* __restrict__ col_stride,
    int N, int Vp, float damping, float keep, int use_damping) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Vp) return;
  const int deg = col_deg[c];
  const size_t s0 = static_cast<size_t>(col_slot0[c]);
  const size_t stride = static_cast<size_t>(col_stride[c]);
  const size_t n = static_cast<size_t>(N);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;

  // factor side of every slot of this column, and the belief sum in slot
  // order (rank 0 first, as the Pallas kernel's bucket sum)
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const size_t m = static_cast<size_t>(mate[s]);
    float qm[D];
#pragma unroll
    for (int j = 0; j < D; ++j) qm[j] = q_in[j * n + m];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      // cost rows are other-value-major: row j*D+i = cost(other=j, tgt=i)
      float best = cost[i * n + s] + qm[0];
#pragma unroll
      for (int j = 1; j < D; ++j) {
        best = fminf(best, cost[(j * D + i) * n + s] + qm[j]);
      }
      float rn = best * vmask[i * n + s];
      if (use_damping) rn = damping * r_in[i * n + s] + keep * rn;
      r_out[i * n + s] = rn;
      acc[i] += rn;
    }
  }

  float bel[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    bel[i] = unary[i * static_cast<size_t>(Vp) + c] + acc[i];
    beliefs[i * static_cast<size_t>(Vp) + c] = bel[i];
  }

  // variable side: q' = belief - own r', centred on the valid values' mean
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    float qv[D];
    float vm[D];
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      vm[i] = vmask[i * n + s];
      qv[i] = bel[i] - r_out[i * n + s];
      total += qv[i] * vm[i];
    }
    const float mean = total * inv_dcount[s];
#pragma unroll
    for (int i = 0; i < D; ++i) q_out[i * n + s] = (qv[i] - mean) * vm[i];
  }
}

// the largest D at which a ternary or quaternary slot exists (the packer
// refuses D > 5 with such factors); the D^3/D^4 loops are compiled only
// up to it
constexpr int kMaxDNary = 5;

struct MixedArgs {
  const float* cost1;  // [D, n1]
  const float* cost2;  // [D^2, n2]
  const float* cost3;  // [D^3, n3]
  const float* cost4;  // [D^4, n4]
  const int* arity;     // [N]
  const int* cost_idx;  // [N]
  const int* mate;      // [N] first sibling slot (-1 on unary slots)
  const int* mate2;     // [N] second sibling slot (-1 below arity 3)
  const int* mate3;     // [N] third sibling slot (-1 below arity 4)
  size_t n1, n2, n3, n4;
};

template <int D>
__device__ __forceinline__ void gather_q(const float* __restrict__ q,
                                         size_t n, int slot, float out[D]) {
  const size_t m = static_cast<size_t>(slot);
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = q[j * n + m];
}

// r' of one mixed slot, in the Pallas kernel's order (see the header)
template <int D>
__device__ __forceinline__ void mixed_r(const MixedArgs& A,
                                        const float* __restrict__ q_in,
                                        size_t n, size_t s, float rn[D]) {
  const int a = A.arity[s];
  const size_t ci = static_cast<size_t>(A.cost_idx[s]);
  if (a == 1) {
#pragma unroll
    for (int i = 0; i < D; ++i) rn[i] = A.cost1[i * A.n1 + ci];
    return;
  }
  float q1[D];
  gather_q<D>(q_in, n, A.mate[s], q1);
  if (a == 2) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float best = A.cost2[i * A.n2 + ci] + q1[0];
#pragma unroll
      for (int j = 1; j < D; ++j)
        best = fminf(best, A.cost2[(j * D + i) * A.n2 + ci] + q1[j]);
      rn[i] = best;
    }
    return;
  }
  if constexpr (D <= kMaxDNary) {
    float q2[D];
    gather_q<D>(q_in, n, A.mate2[s], q2);
    if (a == 3) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float best = (A.cost3[i * A.n3 + ci] + q1[0]) + q2[0];
#pragma unroll
        for (int j = 0; j < D; ++j) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (j == 0 && k == 0) continue;
            const float cand =
                (A.cost3[((j * D + k) * D + i) * A.n3 + ci] + q1[j]) + q2[k];
            best = fminf(best, cand);
          }
        }
        rn[i] = best;
      }
      return;
    }
    float q3[D];
    gather_q<D>(q_in, n, A.mate3[s], q3);
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
            const float cand = (A.cost4[(row + i) * A.n4 + ci] + qjk) + q3[m];
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

template <int D>
__global__ void packed_maxsum_mixed_kernel(
    const float* __restrict__ q_in, float* __restrict__ q_out,
    const float* r_in, float* r_out, float* __restrict__ beliefs,
    MixedArgs A, const float* __restrict__ unary,
    const float* __restrict__ vmask, const float* __restrict__ inv_dcount,
    const int* __restrict__ col_deg, const int* __restrict__ col_slot0,
    const int* __restrict__ col_stride, int N, int Vp, float damping,
    float keep, int use_damping) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Vp) return;
  const int deg = col_deg[c];
  const size_t s0 = static_cast<size_t>(col_slot0[c]);
  const size_t stride = static_cast<size_t>(col_stride[c]);
  const size_t n = static_cast<size_t>(N);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;

  // factor side of every slot of this column (unary, binary, ternary,
  // quaternary ranks in turn), and the belief sum in slot order
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    float rn[D];
    mixed_r<D>(A, q_in, n, s, rn);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float v = rn[i] * vmask[i * n + s];
      if (use_damping) v = damping * r_in[i * n + s] + keep * v;
      r_out[i * n + s] = v;
      acc[i] += v;
    }
  }

  float bel[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    bel[i] = unary[i * static_cast<size_t>(Vp) + c] + acc[i];
    beliefs[i * static_cast<size_t>(Vp) + c] = bel[i];
  }

  // variable side, as the binary kernel's
  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    float qv[D];
    float vm[D];
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      vm[i] = vmask[i * n + s];
      qv[i] = bel[i] - r_out[i * n + s];
      total += qv[i] * vm[i];
    }
    const float mean = total * inv_dcount[s];
#pragma unroll
    for (int i = 0; i < D; ++i) q_out[i * n + s] = (qv[i] - mean) * vm[i];
  }
}

template <int D>
void launch(const float* q_in, float* q_out, const float* r_in, float* r_out,
            float* beliefs, const float* cost, const float* unary,
            const float* vmask, const float* inv_dcount, const int* mate,
            const int* col_deg, const int* col_slot0, const int* col_stride,
            int N, int Vp, float damping, float keep, int use_damping,
            cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int blocks = (Vp + kThreads - 1) / kThreads;
  packed_maxsum_cycle_kernel<D><<<blocks, kThreads, 0, stream>>>(
      q_in, q_out, r_in, r_out, beliefs, cost, unary, vmask, inv_dcount, mate,
      col_deg, col_slot0, col_stride, N, Vp, damping, keep, use_damping);
}

}  // namespace

// Launches one cycle on `stream` and returns cudaGetLastError() (0 on
// success).  D must be in [1, 8]; anything else returns
// cudaErrorInvalidValue without launching.  `keep` is (1 - damping),
// computed by the caller in double precision as the plain version does.
extern "C" int packed_maxsum_cycle(
    const float* q_in, float* q_out, const float* r_in, float* r_out,
    float* beliefs, const float* cost, const float* unary, const float* vmask,
    const float* inv_dcount, const int* mate, const int* col_deg,
    const int* col_slot0, const int* col_stride, int D, int N, int Vp,
    float damping, float keep, int use_damping, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
#define PACKED_MAXSUM_CASE(DD)                                               \
  case DD:                                                                   \
    launch<DD>(q_in, q_out, r_in, r_out, beliefs, cost, unary, vmask,         \
               inv_dcount, mate, col_deg, col_slot0, col_stride, N, Vp,       \
               damping, keep, use_damping, st);                               \
    break;
  switch (D) {
    PACKED_MAXSUM_CASE(1)
    PACKED_MAXSUM_CASE(2)
    PACKED_MAXSUM_CASE(3)
    PACKED_MAXSUM_CASE(4)
    PACKED_MAXSUM_CASE(5)
    PACKED_MAXSUM_CASE(6)
    PACKED_MAXSUM_CASE(7)
    PACKED_MAXSUM_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PACKED_MAXSUM_CASE
  return static_cast<int>(cudaGetLastError());
}

// The mixed-layout cycle: launches one cycle on `stream` and returns
// cudaGetLastError().  D must be in [1, 8] (ternary and quaternary slots
// only up to 5, which the packer guarantees); anything else returns
// cudaErrorInvalidValue without launching.  n1..n4 are the widths of the
// per-arity cost arrays.
extern "C" int packed_maxsum_mixed_cycle(
    const float* q_in, float* q_out, const float* r_in, float* r_out,
    float* beliefs, const float* cost1, const float* cost2,
    const float* cost3, const float* cost4, const int* arity,
    const int* cost_idx, const int* mate, const int* mate2, const int* mate3,
    const float* unary, const float* vmask, const float* inv_dcount,
    const int* col_deg, const int* col_slot0, const int* col_stride, int D,
    int N, int Vp, int n1, int n2, int n3, int n4, float damping, float keep,
    int use_damping, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  if (D > kMaxDNary && (n3 > 0 || n4 > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  MixedArgs A;
  A.cost1 = cost1;
  A.cost2 = cost2;
  A.cost3 = cost3;
  A.cost4 = cost4;
  A.arity = arity;
  A.cost_idx = cost_idx;
  A.mate = mate;
  A.mate2 = mate2;
  A.mate3 = mate3;
  A.n1 = static_cast<size_t>(n1);
  A.n2 = static_cast<size_t>(n2);
  A.n3 = static_cast<size_t>(n3);
  A.n4 = static_cast<size_t>(n4);
  constexpr int kThreads = 128;
  const int blocks = (Vp + kThreads - 1) / kThreads;
#define PACKED_MAXSUM_MIXED_CASE(DD)                                         \
  case DD:                                                                   \
    packed_maxsum_mixed_kernel<DD><<<blocks, kThreads, 0, st>>>(              \
        q_in, q_out, r_in, r_out, beliefs, A, unary, vmask, inv_dcount,       \
        col_deg, col_slot0, col_stride, N, Vp, damping, keep, use_damping);   \
    break;
  switch (D) {
    PACKED_MAXSUM_MIXED_CASE(1)
    PACKED_MAXSUM_MIXED_CASE(2)
    PACKED_MAXSUM_MIXED_CASE(3)
    PACKED_MAXSUM_MIXED_CASE(4)
    PACKED_MAXSUM_MIXED_CASE(5)
    PACKED_MAXSUM_MIXED_CASE(6)
    PACKED_MAXSUM_MIXED_CASE(7)
    PACKED_MAXSUM_MIXED_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PACKED_MAXSUM_MIXED_CASE
  return static_cast<int>(cudaGetLastError());
}
