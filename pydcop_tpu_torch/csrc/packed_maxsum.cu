// One synchronous MaxSum cycle on the packed all-binary layout, for Hopper
// (sm_90a).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_maxsum.py::packed_cycles.
//
// Replaces: pydcop_tpu/ops/pallas_maxsum.py::packed_cycles (its all-binary
// branch, _cycle_body without _mixed_r_new), the Pallas TPU kernel that
// runs n fused cycles with the mate exchange routed through a Clos plan.
//
// Math (identical to the Pallas kernel and to the generic engine):
//   r'[i,s] = vmask[i,s] * min_j(cost[j*D+i, s] + q[j, mate[s]])
//   r'      = damping * r + (1 - damping) * r'          (when damping != 0)
//   b[i,c]  = unary[i,c] + sum_{k < deg(c)} r'[i, slot(c, k)]
//   q'[i,s] = (b[i,col(s)] - r'[i,s] - mean_valid_i(...)) * vmask[i,s]
//
// Layout (var-grouped slots, built by pack_for_gpu): the columns are the
// variables sorted by degree; the columns of one degree class share a
// block of slots, and column c's k-th slot is
// col_slot0[c] + k * col_stride[c].  One thread owns one column: at each
// rank k the threads of a warp touch neighbouring slots (coalesced), and a
// thread stops at its column's true degree, so a hub of any degree is one
// longer loop (no hub splitting, no padding to a degree class).
//
// One launch per cycle: the only read across columns is q_in[:, mate[s]]
// of the PREVIOUS cycle.  Everything after it — r' of the column's slots,
// its belief and q' of its slots — is owned by the column's thread.  So q
// is double-buffered across launches (q_in and q_out never alias), while r
// may be updated in place (r_in == r_out): each r element is read and then
// written by its owner thread only.
//
// Bound: memory.  Per slot per cycle the kernel moves D*D cost floats, D
// gathered q floats, 2*D r floats, D q floats, D vmask floats, the mate
// index and inv_dcount: ~104 B at D=3, ~6.2 MB a cycle at 60k slots (the
// 10k-variable / 30k-constraint coloring) — about 2 us at 3.35 TB/s, well
// under one launch, so at that size the launch sets the pace.  The design
// answers the bound only by reading each operand once and coalescing all
// but the mate gather; shared-memory staging and TMA are not used.
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
