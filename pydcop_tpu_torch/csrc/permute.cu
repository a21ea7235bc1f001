// Lane permutation for Hopper (sm_90a): out[s, t] = x[s, perm[t]] for a
// row-major float32 x [S, N] and a permutation perm of [0, N).  Built by
// pydcop_tpu_torch/ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, bound with ctypes by pydcop_tpu_torch/ops/permute.py.
//
// Replaces the Pallas TPU kernel of pydcop_tpu/ops/pallas_permute.py
// (lane_permute, K3), which routes the permutation through a 7-stage Clos
// plan of within-vreg gathers, tile transposes and per-lane selects
// because a TPU has no fast scattered load.  A GPU has one: each thread
// reads its source element directly, so the port takes the permutation
// itself and no plan.
//
// One thread per output element, t fastest: the stores and the reads of
// perm are coalesced, the reads of x are a gather through perm.  Bound:
// memory — read x and perm once, write out once (4*(2*S*N + N) bytes);
// the gather's scattered reads are the cost above that bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void lane_permute_kernel(const float* __restrict__ x,
                                    const int* __restrict__ perm,
                                    float* __restrict__ out, int64_t S,
                                    int64_t N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= S * N) return;
  const int64_t s = i / N;
  const int64_t t = i - s * N;
  out[i] = x[s * N + perm[t]];
}

}  // namespace

// Launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int lane_permute(const float* x, const int* perm, float* out,
                            long long S, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = S * N;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (total + kThreads - 1) / kThreads;
  lane_permute_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        st>>>(x, perm, out, S, N);
  return static_cast<int>(cudaGetLastError());
}
