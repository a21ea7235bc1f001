// A whole width-1 DPOP sweep (UTIL up the tree, VALUE down it) for Hopper
// (sm_90a).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_dpop.py::whole_sweep.
//
// Replaces: pydcop_tpu/ops/pallas_dpop.py::_launch_sweep (body
// _sweep_body, _childsum, _expand, _up_block), the Pallas TPU kernel that
// runs the whole sweep of a width-1 pseudo-tree in one launch, with the
// forest lane-packed, parent/child routing through a Clos permutation and
// the tables held twice in VMEM.
//
// Math (identical to the Pallas kernel and to the level-scan engine on a
// plan whose every separator is the parent), with red = min (max for max
// objectives) and local[n][i][j] = cost of own value i under parent value j:
//   UTIL, deepest level first:
//     cs[n][i]  = 0 + msg[c1][i] + msg[c2][i] + ...   children by ascending id
//     msg[n][j] = red_i (local[n][i][j] + cs[n][i])
//   VALUE, roots first:
//     assign[n] = first arg-red_i (local[n][i][assign[parent(n)]] + cs[n][i])
// A root reads parent value 0: its table is constant along the parent axis.
//
// Layout (built by pack_sweep): nodes in level order, so level l is the id
// range [level_start[l], level_start[l+1]); children as CSR (child_ptr,
// child_idx) in ascending id; one [n_nodes, D, D] table, own value major.
//
// Design: one launch per level and phase, 2L launches per sweep, all issued
// by one host call on the caller's stream; msg and cs stay in device memory
// between launches.  UTIL runs one thread per (node, value): the D threads
// of a node share a block, each sums its value's children messages (writes
// cs), and after a barrier each reduces one parent value's column of the
// table against the node's cs in shared memory.  VALUE runs one thread per
// node: it reads its parent's value and scans its D own values.
//
// Bound: the sweep must read the table (n_nodes*D*D floats: 4.0 MB at 10k
// nodes and D=10, 1.2 us at 3.35 TB/s) and the tree, and write assign (msg
// and cs are this design's intermediates, not outputs); its operations
// (~2*n_nodes*D^2) are nothing to the card.  But L levels are L dependent
// steps each way, so the sweep is bound by latency: 2L launches
// of small grids, one after the other.  Nothing here hides that; a single
// cooperative launch with a grid-wide barrier per level, or a CUDA graph of
// the 2L launches, would be the next step.
#include <cuda_runtime.h>

namespace {

template <bool kMax>
__device__ __forceinline__ float red(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}

template <bool kMax>
__global__ void dpop_util_level_kernel(
    const float* __restrict__ table, const int* __restrict__ child_ptr,
    const int* __restrict__ child_idx, int lo, int B, int D,
    int nodes_per_block, float* msg, float* __restrict__ cs) {
  extern __shared__ float cs_sh[];  // nodes_per_block * D
  const int slot = threadIdx.x / D;
  const int v = threadIdx.x - slot * D;
  const int b = blockIdx.x * nodes_per_block + slot;
  const bool active = slot < nodes_per_block && b < B;
  const size_t n = static_cast<size_t>(lo) + static_cast<size_t>(b);
  if (active) {
    float s = 0.0f;
    for (int k = child_ptr[n]; k < child_ptr[n + 1]; ++k) {
      s += msg[static_cast<size_t>(child_idx[k]) * D + v];
    }
    cs[n * D + v] = s;
    cs_sh[threadIdx.x] = s;
  }
  __syncthreads();
  if (!active) return;
  // this thread's parent value j = v: reduce column j over own values i
  const float* t = table + n * D * D;
  const float* c = cs_sh + slot * D;
  float m = t[v] + c[0];
  for (int i = 1; i < D; ++i) {
    m = red<kMax>(m, t[static_cast<size_t>(i) * D + v] + c[i]);
  }
  msg[n * D + v] = m;
}

template <bool kMax>
__global__ void dpop_value_level_kernel(
    const float* __restrict__ table, const float* __restrict__ cs,
    const int* __restrict__ parent, int lo, int B, int D, int* assign) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t n = static_cast<size_t>(lo) + static_cast<size_t>(b);
  const int p = parent[n];
  const int j = p < 0 ? 0 : assign[p];
  const float* t = table + n * D * D + j;
  const float* c = cs + n * D;
  float best = t[0] + c[0];
  int arg = 0;
  for (int i = 1; i < D; ++i) {
    const float x = t[static_cast<size_t>(i) * D] + c[i];
    if (kMax ? x > best : x < best) {  // strict: the first index wins ties
      best = x;
      arg = i;
    }
  }
  assign[n] = arg;
}

template <bool kMax>
int sweep(const float* table, const int* child_ptr, const int* child_idx,
          const int* parent, const int* level_start, int L, int D,
          float* msg, float* cs, int* assign, int* launched,
          cudaStream_t stream) {
  const int nodes_per_block = D >= 256 ? 1 : 256 / D;
  const int util_threads = nodes_per_block * D;
  const size_t shared = sizeof(float) * util_threads;
  for (int l = L - 1; l >= 0; --l) {
    const int lo = level_start[l];
    const int B = level_start[l + 1] - lo;
    const int blocks = (B + nodes_per_block - 1) / nodes_per_block;
    dpop_util_level_kernel<kMax><<<blocks, util_threads, shared, stream>>>(
        table, child_ptr, child_idx, lo, B, D, nodes_per_block, msg, cs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++launched[0];
  }
  constexpr int kValueThreads = 256;
  for (int l = 0; l < L; ++l) {
    const int lo = level_start[l];
    const int B = level_start[l + 1] - lo;
    const int blocks = (B + kValueThreads - 1) / kValueThreads;
    dpop_value_level_kernel<kMax><<<blocks, kValueThreads, 0, stream>>>(
        table, cs, parent, lo, B, D, assign);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++launched[1];
  }
  return 0;
}

}  // namespace

// Runs one whole sweep on `stream`: L UTIL launches (deepest level first),
// then L VALUE launches (roots first).  `level_start` ([L+1], level l =
// node ids [level_start[l], level_start[l+1])) and `launched` ([2]) live in
// HOST memory; every other pointer is device memory.  Adds one to
// launched[0] for each UTIL launch and to launched[1] for each VALUE
// launch that went out.  Returns 0, or the first launch error
// (cudaGetLastError after each launch), without launching the rest.  D
// must be in [1, 1024] and every level non-empty, else
// cudaErrorInvalidValue without launching.
extern "C" int dpop_whole_sweep(const float* table, const int* child_ptr,
                                const int* child_idx, const int* parent,
                                const int* level_start, int L, int D,
                                int max_mode, float* msg, float* cs,
                                int* assign, int* launched, void* stream) {
  if (D < 1 || D > 1024 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < L; ++l) {
    if (level_start[l + 1] <= level_start[l]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return max_mode
             ? sweep<true>(table, child_ptr, child_idx, parent, level_start,
                           L, D, msg, cs, assign, launched, st)
             : sweep<false>(table, child_ptr, child_idx, parent, level_start,
                            L, D, msg, cs, assign, launched, st);
}
