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
// Design: ONE cooperative launch a sweep (cudaLaunchCooperativeKernel:
// every block resident, or the launch is refused) that walks the levels
// itself: UTIL from level L-1 down to 0, then VALUE from 0 to L-1, with a
// grid barrier (grid_sync.cuh word_barrier) between consecutive levels,
// 2L - 1 a sweep (a block barrier on a grid of one block).  A level is a
// grid-stride loop over node tiles; a tile is nodes_per_block nodes, one
// thread a (node, value).  UTIL: each thread sums its value's children
// messages (kChildBatch loads in flight at a time, added in ascending
// id; writes cs), and after a block barrier each reduces one parent
// value's column of the table against the node's cs in shared memory;
// every thread of a block runs the same trip count, so the block
// barriers stay legal; up to D = 16 the tile's tables are copied to
// shared memory (cp.async) while the children are summed.  VALUE: one
// thread a node (grid-stride), its parent's value, then a scan of its D
// own values.  A child's msg, and a parent's assign, were written by
// another block before the barrier: they are read through L2 (__ldcg).
// level_start lives in device memory for the kernel; the C entry checks
// its host copy.
//
// Bound: the sweep must read the table (n_nodes*D*D floats: 4.0 MB at 10k
// nodes and D=10, 1.2 us at 3.35 TB/s) and the tree, and write assign (msg
// and cs are this design's intermediates, not outputs); its operations
// (~2*n_nodes*D^2) are nothing to the card.  But L levels are L dependent
// steps each way, so the sweep is bound by latency.  The design this
// replaced made 2L launches of small grids, ~3 us of device time each on
// an H100 and twice that on the host's clock; here a step costs a grid
// barrier, and the wrapper keeps the grid to a few blocks so that a
// barrier is short.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

template <bool kMax>
__device__ __forceinline__ float red(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}

// nodes a UTIL tile takes: one thread a (node, value), 256 threads at most
__host__ __device__ inline int nodes_per_block(int D) {
  return D >= 256 ? 1 : 256 / D;
}

// children whose message loads a UTIL thread keeps in flight at a time
constexpr int kChildBatch = 8;
// up to this D a UTIL tile's tables (nodes_per_block * D * D floats, 16
// KB at most) are copied to shared memory while its children are summed
constexpr int kStageMaxD = 16;

// The blocks meet between two levels: a grid barrier, or on a grid of one
// block a block barrier (the block's global stores are visible to it
// after __syncthreads).
__device__ __forceinline__ void level_barrier(unsigned* bar) {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    word_barrier(bar);
  }
}

template <bool kMax>
__global__ void dpop_sweep_coop_kernel(
    const float* __restrict__ table, const int* __restrict__ child_ptr,
    const int* __restrict__ child_idx, const int* __restrict__ parent,
    const int* __restrict__ level_start, int L, int D, float* msg,
    float* cs, int* assign, unsigned* bar) {
  // cs of the tile's nodes [npb * D], then their tables [npb * D * D]
  // when D <= kStageMaxD
  extern __shared__ float cs_sh[];
  const int npb = nodes_per_block(D);
  float* tab_sh = cs_sh + npb * D;
  const bool staged = D <= kStageMaxD;
  const int slot = threadIdx.x / D;
  const int v = threadIdx.x - slot * D;
  const size_t dd = static_cast<size_t>(D);

  // UTIL, deepest level first
  for (int l = L - 1; l >= 0; --l) {
    const int lo = __ldg(level_start + l);
    const int B = __ldg(level_start + l + 1) - lo;
    const int tiles = (B + npb - 1) / npb;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (staged) {
        // the tile's tables are contiguous: copy them asynchronously,
        // their loads in flight with the children's below
        const int first = tile * npb;
        const int count = min(npb, B - first) * D * D;
        const float* src =
            table + (static_cast<size_t>(lo) + first) * dd * dd;
        for (int x = threadIdx.x; x < count; x += blockDim.x)
          __pipeline_memcpy_async(tab_sh + x, src + x, sizeof(float));
        __pipeline_commit();
      }
      const int b = tile * npb + slot;
      const bool active = slot < npb && b < B;
      const size_t n = static_cast<size_t>(lo) + static_cast<size_t>(b);
      if (active) {
        // the children's messages in ascending id, kChildBatch loads in
        // flight at a time, added in order from 0
        float s = 0.0f;
        const int k1 = __ldg(child_ptr + n + 1);
        for (int k0 = __ldg(child_ptr + n); k0 < k1; k0 += kChildBatch) {
          int c[kChildBatch];
          float m[kChildBatch];
#pragma unroll
          for (int b = 0; b < kChildBatch; ++b)
            c[b] = k0 + b < k1 ? __ldg(child_idx + k0 + b) : 0;
#pragma unroll
          for (int b = 0; b < kChildBatch; ++b)
            m[b] = k0 + b < k1
                       ? __ldcg(msg + static_cast<size_t>(c[b]) * dd + v)
                       : 0.0f;
#pragma unroll
          for (int b = 0; b < kChildBatch; ++b)
            if (k0 + b < k1) s += m[b];
        }
        cs[n * dd + v] = s;
        cs_sh[threadIdx.x] = s;
      }
      if (staged) __pipeline_wait_prior(0);
      __syncthreads();
      if (active) {
        // this thread's parent value j = v: reduce column j over own
        // values i
        const float* t =
            staged ? tab_sh + slot * D * D : table + n * dd * dd;
        const float* c = cs_sh + slot * D;
        float m = t[v] + c[0];
        for (int i = 1; i < D; ++i) {
          const float x = t[static_cast<size_t>(i) * dd + v] + c[i];
          m = red<kMax>(m, x);
        }
        msg[n * dd + v] = m;
      }
      __syncthreads();  // cs_sh is the next tile's
    }
    level_barrier(bar);
  }

  // VALUE, roots first
  const size_t tid =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (int l = 0; l < L; ++l) {
    const size_t lo = static_cast<size_t>(__ldg(level_start + l));
    const size_t hi = static_cast<size_t>(__ldg(level_start + l + 1));
    for (size_t n = lo + tid; n < hi; n += nthreads) {
      const int p = __ldg(parent + n);
      const int j = p < 0 ? 0 : __ldcg(assign + p);
      const float* t = table + n * dd * dd + j;
      const float* c = cs + n * dd;
      float best = __ldg(t) + __ldcg(c);
      int arg = 0;
      for (int i = 1; i < D; ++i) {
        const float x =
            __ldg(t + static_cast<size_t>(i) * dd) + __ldcg(c + i);
        if (kMax ? x > best : x < best) {  // strict: the first index wins
          best = x;
          arg = i;
        }
      }
      assign[n] = arg;
    }
    if (l + 1 < L) level_barrier(bar);
  }
}

const void* sweep_kernel(int max_mode) {
  if (max_mode)
    return reinterpret_cast<const void*>(dpop_sweep_coop_kernel<true>);
  return reinterpret_cast<const void*>(dpop_sweep_coop_kernel<false>);
}

int sweep_threads(int D) { return nodes_per_block(D) * D; }

size_t sweep_shared(int D) {
  const size_t tables = D <= kStageMaxD ? sweep_threads(D) * D : 0;
  return sizeof(float) * (sweep_threads(D) + tables);
}

}  // namespace

// The resident-block capacity of the sweep kernel at domain size D on the
// current device (0 when D is outside [1, 1024] or the device cannot be
// asked), and its threads a block (nodes_per_block(D) * D, one a (node,
// value) of a UTIL tile) in *threads: the wrapper launches at most that
// many blocks.
extern "C" int dpop_sweep_capacity(int D, int max_mode, int* threads) {
  if (D < 1 || D > 1024) return 0;
  if (threads) *threads = sweep_threads(D);
  return coop_capacity(sweep_kernel(max_mode), sweep_threads(D),
                       sweep_shared(D));
}

// Runs one whole sweep on `stream` as one cooperative launch of `blocks`
// blocks (at most dpop_sweep_capacity(D, max_mode)): UTIL from the deepest
// level up, then VALUE from the roots down.  `level_host` is level_start
// ([L+1], level l = node ids [level_start[l], level_start[l+1])) in HOST
// memory, `level_dev` the same in device memory; every other pointer is
// device memory.  `bar` is one unsigned int, zero before the launch and
// shared with no other launch.  Returns the launch's error (0 on
// success).  D must be in [1, 1024], every level non-empty and blocks at
// least 1, else cudaErrorInvalidValue without launching.
extern "C" int dpop_whole_sweep(const float* table, const int* child_ptr,
                                const int* child_idx, const int* parent,
                                const int* level_dev, const int* level_host,
                                int L, int D, int max_mode, float* msg,
                                float* cs, int* assign, int blocks,
                                unsigned* bar, void* stream) {
  if (D < 1 || D > 1024 || L < 1 || blocks < 1 || bar == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < L; ++l) {
    if (level_host[l + 1] <= level_host[l]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  void* args[] = {&table, &child_ptr, &child_idx, &parent, &level_dev,
                  &L,     &D,         &msg,       &cs,     &assign,
                  &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      const_cast<void*>(sweep_kernel(max_mode)),
      dim3(static_cast<unsigned>(blocks)),
      dim3(static_cast<unsigned>(sweep_threads(D))), args, sweep_shared(D),
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
