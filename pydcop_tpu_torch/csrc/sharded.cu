// Per-shard kernels of the sharded engines, all-binary branch, for Hopper
// (sm_90a).  Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_sharded.py.  Each launch computes ONE
// shard's part of a cycle on that shard's layout and device; the caller
// adds (or maxes, mins) the shards' partials in shard order afterwards.
//
// Replaces the Pallas TPU kernels of pydcop_tpu/ops/pallas_sharded.py,
// their binary branches (no mixed= operands, no amaxsum activation):
//   shard_fused_ba    <- packed_shard_fused_ba     (K7)
//   shard_route_gains <- packed_shard_route_gains  (K8, no consts2/consts3)
//   shard_tables      <- packed_shard_tables       (K9)
//
// Layout (parallel/packed_mesh.py::ShardLayout): one common column per
// variable; the shard's threads walk the columns sorted by the shard's
// degree, thread t owning column tcol[t], whose k-th slot is
// t_slot0[t] + k * t_stride[t] (the var-grouped slots of
// ops/packed_maxsum.py, built per shard, so the threads of a degree class
// read neighbouring slots).  mate[s] is the slot of the factor's other
// end, mate_col[s] its column.  Arrays of D rows are row-major [D, N] or
// [D, Vp]; cost rows are other-value-major: row j*D+i = cost(other end at
// j, this end at i).  A column the shard does not touch has degree 0 and
// gets partial 0 (fill 0 of the per-column reduction).
//
// K7, one thread per column, no dependency between threads inside a
// launch: for each of its slots s the thread recomputes the pending
// variable side of the PREVIOUS cycle at the mate slot m (it needs only
// the launch's inputs bel_g[:, col(m)] and r_u[:, m]), in the Pallas
// order:
//   e[j]   = bel_g[j, col(m)] - r_u[j, m]                   (expand, subtract)
//   mean   = (sum_{j from 0} e[j] * vmask[j, m]) * inv_dcount[m]
//   q[j]   = (e[j] - mean) * vmask[j, m]
// then this cycle's factor side at s:
//   r'[i]  = min_{j from 0}(cost[j*D+i, s] + q[j]) * vmask[i, s]
//   r'[i]  = damping * r_u[i, s] + (1 - damping) * r'[i]   (damping != 0)
//   partial[i, col] = sum over the column's slots in rank order, from 0
// On a zero state (bel_g = 0, r_u = 0) the pending side gives q = 0, so
// the first launch needs no flag.  r_out never aliases r_u: another
// thread reads r_u at this thread's slots as its mates.
//
// K8: gn[s] = gain[col(mate(s))] * gmask1[s]; nm_part[col] = max over the
// column's slots of gn, from 0.
// K9: partial[i, col] = sum over the column's slots in rank order, from 0,
// of cost[x[col(mate(s))] * D + i, s].
//
// Built with -fmad=false, so each multiply and add rounds as in the plain
// PyTorch versions (ops/packed_sharded.py *_plain).
//
// Bound: memory.  K7 reads per slot D*D cost floats, 3*D r_u / vmask /
// bel_g floats at the mate and 2*D at the slot, writes D r' floats, and
// reads/writes D floats per column: ~130 B a slot at D=3.  K8 and K9 read
// a few words a slot (K9 the D selected cost floats).  The design answers
// the bound only by reading each operand about once, coalesced within a
// degree class except the mate gathers; shared memory and TMA are not
// used.  Launches are host-issued, S per cycle (one per shard).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Walk {
  const int* tcol;
  const int* t_deg;
  const int* t_slot0;
  const int* t_stride;
};

template <int D>
__global__ void shard_fused_ba_kernel(
    const float* __restrict__ bel_g, const float* __restrict__ r_u,
    float* __restrict__ r_out, float* __restrict__ partial,
    const float* __restrict__ cost, const float* __restrict__ vmask,
    const float* __restrict__ inv_dcount, const int* __restrict__ mate,
    const int* __restrict__ mate_col, Walk W, int N, int Vp, float damping,
    float keep, int use_damping) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Vp) return;
  const int c = W.tcol[t];
  const int deg = W.t_deg[t];
  const size_t s0 = static_cast<size_t>(W.t_slot0[t]);
  const size_t stride = static_cast<size_t>(W.t_stride[t]);
  const size_t n = static_cast<size_t>(N);
  const size_t vp = static_cast<size_t>(Vp);

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;

  for (int k = 0; k < deg; ++k) {
    const size_t s = s0 + static_cast<size_t>(k) * stride;
    const size_t m = static_cast<size_t>(mate[s]);
    const size_t cm = static_cast<size_t>(mate_col[s]);
    // the previous cycle's variable side at the mate slot
    float e[D];
    float vm[D];
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      vm[j] = vmask[j * n + m];
      e[j] = bel_g[j * vp + cm] - r_u[j * n + m];
      total += e[j] * vm[j];
    }
    const float mean = total * inv_dcount[m];
    float q[D];
#pragma unroll
    for (int j = 0; j < D; ++j) q[j] = (e[j] - mean) * vm[j];
    // this cycle's factor side at s
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float best = cost[i * n + s] + q[0];
#pragma unroll
      for (int j = 1; j < D; ++j)
        best = fminf(best, cost[(j * D + i) * n + s] + q[j]);
      float rn = best * vmask[i * n + s];
      if (use_damping) rn = damping * r_u[i * n + s] + keep * rn;
      r_out[i * n + s] = rn;
      acc[i] += rn;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) partial[i * vp + c] = acc[i];
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

}  // namespace

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  D must be in [1, 8]; anything else
// returns cudaErrorInvalidValue without launching.

// K7.  `keep` is (1 - damping), computed by the caller in double precision
// as the plain version does.
extern "C" int shard_fused_ba(const float* bel_g, const float* r_u,
                              float* r_out, float* partial, const float* cost,
                              const float* vmask, const float* inv_dcount,
                              const int* mate, const int* mate_col,
                              const int* tcol, const int* t_deg,
                              const int* t_slot0, const int* t_stride, int D,
                              int N, int Vp, float damping, float keep,
                              int use_damping, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  const Walk W = make_walk(tcol, t_deg, t_slot0, t_stride);
#define SHARD_FUSED_BA_CASE(DD)                                              \
  case DD:                                                                   \
    shard_fused_ba_kernel<DD><<<blocks_for(Vp), kThreads, 0, st>>>(           \
        bel_g, r_u, r_out, partial, cost, vmask, inv_dcount, mate, mate_col,  \
        W, N, Vp, damping, keep, use_damping);                                \
    break;
  switch (D) {
    SHARD_FUSED_BA_CASE(1)
    SHARD_FUSED_BA_CASE(2)
    SHARD_FUSED_BA_CASE(3)
    SHARD_FUSED_BA_CASE(4)
    SHARD_FUSED_BA_CASE(5)
    SHARD_FUSED_BA_CASE(6)
    SHARD_FUSED_BA_CASE(7)
    SHARD_FUSED_BA_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_FUSED_BA_CASE
  return static_cast<int>(cudaGetLastError());
}

// K8 (no value rows, so no D).
extern "C" int shard_route_gains(const float* gain, const float* gmask1,
                                 float* nm_part, float* gn,
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

// K9.
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
    SHARD_TABLES_CASE(1)
    SHARD_TABLES_CASE(2)
    SHARD_TABLES_CASE(3)
    SHARD_TABLES_CASE(4)
    SHARD_TABLES_CASE(5)
    SHARD_TABLES_CASE(6)
    SHARD_TABLES_CASE(7)
    SHARD_TABLES_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SHARD_TABLES_CASE
  return static_cast<int>(cudaGetLastError());
}
