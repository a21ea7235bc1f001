// Synchronous MaxSum cycles on the packed layouts, for Hopper (sm_90a):
// the all-binary layout (packed_maxsum_coop: every cycle of a call in one
// cooperative launch) and the mixed-arity layout of unary, binary,
// ternary and quaternary factors (packed_maxsum_mixed_cycle: one
// cooperative launch a cycle).  Built by pydcop_tpu_torch/ops/cuda_build.py
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
// unary, binary, ternary, quaternary.  The mixed layout keeps one cost
// array per arity, [D^a, n_a] over that arity's slots only, and the slot
// of each of its columns (slots_a, ascending: cost column t belongs to
// slot slots_a[t]).
//
// The binary kernel runs all n cycles of a call in ONE cooperative launch
// (cudaLaunchCooperativeKernel: every block resident, or the launch is
// refused), one grid barrier between consecutive cycles (grid_sync.cuh
// word_barrier) and none after the last.  The work is cut into tiles: a
// tile is a run of up to T neighbouring columns of one degree class (a
// row of the wrapper's tile table: first column, width, degree, slot of
// the first column's rank 0, the class's slot stride), so the slots of
// the tile's columns at one rank are contiguous.  Blocks take tiles
// grid-stride; for each tile
//   phase 1: the block's threads take the tile's deg x width (rank,
//     column) units, lanes on neighbouring columns (coalesced cost, vmask
//     and r rows): a unit gathers q at its slot's mate and writes r' of
//     its slot, kUnits units' loads in flight at a time;
//   __syncthreads;
//   phase 2a: one thread a column sums r' of its slots in rank order from
//     0 (kDirectBatch loads in flight; a tile of higher degree, a hub's,
//     first staged in shared memory by the whole block, kStage floats at
//     a time), adds the unary cost, and keeps the belief in shared memory
//     (written out at the last cycle only);
//   __syncthreads;
//   phase 2b: the units again: q' of every slot from its column's belief.
// A hub (the degree-2,500 star's centre) is a tile of one column, whose
// slots phases 1 and 2b, and the loads of 2a, spread over the whole
// block; only its rank-order belief sum, from shared memory, stays on one
// thread.  The only reads across blocks are q at the mates, written in
// the previous cycle by any block: they come after the grid barrier,
// through L2 (__ldcg).  q is double-buffered by cycle parity (q_a at even
// cycles, q_b at odd ones, the caller's q read at cycle 0 only); the
// caller's q and the last cycle's are value-major
// [D, N], as the layout's, and the q of the cycles between them
// slot-major [N, D], so that a unit's gather of its mate's D values is
// one sector and not D.  r goes from the caller's r_in to r_out at cycle
// 0 and is updated in place after that, each element read and then
// written by the one unit that owns it.  The arithmetic and its order
// are those of the one-thread-a-column kernel this replaced (and of the
// plain version): fminf from j = 0, the mask before damping, the belief
// sum from 0 in rank order, so the results stay equal bit for bit.
//
// The mixed cycle is ONE cooperative launch (cudaLaunchCooperativeKernel:
// every block resident, or the launch is refused) of two phases with a
// grid barrier between them (grid_sync.cuh).  Phase 1 spreads the slots'
// r' over the grid, in arity order: one work unit a unary or binary slot
// (all D values; a binary slot gathers its sibling's q once), D units a
// ternary or quaternary slot, one a value i, each gathering the
// siblings' q and searching the D^(a-1) candidates of its value.  Unit u
// of arity a takes cost column t = u mod n_a and value i = u div n_a, so
// the lanes of a warp read neighbouring columns of one cost row
// (coalesced); a value's cost entries are loaded D^2 at a time before
// its minimum runs over them, so their loads are in flight together.  A
// unit reads r_in[i,s] and writes r_out[i,s] for its own values only, so
// r may still be updated in place.  Phase 2 is one thread per column
// (grid-stride): the belief sum of its slots' r' in rank order from 0,
// then q' of each slot, kBatch slots' loads in flight at a time; r'
// written by other blocks is read through L2 (__ldcg).  fminf is exact in
// any order for non-NaN values, and each sum keeps its order, so the
// split changes no result.  The barrier words
// belong to the caller (the wrapper allocates them zeroed for each
// call).
//
// Bound: memory.  Binary: per slot per cycle D*D cost floats, D gathered
// q floats, 2*D r floats, D q floats, D vmask floats, the mate index and
// inv_dcount: ~104 B at D=3, ~6.2 MB a cycle at 60k slots (the
// 10k-variable / 30k-constraint coloring) — about 2 us at 3.35 TB/s.
// What held the binary kernel this replaced back was latency: one launch
// a cycle of one thread a column, 79 blocks of 4 warps at 10k/30k, each
// thread walking its ~6 slots' chains of dependent loads (layout, mate,
// q) twice.  The tiles put a thread on each (rank, column) unit, the
// cooperative launch takes the per-cycle launches away, and the wrapper
// caps the grid so that the barrier spans few blocks (a barrier over
// hundreds of blocks cost K5 more than the launch it saved).
// Mixed: the bound counts a factor's table once (chip_smoke.py
// packed_bytes), but the layout stores a rotated copy per slot, and the
// mixed kernel reads each slot's copy once: D^a floats an arity-a slot
// (the SECP instances: D=5, so a ternary slot 500 B, a quaternary slot
// 2.5 kB; at SECP-39k 45 MB of quaternary rows, 13.4 us at 3.35 TB/s
// against a 7.5 us bound), and (a-1)*D gathered q floats a unit.  What
// held the one-thread-a-column mixed kernel back was latency: 31 blocks
// at SECP-3.9k, each thread walking its column's slots and searching
// every value's D^(a-1) candidates serially (55x its bound; 24x at
// SECP-39k).  Phase 1 puts a thread on each (slot, value) of the
// ternary and quaternary slots instead.  Measured on the H100 (PERF.md,
// K1-mixed): the batched loads of both phases took SECP-39k from 74 to 44
// us a cycle, though their registers (96 at D=5) halve the resident
// blocks; a cap of 64 registers (spills) or unbatched phase-2 loads
// gave more blocks and 50-51 us.  Shared-memory staging and TMA are not
// used: each cost entry is read once, so there is nothing to reuse; the
// sibling gathers are not coalesced.
#include <cuda_runtime.h>

#include "grid_sync.cuh"

namespace {

// the binary kernel's most threads a block (the wrapper picks its threads
// and its tile width, at most the threads: a tile's column is one
// thread's in phase 2a)
constexpr int kMaxThreads = 512;
// floats of a block's r' staging buffer in shared memory: a rank of the
// widest tile at D = 8 (512 * 8), or more ranks of a narrower one
constexpr int kStage = kMaxThreads * 8;
// a tile table row: first column, width, degree, slot of the first
// column's rank 0, slot stride between ranks
constexpr int kTileFields = 5;

// phase 1 of the binary kernel: r' of the tile's units u = k * width + w
// (rank k, column w of the tile), kUnits units' loads in flight at a time;
// q_in is value-major [D, N] (q_slot_major false) or slot-major [N, D]
template <int D>
__device__ __forceinline__ void binary_r_phase(
    const float* q_in, bool q_slot_major, const float* r_in, float* r,
    const float* __restrict__ cost, const float* __restrict__ vmask,
    const int* __restrict__ mate, size_t n, int width, int units,
    size_t slot0, size_t stride, float damping, float keep,
    int use_damping) {
  constexpr int kUnits = D <= 4 ? 4 : 2;
  const int step = static_cast<int>(blockDim.x);
  for (int u0 = threadIdx.x; u0 < units; u0 += kUnits * step) {
    size_t s[kUnits];
    int m[kUnits];
#pragma unroll
    for (int b = 0; b < kUnits; ++b) {
      const int u = u0 + b * step;
      if (u >= units) break;
      const int k = u / width;
      s[b] = slot0 + static_cast<size_t>(k) * stride +
             static_cast<size_t>(u - k * width);
      m[b] = __ldg(mate + s[b]);
    }
    float qm[kUnits][D];
#pragma unroll
    for (int b = 0; b < kUnits; ++b) {
      if (u0 + b * step >= units) break;
#pragma unroll
      for (int j = 0; j < D; ++j)
        qm[b][j] = __ldcg(q_in + (q_slot_major
                                      ? static_cast<size_t>(m[b]) * D + j
                                      : j * n + static_cast<size_t>(m[b])));
    }
#pragma unroll
    for (int b = 0; b < kUnits; ++b) {
      if (u0 + b * step >= units) break;
      // cost rows are other-value-major: row j*D+i = cost(other=j, tgt=i);
      // the minimum over j runs from j = 0 for every target value i
      float best[D];
#pragma unroll
      for (int i = 0; i < D; ++i)
        best[i] = __ldg(cost + i * n + s[b]) + qm[b][0];
#pragma unroll
      for (int j = 1; j < D; ++j) {
#pragma unroll
        for (int i = 0; i < D; ++i)
          best[i] = fminf(best[i],
                          __ldg(cost + (j * D + i) * n + s[b]) + qm[b][j]);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const size_t at = i * n + s[b];
        float rn = best[i] * __ldg(vmask + at);
        if (use_damping) rn = damping * __ldcg(r_in + at) + keep * rn;
        r[at] = rn;
      }
    }
  }
}

// phase 2b of the binary kernel: q' of the tile's units from the beliefs
// of its columns (bel: [D][tile_cols] in shared memory), into q_out
// value-major [D, N] (q_slot_major false) or slot-major [N, D]
template <int D>
__device__ __forceinline__ void binary_q_phase(
    const float* r, float* q_out, bool q_slot_major, const float* bel,
    int tile_cols,
    const float* __restrict__ vmask, const float* __restrict__ inv_dcount,
    size_t n, int width, int units, size_t slot0, size_t stride) {
  constexpr int kUnits = D <= 4 ? 4 : 2;
  const int step = static_cast<int>(blockDim.x);
  for (int u0 = threadIdx.x; u0 < units; u0 += kUnits * step) {
    size_t s[kUnits];
    int w[kUnits];
    float rv[kUnits][D];
    float vm[kUnits][D];
    float dinv[kUnits];
#pragma unroll
    for (int b = 0; b < kUnits; ++b) {
      const int u = u0 + b * step;
      if (u >= units) break;
      const int k = u / width;
      w[b] = u - k * width;
      s[b] = slot0 + static_cast<size_t>(k) * stride +
             static_cast<size_t>(w[b]);
      dinv[b] = __ldg(inv_dcount + s[b]);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        rv[b][i] = __ldcg(r + i * n + s[b]);
        vm[b][i] = __ldg(vmask + i * n + s[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kUnits; ++b) {
      if (u0 + b * step >= units) break;
      // q' = belief - own r', centred on the valid values' mean
      float qv[D];
      float total = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        qv[i] = bel[i * tile_cols + w[b]] - rv[b][i];
        total += qv[i] * vm[b][i];
      }
      const float mean = total * dinv[b];
#pragma unroll
      for (int i = 0; i < D; ++i)
        q_out[q_slot_major ? s[b] * D + i : i * n + s[b]] =
            (qv[i] - mean) * vm[b][i];
    }
  }
}

// r' loads a column's thread of phase 2a keeps in flight at a time
template <int D>
constexpr int kDirectBatch = D <= 4 ? 8 : 4;

// phase 2a's sum of column threadIdx.x < width (acc, from 0 in rank
// order): the thread loads its slots' r' itself, kDirectBatch at a time
template <int D>
__device__ __forceinline__ void binary_sum_direct(
    const float* r, size_t n, int width, int deg, size_t slot0,
    size_t stride, float acc[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;
  if (static_cast<int>(threadIdx.x) >= width) return;
  const size_t s0 = slot0 + threadIdx.x;
  for (int k0 = 0; k0 < deg; k0 += kDirectBatch<D>) {
    float v[kDirectBatch<D>][D];
#pragma unroll
    for (int b = 0; b < kDirectBatch<D>; ++b) {
      if (k0 + b >= deg) break;
      const size_t s = s0 + static_cast<size_t>(k0 + b) * stride;
#pragma unroll
      for (int i = 0; i < D; ++i) v[b][i] = __ldcg(r + i * n + s);
    }
#pragma unroll
    for (int b = 0; b < kDirectBatch<D>; ++b) {
      if (k0 + b >= deg) break;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] += v[b][i];
    }
  }
}

// phase 2a's sum of column threadIdx.x < width for a tile of high degree
// (a hub): the block stages the tile's r' in shared memory, kStage floats
// (`chunk` ranks) at a time, its loads spread over every thread; the
// column's thread then adds its values in rank order from there.  Every
// thread of the block calls it (block barriers inside).
template <int D>
__device__ __forceinline__ void binary_sum_staged(
    const float* r, float* stage, size_t n, int width, int deg,
    size_t slot0, size_t stride, float acc[D]) {
  constexpr int kLoads = 4;
  const int step = static_cast<int>(blockDim.x);
  const int chunk = kStage / (width * D);
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < deg; k0 += chunk) {
    const int count = min(chunk, deg - k0) * width;
    const size_t s0 = slot0 + static_cast<size_t>(k0) * stride;
    for (int x0 = threadIdx.x; x0 < count; x0 += kLoads * step) {
      float v[kLoads][D];
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int x = x0 + b * step;
        if (x >= count) break;
        const int k = x / width;
        const size_t s = s0 + static_cast<size_t>(k) * stride +
                         static_cast<size_t>(x - k * width);
#pragma unroll
        for (int i = 0; i < D; ++i) v[b][i] = __ldcg(r + i * n + s);
      }
#pragma unroll
      for (int b = 0; b < kLoads; ++b) {
        const int x = x0 + b * step;
        if (x >= count) break;
#pragma unroll
        for (int i = 0; i < D; ++i) stage[x * D + i] = v[b][i];
      }
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < width) {
#pragma unroll 4
      for (int x = threadIdx.x; x < count; x += width) {
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] += stage[x * D + i];
      }
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads) packed_maxsum_coop_kernel(
    const float* q0, float* q_a, float* q_b, const float* r0, float* r,
    float* __restrict__ beliefs, const float* __restrict__ cost,
    const float* __restrict__ unary, const float* __restrict__ vmask,
    const float* __restrict__ inv_dcount, const int* __restrict__ mate,
    const int* __restrict__ tiles, int n_tiles, int tile_cols, int N,
    int Vp, int n_cycles, float damping, float keep, int use_damping,
    unsigned* bar) {
  // the tile's beliefs [D][tile_cols], then the staged r' [kStage]
  extern __shared__ float bel[];
  float* stage = bel + D * tile_cols;
  // up to this degree a column's thread loads its r' itself, in two
  // batches at most; a tile of higher degree stages them
  constexpr int kDirectDeg = 2 * kDirectBatch<D>;
  const size_t n = static_cast<size_t>(N);
  const size_t vp = static_cast<size_t>(Vp);
  for (int cyc = 0; cyc < n_cycles; ++cyc) {
    // the caller's q and the result are value-major; the q of the
    // cycles between them is slot-major, so a unit gathers its mate's D
    // values from one sector
    const float* q_in = cyc == 0 ? q0 : (cyc & 1) ? q_a : q_b;
    float* q_out = (cyc & 1) ? q_b : q_a;
    const float* r_in = cyc == 0 ? r0 : r;
    const bool last = cyc == n_cycles - 1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int* row = tiles + t * kTileFields;
      const int c0 = __ldg(row);
      const int width = __ldg(row + 1);
      const int deg = __ldg(row + 2);
      const size_t slot0 = static_cast<size_t>(__ldg(row + 3));
      const size_t stride = static_cast<size_t>(__ldg(row + 4));
      const int units = deg * width;
      binary_r_phase<D>(q_in, cyc > 0, r_in, r, cost, vmask, mate, n,
                        width, units, slot0, stride, damping, keep,
                        use_damping);
      __syncthreads();
      // phase 2a: the belief of each column, its slots' r' summed in rank
      // order from 0 (rank 0 first, as the Pallas kernel's bucket sum),
      // then the unary cost
      float acc[D];
      if (deg <= kDirectDeg) {
        binary_sum_direct<D>(r, n, width, deg, slot0, stride, acc);
      } else {
        binary_sum_staged<D>(r, stage, n, width, deg, slot0, stride, acc);
      }
      if (static_cast<int>(threadIdx.x) < width) {
        const int w = threadIdx.x;
        const size_t c = static_cast<size_t>(c0 + w);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float b = __ldg(unary + i * vp + c) + acc[i];
          bel[i * tile_cols + w] = b;
          if (last) beliefs[i * vp + c] = b;
        }
      }
      __syncthreads();
      binary_q_phase<D>(r, q_out, !last, bel, tile_cols, vmask, inv_dcount,
                        n, width, units, slot0, stride);
      __syncthreads();  // bel is the next tile's
    }
    if (!last) word_barrier(bar);
  }
}

// the binary kernel at domain size D (nullptr outside [1, 8])
const void* binary_kernel(int D) {
  switch (D) {
#define PACKED_MAXSUM_CASE(DD) \
  case DD:                     \
    return reinterpret_cast<const void*>(packed_maxsum_coop_kernel<DD>);
    PACKED_MAXSUM_CASE(1)
    PACKED_MAXSUM_CASE(2)
    PACKED_MAXSUM_CASE(3)
    PACKED_MAXSUM_CASE(4)
    PACKED_MAXSUM_CASE(5)
    PACKED_MAXSUM_CASE(6)
    PACKED_MAXSUM_CASE(7)
    PACKED_MAXSUM_CASE(8)
#undef PACKED_MAXSUM_CASE
    default:
      return nullptr;
  }
}

// shared memory of one block of the binary kernel: the tile's beliefs
// and the r' staging buffer
size_t binary_shared(int D, int tile_cols) {
  return sizeof(float) * (static_cast<size_t>(D) *
                              static_cast<size_t>(tile_cols) +
                          kStage);
}

bool binary_shape_ok(int D, int threads, int tile_cols) {
  return binary_kernel(D) != nullptr && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 && tile_cols >= 1 &&
         tile_cols <= threads;
}

// the largest D at which a ternary or quaternary slot exists (the packer
// refuses D > 5 with such factors); the D^3/D^4 loops are compiled only
// up to it
constexpr int kMaxDNary = 5;
// threads per block of the mixed kernel (a cooperative launch)
constexpr int kMixedThreads = 128;

// The mixed layout's per-arity operands.  Named fields, not arrays: a
// member picked by a runtime arity from an array would put the struct in
// local memory.
struct MixedArgs {
  const float* cost1;  // [D, n1]
  const float* cost2;  // [D^2, n2]
  const float* cost3;  // [D^3, n3]
  const float* cost4;  // [D^4, n4]
  const long long* slots1;  // [n1] the slot of each column of cost1
  const long long* slots2;  // [n2]
  const long long* slots3;  // [n3]
  const long long* slots4;  // [n4]
  const int* mate;   // [N] first sibling slot (-1 on unary slots)
  const int* mate2;  // [N] second sibling slot (-1 below arity 3)
  const int* mate3;  // [N] third sibling slot (-1 below arity 4)
  size_t n1, n2, n3, n4;
};

template <class T>
__device__ __forceinline__ T by_arity(int a, T v1, T v2, T v3, T v4) {
  return a == 1 ? v1 : a == 2 ? v2 : a == 3 ? v3 : v4;
}

template <int D>
__device__ __forceinline__ void gather_q(const float* __restrict__ q,
                                         size_t n, int slot, float out[D]) {
  const size_t m = static_cast<size_t>(slot);
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = q[j * n + m];
}

// r' at value i of the arity-a slot in column t of cost_a, before vmask,
// in the Pallas kernel's order (see the header); q1..q3 are the
// siblings' q.  The cost entries a candidate search reads are loaded
// first, D^2 at a time (all of a ternary value's, a quaternary value's
// for one j), so their loads are in flight together; the minimum then
// runs over them in order.
template <int D>
__device__ __forceinline__ float slot_value(const MixedArgs& A, int a,
                                             size_t t, int i,
                                             const float q1[D],
                                             const float q2[D],
                                             const float q3[D]) {
  const float* cost = by_arity(a, A.cost1, A.cost2, A.cost3, A.cost4);
  const size_t w = by_arity(a, A.n1, A.n2, A.n3, A.n4);
  if (a == 1) return __ldg(cost + i * w + t);
  if (a == 2) {
    float cv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) cv[j] = __ldg(cost + (j * D + i) * w + t);
    float best = cv[0] + q1[0];
#pragma unroll
    for (int j = 1; j < D; ++j) best = fminf(best, cv[j] + q1[j]);
    return best;
  }
  if constexpr (D <= kMaxDNary) {
    float cv[D * D];
    if (a == 3) {
#pragma unroll
      for (int jk = 0; jk < D * D; ++jk)
        cv[jk] = __ldg(cost + (jk * D + i) * w + t);
      float best = (cv[0] + q1[0]) + q2[0];
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (j == 0 && k == 0) continue;
          best = fminf(best, (cv[j * D + k] + q1[j]) + q2[k]);
        }
      }
      return best;
    }
    float best = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      // rows ((j*D + k)*D + m)*D + i for every (k, m)
#pragma unroll
      for (int km = 0; km < D * D; ++km)
        cv[km] = __ldg(cost + ((j * D * D + km) * D + i) * w + t);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float qjk = q1[j] + q2[k];
#pragma unroll
        for (int m = 0; m < D; ++m) {
          const float cand = (cv[k * D + m] + qjk) + q3[m];
          best = (j == 0 && k == 0 && m == 0) ? cand : fminf(best, cand);
        }
      }
    }
    return best;
  } else {
    return 0.0f;  // unreachable: the packer gives no arity-3/4 slot at this D
  }
}

template <int D>
__global__ void __launch_bounds__(kMixedThreads)
    packed_maxsum_mixed_coop_kernel(
        const float* __restrict__ q_in, float* __restrict__ q_out,
        const float* r_in, float* r_out, float* __restrict__ beliefs,
        MixedArgs A, const float* __restrict__ unary,
        const float* __restrict__ vmask,
        const float* __restrict__ inv_dcount,
        const int* __restrict__ col_deg, const int* __restrict__ col_slot0,
        const int* __restrict__ col_stride, int N, int Vp, float damping,
        float keep, int use_damping, unsigned* bar) {
  const size_t tid =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t n = static_cast<size_t>(N);

  // phase 1: r' of every slot.  Work units in arity order: n_a units of
  // arity 1 and 2, D * n_a of arity 3 and 4; arity a's units end at ea.
  const size_t e1 = A.n1;
  const size_t e2 = e1 + A.n2;
  const size_t e3 = e2 + D * A.n3;
  const size_t e4 = e3 + D * A.n4;
  for (size_t u = tid; u < e4; u += nthreads) {
    const int a = u < e1 ? 1 : u < e2 ? 2 : u < e3 ? 3 : 4;
    const size_t na = by_arity(a, A.n1, A.n2, A.n3, A.n4);
    const size_t local = u - by_arity(a, size_t{0}, e1, e2, e3);
    const bool split = a >= 3;
    const size_t t = split ? local % na : local;
    const int i0 = split ? static_cast<int>(local / na) : 0;
    const int i1 = split ? i0 + 1 : D;
    const size_t s = static_cast<size_t>(
        __ldg(by_arity(a, A.slots1, A.slots2, A.slots3, A.slots4) + t));
    float q1[D], q2[D], q3[D];
    if (a >= 2) gather_q<D>(q_in, n, __ldg(A.mate + s), q1);
    if (a >= 3) gather_q<D>(q_in, n, __ldg(A.mate2 + s), q2);
    if (a >= 4) gather_q<D>(q_in, n, __ldg(A.mate3 + s), q3);
    for (int i = i0; i < i1; ++i) {
      const size_t at = static_cast<size_t>(i) * n + s;
      float v = slot_value<D>(A, a, t, i, q1, q2, q3) * vmask[at];
      if (use_damping) v = damping * r_in[at] + keep * v;
      r_out[at] = v;
    }
  }

  grid_barrier(bar);

  // phase 2: one thread per column: the belief sum in slot order (rank 0
  // first), then the variable side; kBatch slots' loads in flight at a
  // time
  constexpr int kBatch = D <= 4 ? 8 : 4;
  const size_t vp = static_cast<size_t>(Vp);
  for (size_t c = tid; c < vp; c += nthreads) {
    const int deg = col_deg[c];
    const size_t s0 = static_cast<size_t>(col_slot0[c]);
    const size_t stride = static_cast<size_t>(col_stride[c]);
    float acc[D];
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] = 0.0f;
    for (int k0 = 0; k0 < deg; k0 += kBatch) {
      float v[kBatch][D];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b >= deg) break;
        const size_t s = s0 + static_cast<size_t>(k0 + b) * stride;
#pragma unroll
        for (int i = 0; i < D; ++i) v[b][i] = __ldcg(r_out + i * n + s);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b >= deg) break;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] += v[b][i];
      }
    }
    float bel[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      bel[i] = unary[i * vp + c] + acc[i];
      beliefs[i * vp + c] = bel[i];
    }
    for (int k0 = 0; k0 < deg; k0 += kBatch) {
      float rv[kBatch][D];
      float vm[kBatch][D];
      float dinv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b >= deg) break;
        const size_t s = s0 + static_cast<size_t>(k0 + b) * stride;
        dinv[b] = inv_dcount[s];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          rv[b][i] = __ldcg(r_out + i * n + s);
          vm[b][i] = vmask[i * n + s];
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (k0 + b >= deg) break;
        const size_t s = s0 + static_cast<size_t>(k0 + b) * stride;
        float qv[D];
        float total = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          qv[i] = bel[i] - rv[b][i];
          total += qv[i] * vm[b][i];
        }
        const float mean = total * dinv[b];
#pragma unroll
        for (int i = 0; i < D; ++i)
          q_out[i * n + s] = (qv[i] - mean) * vm[b][i];
      }
    }
  }
}

// the mixed kernel at domain size D (nullptr outside [1, 8])
const void* mixed_kernel(int D) {
  switch (D) {
#define PACKED_MAXSUM_MIXED_CASE(DD) \
  case DD:                           \
    return reinterpret_cast<const void*>(packed_maxsum_mixed_coop_kernel<DD>);
    PACKED_MAXSUM_MIXED_CASE(1)
    PACKED_MAXSUM_MIXED_CASE(2)
    PACKED_MAXSUM_MIXED_CASE(3)
    PACKED_MAXSUM_MIXED_CASE(4)
    PACKED_MAXSUM_MIXED_CASE(5)
    PACKED_MAXSUM_MIXED_CASE(6)
    PACKED_MAXSUM_MIXED_CASE(7)
    PACKED_MAXSUM_MIXED_CASE(8)
#undef PACKED_MAXSUM_MIXED_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// The resident-block capacity of the binary kernel at domain size D with
// `threads` threads a block and tiles of up to `tile_cols` columns on the
// current device (0 when a parameter is out of range or the device cannot
// be asked): the wrapper launches at most that many blocks.
extern "C" int packed_maxsum_binary_capacity(int D, int threads,
                                              int tile_cols) {
  if (!binary_shape_ok(D, threads, tile_cols)) return 0;
  return coop_capacity(binary_kernel(D), threads,
                       binary_shared(D, tile_cols));
}

// `n_cycles` binary-layout cycles: one cooperative launch of `blocks`
// blocks of `threads` threads on `stream` (at most
// packed_maxsum_binary_capacity(D, threads, tile_cols)); returns the
// launch's error (0 on success).  `tiles` is the [n_tiles, 5] tile table
// (first column, width <= tile_cols, degree, slot0, stride; every column
// in one tile, every slot in one (rank, column) unit).  The caller's q and
// r_in are read at cycle 0 only; q' goes to q_a at even cycles and to q_b
// at odd ones (the last cycle's [D, N], the others' slot-major [N, D]),
// r' to r_out, the beliefs [D, Vp] of the last cycle to `beliefs`.
// `keep` is (1 - damping), computed by the caller in double precision as
// the plain version does.  `bar` is one unsigned int, zero before the
// launch and shared with no other launch.  D must be in
// [1, 8], threads a multiple of 32 up to 512, tile_cols in [1, threads],
// n_tiles, n_cycles and blocks at least 1; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int packed_maxsum_coop(
    const float* q, float* q_a, float* q_b, const float* r_in, float* r_out,
    float* beliefs, const float* cost, const float* unary, const float* vmask,
    const float* inv_dcount, const int* mate, const int* tiles, int n_tiles,
    int tile_cols, int D, int N, int Vp, int n_cycles, int blocks,
    int threads, float damping, float keep, int use_damping, unsigned* bar,
    void* stream) {
  if (!binary_shape_ok(D, threads, tile_cols) || n_tiles < 1 ||
      n_cycles < 1 || blocks < 1 || bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&q,     &q_a,        &q_b,   &r_in,       &r_out,
                  &beliefs, &cost,     &unary, &vmask,      &inv_dcount,
                  &mate,  &tiles,      &n_tiles, &tile_cols, &N,
                  &Vp,    &n_cycles,   &damping, &keep,     &use_damping,
                  &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      const_cast<void*>(binary_kernel(D)), dim3(static_cast<unsigned>(blocks)),
      dim3(static_cast<unsigned>(threads)), args,
      binary_shared(D, tile_cols), static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The resident-block capacity of the mixed kernel at domain size D on the
// current device (0 when D is outside [1, 8] or the device cannot be
// asked), and its threads a block in *threads: the wrapper launches at
// most that many blocks.
extern "C" int packed_maxsum_mixed_capacity(int D, int* threads) {
  if (threads) *threads = kMixedThreads;
  const void* kernel = mixed_kernel(D);
  return kernel ? coop_capacity(kernel, kMixedThreads) : 0;
}

// The mixed-layout cycle: one cooperative launch of `blocks` blocks on
// `stream` (at most packed_maxsum_mixed_capacity(D)); returns the
// launch's error (0 on success).  D must be in [1, 8] (ternary and
// quaternary slots only up to 5, which the packer guarantees); n1..n4 are
// the widths of the per-arity cost arrays and slots1..slots4 their slots;
// `work` must be phase 1's unit count, n1 + n2 + D * (n3 + n4); `bar`
// is two unsigned ints, zero before the first launch of a call, left with
// a zero count.  Anything else returns cudaErrorInvalidValue without
// launching.
extern "C" int packed_maxsum_mixed_cycle(
    const float* q_in, float* q_out, const float* r_in, float* r_out,
    float* beliefs, const float* cost1, const float* cost2,
    const float* cost3, const float* cost4, const long long* slots1,
    const long long* slots2, const long long* slots3,
    const long long* slots4, const int* mate, const int* mate2,
    const int* mate3, const float* unary, const float* vmask,
    const float* inv_dcount, const int* col_deg, const int* col_slot0,
    const int* col_stride, int D, int N, int Vp, int n1, int n2, int n3,
    int n4, int work, int blocks, float damping, float keep, int use_damping,
    unsigned* bar, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* kernel = mixed_kernel(D);
  if (kernel == nullptr || (D > kMaxDNary && (n3 > 0 || n4 > 0)) ||
      work != n1 + n2 + D * (n3 + n4) || blocks < 1 || bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Vp <= 0) return static_cast<int>(cudaGetLastError());
  MixedArgs A;
  A.cost1 = cost1;
  A.cost2 = cost2;
  A.cost3 = cost3;
  A.cost4 = cost4;
  A.slots1 = slots1;
  A.slots2 = slots2;
  A.slots3 = slots3;
  A.slots4 = slots4;
  A.mate = mate;
  A.mate2 = mate2;
  A.mate3 = mate3;
  A.n1 = static_cast<size_t>(n1);
  A.n2 = static_cast<size_t>(n2);
  A.n3 = static_cast<size_t>(n3);
  A.n4 = static_cast<size_t>(n4);
  void* args[] = {&q_in,      &q_out,      &r_in,   &r_out, &beliefs,
                  &A,         &unary,      &vmask,  &inv_dcount,
                  &col_deg,   &col_slot0,  &col_stride,
                  &N,         &Vp,         &damping, &keep, &use_damping,
                  &bar};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      const_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kMixedThreads), args, 0, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
