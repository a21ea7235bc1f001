// Local-search cycle kernels on the packed layouts, for Hopper (sm_90a):
// each entry has a binary branch (all-binary graphs) and a mixed branch
// (`_mixed` entries: unary, binary, ternary and quaternary factors).
// Built by pydcop_tpu_torch/ops/cuda_build.py with nvcc into a shared
// library with a plain C interface, bound with ctypes by
// pydcop_tpu_torch/ops/packed_local_search.py.
//
// Replaces (both branches of each):
//   * ls_tables  <- pydcop_tpu/ops/pallas_maxsum.py::packed_local_tables
//                   (mixed: _mixed_contrib via _contrib_for_values), in
//                   that function's form (x [V] and tables [V, D] in
//                   variable order);
//   * mgm_cycles <- pydcop_tpu/ops/pallas_local_search.py::packed_mgm_cycles
//                   (the tables and _cur_best_gain, then _routed_gains,
//                   _neigh_max_partial, _tiebreak_idx_partial and
//                   _mgm_decision);
//   * dsa_cycles <- pydcop_tpu/ops/pallas_local_search.py::packed_dsa_cycles
//                   (variants A/B/C, probability_hard, awake/activation).
//
// Layout (pack_for_gpu's var-grouped slots): column c is one variable; its
// k-th slot is col_slot0[c] + k * col_stride[c].  Binary: cost_rows is
// [D*D, N], other-value-major: row j*D + i of slot s = cost(other
// endpoint = j, this endpoint = i).  Mixed: one cost array per arity a,
// [D^a, N_a] over that arity's slots (column cost_idx[s]), rows
// other-values-major ((x1*D + x2)*D + i for a ternary slot whose siblings
// hold x1 and x2), and the slot's siblings' columns mate_col, mate2_col,
// mate3_col (-1 where the factor has no such sibling; a unary slot has
// none).  mate_idx[s] (mate2_idx, mate3_idx) is a sibling column's
// original variable index (the static MGM tie-break, and where K2 reads
// x).  x is int32 [Vp] in column order (K2's: [V] in variable order, V =
// Vp).  The Pallas kernels' Clos routing becomes the indexed load
// x[mate_col[s]] (K2: x[mate_idx[s]]), and their 128-lane padding, hub
// split and VMEM budget are gone.
//
// Arithmetic, in the plain PyTorch versions' order and with -fmad=false
// so both round alike:
//   acc[d]  = 0 + sum over slots k in order of the slot's cost row at its
//             siblings' values (binary: cost_rows[x_mate*D + d, s])
//   t[d]    = mask[d,c] > 0 ? unary[d,c] + acc[d] : PAD_COST
//   cur     = t[x_c];  pick[d] = t[d] (+ 1e-6f at d == x_c when
//             prefer_change: an add, so it vanishes once |t| >= 32)
//   best    = first d of the strict minimum of pick;
//   gain    = max(cur - t[best], 0)
// The unary cost is added after the slot sum, as the Pallas K2 kernel
// does.  Every constant compared with a float is a float (1e-9f,
// 10000.0f, probabilities passed as float), as in the JAX code, whose
// Python scalars are weakly typed f32.  MGM's neighbourhood max and
// tie-break run over every sibling of every slot of the column.
//
// ls_tables (K2) is one launch a call, not cooperative.  Blocks take
// tiles of the wrapper's tile table (packed_maxsum.py::tile_table: up to
// T neighbouring columns of one degree class, whose slots at one rank
// are contiguous) grid-stride; in a tile one thread a (rank, column)
// unit loads its slot's siblings' values and D cost floats into shared
// memory (kTableUnits units' loads in flight a thread, lanes on
// neighbouring slots), then one thread a column adds its ranks in order;
// a tile of more ranks than the slab holds (the degree-2,500 star's hub)
// runs in slabs, the running sum kept in the column's thread.  It reads
// x in variable order and writes each column's D floats at its
// variable's row, so the solve path's tables take one launch and no
// gather or transpose around it.  MGM and DSA run
// all n cycles of a call in ONE cooperative launch
// (cudaLaunchCooperativeKernel: every block resident, or the launch is
// refused), one thread a column in grid-stride loops (so any grid of at
// least one block gives the same x; the wrappers launch
// min(ceil(Vp / kThreads), capacity) blocks).  Cycle i reads x_in (i = 0)
// or the previous cycle's buffer and writes x_a (even i) or x_b (odd i).
// MGM (mgm_coop_kernel) reads its neighbours' gains of the SAME cycle, so
// each cycle is two phases of the grid:
//   T tables:      best and gain of every column at the current x, into
//                  a [Vp] workspace each (the tables stay in registers);
//   M arbitration: the neighbourhood max of the siblings' gains from 0,
//                  the smallest sibling variable with a gain within 1e-9
//                  of it (INT_MAX when none), and MGM's decision: move
//                  to best iff the gain is positive and the strict max,
//                  or ties the max within 1e-9 and the column's variable
//                  is smaller than that index; into x_a or x_b.
// DSA (dsa_coop_kernel) reads other columns only through the previous
// cycle's x, so each cycle is ONE phase: T's walk and pick (with the
// nudge for variants B and C), then the DSA rule on row i of the coins,
// into x_a or x_b.
// grid_sync.cuh's word_barrier stands between consecutive phases: 2n - 1
// a call for MGM (between T and M, and between M and the next cycle's
// T), n - 1 for DSA (between cycles only: cycle i + 1 overwrites the
// buffer cycle i read only after every block has passed it).  What one
// block writes and another reads in the launch (the workspaces, x_a,
// x_b) is read through L2 (__ldcg).  The walks take kBatch slots at a
// time, their loads issued with no branch between them, the next batch's
// layout entries loaded while a batch waits for its gathers; a column
// without slots starts no walk.  M keeps the running max and the smallest
// index within 1e-9 of it in one walk; a new max within 1e-9 of the old
// one (where the kept candidates may or may not stay within 1e-9 of the
// final max) walks the slots again with the final max, so M gives the
// two-pass rule's result exactly.
//
// Bound: memory.  Per cycle the function must read x (4 B a column),
// the D selected cost floats, the sibling columns (and for MGM their
// gains and variable indices) per slot, the unary and mask columns and
// the three column arrays (DSA also its coins; K2 col_var in their
// stead), and write its outputs: at the 10k-variable / 30k-constraint
// coloring (N = 60k slots, D = 3) about 1.4 MB for ls_tables, 1.7 MB for
// an MGM cycle and 1.4 MB for a DSA cycle, i.e. 0.4-0.5 us at 3.35 TB/s
// — far below a launch, so launches, barriers and the dependent
// x[mate_col[s]] loads set the pace.  K2's one-thread-a-column kernel that the tiles replaced ran 79
// blocks of 4 warps at 10k/30k, each thread walking its slots' chains
// of dependent loads one slot after another (7.2 us against a 0.48 us
// bound, PERF.md); the tiles put a thread on each slot and keep every
// chain one slot long.  The kernels answer the bound only by reading
// each operand once, coalesced except for the sibling gathers.  The
// MGM and DSA kernels take the launches and the host's per-cycle work
// out (one launch a call), and shorten each phase's chain of dependent
// gathers (slot -> sibling column -> its value -> cost row) by batching
// the walks; their barriers and those chains are what is left.
#include <cuda_runtime.h>

#include <climits>

#include "grid_sync.cuh"

namespace {

constexpr float kPadCost = 1e30f;
constexpr float kHard = 10000.0f;
constexpr float kEps = 1e-9f;
constexpr float kNudge = 1e-6f;
constexpr int kThreads = 128;

struct Layout {
  const float* cost;      // [D*D, N]
  const float* unary;     // [D, Vp] unary * mask
  const float* mask;      // [D, Vp]
  const int* mate_col;    // [N]
  const int* col_deg;     // [Vp]
  const int* col_slot0;   // [Vp]
  const int* col_stride;  // [Vp]
  int N;
  int Vp;
};

// the mixed layout's per-arity cost arrays and per-slot arrays
struct Mixed {
  const float* cost[4];  // cost1 [D, n1] .. cost4 [D^4, n4]
  size_t n[4];
  const int* arity;      // [N]
  const int* cost_idx;   // [N] column of the slot in its arity's array
  const int* mate2_col;  // [N] second sibling's column, -1 below arity 3
  const int* mate3_col;  // [N] third sibling's column, -1 below arity 4
};

// (cur, best, gain) of a column's tables t at its value xc: cur = t[xc];
// best = the first strict minimum of t, + 1e-6f at d == xc when
// prefer_change (an add); gain = max(cur - t[best], 0)
template <int D>
__device__ __forceinline__ void pick_best(const float (&t)[D], int xc,
                                          bool prefer_change, float* cur,
                                          int* best, float* gain) {
  float cv = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d == xc) cv = t[d];
  float bc = t[0];
  if (prefer_change) bc = t[0] + (xc == 0 ? kNudge : 0.0f);
  int bi = 0;
#pragma unroll
  for (int d = 1; d < D; ++d) {
    float p = t[d];
    if (prefer_change) p = t[d] + (xc == d ? kNudge : 0.0f);
    if (p < bc) {
      bc = p;
      bi = d;
    }
  }
  float tb = t[0];
#pragma unroll
  for (int d = 1; d < D; ++d)
    if (d == bi) tb = t[d];
  *cur = cv;
  *best = bi;
  *gain = fmaxf(cv - tb, 0.0f);
}

// ---------------------------------------------------------------------------
// K2: ls_tables_kernel, one launch a packed_local_tables call
// ---------------------------------------------------------------------------

// the tables kernel's most threads a block (the wrapper picks its threads
// and its tile width, at most the threads: a tile's column is one
// thread's in the rank-order sum)
constexpr int kTablesMaxThreads = 256;
// (rank, column) units of a tile staged in shared memory at a time: a
// tile of more ranks (the degree-2,500 star's hub) runs in slabs of
// kSlabUnits / width ranks
constexpr int kSlabUnits = 1024;
// units a thread loads at a time, their loads issued together
constexpr int kTableUnits = 4;
// a tile table row: first column, width, degree, slot of the first
// column's rank 0, slot stride between ranks
constexpr int kTileFields = 5;

// Where a slot's siblings' values are read in x ([V], variable order):
// the siblings' variables (mate_idx, mate2_idx, mate3_idx).  The binary
// layout has the first only.  Where a mixed slot's arity has no such
// sibling the entry is NO_INDEX and is never read.
struct Sibs {
  const int* at[3];
};

// The D cost floats of `units` (rank, column) units of a tile into the
// slab sh ([D][kSlabUnits]): unit u = k * width + w is the slot slot0 + k
// * stride + w; binary, row x[sibling] * D + d of cost_rows; mixed, the
// row of the siblings' values (0, x1, x1*D + x2, (x1*D + x2)*D + x3) of
// the slot's arity's array.  Each thread takes kTableUnits units at a
// time, lanes on neighbouring units (coalesced layout and, on the binary
// layout, cost loads); a unit past the slab loads the thread's first
// unit again and stores nothing.
template <int D, bool kMixed>
__device__ __forceinline__ void stage_slab(const Layout& L, const Mixed& M,
                                           const Sibs& S,
                                           const int* __restrict__ x,
                                           int width, int units,
                                           size_t slot0, size_t stride,
                                           float* sh) {
  const int step = static_cast<int>(blockDim.x);
  const size_t n = static_cast<size_t>(L.N);
  for (int u0 = threadIdx.x; u0 < units; u0 += kTableUnits * step) {
    size_t s[kTableUnits];
#pragma unroll
    for (int b = 0; b < kTableUnits; ++b) {
      const int u = u0 + b * step < units ? u0 + b * step : u0;
      const int k = u / width;
      s[b] = slot0 + static_cast<size_t>(k) * stride +
             static_cast<size_t>(u - k * width);
    }
    float v[kTableUnits][D];
    if constexpr (kMixed) {
      int a[kTableUnits], ci[kTableUnits], m[kTableUnits][3];
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b) {
        a[b] = __ldg(M.arity + s[b]);
        ci[b] = __ldg(M.cost_idx + s[b]);
#pragma unroll
        for (int r = 0; r < 3; ++r) m[b][r] = __ldg(S.at[r] + s[b]);
      }
      int xv[kTableUnits][3];
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b)
#pragma unroll
        for (int r = 0; r < 3; ++r)
          xv[b][r] = a[b] >= r + 2 ? __ldg(x + m[b][r]) : 0;
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b) {
        const int ar = a[b];
        size_t row = ar >= 2 ? static_cast<size_t>(xv[b][0]) : 0;
        if (ar >= 3) row = row * D + static_cast<size_t>(xv[b][1]);
        if (ar >= 4) row = row * D + static_cast<size_t>(xv[b][2]);
        // selects, not M.cost[ar - 1]: a runtime index into the struct's
        // arrays would put them in local memory
        const float* cost = ar == 1   ? M.cost[0]
                            : ar == 2 ? M.cost[1]
                            : ar == 3 ? M.cost[2]
                                      : M.cost[3];
        const size_t na = ar == 1   ? M.n[0]
                          : ar == 2 ? M.n[1]
                          : ar == 3 ? M.n[2]
                                    : M.n[3];
        const size_t c = static_cast<size_t>(ci[b]);
#pragma unroll
        for (int d = 0; d < D; ++d)
          v[b][d] = __ldg(cost + (row * D + d) * na + c);
      }
    } else {
      int m[kTableUnits];
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b) m[b] = __ldg(S.at[0] + s[b]);
      size_t row[kTableUnits];
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b)
        row[b] = static_cast<size_t>(__ldg(x + m[b])) * D;
#pragma unroll
      for (int b = 0; b < kTableUnits; ++b)
#pragma unroll
        for (int d = 0; d < D; ++d)
          v[b][d] = __ldg(L.cost + (row[b] + d) * n + s[b]);
    }
#pragma unroll
    for (int b = 0; b < kTableUnits; ++b) {
      const int u = u0 + b * step;
      if (u < units) {
#pragma unroll
        for (int d = 0; d < D; ++d) sh[d * kSlabUnits + u] = v[b][d];
      }
    }
  }
}

// K2 in both branches (kMixed).  Blocks take the tiles of the wrapper's
// tile table grid-stride (any grid of at least one block gives the same
// tables; there is no barrier between blocks).  For each tile: the column
// threads (threadIdx.x < width) load their columns' mask, unary costs and
// variable first; then, a slab of ranks at a time, the block stages the
// slab's units' cost floats in shared memory (stage_slab), a block
// barrier, each column's thread adds its ranks in order onto its running
// sum from 0, a block barrier; then t[d] = mask > 0 ? unary + sum :
// PAD_COST, in the plain version's order, written at tables[var * D + d]:
// [V, D] in variable order, x [V] in variable order read at the siblings'
// variables.
template <int D, bool kMixed>
__global__ void __launch_bounds__(kTablesMaxThreads)
    ls_tables_kernel(Layout L, Mixed M, Sibs S, const int* __restrict__ x,
                     const int* __restrict__ col_var,
                     const int* __restrict__ tiles, int n_tiles,
                     float* __restrict__ tables) {
  __shared__ float sh[D * kSlabUnits];
  const size_t vp = static_cast<size_t>(L.Vp);
  const int w = threadIdx.x;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int* row = tiles + static_cast<size_t>(t) * kTileFields;
    const int c0 = __ldg(row);
    const int width = __ldg(row + 1);
    const int deg = __ldg(row + 2);
    const size_t slot0 = static_cast<size_t>(__ldg(row + 3));
    const size_t stride = static_cast<size_t>(__ldg(row + 4));
    const bool mine = w < width;
    const size_t c = static_cast<size_t>(c0 + (mine ? w : 0));
    float mk[D], un[D], acc[D];
    int var = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) mk[d] = un[d] = acc[d] = 0.0f;
    if (mine) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        mk[d] = __ldg(L.mask + static_cast<size_t>(d) * vp + c);
        un[d] = __ldg(L.unary + static_cast<size_t>(d) * vp + c);
      }
      var = __ldg(col_var + c);
    }
    const int ranks = kSlabUnits / width;
    for (int k0 = 0; k0 < deg; k0 += ranks) {
      const int nk = min(ranks, deg - k0);
      stage_slab<D, kMixed>(L, M, S, x, width, nk * width,
                            slot0 + static_cast<size_t>(k0) * stride, stride,
                            sh);
      __syncthreads();
      if (mine) {
        for (int k = 0; k < nk; ++k) {
#pragma unroll
          for (int d = 0; d < D; ++d)
            acc[d] += sh[d * kSlabUnits + k * width + w];
        }
      }
      __syncthreads();  // the slab is the next one's
    }
    if (mine) {
      float* o = tables + static_cast<size_t>(var) * D;
#pragma unroll
      for (int d = 0; d < D; ++d)
        o[d] = mk[d] > 0.0f ? un[d] + acc[d] : kPadCost;
    }
  }
}

// K2's kernel of one branch, for coop_kernel's switch over D (its
// occupancy sets the tile width's wave: tables_capacity)
struct TablesKernel {
  template <int D, bool kMixed>
  static const void* get() {
    return reinterpret_cast<const void*>(ls_tables_kernel<D, kMixed>);
  }
};

// ---------------------------------------------------------------------------
// MGM and DSA: mgm_coop_kernel and dsa_coop_kernel, one cooperative launch
// a packed_mgm_cycles or packed_dsa_cycles call
// ---------------------------------------------------------------------------

// MGM's static tie-break: each sibling column's original variable, per
// slot (mate_idx; on the mixed layout also mate2_idx and mate3_idx,
// INT_MAX where the slot has no such sibling), and each column's own
// (col_var)
struct Ties {
  const int* idx[3];
  const int* col_var;
};

// A value written in this launch, possibly by another block: read
// through L2, past this SM's L1.
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldcg(p);
}

// Slots a thread walks at a time.  A batch's loads are issued together,
// with no branch between them (a batch past the column's last slot reads
// that slot again), so a walk of deg slots waits for ceil(deg / kBatch)
// chains of dependent loads, not deg.
constexpr int kBatch = 4;

// A column's slots: slot k is slot0 + k * stride (slot indices are int,
// as the layout's int32 slot arrays).
struct Walk {
  int slot0;
  int stride;
  int deg;
  __device__ __forceinline__ Walk(const Layout& L, int c)
      : slot0(L.col_slot0[c]), stride(L.col_stride[c]), deg(L.col_deg[c]) {}
  // slot k, or the last slot for k past it; only for deg >= 1 (a walk
  // loads nothing of a column without slots)
  __device__ __forceinline__ int slot(int k) const {
    return slot0 + min(k, deg - 1) * stride;
  }
};

// A batch of a column's slots for T: the slot and its sibling's column,
// or on the mixed layout the arity, the sibling columns (-1 read as
// column 0) and the cost column; loaded a batch ahead of their use.
template <bool kMixed>
struct TableSlots {
  int s[kBatch], m[kBatch];
  __device__ __forceinline__ void load(const Layout& L, const Mixed&,
                                       const Walk& walk, int k0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      s[j] = walk.slot(k0 + j);
      m[j] = L.mate_col[s[j]];
    }
  }
};

template <>
struct TableSlots<true> {
  int a[kBatch], m1[kBatch], m2[kBatch], m3[kBatch], ci[kBatch];
  __device__ __forceinline__ void load(const Layout& L, const Mixed& M,
                                       const Walk& walk, int k0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = walk.slot(k0 + j);
      a[j] = M.arity[s];
      m1[j] = max(L.mate_col[s], 0);
      m2[j] = max(M.mate2_col[s], 0);
      m3[j] = max(M.mate3_col[s], 0);
      ci[j] = M.cost_idx[s];
    }
  }
};

// T's walk: the tables t of column c at x (ls_tables_kernel's arithmetic:
// the slot costs from 0 in slot order, then + unary); returns x_c.
template <int D, bool kMixed>
__device__ __forceinline__ int walk_tables(const Layout& L, const Mixed& M,
                                           const int* x, int c,
                                           float (&t)[D]) {
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  const Walk walk(L, c);
  TableSlots<kMixed> cur;
  if (walk.deg > 0) cur.load(L, M, walk, 0);
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
      next.load(L, M, walk, k0 + kBatch);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int a = cur.a[j];
        size_t row = a >= 2 ? static_cast<size_t>(x1[j]) : 0;
        if (a >= 3) row = row * D + static_cast<size_t>(x2[j]);
        if (a >= 4) row = row * D + static_cast<size_t>(x3[j]);
        // selects, not M.cost[a - 1]: a runtime index into the struct's
        // arrays would put them in local memory
        const float* cost = a == 1   ? M.cost[0]
                            : a == 2 ? M.cost[1]
                            : a == 3 ? M.cost[2]
                                     : M.cost[3];
        const size_t na = a == 1   ? M.n[0]
                          : a == 2 ? M.n[1]
                          : a == 3 ? M.n[2]
                                   : M.n[3];
        const size_t ci = static_cast<size_t>(cur.ci[j]);
#pragma unroll
        for (int d = 0; d < D; ++d) v[j][d] = cost[(row * D + d) * na + ci];
      }
      cur = next;
    } else {
      size_t row[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        row[j] = static_cast<size_t>(ld(x + cur.m[j])) * D;
      TableSlots<kMixed> next;
      next.load(L, M, walk, k0 + kBatch);
      const size_t n = static_cast<size_t>(L.N);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int d = 0; d < D; ++d)
          v[j][d] = L.cost[(row[j] + d) * n + static_cast<size_t>(cur.s[j])];
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
  const size_t vp = static_cast<size_t>(L.Vp);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t o = static_cast<size_t>(d) * vp + c;
    t[d] = L.mask[o] > 0.0f ? L.unary[o] + acc[d] : kPadCost;
  }
  return ld(x + c);
}

// MGM's T: best and gain of column c at x (no nudge), into the
// workspaces.
template <int D, bool kMixed>
__device__ __forceinline__ void tables_phase(const Layout& L, const Mixed& M,
                                             const int* x, int* best,
                                             float* gain, int c) {
  float t[D];
  const int xc = walk_tables<D, kMixed>(L, M, x, c, t);
  float cv, g;
  int b;
  pick_best<D>(t, xc, false, &cv, &b, &g);
  best[c] = b;
  gain[c] = g;
}

// A batch of a column's slots for M: each sibling's column (-1: none),
// loaded a batch ahead of their use.  kSibs is 1 on the binary layout
// (every slot has its sibling) and 3 on the mixed one.
template <int kSibs>
struct SiblingSlots {
  int m[kBatch][kSibs];
  __device__ __forceinline__ void load(const Layout& L, const Mixed& M,
                                       const Walk& walk, int k0) {
    const int* cols[3] = {L.mate_col, M.mate2_col, M.mate3_col};
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int r = 0; r < kSibs; ++r) m[j][r] = cols[r][walk.slot(k0 + j)];
  }
};

// The gains of the batch at k0's siblings (a -1 column reads column 0)
// and their variables, loaded together.
template <int kSibs>
__device__ __forceinline__ void sibling_gains(const Ties& T,
                                              const float* gain,
                                              const Walk& walk, int k0,
                                              const SiblingSlots<kSibs>& b,
                                              float (&gn)[kBatch][kSibs],
                                              int (&id)[kBatch][kSibs]) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
#pragma unroll
    for (int r = 0; r < kSibs; ++r) {
      gn[j][r] = ld(gain + max(b.m[j][r], 0));
      id[j][r] = T.idx[r][walk.slot(k0 + j)];
    }
}

// M: MGM's arbitration and move of column c (neighborhood_winner): the
// neighbourhood max nm from 0 over every sibling of every slot, the
// smallest sibling variable with a gain >= nm - 1e-9, then the decision.
// A degree-0 column has nm = 0 and index INT_MAX, so it moves on any
// positive gain.  One walk keeps the running max and the smallest index
// within 1e-9 of it (a new max more than 1e-9 above the old one starts
// the candidates afresh; the repeated last slot of a batch past the end
// changes neither a max nor a min); a new max within 1e-9 of the old one
// walks the slots again with the final max.
template <bool kMixed>
__device__ __forceinline__ void move_phase(const Layout& L, const Mixed& M,
                                           const Ties& T, const int* x,
                                           const int* best, const float* gain,
                                           int* out, int c) {
  constexpr int kSibs = kMixed ? 3 : 1;
  const Walk walk(L, c);
  float nm = 0.0f;
  int idx = INT_MAX;
  bool again = false;
  SiblingSlots<kSibs> cur;
  if (walk.deg > 0) cur.load(L, M, walk, 0);
  for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
    float gn[kBatch][kSibs];
    int id[kBatch][kSibs];
    sibling_gains<kSibs>(T, gain, walk, k0, cur, gn, id);
    SiblingSlots<kSibs> next;
    next.load(L, M, walk, k0 + kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int r = 0; r < kSibs; ++r) {
        if (kMixed && cur.m[j][r] < 0) continue;
        if (gn[j][r] > nm) {
          if (gn[j][r] - kEps > nm)
            idx = id[j][r];
          else
            again = true;
          nm = gn[j][r];
        } else if (gn[j][r] >= nm - kEps) {
          idx = min(idx, id[j][r]);
        }
      }
    cur = next;
  }
  if (again) {
    const float thr = nm - kEps;
    idx = INT_MAX;
    for (int k0 = 0; k0 < walk.deg; k0 += kBatch) {
      SiblingSlots<kSibs> b;
      b.load(L, M, walk, k0);
      float gn[kBatch][kSibs];
      int id[kBatch][kSibs];
      sibling_gains<kSibs>(T, gain, walk, k0, b, gn, id);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int r = 0; r < kSibs; ++r)
          if ((!kMixed || b.m[j][r] >= 0) && gn[j][r] >= thr)
            idx = min(idx, id[j][r]);
    }
  }
  const float g = ld(gain + c);
  const bool move =
      (g > 0.0f) &&
      ((g > nm + kEps) || ((fabsf(g - nm) <= kEps) && (T.col_var[c] < idx)));
  out[c] = move ? ld(best + c) : ld(x + c);
}

// All n cycles of one call: for each, T and M, each a grid-stride loop
// over the columns, a grid barrier between consecutive phases (2n - 1 a
// call).  Cycle i reads x_in (i = 0) or the previous cycle's buffer and
// writes x_a (even i) or x_b (odd i).
template <int D, bool kMixed>
__global__ void __launch_bounds__(kThreads)
    mgm_coop_kernel(Layout L, Mixed M, Ties T, const int* __restrict__ x_in,
                    int* x_a, int* x_b, int* best, float* gain, int n_cycles,
                    unsigned* bar) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  const int* x = x_in;
  for (int i = 0; i < n_cycles; ++i) {
    int* out = (i % 2 == 0) ? x_a : x_b;
    if (i > 0) word_barrier(bar);
    for (int c = first; c < L.Vp; c += step)
      tables_phase<D, kMixed>(L, M, x, best, gain, c);
    word_barrier(bar);
    for (int c = first; c < L.Vp; c += step)
      move_phase<kMixed>(L, M, T, x, best, gain, out, c);
    x = out;
  }
}

// DSA's rule: variant 0/1/2 = A/B/C, probability_hard on conflicted
// columns when use_hard, and the wake coin against activation when the
// call has wake coins.
struct Rule {
  int variant;
  float probability;
  float probability_hard;
  int use_hard;
  float activation;
};

// One DSA-family cycle of column c: T's walk at x and its pick (the nudge
// for variants B and C), then the rule on this cycle's coins u (and
// awake_u, or nullptr), into out.
template <int D, bool kMixed>
__device__ __forceinline__ void dsa_phase(const Layout& L, const Mixed& M,
                                          const Rule& R, const int* x,
                                          const float* u,
                                          const float* awake_u, int* out,
                                          int c) {
  float t[D];
  const int xc = walk_tables<D, kMixed>(L, M, x, c, t);
  float cv, g;
  int b;
  pick_best<D>(t, xc, R.variant != 0, &cv, &b, &g);
  const bool conflict = cv >= kHard;
  const bool improving = g > kEps;
  const bool lateral = (g <= kEps) && (b != xc);
  bool want = improving;
  if (R.variant == 1) want = improving || (lateral && conflict);
  if (R.variant == 2) want = improving || lateral;
  const float p =
      (R.use_hard && conflict) ? R.probability_hard : R.probability;
  bool move = want && (u[c] < p);
  if (awake_u != nullptr) move = move && (awake_u[c] < R.activation);
  out[c] = move ? b : xc;
}

// All n cycles of one call, each one grid-stride loop over the columns, a
// grid barrier between consecutive cycles (n - 1 a call).  Cycle i reads
// row i of the [n, Vp] coins u (and of awake_u, or nullptr), x_in (i = 0)
// or the previous cycle's buffer, and writes x_a (even i) or x_b (odd i).
template <int D, bool kMixed>
__global__ void __launch_bounds__(kThreads)
    dsa_coop_kernel(Layout L, Mixed M, Rule R, const int* __restrict__ x_in,
                    int* x_a, int* x_b, const float* __restrict__ u,
                    const float* __restrict__ awake_u, int n_cycles,
                    unsigned* bar) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  const size_t vp = static_cast<size_t>(L.Vp);
  const int* x = x_in;
  for (int i = 0; i < n_cycles; ++i) {
    int* out = (i % 2 == 0) ? x_a : x_b;
    if (i > 0) word_barrier(bar);
    const size_t row = static_cast<size_t>(i) * vp;
    const float* wake = awake_u == nullptr ? nullptr : awake_u + row;
    for (int c = first; c < L.Vp; c += step)
      dsa_phase<D, kMixed>(L, M, R, x, u + row, wake, out, c);
    x = out;
  }
}

struct MgmKernel {
  template <int D, bool kMixed>
  static const void* get() {
    return reinterpret_cast<const void*>(mgm_coop_kernel<D, kMixed>);
  }
};

struct DsaKernel {
  template <int D, bool kMixed>
  static const void* get() {
    return reinterpret_cast<const void*>(dsa_coop_kernel<D, kMixed>);
  }
};

// K's kernel of one branch at domain size D (nullptr outside [1, 8])
template <class K>
const void* coop_kernel(int D, bool mixed) {
  switch (D) {
#define COOP_CASE(DD) \
  case DD:            \
    return mixed ? K::template get<DD, true>() : K::template get<DD, false>();
    COOP_CASE(1)
    COOP_CASE(2)
    COOP_CASE(3)
    COOP_CASE(4)
    COOP_CASE(5)
    COOP_CASE(6)
    COOP_CASE(7)
    COOP_CASE(8)
#undef COOP_CASE
    default:
      return nullptr;
  }
}

Layout make_layout(const float* cost, const float* unary, const float* mask,
                   const int* mate_col, const int* col_deg,
                   const int* col_slot0, const int* col_stride, int N,
                   int Vp) {
  Layout L;
  L.cost = cost;
  L.unary = unary;
  L.mask = mask;
  L.mate_col = mate_col;
  L.col_deg = col_deg;
  L.col_slot0 = col_slot0;
  L.col_stride = col_stride;
  L.N = N;
  L.Vp = Vp;
  return L;
}

Mixed make_mixed(const float* cost1, const float* cost2, const float* cost3,
                 const float* cost4, int n1, int n2, int n3, int n4,
                 const int* arity, const int* cost_idx, const int* mate2_col,
                 const int* mate3_col) {
  Mixed M;
  M.cost[0] = cost1;
  M.cost[1] = cost2;
  M.cost[2] = cost3;
  M.cost[3] = cost4;
  M.n[0] = static_cast<size_t>(n1);
  M.n[1] = static_cast<size_t>(n2);
  M.n[2] = static_cast<size_t>(n3);
  M.n[3] = static_cast<size_t>(n4);
  M.arity = arity;
  M.cost_idx = cost_idx;
  M.mate2_col = mate2_col;
  M.mate3_col = mate3_col;
  return M;
}

// One cooperative launch of `kernel` on `args`, or
// cudaErrorInvalidValue without launching when there is no kernel (D
// outside [1, 8]), n_cycles < 1, Vp < 1, blocks < 1 or no `bar`.
int launch_coop(const void* kernel, void** args, int n_cycles, int Vp,
                int blocks, const unsigned* bar, void* stream) {
  if (kernel == nullptr || n_cycles < 1 || Vp <= 0 || blocks < 1 ||
      bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      const_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The one cooperative launch of a packed_mgm_cycles call.
int launch_mgm(bool mixed, Layout L, Mixed M, Ties T, const int* x_in,
               int* x_a, int* x_b, int* best, float* gain, int D,
               int n_cycles, int blocks, unsigned* bar, void* stream) {
  void* args[] = {&L, &M, &T, &x_in, &x_a, &x_b, &best, &gain, &n_cycles,
                  &bar};
  return launch_coop(coop_kernel<MgmKernel>(D, mixed), args, n_cycles, L.Vp,
                     blocks, bar, stream);
}

// The one cooperative launch of a packed_dsa_cycles call.
int launch_dsa(bool mixed, Layout L, Mixed M, Rule R, const int* x_in,
               int* x_a, int* x_b, const float* u, const float* awake_u,
               int D, int n_cycles, int blocks, unsigned* bar,
               void* stream) {
  if (R.variant < 0 || R.variant > 2 || u == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&L, &M, &R, &x_in, &x_a, &x_b, &u, &awake_u, &n_cycles,
                  &bar};
  return launch_coop(coop_kernel<DsaKernel>(D, mixed), args, n_cycles, L.Vp,
                     blocks, bar, stream);
}

// The one launch of a K2 call on `stream`, or cudaErrorInvalidValue
// without launching: D outside [1, 8], threads not a multiple of 32 in
// [32, 256], tile_cols outside [1, threads], n_tiles, Vp or blocks below
// 1, or a null x, tables, col_var or tiles.
template <bool kMixed>
int launch_tables(const Layout& L, const Mixed& M, const Sibs& S,
                  const int* x, const int* col_var, const int* tiles,
                  int n_tiles, int tile_cols, float* tables, int D,
                  int blocks, int threads, void* stream) {
  if (threads < 32 || threads > kTablesMaxThreads || threads % 32 != 0 ||
      tile_cols < 1 || tile_cols > threads || n_tiles < 1 || L.Vp < 1 ||
      blocks < 1 || x == nullptr || tables == nullptr || tiles == nullptr ||
      col_var == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(threads));
  switch (D) {
#define LS_TABLES_CASE(DD)                                         \
  case DD:                                                         \
    ls_tables_kernel<DD, kMixed><<<grid, block, 0, st>>>(          \
        L, M, S, x, col_var, tiles, n_tiles, tables);              \
    break;
    LS_TABLES_CASE(1)
    LS_TABLES_CASE(2)
    LS_TABLES_CASE(3)
    LS_TABLES_CASE(4)
    LS_TABLES_CASE(5)
    LS_TABLES_CASE(6)
    LS_TABLES_CASE(7)
    LS_TABLES_CASE(8)
#undef LS_TABLES_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ls_tables entries make ONE launch of K2 on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without
// launching (see launch_tables).  x is [V] in variable order, `mate`
// (mixed: `mate`, `mate2`, `mate3`) holds each slot's siblings'
// variables (mate_idx, ...), and `tables` is [V, D] in variable order,
// written at col_var[c] * D + d.  `tiles` is the [n_tiles, 5] tile table
// of width at most tile_cols (first column, width, degree, slot0,
// stride; every column in one tile, every slot in one (rank, column)
// unit), taken by `blocks` blocks of `threads` threads grid-stride.

extern "C" int ls_tables(const int* x, float* tables, const float* cost,
                         const float* unary, const float* mask,
                         const int* mate, const int* col_var,
                         const int* tiles, int n_tiles, int tile_cols, int D,
                         int N, int Vp, int blocks, int threads,
                         void* stream) {
  const Layout L = make_layout(cost, unary, mask, nullptr, nullptr, nullptr,
                               nullptr, N, Vp);
  const Sibs S = {{mate, nullptr, nullptr}};
  return launch_tables<false>(L, Mixed{}, S, x, col_var, tiles, n_tiles,
                              tile_cols, tables, D, blocks, threads, stream);
}

// The mixed branch.  cost1..cost4 are the per-arity cost arrays of widths
// n1..n4, arity and cost_idx the per-slot arrays.

extern "C" int ls_tables_mixed(
    const int* x, float* tables, const float* cost1, const float* cost2,
    const float* cost3, const float* cost4, const int* arity,
    const int* cost_idx, const int* mate, const int* mate2, const int* mate3,
    const float* unary, const float* mask, const int* col_var,
    const int* tiles, int n_tiles, int tile_cols, int D, int N, int Vp,
    int n1, int n2, int n3, int n4, int blocks, int threads, void* stream) {
  const Layout L = make_layout(nullptr, unary, mask, nullptr, nullptr,
                               nullptr, nullptr, N, Vp);
  const Mixed M = make_mixed(cost1, cost2, cost3, cost4, n1, n2, n3, n4,
                             arity, cost_idx, nullptr, nullptr);
  const Sibs S = {{mate, mate2, mate3}};
  return launch_tables<true>(L, M, S, x, col_var, tiles, n_tiles, tile_cols,
                             tables, D, blocks, threads, stream);
}

// The blocks of K2's kernel of one branch (mixed 0 or 1) at domain size D
// that the current device holds resident at once with `threads` threads
// a block (0 when D is outside [1, 8] or the device cannot be asked): one
// wave of its tiles.

extern "C" int tables_capacity(int D, int mixed, int threads) {
  const void* kernel = coop_kernel<TablesKernel>(D, mixed != 0);
  return kernel ? coop_capacity(kernel, threads) : 0;
}

// LAYOUT_OPERANDS of the MGM and DSA entries: binary, cost_rows, unary,
// mask, mate_col, col_deg, col_slot0, col_stride, D, N, Vp; mixed, the
// per-arity cost arrays cost1..cost4, arity, cost_idx, the sibling
// columns mate_col, mate2_col and mate3_col (-1 where absent), unary,
// mask, col_deg, col_slot0, col_stride, D, N, Vp and the widths n1..n4.

// The resident-block capacity of the MGM kernel of one branch (mixed 0 or
// 1) at domain size D on the current device (0 when D is outside [1, 8]
// or the device cannot be asked), and its threads a block in *threads: a
// call launches at most that many blocks.
extern "C" int mgm_capacity(int D, int mixed, int* threads) {
  if (threads) *threads = kThreads;
  const void* kernel = coop_kernel<MgmKernel>(D, mixed != 0);
  return kernel ? coop_capacity(kernel, kThreads) : 0;
}

// Both entries run n_cycles MGM cycles on `stream` from x_in (left
// unchanged) in ONE cooperative launch of `blocks` blocks (at most
// mgm_capacity(D, ...)): cycle i writes x_a for even i and x_b for odd i,
// so the result is in x_a when n_cycles is odd and in x_b when it is
// even.  best (int) and gain (float) are [Vp] scratch; `bar` is one
// unsigned int, zero before the launch, which no other launch in flight
// may share.  After the layout operands (LAYOUT_OPERANDS above) come
// the tie-break ones: the siblings' variables
// (mate_idx; mixed also mate2_idx and mate3_idx) and col_var.  Returns
// the launch's error (0 on success); D outside [1, 8], n_cycles < 1,
// Vp < 1, blocks < 1 or no `bar` return cudaErrorInvalidValue without
// launching.

extern "C" int mgm_cycles(const int* x_in, int* x_a, int* x_b, int* best,
                          float* gain, const float* cost, const float* unary,
                          const float* mask, const int* mate_col,
                          const int* col_deg, const int* col_slot0,
                          const int* col_stride, int D, int N, int Vp,
                          const int* mate_idx, const int* col_var,
                          int n_cycles, int blocks, unsigned* bar,
                          void* stream) {
  const Layout L = make_layout(cost, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Ties T = {{mate_idx, nullptr, nullptr}, col_var};
  return launch_mgm(false, L, Mixed{}, T, x_in, x_a, x_b, best, gain, D,
                    n_cycles, blocks, bar, stream);
}

extern "C" int mgm_cycles_mixed(
    const int* x_in, int* x_a, int* x_b, int* best, float* gain,
    const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const float* unary, const float* mask, const int* col_deg,
    const int* col_slot0, const int* col_stride, int D, int N, int Vp, int n1,
    int n2, int n3, int n4, const int* mate_idx, const int* mate2_idx,
    const int* mate3_idx, const int* col_var, int n_cycles, int blocks,
    unsigned* bar, void* stream) {
  const Layout L = make_layout(nullptr, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Mixed M = make_mixed(cost1, cost2, cost3, cost4, n1, n2, n3, n4,
                             arity, cost_idx, mate2_col, mate3_col);
  const Ties T = {{mate_idx, mate2_idx, mate3_idx}, col_var};
  return launch_mgm(true, L, M, T, x_in, x_a, x_b, best, gain, D, n_cycles,
                    blocks, bar, stream);
}

// The resident-block capacity of the DSA kernel of one branch, as
// mgm_capacity gives the MGM kernel's.
extern "C" int dsa_capacity(int D, int mixed, int* threads) {
  if (threads) *threads = kThreads;
  const void* kernel = coop_kernel<DsaKernel>(D, mixed != 0);
  return kernel ? coop_capacity(kernel, kThreads) : 0;
}

// Both entries run n_cycles DSA-family cycles on `stream` from x_in (left
// unchanged) in ONE cooperative launch of `blocks` blocks (at most
// dsa_capacity(D, ...)): cycle i reads row i of the [n_cycles, Vp] coins u
// (and of awake_u, the wake coins, or nullptr) and writes x_a for even i
// and x_b for odd i, so the result is in x_a when n_cycles is odd and in
// x_b when it is even.  `bar` is one unsigned int, zero before the
// launch, which no other launch in flight may share.  After the coins
// come the layout operands (LAYOUT_OPERANDS above), then the rule
// (variant 0/1/2 = A/B/C, probability, probability_hard, use_hard,
// activation).  Returns the launch's error (0 on success); D
// outside [1, 8], a variant outside [0, 2], no u, n_cycles < 1, Vp < 1,
// blocks < 1 or no `bar` return cudaErrorInvalidValue without launching.

extern "C" int dsa_cycles(const int* x_in, int* x_a, int* x_b, const float* u,
                          const float* awake_u, const float* cost,
                          const float* unary, const float* mask,
                          const int* mate_col, const int* col_deg,
                          const int* col_slot0, const int* col_stride, int D,
                          int N, int Vp, int variant, float probability,
                          float probability_hard, int use_hard,
                          float activation, int n_cycles, int blocks,
                          unsigned* bar, void* stream) {
  const Layout L = make_layout(cost, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Rule R = {variant, probability, probability_hard, use_hard,
                  activation};
  return launch_dsa(false, L, Mixed{}, R, x_in, x_a, x_b, u, awake_u, D,
                    n_cycles, blocks, bar, stream);
}

extern "C" int dsa_cycles_mixed(
    const int* x_in, int* x_a, int* x_b, const float* u, const float* awake_u,
    const float* cost1, const float* cost2, const float* cost3,
    const float* cost4, const int* arity, const int* cost_idx,
    const int* mate_col, const int* mate2_col, const int* mate3_col,
    const float* unary, const float* mask, const int* col_deg,
    const int* col_slot0, const int* col_stride, int D, int N, int Vp, int n1,
    int n2, int n3, int n4, int variant, float probability,
    float probability_hard, int use_hard, float activation, int n_cycles,
    int blocks, unsigned* bar, void* stream) {
  const Layout L = make_layout(nullptr, unary, mask, mate_col, col_deg,
                               col_slot0, col_stride, N, Vp);
  const Mixed M = make_mixed(cost1, cost2, cost3, cost4, n1, n2, n3, n4,
                             arity, cost_idx, mate2_col, mate3_col);
  const Rule R = {variant, probability, probability_hard, use_hard,
                  activation};
  return launch_dsa(true, L, M, R, x_in, x_a, x_b, u, awake_u, D, n_cycles,
                    blocks, bar, stream);
}
