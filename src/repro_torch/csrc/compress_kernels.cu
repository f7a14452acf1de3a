// Hopper (sm_90a) kernels for the compressed wire of one FedADC round.
//
// Three entry points, each the CUDA counterpart of one Pallas kernel of the
// JAX package (src/repro/kernels/):
//
//   fedadc_threshold_select_leaves  q = v*1[|v| >= tau_row] ; r = v - q
//       for every leaf of a table (the top-k compress of a whole delta, or
//       one leaf), one fp32 threshold a row; replaces
//       compress.py:threshold_select_2d (_threshold_kernel)
//       12 B/element in fp32 (read v; write q, r), 6 B in bf16
//   fedadc_qsgd_leaves       y = |v|*s/scale_row ; level = floor(y) + 1[u < frac(y)]
//                            q = sign(v)*level*scale_row/s ; r = v - q
//       for every leaf of a table (a sweep over a tree, or one leaf), each
//       row's scale max|v| computed in the call or given; replaces
//       compress.py:qsgd_2d (_qsgd_kernel)
//       16 B/element in fp32 (read v, u; write q, r), 8 B in bf16; with
//       the scales computed 20 B (v read twice), 10 B in bf16
//   fedadc_sparse_reduce_leaves  out_l = sum_c w[c] * scatter_add(values_lc @ indices_lc)
//       for every leaf l of a table; replaces
//       sparse_reduce.py:sparse_reduce_2d (_sparse_reduce_kernel)
//       K*k*(value + 4 B index) read, the output written once
//
// All are far under one operation per byte, so memory bounds them.
//
// The select and QSGD take every leaf of a sweep at once, each leaf stacked
// over the round's clients as one flat (rows, n) buffer with one scalar a
// row, so a top-k compress or a QSGD compress of a whole delta is one
// launch per 64 leaves (leaf_table.cuh's QsgdTable, the select's u unused).
// A block owns kQsgdTile elements of one row of one leaf.  The select is
// one pass: a thread loads 16 bytes at a time (4 fp32 or 8 bf16 elements),
// contiguous across a warp, the few elements before the row's first 16-byte
// boundary and after its last one taken one at a time.  A group of 64
// leaves of QSGD is two kernels, the rows' scales (the max of |v| by
// atomicMax on the bits of non-negative floats: exact in any order, NaN
// propagating as in torch.amax) into a zeroed fp32 buffer, then the
// quantisation; the host's per-leaf amax launches and trips through Python
// go.
//
// Arithmetic matches the plain PyTorch versions (repro_torch/kernels/ref.py)
// bit for bit. Every multiply, add and divide is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), so nvcc cannot contract
// them into an FMA. QSGD in bf16 rounds to bf16 after every operation, as
// PyTorch's (and jnp's) bf16 elementwise ops do.
//
// The sparse reduce must add the clients in order and, within a client,
// duplicate indices in pair order, as the plain version does; fp32
// atomicAdd has no fixed order.  One call reduces every leaf of an
// aggregate, described by a leaf table (leaf_table.cuh), in four kernels,
// so its work is O(K*k) and not O(tiles*K*k):
//
//   (a) count   the pairs, in their (leaf, client, pair) order, are cut
//               into chunks of kChunk pairs of one leaf; a block counts its
//               chunk's in-range pairs per output tile of kTile elements.
//               The counts form a (tile, chunk) matrix per leaf, stored
//               tile-major, the leaves one after another, so the output
//               tiles are numbered across the leaves and no two leaves
//               share one;
//   (b) scan    one block takes the exclusive prefix sum of the whole
//               matrix: every (tile, chunk) gets the first slot of its bin,
//               so a tile's bin holds its pairs chunk by chunk; a matrix
//               above kWideScan entries (a leaf cut into segments) is
//               scanned by many blocks instead, in three kernels;
//   (c) scatter each block re-reads its chunk, each warp a contiguous
//               sixteenth of it.  The warps' per-tile counts, scanned in warp
//               order, give each warp a cursor per tile; a warp then walks
//               its pairs 32 at a time, and ballots over the tile's bits
//               rank the lanes that share a tile.  Each pair is staged in shared
//               memory, sorted by tile, as (offset in tile, fp32 w_c*v)
//               with its slot (the bin's first plus its rank), and the
//               block copies the runs out: stable, so a bin holds its
//               pairs in (client, pair) order;
//   (d) apply   one block a tile zeroes an fp32 accumulator in shared
//               memory and applies its bin in order.  Where two pairs of
//               a segment hit one element, the earlier claims it first
//               (atomicMin on its position) and the other waits for the
//               next claim round; a bin without duplicates takes one
//               round a segment.  The tile is written once, cast.
//
// No atomics touch a sum; indices outside [0, n) are dropped in (a) and
// (c), so they add nothing.  The wrapper allocates the count matrix, its
// scan and the bins (8 B a pair); the kernels allocate nothing.

// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "leaf_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileShift = 13;
constexpr int kTile = 1 << kTileShift;       // output elements a tile
constexpr int kChunk = 8192;                 // pairs a chunk
constexpr int kCountThreads = 256;
constexpr int kCountItems = kChunk / kCountThreads;      // pairs a thread
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;               // entries a thread a round
constexpr int kScanRound = kScanThreads * kScanItems;
constexpr int kScanSmem = (kScanRound + kScanRound / 32) * sizeof(int);
constexpr int kScatterWarps = 16;
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kScatterItems = kChunk / kScatterThreads;  // pairs a lane
constexpr int kApplyThreads = 512;
constexpr int kApplyItems = 4;               // pairs a thread a segment
constexpr int kSegment = kApplyThreads * kApplyItems;
constexpr int kApplySmem = kTile * (sizeof(float) + sizeof(int));
constexpr int kMaxSmem = 232448;             // a block's shared memory on sm_90
constexpr int kQsgdTile = 4096;              // a QSGD table block's elements

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Round a float to the storage type T and back: identity for fp32, one
// bf16 rounding (to nearest even) for bf16.
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A row's factors from its scale, each rounded to T: inv = s / max(scale,
// 1e-30) where scale > 0, else 0, and scale / s.
template <typename T>
__device__ __forceinline__ void qsgd_factors(float sc, float s_levels,
                                             float* inv, float* scale_over_s) {
  const float s = rnd<T>(s_levels);
  *inv = sc > 0.0f ? rnd<T>(__fdiv_rn(s, fmaxf(sc, rnd<T>(1e-30f)))) : 0.0f;
  *scale_over_s = rnd<T>(__fdiv_rn(sc, s));
}

// One element of QSGD: y = |x|·inv, level = floor(y) + 1[u < frac(y)],
// q = sign(x)·level·scale/s, every operation rounded to T on its own
// -> q, and r = x - q through `r_out`.
template <typename T>
__device__ __forceinline__ float qsgd_elem(float x, float uu, float inv,
                                           float scale_over_s, float* r_out) {
  const float y = rnd<T>(__fmul_rn(fabsf(x), inv));
  const float lower = floorf(y);
  const float frac = rnd<T>(__fsub_rn(y, lower));
  const float level = rnd<T>(__fadd_rn(lower, uu < frac ? 1.0f : 0.0f));
  const float sgn = (float)((0.0f < x) - (x < 0.0f));
  const float qv =
      rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(sgn, level)), scale_over_s));
  *r_out = __fsub_rn(x, qv);
  return qv;
}

using leaf_table::QsgdTable;

// The leaf, row and element range of a block of the QSGD table's grid: a
// leaf's blocks are its rows times the kQsgdTile-element tiles of a row.
struct QsgdRef {
  int leaf;
  int64_t row, lo, hi, n;
};

__device__ __forceinline__ QsgdRef qsgd_ref(const QsgdTable& t) {
  QsgdRef r;
  r.leaf = leaf_table::find_leaf(t.block_end, t.n_leaves, blockIdx.x);
  const int64_t local =
      blockIdx.x - leaf_table::start_of(t.block_end, r.leaf);
  r.n = t.n[r.leaf];
  const int64_t tiles = (r.n + kQsgdTile - 1) / kQsgdTile;
  r.row = local / tiles;
  r.lo = (local % tiles) * kQsgdTile;
  r.hi = min(r.n, r.lo + kQsgdTile);
  return r;
}

// scale_bits[row] = max(scale_bits[row], the bits of max |v| over the
// block's tile), the rows numbered across the table (row_end).  Non-negative
// floats order as their bits, so the integer max is the float max whatever
// the order of the blocks; a NaN (sign cleared by fabsf) has larger bits
// than +inf, so a row holding one gets a NaN scale, as torch.amax gives.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qsgd_amax_kernel(const __grid_constant__ QsgdTable t,
                 unsigned* __restrict__ scale_bits) {
  __shared__ unsigned warp_max[kThreads / 32];
  const QsgdRef r = qsgd_ref(t);
  const T* v = static_cast<const T*>(t.v[r.leaf]) + r.row * r.n;
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < kQsgdTile / kThreads; ++k) {
    const int64_t i = r.lo + k * kThreads + threadIdx.x;
    if (i < r.hi) m = max(m, __float_as_uint(fabsf(load(v, i))));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(scale_bits + leaf_table::start_of(t.row_end, r.leaf) + r.row, m);
  }
}

// QSGD of every leaf of the table with each row's fp32 scale.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qsgd_leaves_kernel(const __grid_constant__ QsgdTable t,
                   const float* __restrict__ scale, float s_levels) {
  const QsgdRef r = qsgd_ref(t);
  const int64_t base = r.row * r.n;
  const T* v = static_cast<const T*>(t.v[r.leaf]) + base;
  const T* u = static_cast<const T*>(t.u[r.leaf]) + base;
  T* q = static_cast<T*>(t.q[r.leaf]) + base;
  T* rr = static_cast<T*>(t.r[r.leaf]) + base;
  float inv, scale_over_s;
  qsgd_factors<T>(scale[leaf_table::start_of(t.row_end, r.leaf) + r.row],
                  s_levels, &inv, &scale_over_s);
#pragma unroll
  for (int k = 0; k < kQsgdTile / kThreads; ++k) {
    const int64_t i = r.lo + k * kThreads + threadIdx.x;
    if (i >= r.hi) break;
    float rv;
    store(q, i, qsgd_elem<T>(load(v, i), load(u, i), inv, scale_over_s, &rv));
    store(rr, i, rv);
  }
}

template <typename T>
int launch_qsgd_leaves(const int64_t* rows, int64_t n_leaves, void* out,
                       float* scale, int compute_scale, float s_levels,
                       cudaStream_t s) {
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    QsgdTable t;
    if (!leaf_table::make_qsgd_table(rows + g * leaf_table::kQsgdCols, n,
                                     kQsgdTile, out, &t))
      return (int)cudaErrorInvalidValue;
    const int blocks = t.block_end[n - 1], n_rows = t.row_end[n - 1];
    if (compute_scale && n_rows) {
      cudaError_t e = cudaMemsetAsync(scale, 0, n_rows * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
    }
    if (blocks) {
      if (compute_scale)
        qsgd_amax_kernel<T><<<blocks, kThreads, 0, s>>>(t, (unsigned*)scale);
      qsgd_leaves_kernel<T><<<blocks, kThreads, 0, s>>>(t, scale, s_levels);
    }
    scale += n_rows;
  }
  return (int)cudaGetLastError();
}

// The threshold select of one element: keep = x where |x| >= tau, else 0,
// -> keep, and x - keep through `r_out`, both in fp32 (exact: keep is x or
// 0), so one rounding to T on store gives the plain version's bits.
__device__ __forceinline__ float select_elem(float x, float tau, float* r_out) {
  const float keep = fabsf(x) >= tau ? x : 0.0f;
  *r_out = __fsub_rn(x, keep);
  return keep;
}

// The select of every leaf of the table (u unused), each row's threshold
// one fp32 of `tau` (the rows numbered across the table, as QSGD's scales).
// Where v, q and r share their offset from a 16-byte boundary, the tile's
// body goes as 16-byte words, word w of the tile at thread w % kThreads,
// with streaming cache hints (each byte is touched once; on the H100 they
// beat plain loads and stores at ResNet-18's largest leaf); the head
// before the first boundary and the tail after the last word go one
// element a thread.  Otherwise (a view off the boundary) every element goes
// one at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
select_leaves_kernel(const __grid_constant__ QsgdTable t,
                     const float* __restrict__ tau) {
  using V = leaf_table::Vec16<T>;
  constexpr int kWords = kQsgdTile / (kThreads * V::kN);   // a thread's
  static_assert(kWords * kThreads * V::kN == kQsgdTile, "tile");
  const QsgdRef r = qsgd_ref(t);
  const int64_t base = r.row * r.n;
  const T* v = static_cast<const T*>(t.v[r.leaf]) + base;
  T* q = static_cast<T*>(t.q[r.leaf]) + base;
  T* rr = static_cast<T*>(t.r[r.leaf]) + base;
  const float th = tau[leaf_table::start_of(t.row_end, r.leaf) + r.row];
  const uintptr_t at = (uintptr_t)(v + r.lo);
  int64_t body = r.hi;   // the first element of the 16-byte body
  if ((((uintptr_t)(q + r.lo) ^ at) & 15) == 0 &&
      (((uintptr_t)(rr + r.lo) ^ at) & 15) == 0)
    body = min(r.hi, r.lo + (int64_t)(((16 - (at & 15)) & 15) / sizeof(T)));
  const int64_t words = (r.hi - body) / V::kN;
  const int64_t tail = body + words * V::kN;
  uint4 x[kWords];   // all of a thread's loads in flight before its stores
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t w = (int64_t)k * kThreads + threadIdx.x;
    if (w < words)
      x[k] = __ldcs(reinterpret_cast<const uint4*>(v + body + w * V::kN));
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int64_t w = (int64_t)k * kThreads + threadIdx.x;
    if (w < words) {
      float f[V::kN], fr[V::kN];
      V::unpack(x[k], f);
#pragma unroll
      for (int j = 0; j < V::kN; ++j) f[j] = select_elem(f[j], th, &fr[j]);
      __stcs(reinterpret_cast<uint4*>(q + body + w * V::kN), V::pack(f));
      __stcs(reinterpret_cast<uint4*>(rr + body + w * V::kN), V::pack(fr));
    }
  }
  for (int64_t i = r.lo + threadIdx.x; i < body; i += kThreads) {
    float rv;
    store(q, i, select_elem(load(v, i), th, &rv));
    store(rr, i, rv);
  }
  for (int64_t i = tail + threadIdx.x; i < r.hi; i += kThreads) {
    float rv;
    store(q, i, select_elem(load(v, i), th, &rv));
    store(rr, i, rv);
  }
}

template <typename T>
int launch_select_leaves(const int64_t* rows, int64_t n_leaves, void* out,
                         const float* tau, cudaStream_t s) {
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    QsgdTable t;
    if (!leaf_table::make_qsgd_table(rows + g * leaf_table::kQsgdCols, n,
                                     kQsgdTile, out, &t))
      return (int)cudaErrorInvalidValue;
    const int blocks = t.block_end[n - 1];
    if (blocks) select_leaves_kernel<T><<<blocks, kThreads, 0, s>>>(t, tau);
    tau += t.row_end[n - 1];
  }
  return (int)cudaGetLastError();
}

using leaf_table::SparseTable;

// The lanes of the warp whose v equals this lane's, v < 2**bits (bits
// uniform across the warp): one ballot a bit, so the cost grows with the
// bits of the tile count, not with the number of distinct values.
__device__ __forceinline__ unsigned same_value_lanes(unsigned v, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool bit = (v >> b) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}
using leaf_table::find_leaf;
using leaf_table::start_of;

// The row (a leaf's segment), its chunk and the row's geometry for a block
// of (a) or (c).
struct ChunkRef {
  int leaf, chunk, chunks, tiles, base;
  int64_t n, mat0, pair_lo, pair_hi;
};

__device__ __forceinline__ ChunkRef chunk_ref(const SparseTable& t) {
  ChunkRef r;
  r.leaf = find_leaf(t.chunk_end, t.n_leaves, blockIdx.x);
  const int c0 = start_of(t.chunk_end, r.leaf);
  r.chunk = blockIdx.x - c0;
  r.chunks = t.chunk_end[r.leaf] - c0;
  r.tiles = t.tile_end[r.leaf] - start_of(t.tile_end, r.leaf);
  r.mat0 = start_of(t.mat_end, r.leaf);
  r.n = t.n[r.leaf];
  r.base = t.base[r.leaf];
  const int64_t pairs = (int64_t)t.n_clients * t.k[r.leaf];
  r.pair_lo = (int64_t)r.chunk * kChunk;
  r.pair_hi = min(pairs, r.pair_lo + kChunk);
  return r;
}

// The index of a pair within the row's segment, or -1 where the pair is
// absent (past the chunk: ix -1) or its index falls outside the segment.
__device__ __forceinline__ int in_segment(int ix, const ChunkRef& r) {
  const int64_t at = (int64_t)ix - r.base;
  return ix >= 0 && at >= 0 && at < r.n ? (int)at : -1;
}

// (a) counts[mat0 + tile*chunks + chunk] = in-range pairs of the chunk in
// the tile.  Dynamic shared memory: one int per tile of the widest row.
__global__ void __launch_bounds__(kCountThreads)
sparse_count_kernel(const __grid_constant__ SparseTable t,
                    int* __restrict__ counts) {
  extern __shared__ int hist[];
  const ChunkRef r = chunk_ref(t);
  const int32_t* idx = static_cast<const int32_t*>(t.indices[r.leaf]);
  int ix[kCountItems];  // all loads in flight before the first count
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int64_t p = r.pair_lo + it * kCountThreads + threadIdx.x;
    ix[it] = p < r.pair_hi ? idx[p] : -1;
  }
  for (int i = threadIdx.x; i < r.tiles; i += blockDim.x) hist[i] = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kCountItems; ++it) {
    const int at = in_segment(ix[it], r);
    if (at >= 0) atomicAdd(&hist[at >> kTileShift], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r.tiles; i += blockDim.x)
    counts[r.mat0 + (int64_t)i * r.chunks + r.chunk] = hist[i];
}

// Exclusive prefix sum of a[0, n) in shared memory, by the whole block
// (blockDim a multiple of 32), in rounds of blockDim entries -> the
// total.  ws: 32 ints of shared memory.
__device__ int block_exclusive_scan(int* a, int n, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < n_warps ? ws[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      ws[lane] = w;
    }
    __syncthreads();
    if (i < n) a[i] = carry + (warp ? ws[warp - 1] : 0) + x - v;
    carry += ws[n_warps - 1];
    __syncthreads();
  }
  return carry;
}

// Shared-memory index of entry e of a round, padded by one int every 32 so
// that both the coalesced pass (thread t on entries j*blockDim + t) and
// the per-thread pass (thread t on entries t*kScanItems + j) are free of
// bank conflicts.
__device__ __forceinline__ int padded_at(int e) { return e + (e >> 5); }

// One round of kScanRound entries staged in shared memory (`stage`,
// padded_at): each thread's kScanItems consecutive entries scanned from
// `carry`, the exclusive sums written back in place -> the round's total.
// ws: 32 ints of shared memory.  Ends on a barrier.
__device__ __forceinline__ int scan_staged_round(int* stage, int* ws,
                                                 int carry) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v[kScanItems], local = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    v[j] = stage[padded_at(threadIdx.x * kScanItems + j)];
    local += v[j];
  }
  int x = local;  // inclusive scan of the thread totals within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = ws[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    ws[lane] = w;
  }
  __syncthreads();
  int run = carry + (warp ? ws[warp - 1] : 0) + x - local;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    stage[padded_at(threadIdx.x * kScanItems + j)] = run;
    run += v[j];
  }
  const int total = ws[kScanThreads / 32 - 1];
  __syncthreads();
  return total;
}

// (b) scan[i] = sum of counts[0, i) for i in [0, m]; one block, in rounds
// of kScanRound entries: loaded coalesced (the next round's loads in
// flight while this one is scanned), staged in shared memory, scanned
// kScanItems consecutive entries a thread, stored coalesced.
__global__ void __launch_bounds__(kScanThreads)
sparse_scan_kernel(const int* __restrict__ counts, int* __restrict__ scan,
                   int64_t m) {
  extern __shared__ int stage[];  // kScanSmem
  __shared__ int ws[32];
  int next[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t g = (int64_t)j * kScanThreads + threadIdx.x;
    next[j] = g < m ? counts[g] : 0;
  }
  int carry = 0;
  for (int64_t base = 0; base < m; base += kScanRound) {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j)
      stage[padded_at(j * kScanThreads + threadIdx.x)] = next[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int64_t g = base + kScanRound + (int64_t)j * kScanThreads +
                        threadIdx.x;
      next[j] = g < m ? counts[g] : 0;
    }
    carry += scan_staged_round(stage, ws, carry);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int64_t g = base + (int64_t)j * kScanThreads + threadIdx.x;
      if (g < m) scan[g] = stage[padded_at(j * kScanThreads + threadIdx.x)];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) scan[m] = carry;
}

// (b) above kWideScan entries, the same scan in three kernels, each round
// of kScanRound entries a block: the rounds' totals (b1), their exclusive
// scan by sparse_scan_kernel into `offsets` (one block over m / 16384
// entries), then each round scanned from its offset (b2).
constexpr int64_t kWideScan = 1 << 20;

__global__ void __launch_bounds__(kScanThreads)
sparse_round_sums_kernel(const int* __restrict__ counts,
                         int* __restrict__ sums, int64_t m) {
  __shared__ int ws[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = (int64_t)blockIdx.x * kScanRound;
  int v = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t g = base + (int64_t)j * kScanThreads + threadIdx.x;
    if (g < m) v += counts[g];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = ws[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) sums[blockIdx.x] = w;
  }
}

__global__ void __launch_bounds__(kScanThreads)
sparse_scan_rounds_kernel(const int* __restrict__ counts,
                          int* __restrict__ scan, int64_t m,
                          const int* __restrict__ offsets) {
  extern __shared__ int stage[];  // kScanSmem
  __shared__ int ws[32];
  const int64_t base = (int64_t)blockIdx.x * kScanRound;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t g = base + (int64_t)j * kScanThreads + threadIdx.x;
    stage[padded_at(j * kScanThreads + threadIdx.x)] = g < m ? counts[g] : 0;
  }
  __syncthreads();
  scan_staged_round(stage, ws, offsets[blockIdx.x]);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const int64_t g = base + (int64_t)j * kScanThreads + threadIdx.x;
    if (g < m) scan[g] = stage[padded_at(j * kScanThreads + threadIdx.x)];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scan[m] = offsets[gridDim.x];
}

// (c) bins[slot] = (offset in tile, fp32 w_c*v) for every in-range pair,
// stable.  The block places its chunk in shared memory first, sorted by
// tile (a tile's pairs are one run of its bin), then copies the runs out,
// so neighbouring threads write neighbouring slots.  Dynamic shared
// memory: the staged pairs and their slots (12 B a pair of the chunk), and
// per tile of the widest leaf the bin's first slot, the tile's place in
// the block and kScatterWarps 16-bit cursors (40 B).
constexpr int kScatterFixedSmem = kChunk * (sizeof(uint2) + sizeof(int)) +
                                  32 * sizeof(int);
constexpr int kScatterTileSmem =
    2 * sizeof(int) + kScatterWarps * sizeof(unsigned short);

template <typename TV>
__global__ void __launch_bounds__(kScatterThreads, 2)
sparse_scatter_kernel(const __grid_constant__ SparseTable t,
                      const float* __restrict__ w,
                      const int* __restrict__ scan, uint2* __restrict__ bins) {
  extern __shared__ uint2 staged[];  // [kChunk], then the ints below
  int* slot_of = reinterpret_cast<int*>(staged + kChunk);  // [kChunk]
  int* ws = slot_of + kChunk;                              // [32]
  const ChunkRef r = chunk_ref(t);
  int* first = ws + 32;                  // [tile] the bin's first slot
  int* place = first + r.tiles;          // [tile] its place in the block
  // [warp][tile] the warp's count, then its first rank (< kChunk)
  unsigned short* cursor = reinterpret_cast<unsigned short*>(place + r.tiles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* idx = static_cast<const int32_t*>(t.indices[r.leaf]);
  const TV* val = static_cast<const TV*>(t.values[r.leaf]);
  const int k = t.k[r.leaf];
  // the warp's pairs, all loads in flight before any is used; -1 where a
  // pair is past the chunk or its index is out of range.  Pair positions
  // fit in 32 bits (the wrapper checks K*k < 2**31).
  int ix[kScatterItems];
  float wv[kScatterItems];
  const int p0 = (int)r.pair_lo + warp * (kChunk / kScatterWarps) + lane;
  const int hi = (int)r.pair_hi;
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int p = p0 + it * 32;
    ix[it] = p < hi ? idx[p] : -1;
    wv[it] = p < hi ? load(val, p) : 0.0f;
  }
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int p = p0 + it * 32;
    if (p < hi) wv[it] = __fmul_rn(w[p / k], wv[it]);
    ix[it] = in_segment(ix[it], r);
  }
  unsigned short* mine = cursor + warp * r.tiles;
  for (int i = threadIdx.x; i < kScatterWarps * r.tiles; i += blockDim.x)
    cursor[i] = 0;
  __syncthreads();
  // each warp's count per tile, walking its pairs 32 at a time in order
  // (one leader lane a tile adds the group); a pair's rank among the
  // warp's earlier pairs of its tile is the count before its step plus its
  // place among the lanes of the step that share the tile
  const unsigned below = (1u << lane) - 1u;
  const int bits = 32 - __clz(r.tiles);  // tile + 1 < 2**bits
  int rank[kScatterItems];
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    const int tile = ix[it] >= 0 ? ix[it] >> kTileShift : -1;
    const unsigned peers = same_value_lanes((unsigned)(tile + 1), bits);
    const int before = tile >= 0 ? mine[tile] : 0;
    __syncwarp();
    if (tile >= 0 && lane == __ffs(peers) - 1)
      mine[tile] = (unsigned short)(before + __popc(peers));
    rank[it] = before + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();
  // cursors: each warp's first rank in the (tile, chunk) run, the earlier
  // warps' pairs before it; the run's length, then its place in the block
  for (int tile = threadIdx.x; tile < r.tiles; tile += blockDim.x) {
    int run = 0;
    for (int wp = 0; wp < kScatterWarps; ++wp) {
      const int c = cursor[wp * r.tiles + tile];
      cursor[wp * r.tiles + tile] = (unsigned short)run;
      run += c;
    }
    place[tile] = run;
    first[tile] = scan[r.mat0 + (int64_t)tile * r.chunks + r.chunk];
  }
  __syncthreads();
  const int placed = block_exclusive_scan(place, r.tiles, ws);
  // stage every pair at its rank in the (tile, chunk) run: the earlier
  // warps' pairs of the tile, then the warp's own earlier ones
#pragma unroll
  for (int it = 0; it < kScatterItems; ++it) {
    if (ix[it] >= 0) {
      const int tile = ix[it] >> kTileShift;
      const int at = mine[tile] + rank[it];
      staged[place[tile] + at] = make_uint2(
          (unsigned)(ix[it] & (kTile - 1)), __float_as_uint(wv[it]));
      slot_of[place[tile] + at] = first[tile] + at;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < placed; j += blockDim.x)
    bins[slot_of[j]] = staged[j];
}

// (d) one block a tile: apply its bin in order into fp32 shared memory,
// write the tile once.
template <typename TO>
__global__ void __launch_bounds__(kApplyThreads)
sparse_apply_kernel(const __grid_constant__ SparseTable t,
                    const int* __restrict__ scan,
                    const uint2* __restrict__ bins) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int* claim = reinterpret_cast<int*>(acc + kTile);
  const int leaf = find_leaf(t.tile_end, t.n_leaves, blockIdx.x);
  const int tile = blockIdx.x - start_of(t.tile_end, leaf);
  const int chunks = t.chunk_end[leaf] - start_of(t.chunk_end, leaf);
  const int64_t row = start_of(t.mat_end, leaf) + (int64_t)tile * chunks;
  const int begin = scan[row], end = scan[row + chunks];
  const int64_t tile_start = (int64_t)tile * kTile;
  const int tile_len = (int)min((int64_t)kTile, t.n[leaf] - tile_start);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    acc[i] = 0.0f;
    claim[i] = INT_MAX;
  }
  __syncthreads();
  for (int base = begin; base < end; base += kSegment) {
    int loc[kApplyItems];
    float add[kApplyItems];
    bool pending[kApplyItems];
    bool any = false;
#pragma unroll
    for (int it = 0; it < kApplyItems; ++it) {
      const int j = base + it * kApplyThreads + threadIdx.x;
      pending[it] = j < end;
      if (pending[it]) {
        const uint2 b = bins[j];
        loc[it] = (int)b.x;
        add[it] = __uint_as_float(b.y);
        any = true;
      }
    }
    // claim rounds: each pending pair bids its position in the segment
    // (= its order in the bin) for its element; the lowest bid adds, the
    // rest bid again next round
    while (__syncthreads_or(any)) {
#pragma unroll
      for (int it = 0; it < kApplyItems; ++it) {
        if (pending[it])
          atomicMin(&claim[loc[it]], it * kApplyThreads + (int)threadIdx.x);
      }
      __syncthreads();
      any = false;
#pragma unroll
      for (int it = 0; it < kApplyItems; ++it) {
        if (pending[it]) {
          if (claim[loc[it]] == it * kApplyThreads + (int)threadIdx.x) {
            acc[loc[it]] = __fadd_rn(acc[loc[it]], add[it]);
            claim[loc[it]] = INT_MAX;
            pending[it] = false;
          } else {
            any = true;
          }
        }
      }
    }
  }
  __syncthreads();
  TO* out = static_cast<TO*>(t.out[leaf]);
  for (int i = threadIdx.x; i < tile_len; i += blockDim.x)
    store(out, tile_start + i, acc[i]);
}

// Once per process: each kernel may take its largest dynamic shared
// memory, and all ask for one carveout (all shared), so the card need not
// repartition L1 and shared memory between them.
template <typename TV, typename TO>
cudaError_t allow_smem() {
  static const cudaError_t once = [] {
    const void* kernels[] = {(const void*)sparse_count_kernel,
                             (const void*)sparse_scan_kernel,
                             (const void*)sparse_scatter_kernel<TV>,
                             (const void*)sparse_apply_kernel<TO>,
                             (const void*)sparse_scan_rounds_kernel};
    const int smem[] = {kMaxSmem, kScanSmem, kMaxSmem, kApplySmem,
                        kScanSmem};
    for (int i = 0; i < 5; ++i) {
      cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem[i]);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return once;
}

template <typename TV, typename TO>
int launch_sparse_reduce(const int64_t* rows, int64_t n_leaves, const void* w,
                         int64_t n_clients, int* counts, int* scan,
                         uint2* bins, int* wide, cudaStream_t s) {
  cudaError_t e = allow_smem<TV, TO>();
  if (e != cudaSuccess) return (int)e;
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    SparseTable t;
    if (!leaf_table::make_sparse_table(rows + g * leaf_table::kSparseCols, n,
                                       kTile, kChunk, n_clients, &t))
      return (int)cudaErrorInvalidValue;
    int widest = 0;  // tiles of the widest leaf: the shared memory of (a), (c)
    for (int i = 0; i < n; ++i) {
      const int tiles = t.tile_end[i] - (i ? t.tile_end[i - 1] : 0);
      widest = tiles > widest ? tiles : widest;
    }
    const int64_t scatter_smem =
        kScatterFixedSmem + (int64_t)kScatterTileSmem * widest;
    if (scatter_smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    const int chunks = t.chunk_end[n - 1], tiles = t.tile_end[n - 1];
    const int64_t m = t.mat_end[n - 1];
    if (chunks)
      sparse_count_kernel<<<chunks, kCountThreads, widest * sizeof(int), s>>>(
          t, counts);
    if (m > kWideScan) {   // the rounds' sums and their scan in `wide`
      const int64_t rounds = (m + kScanRound - 1) / kScanRound;
      if (!wide || rounds > INT32_MAX) return (int)cudaErrorInvalidValue;
      sparse_round_sums_kernel<<<(unsigned)rounds, kScanThreads, 0, s>>>(
          counts, wide, m);
      sparse_scan_kernel<<<1, kScanThreads, kScanSmem, s>>>(
          wide, wide + rounds, rounds);
      sparse_scan_rounds_kernel<<<(unsigned)rounds, kScanThreads, kScanSmem,
                                  s>>>(counts, scan, m, wide + rounds);
      wide += 2 * rounds + 1;
    } else {
      sparse_scan_kernel<<<1, kScanThreads, kScanSmem, s>>>(counts, scan, m);
    }
    if (chunks)
      sparse_scatter_kernel<TV><<<chunks, kScatterThreads, scatter_smem, s>>>(
          t, (const float*)w, scan, bins);
    if (tiles)
      sparse_apply_kernel<TO><<<tiles, kApplyThreads, kApplySmem, s>>>(
          t, scan, bins);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    counts += m;
    scan += m + 1;
    bins += t.bin_end[n - 1];
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: n_leaves host rows of leaf_table::kQsgdCols int64 (v, u unused,
// q and r byte offsets into out, n, ends of rows and blocks); tau: one fp32
// threshold a row of the table (the rows of every group, in order).
int fedadc_threshold_select_leaves(const int64_t* rows, int64_t n_leaves,
                                   void* out, const void* tau, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_select_leaves<float>(rows, n_leaves, out,
                                       (const float*)tau, s);
  if (dtype == kBF16)
    return launch_select_leaves<__nv_bfloat16>(rows, n_leaves, out,
                                               (const float*)tau, s);
  return (int)cudaErrorInvalidValue;
}

// rows: n_leaves host rows of leaf_table::kQsgdCols int64 (v, u, q and r
// byte offsets into out, n, ends of rows and blocks); scale: one fp32 a row
// of the table (the rows of every group, in order), computed here as each
// row's max |v| when compute_scale, else read.
int fedadc_qsgd_leaves(const int64_t* rows, int64_t n_leaves, void* out,
                       void* scale, int compute_scale, float s_levels,
                       int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_qsgd_leaves<float>(rows, n_leaves, out, (float*)scale,
                                     compute_scale, s_levels, s);
  if (dtype == kBF16)
    return launch_qsgd_leaves<__nv_bfloat16>(rows, n_leaves, out,
                                             (float*)scale, compute_scale,
                                             s_levels, s);
  return (int)cudaErrorInvalidValue;
}

// rows: n_rows host rows of leaf_table::kSparseCols int64 (values,
// indices, out, n, k, base, ends of tiles, chunks, matrix entries and
// bins), a leaf wider than the scatter's widest row cut into segments; w
// the K fp32 weights; counts, scan and bins device scratch of (per group
// of kMaxLeaves rows) m, m + 1 and the bins' end entries; wide, for a
// group whose m exceeds kWideScan, 2 ceil(m / kScanRound) + 1 entries
// (null if none does).
int fedadc_sparse_reduce_leaves(const int64_t* rows, int64_t n_leaves,
                                const void* w, int64_t n_clients, void* counts,
                                void* scan, void* bins, void* wide,
                                int value_dtype, int out_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* c = (int*)counts;
  int* sc = (int*)scan;
  uint2* b = (uint2*)bins;
  int* wd = (int*)wide;
  if (value_dtype == kF32 && out_dtype == kF32)
    return launch_sparse_reduce<float, float>(rows, n_leaves, w, n_clients, c,
                                              sc, b, wd, s);
  if (value_dtype == kF32 && out_dtype == kBF16)
    return launch_sparse_reduce<float, __nv_bfloat16>(
        rows, n_leaves, w, n_clients, c, sc, b, wd, s);
  if (value_dtype == kBF16 && out_dtype == kF32)
    return launch_sparse_reduce<__nv_bfloat16, float>(
        rows, n_leaves, w, n_clients, c, sc, b, wd, s);
  if (value_dtype == kBF16 && out_dtype == kBF16)
    return launch_sparse_reduce<__nv_bfloat16, __nv_bfloat16>(
        rows, n_leaves, w, n_clients, c, sc, b, wd, s);
  return (int)cudaErrorInvalidValue;
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
