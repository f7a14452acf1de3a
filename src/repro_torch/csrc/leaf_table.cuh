// Leaf tables: one kernel launch over many leaves of a parameter tree.
//
// A sweep of the update and wire kernels touches every leaf of the model
// (16 for the paper CNN, 76 for ResNet-18).  Launching once per leaf costs
// one trip through Python, ctypes and the CUDA runtime for each, which at the
// CNN's size is more than the kernels' own time.  A leaf table instead
// describes up to kMaxLeaves leaves in one fixed-size struct that the
// kernel takes by value as a __grid_constant__ parameter: no copy to the
// device, no allocation, one launch.  Each leaf holds its pointers, its
// element count and the inclusive end of its share of the grid ("ends",
// a prefix over the leaves of blocks, tiles or chunks), so a block finds
// its leaf by a binary search over the ends.
//
// The host side (repro_torch/kernels/leaf_table.py) packs one int64 row a
// leaf: the row's fields in the order of the struct's members, the ends
// restarting from 0 at every kMaxLeaves-th leaf.  A C entry point walks
// the rows kMaxLeaves at a time, builds one struct from each group and
// launches once per group.  The structs stay under the 4 KB limit of a
// kernel's parameters (AxpyTable 2.6 KB, SparseTable 3.8 KB, QsgdTable
// 3.0 KB, UpdateTable 3.3 KB: int32 ends where they fit, since 64 leaves of
// seven int64 fields would be 3.6 KB before the kernel's other
// parameters).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace leaf_table {

constexpr int kMaxLeaves = 64;

// 16 bytes of T as floats and back (bf16 is the upper half of an fp32):
// the one load or store a thread makes of 4 fp32 or 8 bf16 elements.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(uint4 v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j + 1]))
              << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// The elementwise table: two inputs, one output, n elements a leaf.
// Host row: a, b, the output's byte offset in the sweep's buffer, n, end
// of the leaf's blocks.
constexpr int kAxpyCols = 5;
struct AxpyTable {
  const void* a[kMaxLeaves];
  const void* b[kMaxLeaves];
  void* out[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t end[kMaxLeaves];
  int n_leaves;
};

// The sparse-reduce table: a row is a segment of a leaf, elements [base,
// base + n) of it, with the leaf's stacked (K, k) wire (values, int32
// indices: a row keeps the pairs whose index falls in its segment), the
// segment's dense output of n elements, and three ends: output tiles,
// chunks of pairs (every pair of the leaf, in each of its segments), and
// entries of the (tile, chunk) count matrix; the fourth, bins, reserves K k
// slots for a leaf's first segment of the group (a leaf's segments share
// its pairs, so its in-range pairs in them are at most K k).  A leaf of up
// to the scatter's widest tile count is one segment with base 0.
// Host row: values, indices, out, n, k, base, tile end, chunk end, matrix
// end, bin end.
constexpr int kSparseCols = 10;
struct SparseTable {
  const void* values[kMaxLeaves];
  const void* indices[kMaxLeaves];
  void* out[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int64_t mat_end[kMaxLeaves];
  int32_t k[kMaxLeaves];
  int32_t base[kMaxLeaves];
  int32_t tile_end[kMaxLeaves];
  int32_t chunk_end[kMaxLeaves];
  int32_t bin_end[kMaxLeaves];
  int n_leaves;
  int n_clients;
};
static_assert(sizeof(SparseTable) <= 4096 - 64,
              "SparseTable must leave room for the kernels' other parameters "
              "under the 4 KB limit");

// The QSGD table: per leaf its stacked (rows, n) operand v and draws u,
// the outputs q and r (byte offsets into the call's output buffer), n, and
// two ends: rows (numbering each leaf's rows across the group, the index of
// its per-row scale) and blocks (rows x tiles of a row).  The top-k
// threshold select takes the same table with u unused (0) and each row's
// threshold in the scale's place.
// Host row: v, u, q offset, r offset, n, row end, block end.
constexpr int kQsgdCols = 7;
struct QsgdTable {
  const void* v[kMaxLeaves];
  const void* u[kMaxLeaves];
  void* q[kMaxLeaves];
  void* r[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t row_end[kMaxLeaves];
  int32_t block_end[kMaxLeaves];
  int n_leaves;
};

// The update table: three inputs, up to two outputs, n elements a leaf
// (the FedADC local and server steps).  The first output takes the first
// input's dtype, the second is fp32 (the server's momentum); a kernel with
// one output leaves the second unused.
// Host row: a, b, c, the first output's byte offset in its buffer, the
// second's in its own, n, end of the leaf's blocks.
constexpr int kUpdateCols = 7;
struct UpdateTable {
  const void* a[kMaxLeaves];
  const void* b[kMaxLeaves];
  const void* c[kMaxLeaves];
  void* out0[kMaxLeaves];
  void* out1[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t end[kMaxLeaves];
  int n_leaves;
};
static_assert(sizeof(UpdateTable) <= 4096 - 64,
              "UpdateTable must leave room for the kernel's other parameters "
              "under the 4 KB limit");

// The leaf whose share of the grid holds unit b: the first leaf whose
// inclusive end exceeds b (leaves with no units are passed over).
template <typename I>
__device__ __forceinline__ int find_leaf(const I* end, int n_leaves,
                                         int64_t b) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)end[mid] > b) hi = mid; else lo = mid + 1;
  }
  return lo;
}

template <typename I>
__device__ __forceinline__ I start_of(const I* end, int leaf) {
  return leaf ? end[leaf - 1] : (I)0;
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Build the table of rows [0, n) (n <= kMaxLeaves), each row's out field
// a byte offset into the buffer `out`.  Returns false if a row's end does
// not follow from its count and the kernel's unit: a packer whose unit
// differs from the kernel's is refused, not trusted.
inline bool make_axpy_table(const int64_t* rows, int n, int64_t unit,
                            void* out, AxpyTable* t) {
  *t = AxpyTable{};
  t->n_leaves = n;
  int64_t prev = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = rows + (int64_t)i * kAxpyCols;
    t->a[i] = (const void*)(intptr_t)r[0];
    t->b[i] = (const void*)(intptr_t)r[1];
    t->out[i] = static_cast<char*>(out) + r[2];
    t->n[i] = r[3];
    t->end[i] = r[4];
    if (r[3] < 0 || r[4] - prev != cdiv(r[3], unit)) return false;
    prev = r[4];
  }
  return true;
}

// The update table of rows [0, n), out0/out1 the two output buffers (out1
// may be null: the second output is then unused).  Refuses rows whose ends
// do not follow from n and the kernel's unit, as make_axpy_table does.
inline bool make_update_table(const int64_t* rows, int n, int64_t unit,
                              void* out0, void* out1, UpdateTable* t) {
  *t = UpdateTable{};
  t->n_leaves = n;
  int64_t prev = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = rows + (int64_t)i * kUpdateCols;
    t->a[i] = (const void*)(intptr_t)r[0];
    t->b[i] = (const void*)(intptr_t)r[1];
    t->c[i] = (const void*)(intptr_t)r[2];
    t->out0[i] = static_cast<char*>(out0) + r[3];
    t->out1[i] = out1 ? static_cast<char*>(out1) + r[4] : nullptr;
    t->n[i] = r[5];
    if (r[5] < 0 || r[6] > INT32_MAX || r[6] - prev != cdiv(r[5], unit))
      return false;
    prev = r[6];
    t->end[i] = (int32_t)r[6];
  }
  return true;
}

inline bool make_sparse_table(const int64_t* rows, int n, int64_t tile,
                              int64_t chunk, int64_t n_clients,
                              SparseTable* t) {
  *t = SparseTable{};
  t->n_leaves = n;
  t->n_clients = (int)n_clients;
  int64_t tiles = 0, chunks = 0, mat = 0, bins = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = rows + (int64_t)i * kSparseCols;
    t->values[i] = (const void*)(intptr_t)r[0];
    t->indices[i] = (const void*)(intptr_t)r[1];
    t->out[i] = (void*)(intptr_t)r[2];
    t->n[i] = r[3];
    t->k[i] = (int32_t)r[4];
    t->base[i] = (int32_t)r[5];
    const int64_t pairs = n_clients * r[4];
    const int64_t nt = cdiv(r[3], tile), nc = cdiv(pairs, chunk);
    // a segment continues the previous row's leaf; the first of a leaf, or
    // of a group, reserves the leaf's bins
    const bool first = i == 0 || r[5] == 0;
    const bool follows = r[5] == 0 || i == 0 ||
                         (r[0] == rows[(int64_t)(i - 1) * kSparseCols] &&
                          r[1] == rows[(int64_t)(i - 1) * kSparseCols + 1] &&
                          r[5] == rows[(int64_t)(i - 1) * kSparseCols + 5] +
                                      rows[(int64_t)(i - 1) * kSparseCols + 3]);
    if (r[3] < 0 || r[4] < 0 || r[5] < 0 || r[5] + r[3] > INT32_MAX ||
        pairs > INT32_MAX || !follows || r[6] - tiles != nt ||
        r[7] - chunks != nc || r[8] - mat != nt * nc ||
        r[9] - bins != (first ? pairs : 0) || r[6] > INT32_MAX ||
        r[7] > INT32_MAX || r[9] > INT32_MAX)
      return false;
    tiles = r[6], chunks = r[7], mat = r[8], bins = r[9];
    t->tile_end[i] = (int32_t)tiles;
    t->chunk_end[i] = (int32_t)chunks;
    t->mat_end[i] = mat;
    t->bin_end[i] = (int32_t)bins;
  }
  return true;
}

inline bool make_qsgd_table(const int64_t* rows, int n, int64_t tile,
                            void* out, QsgdTable* t) {
  *t = QsgdTable{};
  t->n_leaves = n;
  int64_t prev_rows = 0, prev_blocks = 0;
  for (int i = 0; i < n; ++i) {
    const int64_t* r = rows + (int64_t)i * kQsgdCols;
    t->v[i] = (const void*)(intptr_t)r[0];
    t->u[i] = (const void*)(intptr_t)r[1];
    t->q[i] = static_cast<char*>(out) + r[2];
    t->r[i] = static_cast<char*>(out) + r[3];
    t->n[i] = r[4];
    if (r[4] < 0 || r[5] < prev_rows || r[5] > INT32_MAX ||
        r[6] > INT32_MAX || r[6] - prev_blocks != (r[5] - prev_rows) *
                                                      cdiv(r[4], tile))
      return false;
    prev_rows = r[5], prev_blocks = r[6];
    t->row_end[i] = (int32_t)r[5];
    t->block_end[i] = (int32_t)r[6];
  }
  return true;
}

}  // namespace leaf_table
