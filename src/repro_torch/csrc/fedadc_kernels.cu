// Hopper (sm_90a) kernels for the parameter-space updates of one FedADC round.
//
// Four kernels, each the CUDA counterpart of one Pallas kernel of the JAX
// package (src/repro/kernels/), each over a leaf table (leaf_table.cuh):
//
//   fedadc_fused_axpy_leaves  out_l = x_l + a*y_l for every leaf l
//       replaces fedadc_update.py:fused_axpy_2d (_axpy_kernel)
//       12 B/element in fp32 (read x, y; write out), 6 B in bf16
//   fedadc_local_update_leaves  out_l = theta_l - eta*(g_l + m_bar_l)
//       replaces fedadc_update.py:local_update_2d (_local_update_kernel)
//       16 B/element in fp32, 8 B in bf16
//   fedadc_server_update_leaves  delta_bar = s*delta ;
//       m' = delta_bar + gamma*m ; theta' = theta - alpha_eta*m'
//       replaces fedadc_update.py:server_update_2d (_server_update_kernel),
//       with the step that forms delta_bar = mean_delta/eta folded in
//       (s = 1 is the Pallas kernel itself)
//       20 B/element with fp32 theta and delta (m and m' are always fp32)
//   fedadc_weighted_reduce_leaves  out_l = sum_k w[k]*d_l[k] for every leaf l
//       replaces weighted_reduce.py:weighted_reduce_2d (_weighted_reduce_kernel)
//       4(K+1) B/element in fp32, 2(K+1) B in bf16
//
// All four do well under one operation per byte, so memory bandwidth bounds
// them. The design follows from that: one pass over flat contiguous buffers
// of any length (the ragged tail is masked, no lane padding), neighbouring
// threads on neighbouring elements so every warp load is coalesced, and no
// intermediate ever written to device memory. The weighted reduce keeps the
// fp32 sum in a register and walks the K clients in order inside each
// thread: a fixed summation order, no atomics, one rounding to the output
// type on write.
//
// Arithmetic is fp32 whatever the storage type; bf16 is widened on load and
// rounded once (round to nearest even) on write. Every multiply and add is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn) so that the compiler
// cannot contract them into an FMA: the fp32 results then equal the plain
// PyTorch versions (repro_torch/kernels/ref.py) bit for bit.
//
// The axpy is the local step of every strategy (SGD, and FedADC's nesterov
// half-step) and the local update FedADC's heavy-ball step, so they run H
// or 2·H times a round over every leaf of the model; the weighted reduce
// is the server aggregate and the server update the server step, once a
// round each.  At the paper CNN's size a leaf is a few microseconds of
// device time, less than the host's cost of one launch, so every kernel
// takes a whole sweep: one launch covers up to 64 leaves, each block a
// tile of one leaf.  Where the leaf's pointers are 16-byte aligned a
// thread moves 16 bytes a load (the updates: 16 bytes of fp32, 8 of bf16,
// so that theta in bf16 sits beside an fp32 momentum in one layout); the
// tile's ragged end, and a leaf that is not aligned, take the scalar path.
// The axpy and the two updates load all their vectors before they compute,
// each load contiguous across a warp; the reduce walks the K clients in
// order for its vector, K unrolled by 8 so that eight clients' loads are
// in flight at once (each element's sum still takes them one after
// another).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf_table.cuh"

namespace {

constexpr int kThreads = 256;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr int64_t kAxpyTile = 2048;  // elements a block; a multiple of 8

using leaf_table::aligned16;
using leaf_table::Vec16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_leaves_kernel(const __grid_constant__ leaf_table::AxpyTable t, float a) {
  using V = Vec16<T>;
  constexpr int kIters = kAxpyTile / (kThreads * V::kN);
  static_assert(kIters * kThreads * V::kN == kAxpyTile, "tile");
  const int leaf = leaf_table::find_leaf(t.end, t.n_leaves, blockIdx.x);
  const int64_t lo =
      (blockIdx.x - leaf_table::start_of(t.end, leaf)) * kAxpyTile;
  const int64_t hi = min(t.n[leaf], lo + kAxpyTile);
  const T* x = static_cast<const T*>(t.a[leaf]);
  const T* y = static_cast<const T*>(t.b[leaf]);
  T* out = static_cast<T*>(t.out[leaf]);
  if (aligned16(x) && aligned16(y) && aligned16(out)) {
    uint4 vx[kIters], vy[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int64_t i = lo + ((int64_t)it * kThreads + threadIdx.x) * V::kN;
      if (i + V::kN <= hi) {
        vx[it] = *reinterpret_cast<const uint4*>(x + i);
        vy[it] = *reinterpret_cast<const uint4*>(y + i);
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int64_t i = lo + ((int64_t)it * kThreads + threadIdx.x) * V::kN;
      if (i + V::kN <= hi) {
        float fx[V::kN], fy[V::kN];
        V::unpack(vx[it], fx);
        V::unpack(vy[it], fy);
#pragma unroll
        for (int j = 0; j < V::kN; ++j) fx[j] = __fadd_rn(fx[j], __fmul_rn(a, fy[j]));
        *reinterpret_cast<uint4*>(out + i) = V::pack(fx);
      } else {
        for (int64_t j = i; j < hi; ++j)
          store(out, j, __fadd_rn(load(x, j), __fmul_rn(a, load(y, j))));
      }
    }
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads)
      store(out, i, __fadd_rn(load(x, i), __fmul_rn(a, load(y, i))));
  }
}

// A thread of the update kernels takes kQuads quads, 4 consecutive elements
// each, of its block's tile: quad q of thread x starts kThreads*q + x quads
// into the tile, so each quad's load is contiguous across a warp.  A quad
// is one 16-byte load in fp32 and one 8-byte load in bf16, so theta in
// bf16 sits beside an fp32 momentum.
constexpr int kQuads = 2;
constexpr int64_t kUpdateTile = kThreads * 4 * kQuads;

template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using V = uint4;
  __device__ static void unpack(uint4 v, float* f) {
    Vec16<float>::unpack(v, f);
  }
  __device__ static uint4 pack(const float* f) { return Vec16<float>::pack(f); }
};
template <>
struct Quad<__nv_bfloat16> {
  using V = uint2;
  __device__ static void unpack(uint2 v, float* f) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ static uint2 pack(const float* f) {
    unsigned w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j + 1]))
              << 16);
    return make_uint2(w[0], w[1]);
  }
};

template <typename T>
__device__ __forceinline__ typename Quad<T>::V load_quad(const T* p) {
  return *reinterpret_cast<const typename Quad<T>::V*>(p);
}
template <typename T>
__device__ __forceinline__ void store_quad(T* p, const float* f) {
  *reinterpret_cast<typename Quad<T>::V*>(p) = Quad<T>::pack(f);
}

// The tile [lo, hi) of leaf `leaf` that block blockIdx.x takes.
struct Tile {
  int leaf;
  int64_t lo, hi;
  // the first element of the thread's quad q
  __device__ __forceinline__ int64_t at(int q) const {
    return lo + ((int64_t)q * kThreads + threadIdx.x) * 4;
  }
};
__device__ __forceinline__ Tile update_tile(const leaf_table::UpdateTable& t) {
  const int leaf = leaf_table::find_leaf(t.end, t.n_leaves, blockIdx.x);
  const int64_t lo =
      ((int64_t)blockIdx.x - leaf_table::start_of(t.end, leaf)) * kUpdateTile;
  return {leaf, lo, min(t.n[leaf], lo + kUpdateTile)};
}

__device__ __forceinline__ float local_step(float theta, float g, float m_bar,
                                            float eta) {
  return __fsub_rn(theta, __fmul_rn(eta, __fadd_rn(g, m_bar)));
}

// theta_l' = theta_l - eta*(g_l + m_bar_l) over a leaf table: a = theta,
// b = g, c = m_bar, all in T; out0 = theta' in T (out1 unused).
template <typename T>
__global__ void __launch_bounds__(kThreads)
local_update_leaves_kernel(const __grid_constant__ leaf_table::UpdateTable t,
                           float eta) {
  const Tile tile = update_tile(t);
  const T* theta = static_cast<const T*>(t.a[tile.leaf]);
  const T* g = static_cast<const T*>(t.b[tile.leaf]);
  const T* m_bar = static_cast<const T*>(t.c[tile.leaf]);
  T* out = static_cast<T*>(t.out0[tile.leaf]);
  if (aligned16(theta) && aligned16(g) && aligned16(m_bar) && aligned16(out)) {
    typename Quad<T>::V vt[kQuads], vg[kQuads], vm[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int64_t i = tile.at(q);
      if (i + 4 <= tile.hi) {
        vt[q] = load_quad(theta + i);
        vg[q] = load_quad(g + i);
        vm[q] = load_quad(m_bar + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int64_t i = tile.at(q);
      if (i + 4 <= tile.hi) {
        float ft[4], fg[4], fm[4];
        Quad<T>::unpack(vt[q], ft);
        Quad<T>::unpack(vg[q], fg);
        Quad<T>::unpack(vm[q], fm);
#pragma unroll
        for (int j = 0; j < 4; ++j) ft[j] = local_step(ft[j], fg[j], fm[j], eta);
        store_quad(out + i, ft);
      } else {
        for (int64_t j = i; j < tile.hi; ++j)
          store(out, j, local_step(load(theta, j), load(g, j),
                                   load(m_bar, j), eta));
      }
    }
  } else {
    for (int64_t j = tile.lo + threadIdx.x; j < tile.hi; j += kThreads)
      store(out, j, local_step(load(theta, j), load(g, j), load(m_bar, j),
                               eta));
  }
}

// m' = s*delta + gamma*m, each product rounded on its own (s = 1 leaves
// delta as it is: x*1 is exact)
__device__ __forceinline__ float server_m(float delta, float m, float s,
                                          float gamma) {
  return __fadd_rn(__fmul_rn(delta, s), __fmul_rn(gamma, m));
}

// delta_bar = s*delta ; m' = delta_bar + gamma*m ; theta' = theta -
// alpha_eta*m' over a leaf table: a = theta in T, b = m in fp32, c = delta
// in D; out0 = theta' in T, out1 = m' in fp32.
template <typename T, typename D>
__global__ void __launch_bounds__(kThreads)
server_update_leaves_kernel(const __grid_constant__ leaf_table::UpdateTable t,
                            float gamma, float alpha_eta, float s) {
  const Tile tile = update_tile(t);
  const T* theta = static_cast<const T*>(t.a[tile.leaf]);
  const float* m = static_cast<const float*>(t.b[tile.leaf]);
  const D* delta = static_cast<const D*>(t.c[tile.leaf]);
  T* theta_out = static_cast<T*>(t.out0[tile.leaf]);
  float* m_out = static_cast<float*>(t.out1[tile.leaf]);
  if (aligned16(theta) && aligned16(m) && aligned16(delta) &&
      aligned16(theta_out) && aligned16(m_out)) {
    typename Quad<T>::V vt[kQuads];
    uint4 vm[kQuads];
    typename Quad<D>::V vd[kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int64_t i = tile.at(q);
      if (i + 4 <= tile.hi) {
        vt[q] = load_quad(theta + i);
        vm[q] = load_quad(m + i);
        vd[q] = load_quad(delta + i);
      }
    }
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int64_t i = tile.at(q);
      if (i + 4 <= tile.hi) {
        float ft[4], fm[4], fd[4];
        Quad<T>::unpack(vt[q], ft);
        Quad<float>::unpack(vm[q], fm);
        Quad<D>::unpack(vd[q], fd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fm[j] = server_m(fd[j], fm[j], s, gamma);
          ft[j] = __fsub_rn(ft[j], __fmul_rn(alpha_eta, fm[j]));
        }
        store_quad(m_out + i, fm);
        store_quad(theta_out + i, ft);
      } else {
        for (int64_t j = i; j < tile.hi; ++j) {
          const float m_new = server_m(load(delta, j), m[j], s, gamma);
          m_out[j] = m_new;
          store(theta_out, j,
                __fsub_rn(load(theta, j), __fmul_rn(alpha_eta, m_new)));
        }
      }
    }
  } else {
    for (int64_t j = tile.lo + threadIdx.x; j < tile.hi; j += kThreads) {
      const float m_new = server_m(load(delta, j), m[j], s, gamma);
      m_out[j] = m_new;
      store(theta_out, j,
            __fsub_rn(load(theta, j), __fmul_rn(alpha_eta, m_new)));
    }
  }
}

// Walk n_leaves update-table rows kMaxLeaves at a time and launch(table,
// blocks) for each group that holds an element.  -> a CUDA error code.
template <typename Launch>
int update_groups(const int64_t* rows, int64_t n_leaves, void* out0,
                  void* out1, Launch launch) {
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    leaf_table::UpdateTable t;
    if (!leaf_table::make_update_table(rows + g * leaf_table::kUpdateCols, n,
                                       kUpdateTile, out0, out1, &t))
      return (int)cudaErrorInvalidValue;
    if (t.end[n - 1] == 0) continue;
    launch(t, (unsigned)t.end[n - 1]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// out_l = Σ_c w[c]·d_l[c] over a leaf table: a leaf's stack d_l is (K, n)
// (table field a), its output n elements (out); b is unused.  Each element
// sums the clients in order in one fp32 register and rounds once on
// write: the arithmetic of the plain version, bit for bit.  A block
// reduces kReduceBytes of output, a thread one 16-byte vector of it: the
// output is K times smaller than the stack it reads, so tiles of the axpy's
// size would leave too few blocks to fill the card in whole waves.
constexpr int kReduceBytes = kThreads * 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_leaves_kernel(const __grid_constant__ leaf_table::AxpyTable t,
                     const float* __restrict__ w, int k) {
  using V = Vec16<T>;
  constexpr int64_t kTile = kReduceBytes / sizeof(T);
  const int leaf = leaf_table::find_leaf(t.end, t.n_leaves, blockIdx.x);
  const int64_t n = t.n[leaf];
  const int64_t lo = (blockIdx.x - leaf_table::start_of(t.end, leaf)) * kTile;
  const int64_t hi = min(n, lo + kTile);
  const T* d = static_cast<const T*>(t.a[leaf]);
  T* out = static_cast<T*>(t.out[leaf]);
  // every client's row starts 16-byte aligned only if n is a whole number
  // of vectors
  if (aligned16(d) && aligned16(out) && n % V::kN == 0) {
    const int64_t i = lo + (int64_t)threadIdx.x * V::kN;
    if (i >= hi) return;
    float acc[V::kN];
#pragma unroll
    for (int j = 0; j < V::kN; ++j) acc[j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < k; ++c) {
      float f[V::kN];
      V::unpack(__ldg(reinterpret_cast<const uint4*>(d + c * n + i)), f);
      const float wc = __ldg(w + c);
#pragma unroll
      for (int j = 0; j < V::kN; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wc, f[j]));
    }
    *reinterpret_cast<uint4*>(out + i) = V::pack(acc);
  } else {
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      float acc = 0.0f;
      for (int c = 0; c < k; ++c)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + c), load(d, c * n + i)));
      store(out, i, acc);
    }
  }
}

}  // namespace

extern "C" {

// rows: n_leaves host rows of leaf_table::kAxpyCols int64 (x, y, the
// output's byte offset in `out`, n, end of the leaf's kAxpyTile blocks);
// one launch per kMaxLeaves leaves that hold any element.
int fedadc_fused_axpy_leaves(const int64_t* rows, int64_t n_leaves,
                             void* out, float a, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    leaf_table::AxpyTable t;
    if (!leaf_table::make_axpy_table(rows + g * leaf_table::kAxpyCols, n,
                                     kAxpyTile, out, &t))
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = t.end[n - 1];
    if (blocks == 0) continue;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    if (dtype == kF32)
      axpy_leaves_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(t, a);
    else
      axpy_leaves_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          t, a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// rows: n_leaves host rows of leaf_table::kUpdateCols int64 (theta, g,
// m_bar, the output's byte offset in `out`, unused, n, end of the leaf's
// kUpdateTile blocks); all in one dtype.  One launch per kMaxLeaves leaves
// that hold any element.
int fedadc_local_update_leaves(const int64_t* rows, int64_t n_leaves,
                               void* out, float eta, int dtype,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  return update_groups(rows, n_leaves, out, nullptr,
                       [&](const leaf_table::UpdateTable& t, unsigned blocks) {
    if (dtype == kF32)
      local_update_leaves_kernel<float><<<blocks, kThreads, 0, s>>>(t, eta);
    else
      local_update_leaves_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          t, eta);
  });
}

// rows: n_leaves host rows of leaf_table::kUpdateCols int64 (theta, m,
// delta, theta''s byte offset in `theta_out`, m''s in `m_out`, n, end of
// the leaf's kUpdateTile blocks); theta in `dtype`, delta in `delta_dtype`,
// m fp32.  One launch per kMaxLeaves leaves that hold any element.
int fedadc_server_update_leaves(const int64_t* rows, int64_t n_leaves,
                                void* theta_out, void* m_out, float gamma,
                                float alpha_eta, float scale, int dtype,
                                int delta_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((dtype != kF32 && dtype != kBF16) ||
      (delta_dtype != kF32 && delta_dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  return update_groups(rows, n_leaves, theta_out, m_out,
                       [&](const leaf_table::UpdateTable& t, unsigned blocks) {
    if (dtype == kF32 && delta_dtype == kF32)
      server_update_leaves_kernel<float, float><<<blocks, kThreads, 0, st>>>(
          t, gamma, alpha_eta, scale);
    else if (dtype == kF32)
      server_update_leaves_kernel<float, __nv_bfloat16>
          <<<blocks, kThreads, 0, st>>>(t, gamma, alpha_eta, scale);
    else if (delta_dtype == kF32)
      server_update_leaves_kernel<__nv_bfloat16, float>
          <<<blocks, kThreads, 0, st>>>(t, gamma, alpha_eta, scale);
    else
      server_update_leaves_kernel<__nv_bfloat16, __nv_bfloat16>
          <<<blocks, kThreads, 0, st>>>(t, gamma, alpha_eta, scale);
  });
}

// rows: n_leaves host rows of leaf_table::kAxpyCols int64 (stack, unused,
// the output's byte offset in `out`, n, end of the leaf's blocks of
// kReduceBytes of output); w: K fp32 weights on the card.  One launch per
// kMaxLeaves leaves that hold any element.
int fedadc_weighted_reduce_leaves(const int64_t* rows, int64_t n_leaves,
                                  void* out, const void* w, int64_t k,
                                  int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((dtype != kF32 && dtype != kBF16) || k < 0 || k > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  for (int64_t g = 0; g < n_leaves; g += leaf_table::kMaxLeaves) {
    const int n = (int)(n_leaves - g < leaf_table::kMaxLeaves
                            ? n_leaves - g : leaf_table::kMaxLeaves);
    leaf_table::AxpyTable t;
    const int64_t tile = kReduceBytes / (dtype == kF32 ? 4 : 2);
    if (!leaf_table::make_axpy_table(rows + g * leaf_table::kAxpyCols, n,
                                     tile, out, &t))
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = t.end[n - 1];
    if (blocks == 0) continue;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    if (dtype == kF32)
      reduce_leaves_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          t, wf, (int)k);
    else
      reduce_leaves_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0,
                                            s>>>(t, wf, (int)k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
