// Hopper (sm_90a) kernels for the parameter-space updates of one FedADC round.
//
// Four kernels, each the CUDA counterpart of one Pallas kernel of the JAX
// package (src/repro/kernels/):
//
//   fedadc_fused_axpy_leaves  out_l = x_l + a*y_l for every leaf l of a table
//       replaces fedadc_update.py:fused_axpy_2d (_axpy_kernel)
//       12 B/element in fp32 (read x, y; write out), 6 B in bf16
//   fedadc_local_update   out = theta - eta*(g + m_bar)
//       replaces fedadc_update.py:local_update_2d (_local_update_kernel)
//       16 B/element in fp32, 8 B in bf16
//   fedadc_server_update  m' = delta_bar + gamma*m ; theta' = theta - alpha_eta*m'
//       replaces fedadc_update.py:server_update_2d (_server_update_kernel)
//       20 B/element with fp32 theta (m, delta_bar and m' are always fp32)
//   fedadc_weighted_reduce_leaves  out_l = sum_k w[k]*d_l[k] for every leaf l
//       of a table
//       replaces weighted_reduce.py:weighted_reduce_2d (_weighted_reduce_kernel)
//       4(K+1) B/element in fp32, 2(K+1) B in bf16
//
// All four do well under one operation per byte, so memory bandwidth bounds
// them. The design follows from that: one pass over flat contiguous buffers
// of any length (the ragged tail is masked by the loop bound, no lane
// padding), neighbouring threads on neighbouring elements so every warp load
// is coalesced, and no intermediate ever written to device memory. The
// weighted reduce keeps the fp32 sum in a register and walks the K clients
// in order inside each thread: a fixed summation order, no atomics, one
// rounding to the output type on write.
//
// Arithmetic is fp32 whatever the storage type; bf16 is widened on load and
// rounded once (round to nearest even) on write. Every multiply and add is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn) so that the compiler
// cannot contract them into an FMA: the fp32 results then equal the plain
// PyTorch versions (repro_torch/kernels/ref.py) bit for bit.
//
// The axpy is the local step of every strategy (SGD, and FedADC's nesterov
// half-step), so it runs 2·H times a round over every leaf of the model;
// the weighted reduce is the server aggregate, once a round over every
// leaf.  At the paper CNN's size a leaf is a few microseconds of device
// time, less than the host's cost of one launch, so both take a leaf table
// (leaf_table.cuh): one launch covers every leaf of a sweep, each block a
// tile of one leaf.  Where the leaf's pointers are 16-byte aligned a
// thread moves 16 bytes a load (4 fp32 or 8 bf16 elements); the tile's
// ragged end, and a leaf that is not aligned, take the scalar path.  The
// axpy loads all its vectors before it computes; the reduce walks the K
// clients in order for its vector, K unrolled by 8 so that eight clients'
// loads are in flight at once (each element's sum still takes them one
// after another).
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "leaf_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Grid-stride loop over [0, n).
#define FOR_EACH_ELEMENT(i, n)                                            \
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < (n); \
       i += (int64_t)gridDim.x * blockDim.x)

constexpr int64_t kAxpyTile = 2048;  // elements a block; a multiple of 8

// 16 bytes of T as floats and back (bf16 is the upper half of an fp32).
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

template <typename T>
__global__ void local_update_kernel(const T* __restrict__ theta,
                                    const T* __restrict__ g,
                                    const T* __restrict__ m_bar,
                                    T* __restrict__ out, int64_t n, float eta) {
  FOR_EACH_ELEMENT(i, n) {
    float step = __fmul_rn(eta, __fadd_rn(load(g, i), load(m_bar, i)));
    store(out, i, __fsub_rn(load(theta, i), step));
  }
}

template <typename T>
__global__ void server_update_kernel(const T* __restrict__ theta,
                                     const float* __restrict__ m,
                                     const float* __restrict__ delta_bar,
                                     T* __restrict__ theta_out,
                                     float* __restrict__ m_out, int64_t n,
                                     float gamma, float alpha_eta) {
  FOR_EACH_ELEMENT(i, n) {
    float m_new = __fadd_rn(delta_bar[i], __fmul_rn(gamma, m[i]));
    m_out[i] = m_new;
    store(theta_out, i, __fsub_rn(load(theta, i), __fmul_rn(alpha_eta, m_new)));
  }
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

inline unsigned blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
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

int fedadc_local_update(const void* theta, const void* g, const void* m_bar,
                        void* out, int64_t n, float eta, int dtype,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    local_update_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)theta, (const float*)g, (const float*)m_bar,
        (float*)out, n, eta);
  } else if (dtype == kBF16) {
    local_update_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)theta, (const __nv_bfloat16*)g,
        (const __nv_bfloat16*)m_bar, (__nv_bfloat16*)out, n, eta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedadc_server_update(const void* theta, const void* m,
                         const void* delta_bar, void* theta_out, void* m_out,
                         int64_t n, float gamma, float alpha_eta, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    server_update_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)theta, (const float*)m, (const float*)delta_bar,
        (float*)theta_out, (float*)m_out, n, gamma, alpha_eta);
  } else if (dtype == kBF16) {
    server_update_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)theta, (const float*)m, (const float*)delta_bar,
        (__nv_bfloat16*)theta_out, (float*)m_out, n, gamma, alpha_eta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
