// Hopper (sm_90a) kernels for the compressed wire of one FedADC round.
//
// Three kernels, each the CUDA counterpart of one Pallas kernel of the JAX
// package (src/repro/kernels/):
//
//   fedadc_threshold_select  q = v*1[|v| >= tau_row] ; r = v - q
//       replaces compress.py:threshold_select_2d (_threshold_kernel)
//       12 B/element in fp32 (read v; write q, r), 6 B in bf16
//   fedadc_qsgd              y = |v|*s/scale_row ; level = floor(y) + 1[u < frac(y)]
//                            q = sign(v)*level*scale_row/s ; r = v - q
//       replaces compress.py:qsgd_2d (_qsgd_kernel)
//       16 B/element in fp32 (read v, u; write q, r), 8 B in bf16
//   fedadc_sparse_reduce     out = sum_c w[c] * scatter_add(values_c @ indices_c)
//       replaces sparse_reduce.py:sparse_reduce_2d (_sparse_reduce_kernel)
//       K*k*(value + 4 B index) read, the output written once
//
// All three are far under one operation per byte, so memory bounds them.
//
// The select and QSGD take a leaf stacked over the round's clients as one
// flat (rows, n) buffer with one scalar per row (the threshold, the scale),
// so a whole stacked leaf is one launch: blockIdx.y is the row, a
// grid-stride loop over x covers the row's n elements, neighbouring threads
// on neighbouring elements. No (rows, 128) tiling and no lane padding.
//
// Arithmetic matches the plain PyTorch versions (repro_torch/kernels/ref.py)
// bit for bit. Every multiply, add and divide is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), so nvcc cannot contract
// them into an FMA. QSGD in bf16 rounds to bf16 after every operation, as
// PyTorch's (and jnp's) bf16 elementwise ops do.
//
// The sparse reduce must add the clients in order and, within a client,
// duplicate indices in pair order, as the plain version does; fp32
// atomicAdd has no fixed order. So each block owns a tile of the output in
// shared memory (an fp32 accumulator and a claim slot per element) and walks
// the K clients in order; for each chunk of a client's pairs, every pair
// that falls in the tile is applied, and where two pairs of the chunk hit
// one element the one earlier in pair order claims it first (atomicMin on
// its position) and the rest wait for the next claim round. The tile is
// written once, cast to the output type. Every block reads every pair's
// index: the cost of this simple form is (tiles)x the index bytes, which the
// bound does not count.
//
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1024;
constexpr int kReduceThreads = 512;
constexpr int kItems = 4;                    // pairs per thread per chunk
constexpr int kChunk = kReduceThreads * kItems;
constexpr int kTile = 8192;                  // output elements per block
constexpr int kReduceSmem = kTile * (sizeof(float) + sizeof(int));

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

// Grid-stride loop over one row's [0, n), the row being blockIdx.y.
#define FOR_EACH_IN_ROW(i, n)                                             \
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < (n); \
       i += (int64_t)gridDim.x * blockDim.x)

template <typename T>
__global__ void threshold_kernel(const T* __restrict__ v,
                                 const T* __restrict__ thresh,
                                 T* __restrict__ q, T* __restrict__ r,
                                 int64_t n) {
  const int64_t base = blockIdx.y * n;
  const float tau = load(thresh, blockIdx.y);
  FOR_EACH_IN_ROW(i, n) {
    float x = load(v, base + i);
    float keep = fabsf(x) >= tau ? x : 0.0f;
    store(q, base + i, keep);
    store(r, base + i, __fsub_rn(x, keep));
  }
}

template <typename T>
__global__ void qsgd_kernel(const T* __restrict__ v, const T* __restrict__ u,
                            const T* __restrict__ scale, T* __restrict__ q,
                            T* __restrict__ r, int64_t n, float s_levels) {
  const int64_t base = blockIdx.y * n;
  const float sc = load(scale, blockIdx.y);
  const float s = rnd<T>(s_levels);
  // inv = s / max(scale, 1e-30) where scale > 0, else 0; scale_over_s = scale / s
  const float inv =
      sc > 0.0f ? rnd<T>(__fdiv_rn(s, fmaxf(sc, rnd<T>(1e-30f)))) : 0.0f;
  const float scale_over_s = rnd<T>(__fdiv_rn(sc, s));
  FOR_EACH_IN_ROW(i, n) {
    float x = load(v, base + i);
    float y = rnd<T>(__fmul_rn(fabsf(x), inv));
    float lower = floorf(y);
    float frac = rnd<T>(__fsub_rn(y, lower));
    float level = rnd<T>(__fadd_rn(lower, load(u, base + i) < frac ? 1.0f : 0.0f));
    float sgn = (float)((0.0f < x) - (x < 0.0f));
    float qv = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(sgn, level)), scale_over_s));
    store(q, base + i, qv);
    store(r, base + i, __fsub_rn(x, qv));
  }
}

template <typename TV, typename TO>
__global__ void __launch_bounds__(kReduceThreads)
sparse_reduce_kernel(const TV* __restrict__ values,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ w, TO* __restrict__ out,
                     int64_t n_clients, int64_t k, int64_t n) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int* claim = reinterpret_cast<int*>(acc + kTile);
  const int64_t tile_start = blockIdx.x * (int64_t)kTile;
  const int64_t tile_len = min((int64_t)kTile, n - tile_start);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    acc[i] = 0.0f;
    claim[i] = INT_MAX;
  }
  __syncthreads();
  for (int64_t c = 0; c < n_clients; ++c) {
    const float wc = w[c];
    const int32_t* idx_c = indices + c * k;
    const TV* val_c = values + c * k;
    for (int64_t base = 0; base < k; base += kChunk) {
      int loc[kItems];
      float add[kItems];
      bool pending[kItems];
      bool any = false;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int64_t j = base + it * kReduceThreads + threadIdx.x;
        pending[it] = false;
        if (j < k) {
          const int64_t off = (int64_t)idx_c[j] - tile_start;
          if (off >= 0 && off < tile_len) {
            loc[it] = (int)off;
            add[it] = __fmul_rn(wc, load(val_c, j));
            pending[it] = true;
            any = true;
          }
        }
      }
      // claim rounds: each pending pair bids its position in the chunk
      // (= its pair order) for its element; the lowest bid adds, the rest
      // bid again next round
      while (__syncthreads_or(any)) {
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          if (pending[it]) atomicMin(&claim[loc[it]], it * kReduceThreads + (int)threadIdx.x);
        }
        __syncthreads();
        any = false;
#pragma unroll
        for (int it = 0; it < kItems; ++it) {
          if (pending[it]) {
            if (claim[loc[it]] == it * kReduceThreads + (int)threadIdx.x) {
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
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < tile_len; i += blockDim.x) {
    store(out, tile_start + i, acc[i]);
  }
}

inline dim3 row_grid(int64_t n, int64_t rows) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return dim3((unsigned)(b < kMaxBlocksX ? b : kMaxBlocksX), (unsigned)rows);
}

template <typename TV, typename TO>
int launch_sparse_reduce(const void* values, const void* indices,
                         const void* w, void* out, int64_t n_clients,
                         int64_t k, int64_t n, cudaStream_t s) {
  auto kernel = sparse_reduce_kernel<TV, TO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kReduceSmem);
  if (e != cudaSuccess) return (int)e;
  unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  kernel<<<blocks, kReduceThreads, kReduceSmem, s>>>(
      (const TV*)values, (const int32_t*)indices, (const float*)w, (TO*)out,
      n_clients, k, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fedadc_threshold_select(const void* v, const void* thresh, void* q,
                            void* r, int64_t rows, int64_t n, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    threshold_kernel<float><<<row_grid(n, rows), kThreads, 0, s>>>(
        (const float*)v, (const float*)thresh, (float*)q, (float*)r, n);
  } else if (dtype == kBF16) {
    threshold_kernel<__nv_bfloat16><<<row_grid(n, rows), kThreads, 0, s>>>(
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)thresh,
        (__nv_bfloat16*)q, (__nv_bfloat16*)r, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedadc_qsgd(const void* v, const void* u, const void* scale, void* q,
                void* r, int64_t rows, int64_t n, float s_levels, int dtype,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    qsgd_kernel<float><<<row_grid(n, rows), kThreads, 0, s>>>(
        (const float*)v, (const float*)u, (const float*)scale, (float*)q,
        (float*)r, n, s_levels);
  } else if (dtype == kBF16) {
    qsgd_kernel<__nv_bfloat16><<<row_grid(n, rows), kThreads, 0, s>>>(
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)u,
        (const __nv_bfloat16*)scale, (__nv_bfloat16*)q, (__nv_bfloat16*)r, n,
        s_levels);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedadc_sparse_reduce(const void* values, const void* indices,
                         const void* w, void* out, int64_t n_clients,
                         int64_t k, int64_t n, int value_dtype, int out_dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (value_dtype == kF32 && out_dtype == kF32)
    return launch_sparse_reduce<float, float>(values, indices, w, out,
                                              n_clients, k, n, s);
  if (value_dtype == kF32 && out_dtype == kBF16)
    return launch_sparse_reduce<float, __nv_bfloat16>(values, indices, w, out,
                                                      n_clients, k, n, s);
  if (value_dtype == kBF16 && out_dtype == kF32)
    return launch_sparse_reduce<__nv_bfloat16, float>(values, indices, w, out,
                                                      n_clients, k, n, s);
  if (value_dtype == kBF16 && out_dtype == kBF16)
    return launch_sparse_reduce<__nv_bfloat16, __nv_bfloat16>(
        values, indices, w, out, n_clients, k, n, s);
  return (int)cudaErrorInvalidValue;
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
