// Hopper (sm_90a) kernels for the parameter-space updates of one FedADC round.
//
// Four kernels, each the CUDA counterpart of one Pallas kernel of the JAX
// package (src/repro/kernels/):
//
//   fedadc_fused_axpy     out = x + a*y
//       replaces fedadc_update.py:fused_axpy_2d (_axpy_kernel)
//       12 B/element in fp32 (read x, y; write out), 6 B in bf16
//   fedadc_local_update   out = theta - eta*(g + m_bar)
//       replaces fedadc_update.py:local_update_2d (_local_update_kernel)
//       16 B/element in fp32, 8 B in bf16
//   fedadc_server_update  m' = delta_bar + gamma*m ; theta' = theta - alpha_eta*m'
//       replaces fedadc_update.py:server_update_2d (_server_update_kernel)
//       20 B/element with fp32 theta (m, delta_bar and m' are always fp32)
//   fedadc_weighted_reduce out = sum_k w[k]*d[k]
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
// Each entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void axpy_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            T* __restrict__ out, int64_t n, float a) {
  FOR_EACH_ELEMENT(i, n) {
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

template <typename T>
__global__ void weighted_reduce_kernel(const T* __restrict__ d,
                                       const float* __restrict__ w,
                                       T* __restrict__ out, int64_t k,
                                       int64_t n) {
  FOR_EACH_ELEMENT(i, n) {
    float acc = 0.0f;
    for (int64_t c = 0; c < k; ++c) {
      acc = __fadd_rn(acc, __fmul_rn(w[c], load(d, c * n + i)));
    }
    store(out, i, acc);
  }
}

inline unsigned blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

int fedadc_fused_axpy(const void* x, const void* y, void* out, int64_t n,
                      float a, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    axpy_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)x, (const float*)y, (float*)out, n, a);
  } else if (dtype == kBF16) {
    axpy_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, (__nv_bfloat16*)out,
        n, a);
  } else {
    return (int)cudaErrorInvalidValue;
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

int fedadc_weighted_reduce(const void* d, const void* w, void* out, int64_t k,
                           int64_t n, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) {
    weighted_reduce_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        (const float*)d, (const float*)w, (float*)out, k, n);
  } else if (dtype == kBF16) {
    weighted_reduce_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        (const __nv_bfloat16*)d, (const float*)w, (__nv_bfloat16*)out, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
