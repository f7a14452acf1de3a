// Hopper (sm_90a) kernel for causal GQA flash attention, forward only.
//
//   fedadc_flash_attention   o = softmax(q k^T / sqrt(D) + mask) v per
//       (batch, head), head h reading kv head h / (H / Hk); the mask keeps
//       key kpos for query qpos when kpos <= qpos (causal) and
//       kpos > qpos - window (window > 0). Self-attention: Lk = Lq = L.
//     replaces flash_attention.py:flash_attention (_flash_kernel), the
//     Pallas kernel the JAX package's shared-attention prefill reaches
//     through ops.flash_attention.
//
// Layout. q (B, L, H, D), k and v (B, L, Hk, D), o (B, L, H, D), all
// contiguous: the model's own layout, read with strides, so the wrapper
// moves no axis (the TPU kernel took (B, H, L, D) and its caller
// transposed).
//
// Bound. At zamba2-1.2b's prefill shape (B 4, H 32, L 2048, D 64) the work is
// 4·D flops for every visible (query, key) pair of every (batch, head),
// about 6.9e10, against 268 MB of q, k, v and o: 1.0 ms at 67 TFLOP/s of
// fp32 on the CUDA cores, 0.08 ms for the bytes at 3.35 TB/s. So it is bound by
// operations, and this kernel runs them on the CUDA cores in fp32; the
// tensor cores (wgmma, bf16 in, fp32 sum) are the later step that moves the
// roof 15-fold.
//
// Design. One 256-thread block per (batch·head, 64-query tile). The TPU
// grid walked the key blocks of a query block in order with the running
// max, sum and accumulator in VMEM scratch; here the block loops over the
// key tiles itself and keeps that state on chip: the max and sum of its 4
// rows and a 4 x D/16 accumulator in each thread's registers, the q tile,
// the k tile (transposed) and v tile and the probabilities in shared memory
// (67 KB at D 64, 117 KB at D 128). Thread t owns rows 4·(t/16)..+3 and
// columns t%16 + 16·j, so a row's 64 scores sit in 16 lanes of one warp and
// its max and sum are two shuffle reductions. Key tiles that the causal
// mask or the window hides entirely are skipped (the TPU kernel's pl.when),
// so the causal case does about half the tiles and a window O(L·W). Keys
// and queries past L (L 192 is not a multiple of 64) load as zeros, masked
// keys weigh exactly 0, and rows past L are not written. D is 64 or 128.
//
// Inputs fp32 or bf16 (q, k, v one type), arithmetic and accumulation
// fp32, o written in the inputs' type. Exact expf and division, no
// fast-math intrinsics. Launches on the given stream, does not synchronise,
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;             // query rows a block
constexpr int kBK = 64;             // keys a tile
constexpr int kKS = kBK + 1;        // padded row of the transposed k tile
constexpr float kNegInf = -1e30f;   // the reference's masked score

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile (row stride D + 4), transposed k tile, v tile, probabilities
  return sizeof(float) * (kBQ * (D + 4) + D * kKS + kBK * D + kBQ * kKS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int L, int H, int Hk,
          int causal, int window, float scale) {
  constexpr int kQS = D + 4;
  constexpr int kDC = D / 16;       // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][kQS], pre-scaled
  float* Kt = Qs + kBQ * kQS;       // [D][kKS]
  float* Vs = Kt + D * kKS;         // [kBK][D]
  float* Ps = Vs + kBK * D;         // [kBQ][kKS]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r4 = (tid / 16) * 4;    // first of the thread's 4 rows
  const int c = tid % 16;           // columns c + 16 j

  const int64_t q_row = (int64_t)H * D, k_row = (int64_t)Hk * D;
  const T* qb = q + ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * L * Hk + hk) * D;
  const T* vb = v + ((int64_t)b * L * Hk + hk) * D;
  T* ob = o + ((int64_t)b * L * H + h) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D, qpos = q0 + row;
    Qs[row * kQS + d] = qpos < L ? load(qb, qpos * q_row + d) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kBQ, L) - 1;
  const int kt_end = causal ? q_last / kBK : (L - 1) / kBK;
  const int first_key = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int kt_begin = first_key / kBK;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                // the last tile's Kt, Vs, Ps are read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int key = i / D, d = i % D, kpos = k0 + key;
      float kv = 0.f, vv = 0.f;
      if (kpos < L) {
        kv = load(kb, kpos * k_row + d);
        vv = load(vb, kpos * k_row + d);
      }
      Kt[d * kKS + key] = kv;
      Vs[key * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(r4 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Kt[d * kKS + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        ok[j] = kpos < L && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(r4 + i) * kKS + c + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[4], vv[kDC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r4 + i) * kKS + key];
#pragma unroll
      for (int j = 0; j < kDC; ++j) vv[j] = Vs[key * D + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + r4 + i;
    if (qpos >= L) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDC; ++j)
      store(ob, qpos * q_row + c + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t L, int64_t H, int64_t Hk, int causal,
                   int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd<T, D><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)L, (int)H, (int)Hk,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fedadc_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int64_t B, int64_t L, int64_t H,
                           int64_t Hk, int64_t D, int causal, int window,
                           float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return dtype == kBF16
               ? launch<__nv_bfloat16, 64>(q, k, v, o, B, L, H, Hk, causal,
                                           window, scale, st)
               : launch<float, 64>(q, k, v, o, B, L, H, Hk, causal, window,
                                   scale, st);
  if (D == 128)
    return dtype == kBF16
               ? launch<__nv_bfloat16, 128>(q, k, v, o, B, L, H, Hk, causal,
                                            window, scale, st)
               : launch<float, 128>(q, k, v, o, B, L, H, Hk, causal, window,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
