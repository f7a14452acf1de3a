// Hopper (sm_90a) kernel for the Mamba2 chunked SSD scan.
//
//   fedadc_ssd_scan   per (batch, head), over chunks of Q positions in order,
//       with acum the running sum of the log decay a within the chunk:
//         y_i = sum_{j <= i} (C_i . B_j) exp(acum_i - acum_j) x_j
//               + exp(acum_i) C_i h                        (intra + carried)
//         h  <- exp(acum_end) h + sum_j B_j^T exp(acum_end - acum_j) x_j
//     with h (N x P) zero at the first chunk. x is already x·dt and a the
//     per-step log decay -exp(A_log)·dt: the wrapper computes that prologue
//     and adds the D skip after, as the TPU kernel's caller does.
//     replaces ssd_scan.py:ssd_scan (_ssd_kernel), the Pallas kernel the JAX
//     package's Mamba2 blocks reach through ops.ssd_scan.
//
// Layout. x (b, L, H, P) fp32, a (b, L, H) fp32, B and C (b, L, H, N),
// y (b, L, H, P): the model's own layout, read with strides (the TPU kernel
// took (b, H, L, .) and its caller transposed).
//
// Bound. Per (batch, head, chunk) the work is about 2Q^2N + 2Q^2P + 4QNP
// flops counting the whole Q x Q tile (half of it is causally masked and
// skipped here); at zamba2-1.2b's prefill shape (b 4, L 2048, H 64, P 64,
// N 64, Q 256) that is ~4.3e10 flops, 0.64 ms at 67 TFLOP/s of fp32, against
// ~0.54 GB of operands and output, 0.16 ms at 3.35 TB/s: bound by
// operations.
//
// Design. The TPU kernel carries h across a sequential grid axis in VMEM
// scratch. Here one 256-thread block owns one (batch, head) and loops over
// its chunks in order, h (64 x 64 fp32, 16 KB) staying in shared memory
// throughout. Each chunk stages x (Q x 64) and B (Q x (N+1)) in shared
// memory with the running sums of a (a block-wide scan), then walks query
// tiles of 64 rows: the Q x Q score tile (256 KB at Q 256, more than the
// 227 KB a block may have) is never staged whole; for each query tile the
// block computes the carried term exp(acum_i) C_i h and then, per key tile
// of 64 at or below the diagonal, the 64 x 64 gated scores into shared
// memory and their product with x. Thread t owns rows 4·(t/16)..+3 and
// columns t%16 + 16·j of each 64 x 64 tile. After the last query tile the
// block folds the chunk into h. Positions past L (a ragged last chunk, as
// the Pallas kernel's cdiv grid gives) load as zeros: x, B and C zero and
// a 0, so they change neither y nor h, and their rows are not written.
// Shared memory is ~186 KB at Q 256, N 64, so one block runs on an SM; at
// batch 1 zamba2 has 64 (batch, head) blocks for 132 SMs. Splitting the
// chunks over blocks (the state passing in a second pass) is later work.
// Limits: P <= 64, N <= 64, Q <= 256.
//
// x and a fp32; B and C fp32 or bf16; y fp32 or bf16; arithmetic and
// accumulation fp32, except the running sums of a, which are kept in double
// (see the scan below). Exact expf and exp, no fast-math intrinsics.
// Launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;              // query and key tile
constexpr int kTS = kT + 1;         // padded row of the score tile
constexpr int kMaxP = 64;           // x and h row stride (P <= 64)
constexpr int kMaxN = 64;
constexpr int kMaxQ = 256;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

size_t smem_bytes(int Qpad, int N) {
  // acum (double), x, B, exp(acum), decay-to-end weights, h, one C tile,
  // one score tile
  return sizeof(double) * (size_t)Qpad +
         sizeof(float) * ((size_t)Qpad * kMaxP + (size_t)Qpad * (N + 1) +
                          2 * (size_t)Qpad + kMaxN * kMaxP + kT * (N + 1) +
                          kT * kTS);
}

template <typename TB, typename TY>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const float* __restrict__ x, const float* __restrict__ a,
        const TB* __restrict__ Bm, const TB* __restrict__ Cm,
        TY* __restrict__ y, int L, int H, int P, int N, int Q) {
  const int Qpad = (Q + kT - 1) / kT * kT;
  const int NS = N + 1;
  extern __shared__ double smem_d[];
  double* acum = smem_d;               // [Qpad] running sum of a
  float* xs = reinterpret_cast<float*>(acum + Qpad);  // [Qpad][kMaxP]
  float* Bs = xs + Qpad * kMaxP;       // [Qpad][NS]
  float* gq = Bs + Qpad * NS;          // [Qpad] exp(acum_i)
  float* wend = gq + Qpad;             // [Qpad] exp(acum_end - acum_j)
  float* hs = wend + Qpad;             // [kMaxN][kMaxP]
  float* Cs = hs + kMaxN * kMaxP;      // [kT][NS]
  float* Ss = Cs + kT * NS;            // [kT][kTS]

  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x;
  const int r4 = (tid / 16) * 4;
  const int c = tid % 16;

  // position t of this (batch, head): x at xb + t*x_row, etc.
  const int64_t x_row = (int64_t)H * P, n_row = (int64_t)H * N;
  const float* xb = x + ((int64_t)b * L * H + hh) * P;
  const float* ab = a + (int64_t)b * L * H + hh;
  const TB* Bb = Bm + ((int64_t)b * L * H + hh) * N;
  const TB* Cb = Cm + ((int64_t)b * L * H + hh) * N;
  TY* yb = y + ((int64_t)b * L * H + hh) * P;

  for (int i = tid; i < kMaxN * kMaxP; i += kThreads) hs[i] = 0.f;

  const int n_chunks = (L + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    __syncthreads();                  // the last chunk's state update is done
    // running sum of a over the chunk (Hillis-Steele, one element a
    // thread), in double: the gates are exp of differences of these sums,
    // which reach some -1e4 over a chunk, and fp32 would lose their low
    // digits (7e-5 of the output at zamba2's decays, over the 2e-5 bar)
    double av = 0.0;
    if (tid < Q && t0 + tid < L) av = ab[(int64_t)(t0 + tid) * H];
    if (tid < Qpad) acum[tid] = av;
    __syncthreads();
    for (int off = 1; off < Qpad; off <<= 1) {
      const double add = (tid < Qpad && tid >= off) ? acum[tid - off] : 0.0;
      __syncthreads();
      if (tid < Qpad) acum[tid] += add;
      __syncthreads();
    }
    for (int i = tid; i < Qpad * kMaxP; i += kThreads) {
      const int row = i / kMaxP, p = i % kMaxP, t = t0 + row;
      xs[i] = (row < Q && p < P && t < L) ? xb[t * x_row + p] : 0.f;
    }
    for (int i = tid; i < Qpad * NS; i += kThreads) {
      const int row = i / NS, n = i % NS, t = t0 + row;
      Bs[i] = (row < Q && n < N && t < L) ? load(Bb, t * n_row + n) : 0.f;
    }
    const double a_end = acum[Q - 1];
    if (tid < Qpad) {
      gq[tid] = (float)exp(acum[tid]);
      wend[tid] = (float)exp(a_end - acum[tid]);
    }
    __syncthreads();

    for (int q0 = 0; q0 < Q; q0 += kT) {
      for (int i = tid; i < kT * NS; i += kThreads) {
        const int row = i / NS, n = i % NS, t = t0 + q0 + row;
        Cs[i] = (q0 + row < Q && n < N && t < L) ? load(Cb, t * n_row + n)
                                                 : 0.f;
      }
      __syncthreads();
      // carried state: exp(acum_i) C_i h
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(r4 + i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[n * kMaxP + c + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = gq[q0 + r4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g;
      }
      // within the chunk: key tiles at or below the diagonal
      for (int k0 = 0; k0 <= q0; k0 += kT) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(r4 + i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(k0 + c + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = q0 + r4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k0 + c + 16 * j;
            Ss[(r4 + i) * kTS + c + 16 * j] =
                kj <= qi ? s[i][j] * expf((float)(acum[qi] - acum[kj])) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kT; ++kk) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = Ss[(r4 + i) * kTS + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[(k0 + kk) * kMaxP + c + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
        __syncthreads();              // Ss is rewritten by the next key tile
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r4 + i, t = t0 + row;
        if (row >= Q || t >= L) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = c + 16 * j;
          if (p < P) store(yb, t * x_row + p, acc[i][j]);
        }
      }
      __syncthreads();                // Cs is reloaded by the next query tile
    }

    // fold the chunk into the state: h = exp(a_end) h + B^T (w x)
    const float g_end = (float)exp(a_end);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = r4 + i;
      if (n >= N) continue;
      float hacc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hacc[j] = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float bw = Bs[t * NS + n] * wend[t];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hacc[j] = fmaf(bw, xs[t * kMaxP + c + 16 * j], hacc[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* hp = hs + n * kMaxP + c + 16 * j;
        *hp = g_end * *hp + hacc[j];
      }
    }
  }
}

template <typename TB, typename TY>
cudaError_t launch(const void* x, const void* a, const void* B, const void* C,
                   void* y, int64_t batch, int64_t L, int64_t H, int64_t P,
                   int64_t N, int64_t Q, cudaStream_t st) {
  const int Qpad = (int)((Q + kT - 1) / kT * kT);
  const size_t bytes = smem_bytes(Qpad, (int)N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<TB, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<TB, TY><<<(unsigned)(batch * H), kThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const TB*>(B), static_cast<const TB*>(C),
      static_cast<TY*>(y), (int)L, (int)H, (int)P, (int)N, (int)Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fedadc_ssd_scan(const void* x, const void* a, const void* B,
                    const void* C, void* y, int64_t batch, int64_t L,
                    int64_t H, int64_t P, int64_t N, int64_t Q, int bc_dtype,
                    int y_dtype, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == kBF16)
    return y_dtype == kBF16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, a, B, C, y, batch, L,
                                                      H, P, N, Q, st)
               : launch<__nv_bfloat16, float>(x, a, B, C, y, batch, L, H, P,
                                              N, Q, st);
  return y_dtype == kBF16
             ? launch<float, __nv_bfloat16>(x, a, B, C, y, batch, L, H, P, N,
                                            Q, st)
             : launch<float, float>(x, a, B, C, y, batch, L, H, P, N, Q, st);
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
