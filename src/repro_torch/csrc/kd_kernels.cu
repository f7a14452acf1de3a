// Hopper (sm_90a) kernels for the FedADC+ self-confidence KD loss
// (paper Sec. III, eqs. (7)-(9)), forward and backward.
//
//   fedadc_kd_loss_fwd   per row i with label y and confidence rho (C,):
//       p_t    = softmax(t / tau)
//       tgt_j  = clip((1 - rho_j) * p_t_j, 1e-9, 1)          j != y  (eq. 8)
//       tgt_y  = clip(1 - sum_{j != y} (1 - rho_j) * p_t_j)          (eq. 9)
//       ce     = logsumexp(s) - s_y
//       kl     = tau^2 * sum_j tgt_j * (log tgt_j - log softmax(s / tau)_j)
//       loss   = (1 - lam) * ce + lam * kl
//     and per-row statistics for the backward: logsumexp(s),
//     logsumexp(s / tau), logsumexp(t / tau), the true-class mass and
//     S = sum_j tgt_j.
//       replaces kd_loss.py:kd_loss (_kd_kernel); the Pallas kernel has no
//       backward, so fedadc_kd_loss_bwd has no TPU counterpart
//   fedadc_kd_loss_bwd   ds_j = g_i * [(1 - lam) * (softmax(s)_j - 1[j = y])
//                                      + lam * tau * (S * softmax(s / tau)_j - tgt_j)]
//     from the forward's statistics, one pass over the row.
//
// Bound: bytes. The forward reads s and t (B x C each) once from device
// memory, labels (B), rho (G x C), and writes 8 floats a row; it does a few
// tens of operations an element (three exps, a log, a divide), far under
// the card's ~20 fp32 operations per byte of HBM. At the main path's
// (512, 10) in fp32 that is about 62 KB, some 18 ns at 3.35 TB/s: the
// launch, not the bytes, sets its time. At (1024, 32768) it is 268 MB,
// some 80 us. The backward reads s, t and the statistics and writes ds.
//
// Design. One row is reduced by one warp (C <= 1024, the CNN's 10 and
// ResNet-18's 100 classes: eight rows a block) or by one 256-thread block
// (larger C, up to an LM vocabulary), with a loop over C, so any C works;
// the TPU kernel's whole-row VMEM block has no counterpart. The forward
// walks the row three times, the second and third reads coming mostly from
// L2: (1) the maxima of s and t/tau (max s/tau = max s / tau, division by
// tau > 0 being monotonic); (2) the three exp-sums; (3) the damped non-true
// mass, the KL sum and S over j != y. The true class's target needs the
// whole non-true sum (eq. 9), so its KL term and its share of S are added
// after the row's reduction, by every thread of the row alike.
//
// ``rho`` is (G, C) with rows_per_group consecutive rows to each group: G=1
// is one confidence vector for the batch (the reference's signature); G=K
// lets one launch carry the K clients of a round, each with its own rho.
//
// Inputs fp32 or bf16 (s and t the same type), labels int64 in [0, C),
// rho and statistics fp32, accumulation fp32; ds is written in the logits'
// type. Exact expf/logf, no fast-math intrinsics. A label outside [0, C)
// gives NaN in that row. Each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int64_t kWarpRowMaxC = 1024;   // above: one block a row
constexpr int kStats = 5;
constexpr float kClipLo = 1e-9f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, kClipLo), 1.0f);
}

// Reduce N values across the threads of one row: a warp (kRowThreads 32)
// or the whole block (kRowThreads kBlock, through `scratch`, kWarps * N
// floats). Every thread of the row gets the results.
template <int kRowThreads, bool kMax, int N>
__device__ __forceinline__ void row_reduce(float (&v)[N], float* scratch) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float other = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = kMax ? fmaxf(v[k], other) : v[k] + other;
    }
  }
  if (kRowThreads == 32) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous reduction's readers are done
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = lane < kWarps ? scratch[k * kWarps + lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      float other = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = kMax ? fmaxf(v[k], other) : v[k] + other;
    }
  }
}

// The row this thread works on and its index within the row.
template <int kRowThreads>
__device__ __forceinline__ void row_of(int64_t& row, int& tid) {
  if (kRowThreads == 32) {
    row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
    tid = threadIdx.x & 31;
  } else {
    row = blockIdx.x;
    tid = threadIdx.x;
  }
}

template <typename T, int kRowThreads>
__global__ void __launch_bounds__(kBlock)
kd_fwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
              const int64_t* __restrict__ labels,
              const float* __restrict__ rho, float* __restrict__ loss,
              float* __restrict__ ce_out, float* __restrict__ kl_out,
              float* __restrict__ stats, int64_t rows, int64_t C,
              int64_t rows_per_group, float lam, float tau) {
  __shared__ float scratch[3 * kWarps];
  int64_t row;
  int tid;
  row_of<kRowThreads>(row, tid);
  // a whole warp or block is out of range together, so no thread a
  // reduction waits for has left
  if (row >= rows) return;
  const T* s_row = s + row * C;
  const T* t_row = t + row * C;
  const float* rho_row = rho + (row / rows_per_group) * C;
  const int64_t y = labels[row];
  const bool valid = y >= 0 && y < C;

  // (1) maxima of s and t / tau
  float mx[2] = {-INFINITY, -INFINITY};
  for (int64_t j = tid; j < C; j += kRowThreads) {
    mx[0] = fmaxf(mx[0], load(s_row, j));
    mx[1] = fmaxf(mx[1], load(t_row, j) / tau);
  }
  row_reduce<kRowThreads, true>(mx, scratch);
  const float m_s = mx[0], m_st = mx[0] / tau, m_t = mx[1];

  // (2) exp-sums of s, s / tau and t / tau
  float z[3] = {0.0f, 0.0f, 0.0f};
  for (int64_t j = tid; j < C; j += kRowThreads) {
    const float sj = load(s_row, j);
    z[0] += expf(sj - m_s);
    z[1] += expf(sj / tau - m_st);
    z[2] += expf(load(t_row, j) / tau - m_t);
  }
  row_reduce<kRowThreads, false>(z, scratch);
  const float lse_s = logf(z[0]) + m_s;
  const float lse_st = logf(z[1]) + m_st;
  const float lse_t = logf(z[2]) + m_t;
  const float inv_zt = 1.0f / z[2];

  // (3) over the non-true classes: the damped mass, the KL sum and S
  float acc[3] = {0.0f, 0.0f, 0.0f};   // non-true mass, kl, S
  for (int64_t j = tid; j < C; j += kRowThreads) {
    if (j == y) continue;
    const float pt = expf(load(t_row, j) / tau - m_t) * inv_zt;
    const float d = (1.0f - rho_row[j]) * pt;
    const float tgt = clip(d);
    const float logp = load(s_row, j) / tau - lse_st;
    acc[0] += d;
    acc[1] += tgt * (logf(tgt) - logp);
    acc[2] += tgt;
  }
  row_reduce<kRowThreads, false>(acc, scratch);
  if (tid != 0) return;
  float ce = NAN, kl = NAN, true_mass = NAN, tsum = NAN;
  if (valid) {
    // the true class, once the whole non-true mass is known (eq. 9)
    const float s_y = load(s_row, y);
    true_mass = 1.0f - acc[0];
    const float tgt_y = clip(true_mass);
    kl = (acc[1] + tgt_y * (logf(tgt_y) - (s_y / tau - lse_st))) * (tau * tau);
    tsum = acc[2] + tgt_y;
    ce = lse_s - s_y;
  }
  loss[row] = (1.0f - lam) * ce + lam * kl;
  ce_out[row] = ce;
  kl_out[row] = kl;
  float* st = stats + row * kStats;
  st[0] = lse_s;
  st[1] = lse_st;
  st[2] = lse_t;
  st[3] = true_mass;
  st[4] = tsum;
}

template <typename T, int kRowThreads>
__global__ void __launch_bounds__(kBlock)
kd_bwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
              const int64_t* __restrict__ labels,
              const float* __restrict__ rho, const float* __restrict__ stats,
              const float* __restrict__ g, T* __restrict__ ds, int64_t rows,
              int64_t C, int64_t rows_per_group, float lam, float tau) {
  int64_t row;
  int tid;
  row_of<kRowThreads>(row, tid);
  if (row >= rows) return;
  const T* s_row = s + row * C;
  const T* t_row = t + row * C;
  const float* rho_row = rho + (row / rows_per_group) * C;
  const float* st = stats + row * kStats;
  const float lse_s = st[0], lse_st = st[1], lse_t = st[2];
  const float tgt_y = clip(st[3]), tsum = st[4];
  const int64_t y = labels[row];
  const float gi = g[row];
  const float a = gi * (1.0f - lam), b = gi * lam * tau;
  for (int64_t j = tid; j < C; j += kRowThreads) {
    const float sj = load(s_row, j);
    const float p = expf(sj - lse_s);
    const float p_tau = expf(sj / tau - lse_st);
    float tgt, hot;
    if (j == y) {
      tgt = tgt_y;
      hot = 1.0f;
    } else {
      tgt = clip((1.0f - rho_row[j]) * expf(load(t_row, j) / tau - lse_t));
      hot = 0.0f;
    }
    store(ds, row * C + j, a * (p - hot) + b * (tsum * p_tau - tgt));
  }
}

inline unsigned grid_for(int64_t rows, int64_t C) {
  return (unsigned)(C <= kWarpRowMaxC ? (rows + kWarps - 1) / kWarps : rows);
}

template <typename T>
void launch_fwd(const void* s, const void* t, const void* labels,
                const void* rho, void* loss, void* ce, void* kl, void* stats,
                int64_t rows, int64_t C, int64_t rpg, float lam, float tau,
                cudaStream_t st) {
  auto kernel = C <= kWarpRowMaxC ? kd_fwd_kernel<T, 32> : kd_fwd_kernel<T, kBlock>;
  kernel<<<grid_for(rows, C), kBlock, 0, st>>>(
      (const T*)s, (const T*)t, (const int64_t*)labels, (const float*)rho,
      (float*)loss, (float*)ce, (float*)kl, (float*)stats, rows, C, rpg, lam,
      tau);
}

template <typename T>
void launch_bwd(const void* s, const void* t, const void* labels,
                const void* rho, const void* stats, const void* g, void* ds,
                int64_t rows, int64_t C, int64_t rpg, float lam, float tau,
                cudaStream_t st) {
  auto kernel = C <= kWarpRowMaxC ? kd_bwd_kernel<T, 32> : kd_bwd_kernel<T, kBlock>;
  kernel<<<grid_for(rows, C), kBlock, 0, st>>>(
      (const T*)s, (const T*)t, (const int64_t*)labels, (const float*)rho,
      (const float*)stats, (const float*)g, (T*)ds, rows, C, rpg, lam, tau);
}

}  // namespace

extern "C" {

int fedadc_kd_loss_fwd(const void* s, const void* t, const void* labels,
                       const void* rho, void* loss, void* ce, void* kl,
                       void* stats, int64_t rows, int64_t C,
                       int64_t rows_per_group, float lam, float tau,
                       int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_per_group < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    launch_fwd<float>(s, t, labels, rho, loss, ce, kl, stats, rows, C,
                      rows_per_group, lam, tau, st);
  } else if (dtype == kBF16) {
    launch_fwd<__nv_bfloat16>(s, t, labels, rho, loss, ce, kl, stats, rows,
                              C, rows_per_group, lam, tau, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int fedadc_kd_loss_bwd(const void* s, const void* t, const void* labels,
                       const void* rho, const void* stats, const void* g,
                       void* ds, int64_t rows, int64_t C,
                       int64_t rows_per_group, float lam, float tau,
                       int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_per_group < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    launch_bwd<float>(s, t, labels, rho, stats, g, ds, rows, C,
                      rows_per_group, lam, tau, st);
  } else if (dtype == kBF16) {
    launch_bwd<__nv_bfloat16>(s, t, labels, rho, stats, g, ds, rows, C,
                              rows_per_group, lam, tau, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
