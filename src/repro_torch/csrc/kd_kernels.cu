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
//     from the forward's statistics, one elementwise pass.
//
// Bound: bytes. The forward reads s and t (B x C each) once from device
// memory, labels (B), rho (G x C), and writes 8 floats a row. At the main
// path's (512, 10) in fp32 that is about 62 KB, some 18 ns at 3.35 TB/s:
// the launch, not the bytes, sets its time. At (1024, 32768) it is 268 MB,
// some 80 us, and its per-element work (three exps, a log, about twenty
// adds, multiplies and compares) is of the same order on the CUDA cores.
// The backward reads s, t, rho and the statistics and writes ds: at
// (1024, 32768) in fp32 402 MB, some 120 us, against two exps (tau = 1) or
// three and two divides and about a dozen other operations an element.
//
// Design of the backward: each element is one term of closed form, so a
// CTA takes a tile of the flattened logits (a row's chunk, or whole short
// rows), wherever the rows end: every shape fills the card. s and t come
// as 16-byte words with streaming hints, ds goes out the same way, and each
// row's values are read once a tile. At tau = 1 p stands for softmax(s /
// tau) on every row whose lse_st is its lse_s bit for bit (one exp fewer).
//
// Design of the forward: each row is read from device memory once. The
// reductions it needs come in two steps: the three log-sum-exps (of s,
// s/tau and t/tau), then, given logsumexp(t/tau), the damped non-true mass,
// the KL sum and S over j != y. The second step cannot fold into the first
// (each target is clipped: no running rescale makes its sum exact), so the
// row stays on chip between them:
//   - C <= kWarpRowMaxC (the CNN's 10 and ResNet-18's 100 classes): a warp
//     a row, eight rows a block, each lane holding its classes lane + 32k
//     of s and t in registers (kPer of each, C <= 32 kPer);
//   - larger C (an LM vocabulary): a thread-block cluster a row, of up to
//     kMaxCluster CTAs, each staging a slice of the row's s and t in shared
//     memory by two bulk copies (TMA) completing on an mbarrier, the few
//     elements off a 16-byte boundary loaded by threads. The slice is sized
//     so s and t take at most kSliceBytes, three CTAs an SM (the copies of
//     one overlap the others' work). The reductions cross the cluster
//     through distributed shared memory;
//   - C above what a cluster stages (max_classes in kd_loss.py: 231,360 in
//     fp32, 462,784 in bf16): a row split over
//     cdiv(C, kSplitSlice) CTAs that no cluster ties, in three kernels.
//     (1) each CTA holds its slice in registers (kSplitPer classes a
//     thread) and writes its partial log-sum-exps; (2) each CTA merges its
//     row's partials in one fixed order (every CTA of the row gets the same
//     bits; the first writes them for (3)), reads its slice again and
//     writes its partial non-true sums; (3) a warp a row adds the partials
//     in order and writes the row.  The row is read twice from device
//     memory, since no running rescale folds the clipped targets into the
//     first reduction.
// The maxima and exp-sums are one reduction: each thread forms (max, sum
// of exp(x - max)) of its values, and partials merge by rescaling the sum
// of the smaller max (Lse below). The true class's target needs the whole
// non-true sum (eq. 9), so its KL term and its share of S are added after
// the row's reduction, from the s_y that the thread holding it hands on.
//
// ``rho`` is (G, C) with rows_per_group consecutive rows to each group: G=1
// is one confidence vector for the batch (the reference's signature); G=K
// lets one launch carry the K clients of a round, each with its own rho.
//
// Inputs fp32 or bf16 (s and t the same type), labels int64 in [0, C),
// rho and statistics fp32, accumulation fp32; ds is written in the logits'
// type. Exact expf/logf, no fast-math intrinsics; the forward scales by
// 1/tau (exact for tau a power of two), the backward divides by tau.
// A label outside [0, C) gives NaN in that row; +-inf logits give the
// log-sum-exps torch.logsumexp gives. Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "leaf_table.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// the cluster route's CTA: threads, and CTAs an SM (its launch bounds)
constexpr int kCtaThreads = 256;
constexpr int kCtaWarps = kCtaThreads / 32;
constexpr int kCtasPerSm = 3;
constexpr int64_t kWarpRowMaxC = 1024;   // above: a cluster a row
constexpr int kStats = 5;
constexpr float kClipLo = 1e-9f;
constexpr int64_t kSliceBytes = 65536;   // s and t of a CTA's slice
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int64_t kMaxDynSmem = 232448 - 1024;   // less the static part
// the split route: classes a thread holds, and a CTA's slice
constexpr int kSplitPer = 32;
constexpr int64_t kSplitSlice = (int64_t)kSplitPer * kCtaThreads;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
// The forward's clip keeps a NaN, as torch.clamp and jnp.clip do (fminf
// and fmaxf drop it): an undefined target stays undefined in the loss.
__device__ __forceinline__ float clip_target(float x) {
  return isnan(x) ? x : clip(x);
}

// A partial log-sum-exp: m the largest value, z = sum exp(x - base(m)),
// where base(m) = m if finite, else 0 (torch.logsumexp's shift), so an
// empty or all -inf partial is (-inf, 0) and one holding +inf is (+inf,
// inf): no inf - inf. Merging rescales each sum to the larger maximum; a
// zero sum stays zero (an all -inf partial), a NaN propagates. The merge is
// commutative bit for bit, so every lane of a butterfly ends alike.
struct Lse {
  float m, z;
};
__device__ __forceinline__ float lse_base(float m) {
  return isinf(m) ? 0.0f : m;
}
__device__ __forceinline__ float rescaled(Lse a, float base) {
  return a.z == 0.0f ? 0.0f : a.z * expf(lse_base(a.m) - base);
}
__device__ __forceinline__ Lse lse_merge(Lse a, Lse b) {
  const float m = fmaxf(a.m, b.m), base = lse_base(m);
  return {m, rescaled(a, base) + rescaled(b, base)};
}
__device__ __forceinline__ float lse_value(Lse a) {
  return logf(a.z) + lse_base(a.m);
}
__device__ __forceinline__ void warp_merge(Lse (&p)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Lse other = {__shfl_xor_sync(0xffffffffu, p[k].m, o),
                         __shfl_xor_sync(0xffffffffu, p[k].z, o)};
      p[k] = lse_merge(p[k], other);
    }
  }
}
__device__ __forceinline__ void warp_sum(float (&v)[3]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

// One term of the second step, class j != y: the damped teacher mass d,
// its target and the KL term, added to acc (non-true mass, kl, S) unless
// `skip` (the true class: a select, so its term's value never matters).
__device__ __forceinline__ void target_term(float s_j, float t_over_tau,
                                            float rho_j, float base_t,
                                            float inv_zt, float inv_tau,
                                            float lse_st, bool skip,
                                            float (&acc)[3]) {
  const float pt = expf(t_over_tau - base_t) * inv_zt;
  const float d = (1.0f - rho_j) * pt;
  const float tgt = clip_target(d);
  const float kl = tgt * (logf(tgt) - (s_j * inv_tau - lse_st));
  acc[0] += skip ? 0.0f : d;
  acc[1] += skip ? 0.0f : kl;
  acc[2] += skip ? 0.0f : tgt;
}

// A row's outputs from its log-sum-exps and non-true sums: the true class
// once the whole non-true mass is known (eq. 9).
__device__ __forceinline__ void write_row(
    int64_t row, bool valid, float lse_s, float lse_st, float lse_t,
    const float (&acc)[3], float s_y, float lam, float tau,
    float* __restrict__ loss, float* __restrict__ ce_out,
    float* __restrict__ kl_out, float* __restrict__ stats) {
  float ce = NAN, kl = NAN, true_mass = NAN, tsum = NAN;
  if (valid) {
    true_mass = 1.0f - acc[0];
    const float tgt_y = clip_target(true_mass);
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

// C <= 32 kPer: a warp a row, the row in registers.
template <typename T, int kPer>
__global__ void __launch_bounds__(kBlock)
kd_fwd_warp_kernel(const T* __restrict__ s, const T* __restrict__ t,
                   const int64_t* __restrict__ labels,
                   const float* __restrict__ rho, float* __restrict__ loss,
                   float* __restrict__ ce_out, float* __restrict__ kl_out,
                   float* __restrict__ stats, int64_t rows, int64_t C,
                   int64_t rows_per_group, float lam, float tau) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // a whole warp is out of range together
  if (row >= rows) return;
  const T* s_row = s + row * C;
  const T* t_row = t + row * C;
  const float* rho_row = rho + (row / rows_per_group) * C;
  const int64_t y = labels[row];
  const float inv_tau = 1.0f / tau;
  // the lane's classes lane + 32k, t already over tau; -inf past C
  float sv[kPer], tv[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = lane + 32 * k;
    sv[k] = j < C ? load(s_row, j) : -INFINITY;
    tv[k] = j < C ? load(t_row, j) * inv_tau : -INFINITY;
  }
  float ms = -INFINITY, mt = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    ms = fmaxf(ms, sv[k]);
    mt = fmaxf(mt, tv[k]);
  }
  const float mst = ms * inv_tau;
  const float bs = lse_base(ms), bst = lse_base(mst), bt = lse_base(mt);
  float zs = 0.0f, zst = 0.0f, zt = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    zs += expf(sv[k] - bs);
    zst += expf(sv[k] * inv_tau - bst);
    zt += expf(tv[k] - bt);
  }
  Lse part[3] = {{ms, zs}, {mst, zst}, {mt, zt}};
  warp_merge(part);
  const float lse_s = lse_value(part[0]), lse_st = lse_value(part[1]);
  const float lse_t = lse_value(part[2]);
  const float base_t = lse_base(part[2].m), inv_zt = 1.0f / part[2].z;
  float acc[3] = {0.0f, 0.0f, 0.0f}, mine = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = lane + 32 * k;
    if (j == y) mine = sv[k];
    if (j < C)
      target_term(sv[k], tv[k], rho_row[j], base_t, inv_zt, inv_tau, lse_st,
                  j == y, acc);
  }
  warp_sum(acc);
  const float s_y = __shfl_sync(0xffffffffu, mine, (int)(y & 31));
  if (lane == 0)
    write_row(row, y >= 0 && y < C, lse_s, lse_st, lse_t, acc, s_y, lam, tau,
              loss, ce_out, kl_out, stats);
}

// The part of a slice that bulk copies take: elements [head, tail), from
// the first to the last 16-byte boundary in it, `bytes` long.
struct Span {
  int64_t head, tail;
  uint32_t bytes;
};
template <typename T>
__device__ __forceinline__ Span span_of(const T* g, int64_t n) {
  const int64_t e = sizeof(T);
  const int64_t head = min(n, (int64_t)((16 - ((uintptr_t)g & 15)) & 15) / e);
  const int64_t tail = head + (n - head) * e / 16 * 16 / e;
  return {head, tail, (uint32_t)((tail - head) * e)};
}

// Stage n elements at g into the slot at `slot`, placed at g's offset from
// a 16-byte boundary so the bulk part lands aligned -> where element 0 sits.
// One thread issues the bulk copy on `bar`; every thread loads its share of
// the head and tail.
template <typename T>
__device__ __forceinline__ T* stage(unsigned char* slot, const T* g,
                                    int64_t n, uint32_t bar) {
  T* dst = reinterpret_cast<T*>(slot + ((uintptr_t)g & 15));
  const Span sp = span_of(g, n);
  if (threadIdx.x == 0 && sp.bytes)
    hopper::bulk_load(hopper::smem_u32(dst + sp.head), g + sp.head, sp.bytes,
                      bar);
  for (int64_t i = threadIdx.x; i < sp.head; i += kCtaThreads) dst[i] = g[i];
  for (int64_t i = sp.tail + threadIdx.x; i < n; i += kCtaThreads)
    dst[i] = g[i];
  return dst;
}

// C > kWarpRowMaxC: a cluster of cl CTAs a row (blockIdx.x / cl), CTA r
// taking the row's classes [r slice, (r + 1) slice).
template <typename T>
__global__ void __launch_bounds__(kCtaThreads, kCtasPerSm)
kd_fwd_cluster_kernel(const T* __restrict__ s, const T* __restrict__ t,
                      const int64_t* __restrict__ labels,
                      const float* __restrict__ rho, float* __restrict__ loss,
                      float* __restrict__ ce_out, float* __restrict__ kl_out,
                      float* __restrict__ stats, int64_t C, int64_t slice,
                      int64_t rows_per_group, float lam, float tau) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Lse warp_part[kCtaWarps][3], cta_part[3], total[3];
  __shared__ float warp_acc[kCtaWarps][3], cta_acc[3], s_y;
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = blockIdx.x / cl;
  const int64_t lo = rank * slice;
  const int64_t n = max(min(C, lo + slice) - lo, (int64_t)0);
  const T* gs = s + row * C + lo;
  const T* gt = t + row * C + lo;

  // -- stage the slice: s then t, each slot slice elements + 16 bytes ------
  const uint32_t bar_a = hopper::smem_u32(&bar);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    hopper::mbar_expect_tx(bar_a,
                           span_of(gs, n).bytes + span_of(gt, n).bytes);
  const T* ss = stage(smem, gs, n, bar_a);
  const T* ts = stage(smem + slice * sizeof(T) + 16, gt, n, bar_a);
  __syncthreads();
  hopper::mbar_wait(bar_a, 0);

  // -- the three log-sum-exps: the thread's, merged over the cluster -------
  const float inv_tau = 1.0f / tau;
  const bool unit_tau = tau == 1.0f;   // s/tau is s: one exp fewer
  float ms = -INFINITY, mt = -INFINITY;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n; i += kCtaThreads) {
    ms = fmaxf(ms, to_f(ss[i]));
    mt = fmaxf(mt, to_f(ts[i]));
  }
  mt *= inv_tau;   // a positive scale keeps the maximum's place
  const float mst = ms * inv_tau;
  const float bs = lse_base(ms), bst = lse_base(mst), bt = lse_base(mt);
  float zs = 0.0f, zst = 0.0f, zt = 0.0f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n; i += kCtaThreads) {
    const float x = to_f(ss[i]);
    zs += expf(x - bs);
    if (!unit_tau) zst += expf(x * inv_tau - bst);
    zt += expf(to_f(ts[i]) * inv_tau - bt);
  }
  Lse part[3] = {{ms, zs}, {mst, unit_tau ? zs : zst}, {mt, zt}};
  warp_merge(part);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_part[warp][k] = part[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      part[k] = lane < kCtaWarps ? warp_part[lane][k] : Lse{-INFINITY, 0.0f};
    warp_merge(part);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) cta_part[k] = part[k];
    }
  }
  cluster.sync();
  if (warp == 0) {
    const Lse* remote = cluster.map_shared_rank(cta_part, lane < cl ? lane : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      part[k] = lane < cl ? remote[k] : Lse{-INFINITY, 0.0f};
    warp_merge(part);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) total[k] = part[k];
    }
  }
  __syncthreads();

  // -- the non-true sums over the slice, summed over the cluster -----------
  const float lse_s = lse_value(total[0]), lse_st = lse_value(total[1]);
  const float lse_t = lse_value(total[2]);
  const float base_t = lse_base(total[2].m), inv_zt = 1.0f / total[2].z;
  const int64_t y = labels[row];
  const float* rho_sl = rho + (row / rows_per_group) * C + lo;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n; i += kCtaThreads) {
    const float sj = to_f(ss[i]);
    if (lo + i == y) s_y = sj;
    target_term(sj, to_f(ts[i]) * inv_tau, rho_sl[i], base_t, inv_zt,
                inv_tau, lse_st, lo + i == y, acc);
  }
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_acc[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float a = 0.0f;
      for (int w = 0; w < kCtaWarps; ++w) a += warp_acc[w][k];
      cta_acc[k] = a;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float a[3] = {0.0f, 0.0f, 0.0f};
    for (int r = 0; r < cl; ++r) {
      const float* remote = cluster.map_shared_rank(cta_acc, r);
#pragma unroll
      for (int k = 0; k < 3; ++k) a[k] += remote[k];
    }
    const bool valid = y >= 0 && y < C;
    const float sy =
        valid ? *cluster.map_shared_rank(&s_y, (unsigned)(y / slice)) : 0.0f;
    write_row(row, valid, lse_s, lse_st, lse_t, a, sy, lam, tau, loss, ce_out,
              kl_out, stats);
  }
  cluster.sync();   // no CTA leaves while rank 0 reads its shared memory
}

// -- the split route: a row over CTAs that no cluster ties ------------------
//
// Scratch (fp32, the wrapper's): part_lse (rows x parts x 3 Lse), part_acc
// (rows x parts x 3 floats), row_lse (rows x 3 Lse).  CTA b takes slice
// b % parts of row b / parts: classes [slice kSplitSlice, ...), thread t
// the classes t + kCtaThreads j, j < kSplitPer.

// The block's merge of three partials (warp butterflies, then warp 0 over
// the warps' in warp order) -> every thread's copy of the block's result.
__device__ __forceinline__ void block_merge(Lse (&p)[3]) {
  __shared__ Lse warp_part[kCtaWarps][3], result[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_merge(p);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_part[warp][k] = p[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = lane < kCtaWarps ? warp_part[lane][k] : Lse{-INFINITY, 0.0f};
    warp_merge(p);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) result[k] = p[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = result[k];
}

// (1) the slice's three log-sum-exps, of s, s / tau and t / tau.
template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
kd_split_lse_kernel(const T* __restrict__ s, const T* __restrict__ t,
                    int64_t C, int64_t parts, float tau,
                    Lse* __restrict__ part_lse) {
  const int64_t row = blockIdx.x / parts, part = blockIdx.x % parts;
  const int64_t lo = part * kSplitSlice;
  const T* s_row = s + row * C;
  const T* t_row = t + row * C;
  const float inv_tau = 1.0f / tau;
  float sv[kSplitPer], tv[kSplitPer];
#pragma unroll
  for (int k = 0; k < kSplitPer; ++k) {
    const int64_t j = lo + threadIdx.x + (int64_t)kCtaThreads * k;
    sv[k] = j < C ? load(s_row, j) : -INFINITY;
    tv[k] = j < C ? load(t_row, j) * inv_tau : -INFINITY;
  }
  float ms = -INFINITY, mt = -INFINITY;
#pragma unroll
  for (int k = 0; k < kSplitPer; ++k) {
    ms = fmaxf(ms, sv[k]);
    mt = fmaxf(mt, tv[k]);
  }
  const float mst = ms * inv_tau;
  const float bs = lse_base(ms), bst = lse_base(mst), bt = lse_base(mt);
  float zs = 0.0f, zst = 0.0f, zt = 0.0f;
#pragma unroll
  for (int k = 0; k < kSplitPer; ++k) {
    zs += expf(sv[k] - bs);
    zst += expf(sv[k] * inv_tau - bst);
    zt += expf(tv[k] - bt);
  }
  Lse part_[3] = {{ms, zs}, {mst, zst}, {mt, zt}};
  block_merge(part_);
  if (threadIdx.x < 3) part_lse[blockIdx.x * 3 + threadIdx.x] =
      part_[threadIdx.x];
}

// (2) the row's log-sum-exps from its partials, then the slice's non-true
// sums (damped mass, KL, S) given logsumexp(t / tau).
template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
kd_split_terms_kernel(const T* __restrict__ s, const T* __restrict__ t,
                      const int64_t* __restrict__ labels,
                      const float* __restrict__ rho, int64_t C,
                      int64_t parts, int64_t rows_per_group, float tau,
                      const Lse* __restrict__ part_lse,
                      float* __restrict__ part_acc, Lse* __restrict__ row_lse) {
  __shared__ float warp_acc[kCtaWarps][3];
  const int64_t row = blockIdx.x / parts, part = blockIdx.x % parts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Lse tot[3] = {{-INFINITY, 0.0f}, {-INFINITY, 0.0f}, {-INFINITY, 0.0f}};
  for (int64_t q = threadIdx.x; q < parts; q += kCtaThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tot[k] = lse_merge(tot[k], part_lse[(row * parts + q) * 3 + k]);
  }
  block_merge(tot);
  if (part == 0 && threadIdx.x < 3) row_lse[row * 3 + threadIdx.x] =
      tot[threadIdx.x];
  const float inv_tau = 1.0f / tau;
  const float lse_st = lse_value(tot[1]);
  const float base_t = lse_base(tot[2].m), inv_zt = 1.0f / tot[2].z;
  const int64_t y = labels[row];
  const int64_t lo = part * kSplitSlice;
  const T* s_row = s + row * C;
  const T* t_row = t + row * C;
  const float* rho_row = rho + (row / rows_per_group) * C;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 8
  for (int k = 0; k < kSplitPer; ++k) {
    const int64_t j = lo + threadIdx.x + (int64_t)kCtaThreads * k;
    if (j < C)
      target_term(load(s_row, j), load(t_row, j) * inv_tau, rho_row[j],
                  base_t, inv_zt, inv_tau, lse_st, j == y, acc);
  }
  warp_sum(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) warp_acc[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float a = 0.0f;
    for (int w = 0; w < kCtaWarps; ++w) a += warp_acc[w][threadIdx.x];
    part_acc[blockIdx.x * 3 + threadIdx.x] = a;
  }
}

// (3) a warp a row: the partial sums in order, then the row's outputs.
template <typename T>
__global__ void __launch_bounds__(kBlock)
kd_split_finish_kernel(const T* __restrict__ s,
                       const int64_t* __restrict__ labels, int64_t rows,
                       int64_t C, int64_t parts,
                       const float* __restrict__ part_acc,
                       const Lse* __restrict__ row_lse, float lam, float tau,
                       float* __restrict__ loss, float* __restrict__ ce_out,
                       float* __restrict__ kl_out, float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int64_t q = lane; q < parts; q += 32) {
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += part_acc[(row * parts + q) * 3 + k];
  }
  warp_sum(acc);
  if (lane == 0) {
    const int64_t y = labels[row];
    const bool valid = y >= 0 && y < C;
    const float s_y = valid ? load(s + row * C, y) : 0.0f;
    const Lse* tot = row_lse + row * 3;
    write_row(row, valid, lse_value(tot[0]), lse_value(tot[1]),
              lse_value(tot[2]), acc, s_y, lam, tau, loss, ce_out, kl_out,
              stats);
  }
}

// -- the backward: one elementwise pass over tiles of the flattened logits --
//
// ds_j needs only its own s_j, t_j and rho_j and five statistics of its row,
// so no reduction ties a row to a CTA: a CTA takes a tile of at most
// kBwdTile elements of the flattened (rows x C) logits.  C > kBwdTile: a
// tile is one row's chunk of kBwdTile classes (the last shorter), so 8 rows
// of 32768 classes make 256 CTAs; C <= kBwdTile: a tile is
// min(kBwdTile / C, kBwdMaxRows) whole rows, so at C = 10 no lane is idle.

// A row's share of the backward: the forward's statistics, the clipped
// true-class target, the upstream gradient, and the label (-1 when out of
// range: no class matches it, and S is NaN there).
struct __align__(16) BwdRow {
  float lse_s, lse_st, lse_t, tgt_y, tsum, g;
  int y;
};

__device__ __forceinline__ BwdRow bwd_row(const float* __restrict__ stats,
                                          const int64_t* __restrict__ labels,
                                          const float* __restrict__ g,
                                          int64_t row, int64_t C) {
  const float* st = stats + row * kStats;
  const int64_t y = labels[row];
  BwdRow r;
  r.lse_s = st[0];
  r.lse_st = st[1];
  r.lse_t = st[2];
  r.tgt_y = clip_target(st[3]);
  r.tsum = st[4];
  r.g = g[row];
  r.y = y >= 0 && y < C ? (int)y : -1;
  return r;
}

// The weights of the two terms, w_ce = 1 - lam and w_kd = lam tau, and
// 1 / tau, each rounded once to fp32 from the caller's double, as torch
// rounds a number that scales or divides a tensor on the card.
struct BwdScale {
  float w_ce, w_kd, inv_tau;
};

// ds of one element, rounded step by step as ref.kd_loss_bwd's torch ops
// round on the card (no FMA: __fmul_rn and __fadd_rn are never
// contracted; t / tau is t * fp32(1 / tau), as torch divides a tensor by a
// number), so a ds rounded to bf16 rounds where the plain version's does.
// p_tau is p itself on a row whose lse_st equals its lse_s bit for bit: at
// 1 / tau = 1 s / tau is s, and both forwards (the kernel's and
// ref.kd_loss) then give lse_st == lse_s.
template <bool kUnitTau, bool kShared>
__device__ __forceinline__ float bwd_elem(float sj, float tj, float rho_j,
                                          bool is_y, const BwdRow& r,
                                          const BwdScale& w) {
  const float p = expf(sj - r.lse_s);
  float p_tau, pt;
  if (kUnitTau) {
    p_tau = kShared ? p : expf(sj - r.lse_st);
    pt = expf(tj - r.lse_t);
  } else {
    p_tau = expf(__fmul_rn(sj, w.inv_tau) - r.lse_st);
    pt = expf(__fmul_rn(tj, w.inv_tau) - r.lse_t);
  }
  const float tgt =
      is_y ? r.tgt_y : clip_target(__fmul_rn(1.0f - rho_j, pt));
  const float ce = __fmul_rn(w.w_ce, p - (is_y ? 1.0f : 0.0f));
  const float kd = __fmul_rn(w.w_kd, __fmul_rn(r.tsum, p_tau) - tgt);
  return __fmul_rn(r.g, __fadd_rn(ce, kd));
}

constexpr int kBwdTile = 1024;     // elements a tile at most
constexpr int kBwdWords = 2;       // 16-byte words of s (and of t) a thread
constexpr int kBwdMaxRows = 256;   // whole rows a tile at most (C <= kBwdTile)
template <typename T>
constexpr int kBwdThreads = kBwdTile / (kBwdWords * (16 / (int)sizeof(T)));

// One tile.  kWide: row `tile / per_tile`, its chunk `tile % per_tile`, the
// row's values in registers.  Else rows [tile per_tile, ...), their values
// staged in shared memory once a row; element k of the tile is in tile row
// k / C, found as __umulhi(k, magic) with magic = ceil(2^32 / C) (exact for
// k C < 2^32; magic 0 is C = 1).  Where s, t and ds share their offset from
// a 16-byte boundary, the tile's body goes as 16-byte words with streaming
// hints (each byte is touched once), kBwdWords a thread, all in flight
// before the rows' values load; the head before the first boundary and
// the tail after the last word go one element a thread.  Otherwise every
// element goes alone.  rho (G x C, re-read by every row of its group)
// comes through the read-only path.  kUnitTau (1 / tau == 1): p for p_tau
// where the tile's every row has lse_st == lse_s, and no scaling by 1 / tau.
template <typename T, bool kWide, bool kUnitTau>
__global__ void __launch_bounds__(kBwdThreads<T>)
kd_bwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
              const int64_t* __restrict__ labels,
              const float* __restrict__ rho, const float* __restrict__ stats,
              const float* __restrict__ g, T* __restrict__ ds, int64_t rows,
              int64_t C, int64_t rows_per_group, int64_t per_tile,
              uint32_t magic, BwdScale w) {
  using V = leaf_table::Vec16<T>;
  constexpr int kThreads = kBwdThreads<T>;
  __shared__ BwdRow srow[kWide ? 1 : kBwdMaxRows];
  __shared__ const float* srho[kWide ? 1 : kBwdMaxRows];
  const int64_t tile = blockIdx.x;
  int64_t row = 0, lo, j0 = 0;   // kWide: the row; else the tile's first
  int n, nr = 0;
  if constexpr (kWide) {
    row = tile / per_tile;
    j0 = (tile - row * per_tile) * kBwdTile;
    n = (int)min(C - j0, (int64_t)kBwdTile);
    lo = row * C + j0;
  } else {
    row = tile * per_tile;
    nr = (int)min(per_tile, rows - row);
    n = nr * (int)C;
    lo = row * C;
  }
  const T* sp = s + lo;
  const T* tp = t + lo;
  T* dp = ds + lo;
  const uintptr_t at = (uintptr_t)sp & 15;
  const bool together =
      at == ((uintptr_t)tp & 15) && at == ((uintptr_t)dp & 15);
  const int head =
      together ? min(n, (int)((16 - at) & 15) / (int)sizeof(T)) : n;
  const int words = (n - head) / V::kN;
  const int tail = head + words * V::kN;
  uint4 sw[kBwdWords], tw[kBwdWords];
#pragma unroll
  for (int u = 0; u < kBwdWords; ++u) {
    const int wd = u * kThreads + threadIdx.x;
    if (wd < words) {
      sw[u] = __ldcs(reinterpret_cast<const uint4*>(sp + head) + wd);
      tw[u] = __ldcs(reinterpret_cast<const uint4*>(tp + head) + wd);
    }
  }

  BwdRow r{};
  const float* rho_row = rho;
  bool share;
  if constexpr (kWide) {
    r = bwd_row(stats, labels, g, row, C);
    rho_row = rho + (row / rows_per_group) * C;
    share = __float_as_uint(r.lse_st) == __float_as_uint(r.lse_s);
  } else {
    bool mine = true;
    for (int i = threadIdx.x; i < nr; i += kThreads) {
      const BwdRow ri = bwd_row(stats, labels, g, row + i, C);
      srow[i] = ri;
      srho[i] = rho + ((row + i) / rows_per_group) * C;
      mine &= __float_as_uint(ri.lse_st) == __float_as_uint(ri.lse_s);
    }
    share = __syncthreads_and(mine);
  }
  auto run = [&](auto shared_tag) {
    constexpr bool kShared = decltype(shared_tag)::value;
    // ds of tile element k, from its s and t
    auto elem = [&](int k, float sj, float tj) -> float {
      if constexpr (kWide) {
        const int64_t j = j0 + k;
        return bwd_elem<kUnitTau, kShared>(sj, tj, __ldg(rho_row + j),
                                           j == r.y, r, w);
      } else {
        const uint32_t q = magic ? __umulhi((uint32_t)k, magic) : (uint32_t)k;
        const int j = k - (int)q * (int)C;
        const BwdRow& rq = srow[q];
        return bwd_elem<kUnitTau, kShared>(sj, tj, __ldg(srho[q] + j),
                                           j == rq.y, rq, w);
      }
    };
    for (int k = threadIdx.x; k < head; k += kThreads)
      store(dp, k, elem(k, load(sp, k), load(tp, k)));
    for (int k = tail + threadIdx.x; k < n; k += kThreads)
      store(dp, k, elem(k, load(sp, k), load(tp, k)));
#pragma unroll
    for (int u = 0; u < kBwdWords; ++u) {
      const int wd = u * kThreads + threadIdx.x;
      if (wd < words) {
        float x[V::kN], z[V::kN];
        V::unpack(sw[u], x);
        V::unpack(tw[u], z);
        const int k0 = head + wd * V::kN;
#pragma unroll
        for (int e = 0; e < V::kN; ++e) x[e] = elem(k0 + e, x[e], z[e]);
        __stcs(reinterpret_cast<uint4*>(dp + head) + wd, V::pack(x));
      }
    }
  };
  if (kUnitTau && share)
    run(std::true_type{});
  else
    run(std::false_type{});
}

// The backward's tile plan (kd_loss.py's bwd_plan mirrors it): C >
// kBwdTile, per_tile chunks a row and rows x per_tile tiles; else per_tile
// rows a tile.  The grid is one tile a CTA on blockIdx.x (up to 2^31 - 1).
template <typename T>
int launch_bwd(const void* s, const void* t, const void* labels,
               const void* rho, const void* stats, const void* g, void* ds,
               int64_t rows, int64_t C, int64_t rpg, float w_ce, float w_kd,
               float inv_tau, cudaStream_t st) {
  const bool wide = C > kBwdTile;
  const int64_t per_tile =
      wide ? (C + kBwdTile - 1) / kBwdTile
           : (kBwdTile / C < kBwdMaxRows ? kBwdTile / C : kBwdMaxRows);
  const int64_t tiles =
      wide ? rows * per_tile : (rows + per_tile - 1) / per_tile;
  if (C > INT32_MAX || tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const uint32_t magic = (uint32_t)(((1ull << 32) + C - 1) / C);   // C = 1: 0
  const bool unit = inv_tau == 1.0f;
  auto kernel = wide ? (unit ? kd_bwd_kernel<T, true, true>
                             : kd_bwd_kernel<T, true, false>)
                     : (unit ? kd_bwd_kernel<T, false, true>
                             : kd_bwd_kernel<T, false, false>);
  kernel<<<(unsigned)tiles, kBwdThreads<T>, 0, st>>>(
      (const T*)s, (const T*)t, (const int64_t*)labels, (const float*)rho,
      (const float*)stats, (const float*)g, (T*)ds, rows, C, rpg, per_tile,
      magic, BwdScale{w_ce, w_kd, inv_tau});
  return (int)cudaGetLastError();
}

// The cluster route's shape for C classes of `esize` bytes: the smallest
// cluster (up to kMaxCluster) whose slices keep s and t within
// kSliceBytes a CTA, the slice a multiple of 8 elements, and the dynamic
// shared memory (two slots, each 16 bytes over for the alignment shift).
struct ClusterPlan {
  int cl;
  int64_t slice, smem;
};
inline ClusterPlan cluster_plan(int64_t C, int64_t esize) {
  int cl = 1;
  while (cl < kMaxCluster && (C + cl - 1) / cl * 2 * esize > kSliceBytes)
    cl *= 2;
  const int64_t slice = ((C + cl - 1) / cl + 7) / 8 * 8;
  return {cl, slice, 2 * (slice * esize + 16)};
}

template <typename T>
int launch_fwd(const void* s_, const void* t_, const void* labels_,
               const void* rho_, void* loss_, void* ce_, void* kl_,
               void* stats_, void* scratch, int64_t rows, int64_t C,
               int64_t rpg, float lam, float tau, cudaStream_t st) {
  const T* s = (const T*)s_;
  const T* t = (const T*)t_;
  const int64_t* labels = (const int64_t*)labels_;
  const float* rho = (const float*)rho_;
  float *loss = (float*)loss_, *ce = (float*)ce_, *kl = (float*)kl_;
  float* stats = (float*)stats_;
  if (C <= kWarpRowMaxC) {   // a lane holds kPer classes: C <= 32 kPer
    auto kernel = C <= 32    ? kd_fwd_warp_kernel<T, 1>
                  : C <= 64  ? kd_fwd_warp_kernel<T, 2>
                  : C <= 128 ? kd_fwd_warp_kernel<T, 4>
                  : C <= 256 ? kd_fwd_warp_kernel<T, 8>
                  : C <= 512 ? kd_fwd_warp_kernel<T, 16>
                             : kd_fwd_warp_kernel<T, 32>;
    kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kBlock, 0, st>>>(
        s, t, labels, rho, loss, ce, kl, stats, rows, C, rpg, lam, tau);
    return (int)cudaGetLastError();
  }
  const ClusterPlan p = cluster_plan(C, sizeof(T));
  if (p.smem > kMaxDynSmem) {   // the split route: three kernels
    const int64_t parts = (C + kSplitSlice - 1) / kSplitSlice;
    if (!scratch || rows * parts > INT32_MAX) return (int)cudaErrorInvalidValue;
    Lse* part_lse = static_cast<Lse*>(scratch);
    float* part_acc = reinterpret_cast<float*>(part_lse + rows * parts * 3);
    Lse* row_lse = reinterpret_cast<Lse*>(part_acc + rows * parts * 3);
    const unsigned ctas = (unsigned)(rows * parts);
    kd_split_lse_kernel<T><<<ctas, kCtaThreads, 0, st>>>(s, t, C, parts, tau,
                                                        part_lse);
    kd_split_terms_kernel<T><<<ctas, kCtaThreads, 0, st>>>(
        s, t, labels, rho, C, parts, rpg, tau, part_lse, part_acc, row_lse);
    kd_split_finish_kernel<T>
        <<<(unsigned)((rows + kWarps - 1) / kWarps), kBlock, 0, st>>>(
            s, labels, rows, C, parts, part_acc, row_lse, lam, tau, loss, ce,
            kl, stats);
    return (int)cudaGetLastError();
  }
  // once per process: the kernel may take up to kMaxDynSmem
  static const cudaError_t attr = cudaFuncSetAttribute(
      kd_fwd_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxDynSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = p.cl;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * p.cl));
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kd_fwd_cluster_kernel<T>, s, t, labels, rho, loss, ce, kl, stats,
      C, p.slice, rpg, lam, tau);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch: the split route's partials (kd_loss.py's fwd_plan sizes them:
// rows x (9 parts + 6) floats), unused (may be null) on the other routes.
int fedadc_kd_loss_fwd(const void* s, const void* t, const void* labels,
                       const void* rho, void* loss, void* ce, void* kl,
                       void* stats, void* scratch, int64_t rows, int64_t C,
                       int64_t rows_per_group, float lam, float tau,
                       int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows_per_group < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_fwd<float>(s, t, labels, rho, loss, ce, kl, stats, scratch,
                             rows, C, rows_per_group, lam, tau, st);
  if (dtype == kBF16)
    return launch_fwd<__nv_bfloat16>(s, t, labels, rho, loss, ce, kl, stats,
                                     scratch, rows, C, rows_per_group, lam,
                                     tau, st);
  return (int)cudaErrorInvalidValue;
}

int fedadc_kd_loss_bwd(const void* s, const void* t, const void* labels,
                       const void* rho, const void* stats, const void* g,
                       void* ds, int64_t rows, int64_t C,
                       int64_t rows_per_group, float w_ce, float w_kd,
                       float inv_tau, int64_t tile, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // `tile` is the wrapper's mirror of kBwdTile: a plan it tests must be ours
  if (rows_per_group < 1 || C < 1 || tile != kBwdTile)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_bwd<float>(s, t, labels, rho, stats, g, ds, rows, C,
                             rows_per_group, w_ce, w_kd, inv_tau, st);
  if (dtype == kBF16)
    return launch_bwd<__nv_bfloat16>(s, t, labels, rho, stats, g, ds, rows,
                                     C, rows_per_group, w_ce, w_kd, inv_tau,
                                     st);
  return (int)cudaErrorInvalidValue;
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
