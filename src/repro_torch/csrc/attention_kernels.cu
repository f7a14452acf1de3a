// Hopper (sm_90a) kernels for causal GQA flash attention, forward only.
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
// contiguous and 16-byte aligned: the model's own layout, read with
// strides, so the wrapper moves no axis (the TPU kernel took (B, H, L, D)
// and its caller transposed). D is 64 or 128.
//
// Bound. At zamba2-1.2b's prefill shape (B 4, H 32, L 2048, D 64) the work
// is 4·D flops for every visible (query, key) pair of every (batch, head),
// about 6.9e10, against 268 MB of fp32 q, k, v and o: 1.0 ms at 67 TFLOP/s
// on the CUDA cores, 0.08 ms for the bytes at 3.35 TB/s; in bf16 0.07 ms at
// 989 TFLOP/s on the tensor cores. Operations bound it in both types, so
// each type takes the units that do its operations fastest.
//
// Both kernels keep the TPU kernel's structure: a block owns a tile of
// query rows of one (batch, head) and walks the key tiles that the causal
// mask and the window leave visible (the TPU kernel's pl.when), with the
// running max, the running sum and the output accumulator on chip; the
// sequential TPU grid axis over key blocks is the loop inside the block.
// Blocks are issued from the last query tile down, so the causal mask's
// longest rows start first. Keys and queries past L (L 192 is no multiple
// of a tile) load as zeros, masked keys weigh exactly 0, and rows past L
// are not written. K and V tiles are copied asynchronously into a ring of
// stages, so that tile j+1 arrives while tile j is computed.
//
// bf16: the tensor cores (flash_bf16). Both products are wgmma with bf16
// operands and fp32 accumulators: S = Q·K^T with Q and K from shared
// memory, and O += P·V with P from registers and V from shared memory in
// its natural keys x D layout, read MN-major (the transpose bit that 16-bit
// types allow), so no transposed copy is made. Tiles sit in shared memory
// in wgmma's 128-byte swizzle (64 bf16 a row of a panel, 16-byte chunk c of
// row r at chunk c ^ (r % 8)), one panel per 64 columns of D. A block is
// 128 query rows and three warpgroups: a producer and two consumers of 64
// rows each; key tiles of 128 (D 64) or 64 (D 128) keys, so the S
// accumulator is 64 or 32 registers a thread and the O accumulator 32 or
// 64.
//   The producer's first thread issues TMA loads (4-D tensor maps over the
//   model's (B, L, heads, D) layout, which write the swizzle and zero-fill
//   rows past L) into a ring of kStages stages with a full and an empty
//   mbarrier each; the consumers wait on full, release on empty, and never
//   wait on each other. Consumers kept in step by __syncthreads around
//   cp.async copies instead each wait for the slowest at every tile, and
//   the products run at about a fifth of the card's rate, whatever the
//   softmax costs. The producer gives its registers to the consumers
//   (setmaxnreg 24 and 240).
//   Within a consumer the next tile's S is issued before this tile's
//   softmax, so that the tensor cores compute it while the CUDA cores
//   exponentiate; the products of this tile (P·V) follow.
// Softmax stays in fp32 registers: the running max (in raw score units)
// and sum of the thread's two rows (its partial sum, reduced over the row's
// four lanes once at the end) and one rescale of the accumulator a tile;
// per score one FFMA and one ex2.approx (2 ulp, subnormal results flushed
// to 0), masks only on the tiles that hold a masked pair. Numerics: the
// bf16·bf16 products are exact and sum in fp32; the scale is applied to
// the fp32 scores with log2(e) folded in, p = 2^(s·scale·log2(e) -
// m·scale·log2(e)) (the reference scales q first and takes exp: at D 64 the
// scale is a power of two, at D 128 one more fp32 rounding); P is rounded
// to bf16 before P·V, its fp32 values make the sum. Within the reference's
// bf16 bar (2e-2 abs + rel).
//
// fp32: the CUDA cores (flash_f32), since serving's contract keeps TF32
// off. 256 threads; 128 query rows a block at D 64 (64 at D 128, where 128
// rows do not fit in shared memory) against 64-key tiles. Thread (r, c) of
// the 16 x 16 grid owns rows r + 16 i and keys c + 16 j of the score tile
// (an 8 x 4 tile at D 64, 4 x 4 at D 128) and columns 4c + 64 jj of the
// output; the q and k tiles are read four floats a load (float4 along D),
// the probabilities and v likewise along the keys, so each load feeds 4 to
// 8 FMAs. K and V tiles are double-buffered by cp.async (16 bytes a thread
// and copy). The row's max and sum are shuffles over its 16 lanes. q is
// scaled before the product, as in the reference, by scale·log2(e) (one
// more fp32 rounding), so that p = exp2f(s - m) (2 ulp) stands for the
// reference's exp; exact division, no fast-math intrinsics.
//
// Launches on the given stream, does not synchronise, returns
// cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;   // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int { kF32 = 0, kBF16 = 1 };

// The key tiles [begin, end] that any query row of [q0, q0 + rows) can see.
__device__ __forceinline__ void key_tiles(int q0, int rows, int L, int bk,
                                          int causal, int window, int* begin,
                                          int* end) {
  const int q_last = min(q0 + rows, L) - 1;
  *end = causal ? q_last / bk : (L - 1) / bk;
  *begin = (window > 0 ? max(q0 - window + 1, 0) : 0) / bk;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int L, int causal,
                                        int window) {
  return kpos < L && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kBK = 64;                 // keys a tile

template <int D>
struct Cfg {
  static constexpr int kBQ = D == 64 ? 128 : 64;   // query rows a block
  static constexpr int kRM = kBQ / 16;             // score rows a thread
  static constexpr int kQS = D + 4;                // row stride of q, k tiles
  static constexpr int kPS = kBK + 4;              // row stride of p
  static constexpr int kCG = D / 64;               // output float4s a row
  static constexpr int kFloats =
      kBQ * kQS + 2 * kBK * kQS + 2 * kBK * D + kBQ * kPS;
  static constexpr size_t kSmem = sizeof(float) * kFloats;
};

// Copy keys [k0, k0 + kBK) of one kv head into the tile (row stride ld),
// its columns at or past the head dim `dh` (<= D, a multiple of 4) zero.
template <int D, bool kExact>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* g,
                                          int64_t row, int k0, int L,
                                          int dh) {
  constexpr int kPerRow = D / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kBK * kPerRow; e += kThreads) {
    const int key = e / kPerRow, c4 = e % kPerRow, kpos = k0 + key;
    const bool in = kpos < L && (kExact || 4 * c4 < dh);
    cp_async16(smem_u32(dst + key * ld + 4 * c4),
               g + (in ? kpos * row + 4 * c4 : 0), in ? 16 : 0);
  }
}

// The three steps of a key tile that both CUDA-core kernels share.  Thread
// (r, c) of the 16 x 16 grid owns score rows r + 16 i (i < kRM), keys
// c + 16 j (j < 4) and output columns 4c + 64 g (g < kCG).
//
// s[i][j] += Q[r + 16 i] · K[c + 16 j] over n columns (a multiple of 4),
// the rows of Q and K ld floats apart.
template <int kRM>
__device__ __forceinline__ void qk_tile(float (&s)[kRM][4],
                                        const float* Qs, const float* Kt,
                                        int ld, int n, int r, int c) {
#pragma unroll 4
  for (int d = 0; d < n; d += 4) {
    float4 qa[kRM], kk[4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      qa[i] = *reinterpret_cast<const float4*>(Qs + (r + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      kk[j] = *reinterpret_cast<const float4*>(Kt + (c + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
        s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
        s[i][j] = fmaf(qa[i].z, kk[j].z, s[i][j]);
        s[i][j] = fmaf(qa[i].w, kk[j].w, s[i][j]);
      }
  }
}

// The online softmax of a tile's scores (scaled by log2(e)/sqrt(D)): each
// row's running max m and sum l, its accumulator rescaled, and the
// probabilities into P (rows ld floats apart); masks only where `edge`.
template <int kRM, int kAcc>
__device__ __forceinline__ void softmax_tile(
    const float (&s)[kRM][4], float (&m)[kRM], float (&l)[kRM],
    float (&acc)[kRM][kAcc], float* Ps, int ld, int q0, int k0, int r,
    int c, bool edge, int L, int causal, int window) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qpos = q0 + r + 16 * i;
    bool ok[4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = !edge || visible(qpos, k0 + c + 16 * j, L, causal, window);
      if (ok[j]) mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float corr = exp2f(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
      rs += p;
      Ps[(r + 16 * i) * ld + c + 16 * j] = p;
    }
#pragma unroll
    for (int off = 8; off; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l[i] = l[i] * corr + rs;
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[i][j] *= corr;
  }
}

// acc += P·V over a tile of kBK keys, P's rows ld floats apart, V's vld.
template <int kRM, int kCG>
__device__ __forceinline__ void pv_tile(float (&acc)[kRM][4 * kCG],
                                        const float* Ps, int ld,
                                        const float* Vt, int vld, int r,
                                        int c) {
#pragma unroll 4
  for (int key = 0; key < kBK; key += 4) {
    float4 pv[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      pv[i] = *reinterpret_cast<const float4*>(Ps + (r + 16 * i) * ld + key);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float4 vv[kCG];
#pragma unroll
      for (int g = 0; g < kCG; ++g)
        vv[g] = *reinterpret_cast<const float4*>(Vt + (key + t) * vld +
                                                 64 * g + 4 * c);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                      : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int g = 0; g < kCG; ++g) {
          acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// D: the template's head dim (64 or 128); dh_arg: the operands' (<= D, a
// multiple of 8), the columns past it zero in shared memory and unwritten.
// kExact (dh_arg == D) compiles the head dim in.
template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int L, int H,
          int Hk, int causal, int window, float scale_log2, int dh_arg) {
  using C = Cfg<D>;
  const int dh = kExact ? D : dh_arg;
  constexpr int kBQ = C::kBQ, kRM = C::kRM, kQS = C::kQS, kPS = C::kPS;
  constexpr int kCG = C::kCG;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][kQS], scaled
  float* Ks = Qs + kBQ * kQS;                     // [2][kBK][kQS]
  float* Vs = Ks + 2 * kBK * kQS;                 // [2][kBK][D]
  float* Ps = Vs + 2 * kBK * D;                   // [kBQ][kPS]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;

  const int64_t q_row = (int64_t)H * dh, k_row = (int64_t)Hk * dh;
  const float* qb = q + ((int64_t)b * L * H + h) * dh;
  const float* kb = k + ((int64_t)b * L * Hk + hk) * dh;
  const float* vb = v + ((int64_t)b * L * Hk + hk) * dh;
  float* ob = o + ((int64_t)b * L * H + h) * dh;

  int kt_begin, kt_end;
  key_tiles(q0, kBQ, L, kBK, causal, window, &kt_begin, &kt_end);
  load_tile<D, kExact>(Ks, kQS, kb, k_row, kt_begin * kBK, L, dh);
  load_tile<D, kExact>(Vs, D, vb, k_row, kt_begin * kBK, L, dh);
  cp_async_commit();
  for (int e = tid; e < kBQ * (D / 4); e += kThreads) {
    const int row = e / (D / 4), c4 = e % (D / 4), qpos = q0 + row;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qpos < L && (kExact || 4 * c4 < dh))
      x = *reinterpret_cast<const float4*>(qb + qpos * q_row + 4 * c4);
    x.x *= scale_log2; x.y *= scale_log2; x.z *= scale_log2;
    x.w *= scale_log2;
    *reinterpret_cast<float4*>(Qs + row * kQS + 4 * c4) = x;
  }

  float m[kRM], l[kRM], acc[kRM][4 * kCG];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kCG; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    const int k0 = kt * kBK;
    // tile kt has landed, and every thread is done with tile kt - 1 (its
    // stage and the probabilities)
    cp_async_wait_all();
    __syncthreads();
    if (kt < kt_end) {
      load_tile<D, kExact>(Ks + (st ^ 1) * kBK * kQS, kQS, kb, k_row,
                           k0 + kBK, L, dh);
      load_tile<D, kExact>(Vs + (st ^ 1) * kBK * D, D, vb, k_row, k0 + kBK,
                           L, dh);
    }
    cp_async_commit();
    const float* Kt = Ks + st * kBK * kQS;
    const float* Vt = Vs + st * kBK * D;
    // whether any (row, key) of the tile is masked
    const int q_hi = min(q0 + kBQ, L) - 1;
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > L ||
                      (window > 0 && k0 <= q_hi - window);

    float s[kRM][4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    qk_tile<kRM>(s, Qs, Kt, kQS, D, r, c);
    softmax_tile<kRM, 4 * kCG>(s, m, l, acc, Ps, kPS, q0, k0, r, c, edge, L,
                               causal, window);
    __syncthreads();   // the probabilities are written
    pv_tile<kRM, kCG>(acc, Ps, kPS, Vt, D, r, c);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qpos = q0 + r + 16 * i;
    if (qpos >= L) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kCG; ++g) {
      if (!kExact && 64 * g + 4 * c >= dh) continue;
      float4 y;
      y.x = acc[i][4 * g + 0] / denom;
      y.y = acc[i][4 * g + 1] / denom;
      y.z = acc[i][4 * g + 2] / denom;
      y.w = acc[i][4 * g + 3] / denom;
      *reinterpret_cast<float4*>(ob + qpos * q_row + 64 * g + 4 * c) = y;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t L, int64_t H, int64_t Hk, int64_t dh,
                   int causal, int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = Cfg<D>::kSmem;
  const auto kernel = dh == D ? flash_f32<D, true> : flash_f32<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((L + Cfg<D>::kBQ - 1) / Cfg<D>::kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), (int)L, (int)H,
      (int)Hk, causal, window, scale * kLog2e, (int)dh);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;                // query rows a block: 2 warpgroups
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's

// D: the template's depth of Q·K^T, a multiple of 16 up to 256 (32, 64, 80,
// 96, 128, 192, 256); the operands' head dim is at most D, and the TMA
// fills the columns past it with zeros (their k16 steps add nothing).
template <int D>
struct Cfg {
  static constexpr int kBK = D <= 64 ? 128 : 64;   // keys a tile
  static constexpr int kPanels = (D + 63) / 64;    // 128-byte panels a row
  static constexpr int kStages = D > 192 ? 2 : 3;  // K/V tiles in flight
  // the next tile's S issued before this tile's softmax, where the
  // registers hold both (not at D 256: O alone is 128 a thread)
  static constexpr bool kOverlap = D <= 192;
  static constexpr int kQBytes = kBQ * kPanels * 128;
  static constexpr int kTileBytes = kBK * kPanels * 128;  // one K or V tile
  // 1024 bytes of slack to align the swizzled tiles to 1024; then Q, the
  // stages (K, V) and the barriers (full and empty a stage, Q's)
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// -- the tensor memory accelerator (the mbarriers: hopper.cuh) --------------
// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 2^x by the special-function unit (2 ulp, subnormal results flushed)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q·K^T of one tile into `sc` (issued, not waited): D in steps of 16,
// step kk 32 bytes into panel kk/4.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<D>::kBK / 2],
                                        uint32_t sQw, uint32_t sK) {
  constexpr int kBK = Cfg<D>::kBK;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(sc, kmajor(sQw + (kk / 4) * (kBQ * 128) + (kk % 4) * 32),
             kmajor(sK + (kk / 4) * (kBK * 128) + (kk % 4) * 32), kk);
  wgmma_commit();
}

// A consumer warpgroup's rows and running softmax state.  This thread
// holds rows row0 and row0 + 8 (the wgmma accumulator's layout: element j
// is row row0 + 8·((j/2)%2), column 8·(j/4) + col0 + j%2 of the tile).
template <int D>
struct Rows {
  float acc[Cfg<D>::kPanels][32];   // O, unnormalised
  float m[2], l[2];                 // running max (raw score units), sum
  int row0, col0, r_lo, r_hi;
};

// One key tile: the softmax of its scores `sc` (already waited), O += P·V,
// and the release of its stage.  With kNext, the next tile's S is issued
// into `sn` first, so that the tensor cores compute it while this tile's
// softmax runs on the CUDA cores (the loop's two products overlap within
// the warpgroup).
template <int D, bool kNext>
__device__ __forceinline__ void tile_step(
    Rows<D>& w, float (&sc)[Cfg<D>::kBK / 2], float (&sn)[Cfg<D>::kBK / 2],
    uint32_t sQw, uint32_t sKV, uint32_t full, uint32_t empty, int i, int k0,
    int L, int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK, kPanels = C::kPanels, kS = kBK / 2;
  constexpr int kStages = C::kStages;
  const int s = i % kStages;
  if (kNext) {
    const int s1 = (i + 1) % kStages;
    mbar_wait(full + 8 * s1, ((i + 1) / kStages) & 1);
    wgmma_fence();
    issue_s<D>(sn, sQw, sKV + s1 * 2 * C::kTileBytes);
  }

  // masked scores are -inf; the rows' maxima in raw score units
  if ((causal && k0 + kBK - 1 > w.r_lo) || k0 + kBK > L ||
      (window > 0 && k0 <= w.r_hi - window)) {
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (!visible(w.row0 + 8 * ((j / 2) % 2),
                   k0 + 8 * (j / 4) + w.col0 + j % 2, L, causal, window))
        sc[j] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kS; ++j) mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
  float corr[2], ms[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float m_new = fmaxf(w.m[hf], mx[hf]);
    // a row that has seen no visible key yet keeps 0 as its offset, so
    // that its -inf scores give exactly 0 and never inf - inf
    ms[hf] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    corr[hf] = ex2(fmaf(w.m[hf], scale_log2, -ms[hf]));
    w.m[hf] = m_new;
    w.l[hf] *= corr[hf];
  }
  // p = 2^(s·scale·log2(e) - m·scale·log2(e)) = e^((s - m)/sqrt(D))
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int hf = (j / 2) % 2;
    sc[j] = ex2(fmaf(sc[j], scale_log2, -ms[hf]));
    w.l[hf] += sc[j];
  }
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 32; ++j) w.acc[p][j] *= corr[(j / 2) % 2];

  // P in bf16 as the A operand: the accumulator's 16 columns of step kk
  // are exactly the A fragment of a k16 step
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
  // O += P·V over the keys in steps of 16 (2048 bytes of V), one n64
  // product per panel of D
  const uint32_t sV = sKV + s * 2 * C::kTileBytes + C::kTileBytes;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      wgmma_rs_mn(w.acc[p], pa[kk],
                  mnmajor(sV + p * (kBK * 128) + kk * 2048, kBK * 128));
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int p = 0; p < kPanels; ++p) fence_regs(w.acc[p]);
  if (kNext) fence_regs(sn);
  mbar_arrive(empty + 8 * s);   // this thread is done with the stage
}

// Warp-specialised: warpgroup 2 is the producer, whose first thread issues
// the TMA loads (Q once, then each K/V tile into the next stage of a ring
// of kStages once both consumers have released it) and whose registers go
// to the consumers (setmaxnreg); warpgroups 0 and 1 are the consumers, each
// on its 64 query rows, and never wait on each other.  kExact: the head
// dim is the template's (dh_arg == D), compiled in.  dh_arg comes last in
// both kernels: placed before the others it changed ptxas's register
// allocation of the D 64 template (212 B spilled, not 200; 6% slower).
template <int D, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ o, int L, int H, int Hk, int causal,
           int window, float scale_log2, int dh_arg) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK, kPanels = C::kPanels, kStages = C::kStages;
  constexpr int kS = kBK / 2;           // score registers a thread
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + C::kQBytes;  // stage s: K, then V
  const uint32_t full = sQ + C::kBarOffset, empty = full + 8 * kStages;
  const uint32_t qbar = empty + 8 * kStages;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  int kt_begin, kt_end;
  key_tiles(q0, kBQ, L, kBK, causal, window, &kt_begin, &kt_end);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // -- the producer ------------------------------------------------------
    // its registers go to the consumers: 2·128·240 + 128·24 <= 65536
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 128 * kConsumers) return;
    mbar_expect_tx(qbar, C::kQBytes);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
      tma_load(sQ + p * (kBQ * 128), &tq, qbar, 64 * p, h, q0, b);
    for (int kt = kt_begin, i = 0; kt <= kt_end; ++kt, ++i) {
      const int s = i % kStages, use = i / kStages;
      if (use) mbar_wait(empty + 8 * s, (use - 1) & 1);
      const uint32_t sK = sKV + s * 2 * C::kTileBytes;
      mbar_expect_tx(full + 8 * s, 2 * C::kTileBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sK + p * (kBK * 128), &tk, full + 8 * s, 64 * p, hk,
                 kt * kBK, b);
        tma_load(sK + C::kTileBytes + p * (kBK * 128), &tv, full + 8 * s,
                 64 * p, hk, kt * kBK, b);
      }
    }
    return;
  }

  // -- a consumer warpgroup: rows [r_lo, r_lo + 64) ------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  Rows<D> w;
  w.r_lo = q0 + 64 * wg;
  w.r_hi = min(w.r_lo + 63, L - 1);
  w.row0 = w.r_lo + 16 * warp + lane / 4;
  w.col0 = 2 * (lane % 4);
#pragma unroll
  for (int p = 0; p < kPanels; ++p)
#pragma unroll
    for (int j = 0; j < 32; ++j) w.acc[p][j] = 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    w.m[hf] = -INFINITY;
    w.l[hf] = 0.f;
  }
  const uint32_t sQw = sQ + wg * 64 * 128;
  mbar_wait(qbar, 0);
  // a tile that only part of the block sees is masked, not skipped, so
  // that no warpgroup's products sit on a divergent path
  const int n_tiles = kt_end - kt_begin + 1;
  float sc[kS];
  mbar_wait(full, 0);
  wgmma_fence();
  issue_s<D>(sc, sQw, sKV);
  wgmma_wait_all();
  fence_regs(sc);
  int i = 0;
  if constexpr (C::kOverlap) {
    for (; i + 1 < n_tiles; ++i) {
      float sn[kS];
      tile_step<D, true>(w, sc, sn, sQw, sKV, full, empty, i,
                         (kt_begin + i) * kBK, L, causal, window, scale_log2);
#pragma unroll
      for (int j = 0; j < kS; ++j) sc[j] = sn[j];
    }
  } else {
    for (; i + 1 < n_tiles; ++i) {
      tile_step<D, false>(w, sc, sc, sQw, sKV, full, empty, i,
                          (kt_begin + i) * kBK, L, causal, window,
                          scale_log2);
      const int s1 = (i + 1) % kStages;
      mbar_wait(full + 8 * s1, ((i + 1) / kStages) & 1);
      wgmma_fence();
      issue_s<D>(sc, sQw, sKV + s1 * 2 * C::kTileBytes);
      wgmma_wait_all();
      fence_regs(sc);
    }
  }
  tile_step<D, false>(w, sc, sc, sQw, sKV, full, empty, i,
                      (kt_begin + i) * kBK, L, causal, window, scale_log2);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    w.l[hf] += __shfl_xor_sync(0xffffffffu, w.l[hf], 1);
    w.l[hf] += __shfl_xor_sync(0xffffffffu, w.l[hf], 2);
  }
  const int dh = kExact ? D : dh_arg;
  const int64_t q_row = (int64_t)H * dh;
  __nv_bfloat16* ob = o + ((int64_t)b * L * H + h) * dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qpos = w.row0 + 8 * hf;
    if (qpos >= L) continue;
    const float inv = 1.f / fmaxf(w.l[hf], 1e-30f);
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int j = 2 * hf; j < 32; j += 4) {
        const int col = 64 * p + 8 * (j / 4) + w.col0;
        // dh a multiple of 8: col + 1 < dh too; no column past the panels
        // of an exact multiple of 64
        if ((kExact && D % 64 == 0) || col < dh)
          *reinterpret_cast<__nv_bfloat162*>(ob + qpos * q_row + col) =
              __floats2bfloat162_rn(w.acc[p][j] * inv,
                                    w.acc[p][j + 1] * inv);
      }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (B, L, heads, D) bf16 tensor whose box is `rows` positions
// of one head and 64 of its D columns (128 bytes, 128-byte swizzle); rows
// past L read as zeros.
bool head_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t L,
              int64_t heads, int64_t D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(D * 2),
                                 (cuuint64_t)(heads * D * 2),
                                 (cuuint64_t)(L * heads * D * 2)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t L, int64_t H, int64_t Hk, int64_t dh,
                   int causal, int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = Cfg<D>::kSmem;
  if (!encode_tiled()) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, L, H, dh, kBQ) ||
      !head_map(&tk, k, B, L, Hk, dh, Cfg<D>::kBK) ||
      !head_map(&tv, v, B, L, Hk, dh, Cfg<D>::kBK))
    return cudaErrorInvalidValue;
  const auto kernel = dh == D ? flash_bf16<D, true> : flash_bf16<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), (int)L, (int)H, (int)Hk,
      causal, window, scale * kLog2e, (int)dh);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// any head dim: the CUDA cores, one slice of V's columns a launch
// ---------------------------------------------------------------------------
// The route for head dims past the templates (fp32 above 128, bf16 above
// 256). A block is 64 query rows against 64-key tiles, 256 threads as in
// flash_f32 (thread (r, c) owns rows r + 16 i and keys c + 16 j, and the
// output columns 4c + 64 g of its slice). Q·K^T sums over the whole head
// dim in chunks of 64 columns, each chunk of Q (scaled) and of K staged in
// shared memory by plain loads, in fp32 whatever the operands' type; the
// softmax is flash_f32's; P stays fp32 for P·V over the slice's DV columns
// of V, [v0, v0 + DV). The wrapper launches once a slice of at most 256
// columns, each launch recomputing the same scores: simple and correct,
// not fast.
namespace wide {

constexpr int kThreads = 256;
constexpr int kBQ = 64, kBK = 64, kDC = 64;   // rows, keys, a chunk of D
constexpr int kLd = kDC + 4;                  // padded row of Q, K, P

template <int DV>
constexpr size_t kSmem = sizeof(float) * (3 * kBQ * kLd + kBK * DV);

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int L, int H, int Hk,
           int dh, int v0, int causal, int window, float scale_log2) {
  constexpr int kRM = kBQ / 16, kCG = DV / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLd], scaled
  float* Ks = Qs + kBQ * kLd;                     // [kBK][kLd]
  float* Ps = Ks + kBK * kLd;                     // [kBQ][kLd]
  float* Vs = Ps + kBQ * kLd;                     // [kBK][DV]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;
  const int64_t q_row = (int64_t)H * dh, k_row = (int64_t)Hk * dh;
  const T* qb = q + ((int64_t)b * L * H + h) * dh;
  const T* kb = k + ((int64_t)b * L * Hk + hk) * dh;
  const T* vb = v + ((int64_t)b * L * Hk + hk) * dh;
  T* ob = o + ((int64_t)b * L * H + h) * dh;

  int kt_begin, kt_end;
  key_tiles(q0, kBQ, L, kBK, causal, window, &kt_begin, &kt_end);
  float m[kRM], l[kRM], acc[kRM][4 * kCG];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * kCG; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    float s[kRM][4];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDC) {
      __syncthreads();   // the last chunk's (and tile's) reads are done
      for (int e = tid; e < kBQ * kDC; e += kThreads) {
        const int row = e / kDC, col = e % kDC, d = d0 + col;
        const bool dq = q0 + row < L && d < dh, dk = k0 + row < L && d < dh;
        Qs[row * kLd + col] =
            dq ? ld(qb, (q0 + row) * q_row + d) * scale_log2 : 0.f;
        Ks[row * kLd + col] = dk ? ld(kb, (k0 + row) * k_row + d) : 0.f;
      }
      __syncthreads();
      f32::qk_tile<kRM>(s, Qs, Ks, kLd, kDC, r, c);
    }
    const int q_hi = min(q0 + kBQ, L) - 1;
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > L ||
                      (window > 0 && k0 <= q_hi - window);
    f32::softmax_tile<kRM, 4 * kCG>(s, m, l, acc, Ps, kLd, q0, k0, r, c,
                                    edge, L, causal, window);
    for (int e = tid; e < kBK * DV; e += kThreads) {
      const int key = e / DV, col = e % DV, d = v0 + col;
      Vs[key * DV + col] =
          k0 + key < L && d < dh ? ld(vb, (k0 + key) * k_row + d) : 0.f;
    }
    __syncthreads();   // the probabilities and the V tile are written
    f32::pv_tile<kRM, kCG>(acc, Ps, kLd, Vs, DV, r, c);
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int qpos = q0 + r + 16 * i;
    if (qpos >= L) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kCG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + 64 * g + 4 * c + e;
        if (col < dh) st(ob, qpos * q_row + col, acc[i][4 * g + e] / denom);
      }
  }
}

template <typename T, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t L, int64_t H, int64_t Hk, int64_t dh,
                   int64_t v0, int causal, int window, float scale,
                   cudaStream_t st) {
  constexpr size_t bytes = kSmem<DV>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_wide<T, DV><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)L, (int)H, (int)Hk,
      (int)dh, (int)v0, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// The slice [v0, v0 + width) of V's columns, width <= 256, in the template
// of the next multiple of 64.
template <typename T>
cudaError_t launch_slice(const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t L, int64_t H, int64_t Hk,
                         int64_t dh, int64_t v0, int causal, int window,
                         float scale, cudaStream_t st) {
  const int64_t width = dh - v0;
  if (width <= 64)
    return launch<T, 64>(q, k, v, o, B, L, H, Hk, dh, v0, causal, window,
                         scale, st);
  if (width <= 128)
    return launch<T, 128>(q, k, v, o, B, L, H, Hk, dh, v0, causal, window,
                          scale, st);
  if (width <= 192)
    return launch<T, 192>(q, k, v, o, B, L, H, Hk, dh, v0, causal, window,
                          scale, st);
  return launch<T, 256>(q, k, v, o, B, L, H, Hk, dh, v0, causal, window,
                        scale, st);
}

}  // namespace wide

// The bf16 route's template for a head dim dh <= 256: the smallest of 32,
// 64, 80, 96, 128, 192 and 256 at or above dh (flash_attention.py's plan).
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t L, int64_t H, int64_t Hk,
                        int64_t dh, int causal, int window, float scale,
                        cudaStream_t st) {
#define FEDADC_TC(DK)                                                     \
  if (dh <= DK)                                                           \
    return tc::launch<DK>(q, k, v, o, B, L, H, Hk, dh, causal, window, \
                          scale, st);
  FEDADC_TC(32)
  FEDADC_TC(64)
  FEDADC_TC(80)
  FEDADC_TC(96)
  FEDADC_TC(128)
  FEDADC_TC(192)
  FEDADC_TC(256)
#undef FEDADC_TC
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dh: the head dim, a multiple of 8 (the wrapper pads another with zeros);
// v0: the first of V's columns that this launch writes, 0 but on the wide
// route (fp32 above 128, bf16 above 256: one launch a slice of up to 256
// columns, flash_attention.py's plan).
int fedadc_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int64_t B, int64_t L, int64_t H,
                           int64_t Hk, int64_t D, int64_t v0, int causal,
                           int window, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 8 || D % 8 || v0 < 0 || v0 >= D || v0 % 64 ||
      (dtype != kBF16 && dtype != kF32))
    return (int)cudaErrorInvalidValue;
  const bool wide = D > (dtype == kBF16 ? 256 : 128);
  if (!wide && v0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == kBF16)
    e = wide ? wide::launch_slice<__nv_bfloat16>(q, k, v, o, B, L, H, Hk, D,
                                                 v0, causal, window, scale, st)
             : launch_bf16(q, k, v, o, B, L, H, Hk, D, causal, window, scale,
                           st);
  else if (wide)
    e = wide::launch_slice<float>(q, k, v, o, B, L, H, Hk, D, v0, causal,
                                  window, scale, st);
  else if (D <= 64)
    e = f32::launch<64>(q, k, v, o, B, L, H, Hk, D, causal, window, scale,
                        st);
  else
    e = f32::launch<128>(q, k, v, o, B, L, H, Hk, D, causal, window, scale,
                         st);
  return (int)e;
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
