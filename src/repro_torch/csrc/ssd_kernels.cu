// Hopper (sm_90a) kernels for the Mamba2 chunked SSD scan.
//
//   fedadc_ssd_scan   per (batch, head), over chunks of Q positions, with
//       acum the running sum of the log decay a within the chunk:
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
// Bound. Per (batch, head, chunk of q positions) the work is (q² + q)(N + P)
// flops for the causal scores and their product with x and 4qNP for the
// carried term and the state; at zamba2-1.2b's prefill shape (b 4, L 2048,
// H 64, P 64, N 64, Q 256) that is 2.6e10 flops, 0.39 ms at 67 TFLOP/s of
// fp32 and 0.026 ms at 989 TFLOP/s of bf16, against 0.34 GB of operands and
// output (0.10 ms at 3.35 TB/s with B, C and y in bf16): operations bound
// the fp32 route, bytes the bf16 route.
//
// Design: the state-passing form, three kernels a call (four with chunks
// above 256), each parallel over the chunks (the TPU kernel carries h along a sequential grid axis, which a
// GPU would run as b·H blocks walking their chunks in order: 64 blocks for
// 132 SMs at batch 1).
//   1. states  one block a (batch, head, chunk): the running sums acum of
//              the chunk's a in double (a block scan), written to scratch,
//              exp(acum_end) to scratch, and the chunk's state
//              S_c = B^T (exp(acum_end - acum) x), N x P in fp32, to scratch;
//   2. carry   one thread four state elements of one (batch, head):
//              h_c = exp(acum_end,c) h_{c-1} + S_c along the chunks, each S_c
//              overwritten in place by the state before the chunk, the loads
//              of 16 chunks in flight;
//   3. outputs one block a (batch, head, chunk, query tile of 64 rows): the
//              carried term exp(acum_i) C_i h_prev, then the key tiles at or
//              below the diagonal. Blocks go chunk by chunk, so that the
//              query tiles of a chunk, which read the same key tiles, run
//              together and find them in L2; within a chunk the heaviest
//              first (the last query tile carries 4 key tiles at Q 256).
// The wrapper allocates the scratch: acum, (b, H, chunks, Qpad) doubles, the
// states, (b, H, chunks, Np, Pp) fp32 (N and P rounded up to 64: 33.5 MB at
// the prefill shape), and the decays, (b, H, chunks) fp32. At the prefill
// shape the grids are 2048, 2048 and 8192 blocks; at L 32768, batch 1,
// 8192, 512 and 32768.
//
// Any P, N and chunk. The states and outputs take 64-wide slices of P on a
// grid axis (y[..., p] depends on x[..., p] alone); the states take 64-wide
// slices of N too (a state's rows are independent). The outputs take N in
// passes of up to 128 columns: one pass natively up to N 128 (kNT 64 or
// 128, the C and B tiles and h_prev that wide), and above that passes that
// add, both in C·B^T and in C·h, into an fp32 partial of y (the wrapper's)
// that the last pass rounds to y's type. A chunk above 256 (kMaxQ) takes a
// fourth kernel first, the running sums alone into the scratch, and the
// states then read them a 64-position tile at a time, as the outputs do.
//
// The gates. The running sums reach about -1e4 within a 256-step chunk at
// zamba2's decays; in fp32 their low digits would be lost (7.5e-5 of the
// output against the 2e-5 bar). So acum stays in double everywhere a gate
// is formed: exp(acum_i - acum_j), exp(acum_end - acum_j) and exp(acum_i)
// take the difference in double and round once to fp32 (expf; ex2 on the
// bf16 route's scores), or exp() in double for the per-row and per-chunk
// factors. Every gate is at most 1, and one that underflows is 0, never
// NaN. Positions past L (a ragged last chunk) or past the chunk (Q not a
// multiple of 64) load as zeros (x, B, C, and a 0, so acum stays finite),
// change neither y nor h, and their rows are not written.
//
// fp32 (B and C fp32): the CUDA cores, since serving's contract keeps TF32
// off. 128 threads a block; in the outputs thread (r, c) of an 8 x 16 grid
// owns rows r + 8i (i < 8) and keys c + 16j (j < 4) of a 64 x 64 score
// tile, and columns 4c..4c+3 of the 64 x P output rows: 8 x 4 register
// tiles, each float4 load of shared memory feeding 8 to 32 FMAs (in the
// states, state rows 8r..8r+7 and columns 4c..4c+3). The key tiles of B and
// x are double-buffered by cp.async. A warp's score rows are the rows its
// own threads need for the product with x, so the gated scores pass through
// shared memory with a __syncwarp, and a key tile costs one block barrier.
// ~104 KB of shared memory an outputs block: two blocks an SM.
//
// bf16 (B and C bf16): the tensor cores, one warpgroup a block, wgmma on
// bf16 operands in the 128-byte swizzle with fp32 accumulators. Outputs:
// S = C·B^T (both K-major), the gate in fp32 on the accumulator, P·x with P
// from registers and x MN-major; the carried term C·h is a product into the
// same accumulator before the rows are scaled by exp(acum_i). States:
// B^T·(w x) with B^T and w x MN-major (the transpose bits). B and C are
// copied by cp.async into the swizzle; x·dt and h are fp32 in memory (TMA
// cannot convert), so they are copied as they are and the block rounds
// them to bf16 in shared memory, keeping each value's rounding error as a
// second bf16 operand (x = x_hi + x_lo, P likewise): P·x = P_hi·x_hi +
// P_hi·x_lo + P_lo·x_hi, C·h = C·h_hi + C·h_lo, B^T(w x) = B^T (w x)_hi +
// B^T (w x)_lo. That keeps the products to ~2^-16 relative, as close to
// the fp32 route as the bf16 output allows, at three times the tensor-core
// work of P·x, which the bytes bound leaves room for; x costs its 4 bytes a
// read (no bf16 copy of it is made). The outputs block keeps one stage of
// each operand (51 KB, four blocks an SM): the next key tile's x is copied
// once this tile's is rounded, its B once this tile's scores are taken,
// both while the products run.
//
// Exact expf and exp elsewhere, no fast-math flags. Launches on the given
// stream, does not synchronise, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;       // every kernel: one warpgroup a block
constexpr int kT = 64;              // positions a tile
constexpr int kMaxQ = 256;          // a chunk whose sums one block holds
constexpr int kMaxNT = 128;         // N columns an outputs pass takes
constexpr int kLd = kT + 4;         // padded row of an fp32 C, B or P tile

enum DType : int { kF32 = 0, kBF16 = 1 };

// Where one call's operands and scratch are, and its geometry.
struct Args {
  const float* x;
  const float* a;
  const void* B;
  const void* C;
  void* y;
  double* acum;      // (b·H, chunks, Qpad)
  float* state;      // (b·H, chunks, Np, Pp)
  float* decay;      // (b·H, chunks): exp(acum_end) of each chunk
  int L, H, P, N, Q, Qpad, nc, bh;
  int vec_x, vec_bc;  // rows 16-byte aligned: copies of 16 bytes
};

// How a call is sliced, a second parameter of the states and outputs
// kernels (Args keeps the layout that the single-tile kernels were tuned
// with: ptxas allocates their registers differently when it changes).
struct Slices {
  float* part;       // (b, L, H, P) fp32: y's sum over the earlier N passes
  int Np, Pp;        // the state's padded N and P (multiples of 64)
  int ns, np;        // 64-wide slices of N and of P
  int n0, nw;        // the outputs pass: B and C columns [n0, n0 + nw)
  int first, last;   // whether the pass is the call's first, its last
};

__device__ __forceinline__ int64_t state_size(const Slices& sl) {
  return (int64_t)sl.Np * sl.Pp;
}

// One (batch, head, chunk): its base offsets and the rows the chunk holds.
struct Chunk {
  int64_t pos;       // (b·L + t0)·H + h: position t0 of (b, h), in units
  int rows;          // positions of the chunk before L
  int64_t scratch;   // (b·H + h)·chunks + c
};

__device__ __forceinline__ Chunk chunk_of(const Args& g, int bh, int c) {
  Chunk k;
  const int b = bh / g.H, h = bh % g.H, t0 = c * g.Q;
  k.pos = ((int64_t)b * g.L + t0) * g.H + h;
  k.rows = min(g.Q, g.L - t0);
  k.scratch = (int64_t)bh * g.nc + c;
  return k;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The running sums of a over one chunk of at most kMaxQ (rows at or past
// its end add 0) in double, into acum[0, Qpad) in shared memory and, where
// `write` (one block of the chunk's slices), into the scratch, each row's
// weight exp(acum_end - acum) into w, and exp(acum_end) into the scratch:
// two entries a thread, a warp scan, the four warps' totals through ws (4
// doubles of shared memory).
__device__ void chunk_sums(const Args& g, const Chunk& k, double* acum,
                           double* ws, float* w, bool write) {
  const int i0 = 2 * threadIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* a = g.a + k.pos;
  const double v0 = i0 < k.rows ? (double)a[(int64_t)i0 * g.H] : 0.0;
  const double v1 =
      i0 + 1 < k.rows ? (double)a[(int64_t)(i0 + 1) * g.H] : 0.0;
  double x = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  double before = x - (v0 + v1);
  for (int i = 0; i < warp; ++i) before += ws[i];
  if (i0 < g.Qpad) acum[i0] = before + v0;
  if (i0 + 1 < g.Qpad) acum[i0 + 1] = before + v0 + v1;
  __syncthreads();
  double* out = g.acum + k.scratch * g.Qpad;
  const double a_end = acum[g.Q - 1];
  for (int i = threadIdx.x; i < g.Qpad; i += kThreads) {
    if (write) out[i] = acum[i];
    w[i] = expf((float)(a_end - acum[i]));
  }
  if (write && threadIdx.x == 0) g.decay[k.scratch] = (float)exp(a_end);
}

// A chunk above kMaxQ: its running sums alone, in rounds of 2 kThreads
// positions with the carry in double, into the scratch, and exp(acum_end).
// One block a (batch, head, chunk), before the states.
__global__ void __launch_bounds__(kThreads)
ssd_sums(const Args g) {
  __shared__ double ws[kThreads / 32];
  const int bh = blockIdx.x / g.nc, c = blockIdx.x % g.nc;
  const Chunk k = chunk_of(g, bh, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* a = g.a + k.pos;
  double* out = g.acum + k.scratch * g.Qpad;
  double carry = 0.0;
  for (int r0 = 0; r0 < g.Qpad; r0 += 2 * kThreads) {
    const int i0 = r0 + 2 * threadIdx.x;
    const double v0 = i0 < k.rows ? (double)a[(int64_t)i0 * g.H] : 0.0;
    const double v1 =
        i0 + 1 < k.rows ? (double)a[(int64_t)(i0 + 1) * g.H] : 0.0;
    double x = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    double before = carry + (x - (v0 + v1));
    for (int i = 0; i < warp; ++i) before += ws[i];
    if (i0 < g.Qpad) out[i0] = before + v0;
    if (i0 + 1 < g.Qpad) out[i0 + 1] = before + v0 + v1;
    for (int i = 0; i < kThreads / 32; ++i) carry += ws[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) g.decay[k.scratch] = (float)exp(out[g.Q - 1]);
}

// Rows [r0, r0 + 64) of an fp32 operand whose row i is at src + i·row
// (rows at or past `rows` and columns at or past `width` zero) into a
// 64 x kCols tile of `ld` floats a row: by cp.async 16 bytes at a time where
// `vec`, else by plain loads (both land before the caller's wait and
// barrier).
template <int kCols = kT>
__device__ __forceinline__ void stage_f32(float* dst, int ld,
                                          const float* src, int64_t row,
                                          int r0, int rows, int width,
                                          int vec) {
  constexpr int kVecs = kCols / 4;
  for (int e = threadIdx.x; e < kT * kVecs; e += kThreads) {
    const int r = e / kVecs, c4 = (e % kVecs) * 4;
    const bool in = r0 + r < rows;
    const float* s = src + (int64_t)(r0 + r) * row + c4;
    if (vec) {
      const bool ok = in && c4 < width;
      cp_async16(smem_u32(dst + r * ld + c4), ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[r * ld + c4 + k] = in && c4 + k < width ? s[k] : 0.f;
    }
  }
}

// The (batch·head, chunk, P slice, query tile) of an outputs block,
// chunk-major, so that the query tiles of one chunk, which read the same
// key tiles, run together and find them in L2; within a chunk and slice the
// heaviest first (the last query tile carries 4 key tiles at Q 256, the
// first one).
__device__ __forceinline__ void out_block(const Args& g, int np, int* bh,
                                          int* c, int* ps, int* qt) {
  const int n_qt = g.Qpad / kT;
  const int rest = blockIdx.x / n_qt;
  const int chunk = rest / np;
  *qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  *ps = rest % np;
  *bh = chunk / g.nc;
  *c = chunk % g.nc;
}

// The (batch·head, chunk, N slice, P slice) of a states block, chunk-major.
__device__ __forceinline__ void states_block(const Args& g,
                                             const Slices& sl, int* bh,
                                             int* c, int* ns, int* ps) {
  const int slices = sl.ns * sl.np;
  const int chunk = blockIdx.x / slices, at = blockIdx.x % slices;
  *ns = at / sl.np;
  *ps = at % sl.np;
  *bh = chunk / g.nc;
  *c = chunk % g.nc;
}

// The decay-to-end weights of positions [t0, t0 + 64) of a chunk above
// kMaxQ, from its running sums in the scratch, into w[0, 64) (the first 64
// threads; the caller's barrier publishes them).
__device__ __forceinline__ void tile_weights(const double* acum, double a_end,
                                             int t0, float* w) {
  if (threadIdx.x < kT)
    w[threadIdx.x] = expf((float)(a_end - acum[t0 + threadIdx.x]));
}

// An outputs block's pass and slice. Unsliced (N and P at most 64: one
// pass, one P slice, the state 64 x 64) every term is a constant, so the
// kernel compiles to the single-tile form.
template <bool kSliced>
struct Pass {
  int np, n0, nw, Pp, h_rows;
  int64_t state;       // floats of one chunk's state
  __device__ __forceinline__ Pass(const Args& g, const Slices& sl, int nt)
      : np(kSliced ? sl.np : 1), n0(kSliced ? sl.n0 : 0),
        nw(kSliced ? sl.nw : g.N), Pp(kSliced ? sl.Pp : kT),
        h_rows(kSliced ? min(nt, sl.Np - sl.n0) : kT),
        state(kSliced ? state_size(sl) : (int64_t)kT * kT) {}
};

// One element of y, at `at` from the block's base: written in y's type by
// the last N pass (with the earlier passes' fp32 sum added), else kept in
// the fp32 partial for the next pass.
template <bool kSliced, typename TY>
__device__ __forceinline__ void put_y(const Slices& sl, TY* y, float* part,
                                      int64_t at, float v) {
  if (kSliced && !sl.first) v += part[at];
  if (!kSliced || sl.last)
    store(y + at, v);
  else
    part[at] = v;
}

// -- the carry (both routes) --------------------------------------------------
// One thread four state elements of one (batch, head): along the chunks,
// the state before chunk c replaces S_c in place. The loads of 16 chunks
// are in flight at once, since none depends on the carried sum. `vecs`:
// float4s of a state (Np Pp / 4, a multiple of kThreads).
__global__ void __launch_bounds__(kThreads)
ssd_carry(float* __restrict__ state, const float* __restrict__ decay,
          int nc, int vecs) {
  const int blocks = vecs / kThreads;   // blocks a (b, h)
  const int bh = blockIdx.x / blocks;
  const int e = (blockIdx.x % blocks) * kThreads + threadIdx.x;
  const int64_t kCarryVecs = vecs;
  float4* s = reinterpret_cast<float4*>(state) + (int64_t)bh * nc * vecs + e;
  const float* d = decay + (int64_t)bh * nc;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 16;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 v[kAhead];
    float g[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < nc) {
        v[k] = s[(int64_t)(c0 + k) * kCarryVecs];
        g[k] = d[c0 + k];
      }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < nc) {
        s[(int64_t)(c0 + k) * kCarryVecs] = h;
        h.x = fmaf(g[k], h.x, v[k].x);
        h.y = fmaf(g[k], h.y, v[k].y);
        h.z = fmaf(g[k], h.z, v[k].z);
        h.w = fmaf(g[k], h.w, v[k].w);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

// Shared memory of the states kernel: B and x key tiles, two stages each,
// then acum (double) and the decay-to-end weights (above kMaxQ two tiles'
// weights, and no acum).
constexpr size_t kStatesSmem =
    sizeof(float) * (2 * 2 * kT * kT + kMaxQ) + sizeof(double) * (kMaxQ + 4);

// The 64 x 64 state tile (rows n0.., columns p0..) of one slice.
__global__ void __launch_bounds__(kThreads)
ssd_states(const Args g, const Slices sl) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [2][64][64]
  float* Xs = Bs + 2 * kT * kT;                   // [2][64][64]
  float* w = Xs + 2 * kT * kT;                    // [kMaxQ]
  double* acum = reinterpret_cast<double*>(w + kMaxQ);  // [kMaxQ]
  double* ws = acum + kMaxQ;                      // [4]

  int bh, c, ns, ps;
  states_block(g, sl, &bh, &c, &ns, &ps);
  const Chunk k = chunk_of(g, bh, c);
  const int n0 = ns * kT, p0 = ps * kT;
  const float* Bb = static_cast<const float*>(g.B) + k.pos * g.N + n0;
  const float* xb = g.x + k.pos * g.P + p0;
  const int64_t n_row = (int64_t)g.H * g.N, x_row = (int64_t)g.H * g.P;
  const int tiles = (k.rows + kT - 1) / kT;
  const bool long_q = g.Q > kMaxQ;
  const double* acum_g = g.acum + k.scratch * g.Qpad;
  const double a_end = long_q ? acum_g[g.Q - 1] : 0.0;

  stage_f32(Bs, kT, Bb, n_row, 0, k.rows, g.N - n0, g.vec_bc);
  stage_f32(Xs, kT, xb, x_row, 0, k.rows, g.P - p0, g.vec_x);
  cp_async_commit();
  if (long_q)
    tile_weights(acum_g, a_end, 0, w);
  else
    chunk_sums(g, k, acum, ws, w, ns == 0 && ps == 0);

  // thread (r, c): state rows n = 8r..8r+7, columns p = 4c..4c+3
  const int r = threadIdx.x / 16, cc = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();    // tile kt landed, tile kt - 1's stage is free
    if (kt + 1 < tiles) {
      stage_f32(Bs + (st ^ 1) * kT * kT, kT, Bb, n_row, (kt + 1) * kT,
                k.rows, g.N - n0, g.vec_bc);
      stage_f32(Xs + (st ^ 1) * kT * kT, kT, xb, x_row, (kt + 1) * kT,
                k.rows, g.P - p0, g.vec_x);
      if (long_q) tile_weights(acum_g, a_end, (kt + 1) * kT, w + (st ^ 1) * kT);
    }
    cp_async_commit();
    const float* Bt = Bs + st * kT * kT;
    const float* Xt = Xs + st * kT * kT;
    const float* wt = long_q ? w + st * kT : w + kt * kT;
#pragma unroll 4
    for (int t = 0; t < kT; ++t) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bt + t * kT + 8 * r);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bt + t * kT + 8 * r + 4);
      float4 xv = *reinterpret_cast<const float4*>(Xt + t * kT + 4 * cc);
      const float wv = wt[t];
      xv.x *= wv; xv.y *= wv; xv.z *= wv; xv.w *= wv;
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xs[j], acc[i][j]);
    }
  }
  cp_async_wait_all();
  float* out = g.state + k.scratch * state_size(sl) + (int64_t)n0 * sl.Pp + p0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(out + (int64_t)(8 * r + i) * sl.Pp + 4 * cc) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// Shared memory of the outputs kernel for a pass of kNT columns of N: the
// C tile, two stages of B (kNT + 4 floats a row each), the gated scores,
// two stages of x, then acum of the query rows and of two key tiles
// (double).  kNT 64: ~104 KB, two blocks an SM; kNT 128: ~153 KB, one.
template <int kNT>
constexpr size_t kOutSmem = sizeof(float) * (3 * kT * (kNT + 4) + kT * kLd +
                                             2 * kT * kT) +
                            sizeof(double) * 3 * kT;

// One query tile of one chunk, P slice and pass of N columns [n0, n0 +
// nw), nw <= kNT.
template <typename TY, int kNT, bool kSliced>
__global__ void __launch_bounds__(kThreads, kNT == kT ? 2 : 1)
ssd_outputs(const Args g, const Slices sl) {
  constexpr int kLdN = kNT + 4;     // padded row of the C and B tiles
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);   // [64][kLdN]
  float* Bs = Cs + kT * kLdN;                     // [2][64][kLdN]
  float* Ps = Bs + 2 * kT * kLdN;                 // [64][kLd]
  float* Xs = Ps + kT * kLd;                      // [2][64][64]
  double* acq = reinterpret_cast<double*>(Xs + 2 * kT * kT);  // [64]
  double* ack = acq + kT;                         // [2][64]

  const Pass<kSliced> pass(g, sl, kNT);
  int bh, c, ps, qt;
  out_block(g, pass.np, &bh, &c, &ps, &qt);
  const Chunk k = chunk_of(g, bh, c);
  const int q0 = qt * kT, p0 = ps * kT;
  if (q0 >= k.rows) return;         // a query tile past L: nothing to write
  const float* Bb = static_cast<const float*>(g.B) + k.pos * g.N + pass.n0;
  const float* Cb = static_cast<const float*>(g.C) + k.pos * g.N + pass.n0;
  const float* xb = g.x + k.pos * g.P + p0;
  const int64_t n_row = (int64_t)g.H * g.N, x_row = (int64_t)g.H * g.P;
  const double* acum = g.acum + k.scratch * g.Qpad;
  // h_prev's rows [n0, n0 + kNT) and the slice's 64 columns, in B's second
  // stage, 64 a row
  float* Hs = Bs + kT * kLdN;
  const float* hb =
      g.state + k.scratch * pass.state + (int64_t)pass.n0 * pass.Pp + p0;

  stage_f32<kNT>(Cs, kLdN, Cb, n_row, q0, k.rows, pass.nw, g.vec_bc);
#pragma unroll
  for (int j = 0; j < kNT / kT; ++j)
    stage_f32(Hs + j * kT * kT, kT, hb + (int64_t)j * kT * pass.Pp, pass.Pp, 0,
              pass.h_rows - j * kT, kT, 1);
  stage_f32<kNT>(Bs, kLdN, Bb, n_row, 0, k.rows, pass.nw, g.vec_bc);
  stage_f32(Xs, kT, xb, x_row, 0, k.rows, g.P - p0, g.vec_x);
  cp_async_commit();
  if (threadIdx.x < kT) {
    acq[threadIdx.x] = acum[q0 + threadIdx.x];
    ack[threadIdx.x] = acum[threadIdx.x];
  }
  cp_async_wait_all();
  __syncthreads();

  const int r = threadIdx.x / 16, cc = threadIdx.x % 16;
  const int n4 = (pass.nw + 3) & ~3;
  // the carried term exp(acum_i) C_i h_prev
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < n4; n += 4) {
    float4 cv[8], hv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cv[i] = *reinterpret_cast<const float4*>(Cs + (r + 8 * i) * kLdN + n);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      hv[t] = *reinterpret_cast<const float4*>(Hs + (n + t) * kT + 4 * cc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float cs[4] = {cv[i].x, cv[i].y, cv[i].z, cv[i].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[i][0] = fmaf(cs[t], hv[t].x, acc[i][0]);
        acc[i][1] = fmaf(cs[t], hv[t].y, acc[i][1]);
        acc[i][2] = fmaf(cs[t], hv[t].z, acc[i][2]);
        acc[i][3] = fmaf(cs[t], hv[t].w, acc[i][3]);
      }
    }
  }
  double aq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    aq[i] = acq[r + 8 * i];
    const float gq = (float)exp(aq[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= gq;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();    // tile kt landed; tile kt - 1 (and h) are done with
    if (kt < qt) {
      stage_f32<kNT>(Bs + (st ^ 1) * kT * kLdN, kLdN, Bb, n_row,
                     (kt + 1) * kT, k.rows, pass.nw, g.vec_bc);
      stage_f32(Xs + (st ^ 1) * kT * kT, kT, xb, x_row, (kt + 1) * kT,
                k.rows, g.P - p0, g.vec_x);
      if (threadIdx.x < kT)
        ack[(st ^ 1) * kT + threadIdx.x] = acum[(kt + 1) * kT + threadIdx.x];
    }
    cp_async_commit();
    const float* Bt = Bs + st * kLdN * kT;
    const float* Xt = Xs + st * kT * kT;
    const double* akt = ack + st * kT;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < n4; n += 4) {
      float4 cv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = *reinterpret_cast<const float4*>(Cs + (r + 8 * i) * kLdN + n);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] =
            *reinterpret_cast<const float4*>(Bt + (cc + 16 * j) * kLdN + n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(cv[i].x, bv[j].x, s[i][j]);
          s[i][j] = fmaf(cv[i].y, bv[j].y, s[i][j]);
          s[i][j] = fmaf(cv[i].z, bv[j].z, s[i][j]);
          s[i][j] = fmaf(cv[i].w, bv[j].w, s[i][j]);
        }
    }
    // the gate, and the causal mask on the diagonal tile; a warp's rows are
    // the rows its own threads read back below
    const bool diag = kt == qt;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double ak = akt[cc + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool keep = !diag || cc + 16 * j <= r + 8 * i;
        Ps[(r + 8 * i) * kLd + cc + 16 * j] =
            keep ? s[i][j] * expf((float)(aq[i] - ak)) : 0.f;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < kT; key += 4) {
      float4 pv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (r + 8 * i) * kLd + key);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        xv[t] = *reinterpret_cast<const float4*>(Xt + (key + t) * kT + 4 * cc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ps_[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[i][0] = fmaf(ps_[t], xv[t].x, acc[i][0]);
          acc[i][1] = fmaf(ps_[t], xv[t].y, acc[i][1]);
          acc[i][2] = fmaf(ps_[t], xv[t].z, acc[i][2]);
          acc[i][3] = fmaf(ps_[t], xv[t].w, acc[i][3]);
        }
      }
    }
    __syncwarp();       // the scores are read before the next tile's write
  }
  cp_async_wait_all();

  TY* yb = static_cast<TY*>(g.y) + k.pos * g.P + p0;
  float* pb = sl.part + k.pos * g.P + p0;   // used only with several passes
  const int64_t y_row = (int64_t)g.H * g.P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + r + 8 * i;
    if (row >= k.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * cc + j < g.P - p0)
        put_y<kSliced>(sl, yb, pb, row * y_row + 4 * cc + j, acc[i][j]);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kTile = kT * 128;     // bytes of a 64 x 64 bf16 tile
constexpr int kTileF = kT * kT * 4; // bytes of a 64 x 64 fp32 tile

// Rows [r0, r0 + 64) of a bf16 operand (row i at src + i·row; rows at or
// past `rows` and columns at or past `width` zero) into a swizzled tile:
// by cp.async 16 bytes at a time where `vec`, else by plain loads.
__device__ __forceinline__ void stage_bf16(uint8_t* tile,
                                           const __nv_bfloat16* src,
                                           int64_t row, int r0, int rows,
                                           int width, int vec) {
  for (int e = threadIdx.x; e < kT * 8; e += kThreads) {
    const int r = e / 8, col = (e % 8) * 8;
    const bool ok = r0 + r < rows && col < width;
    const __nv_bfloat16* s = src + (int64_t)(r0 + r) * row + col;
    if (vec) {
      cp_async16(smem_u32(tile + swz(r, col)), ok ? s : src, ok ? 16 : 0);
    } else {
      __nv_bfloat16 tmp[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        tmp[k] = ok && col + k < width ? s[k] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(tile + swz(r, col)) =
          *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// A staged 64 x 64 fp32 tile (64 floats a row), each row times w[r] where
// w is given, rounded to bf16 into the swizzled `hi` and its rounding
// error, rounded again, into `lo`.
__device__ __forceinline__ void split(uint8_t* hi, uint8_t* lo,
                                      const float* src, const float* w) {
#pragma unroll
  for (int it = 0; it < kT * 8 / kThreads; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int r = e / 8, col = (e % 8) * 8;
    const float4 u = *reinterpret_cast<const float4*>(src + r * kT + col);
    const float4 v = *reinterpret_cast<const float4*>(src + r * kT + col + 4);
    float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    if (w) {
      const float wr = w[r];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] *= wr;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      const float2 hf = __bfloat1622float2(hv);
      h[k] = *reinterpret_cast<const uint32_t*>(&hv);
      l[k] = pack_bf16(f[2 * k] - hf.x, f[2 * k + 1] - hf.y);
    }
    *reinterpret_cast<uint4*>(hi + swz(r, col)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + swz(r, col)) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The aligned start of dynamic shared memory (the swizzled tiles need
// 1024-byte alignment; each kernel asks for 1024 bytes of slack).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// Shared memory: two stages of B (bf16) and of x (fp32, as loaded), the
// bf16 halves of w x, then the weights and acum.
constexpr size_t kStatesSmem = 1024 + 4 * kTile + 2 * kTileF +
                               sizeof(float) * kMaxQ +
                               sizeof(double) * (kMaxQ + 4);

__global__ void __launch_bounds__(kThreads)
ssd_states(const Args g, const Slices sl) {
  extern __shared__ uint8_t smem[];
  uint8_t* base = aligned_smem(smem);
  uint8_t* sB = base;                       // [2][64 positions][64 n]
  uint8_t* sXh = base + 2 * kTile;          // [64 positions][64 p]
  uint8_t* sXl = base + 3 * kTile;
  float* sXf = reinterpret_cast<float*>(base + 4 * kTile);  // [2][64][64]
  float* w = sXf + 2 * kT * kT;
  double* acum = reinterpret_cast<double*>(w + kMaxQ);
  double* ws = acum + kMaxQ;

  int bh, c, ns, ps;
  states_block(g, sl, &bh, &c, &ns, &ps);
  const Chunk k = chunk_of(g, bh, c);
  const int n0 = ns * kT, p0 = ps * kT;
  const __nv_bfloat16* Bb =
      static_cast<const __nv_bfloat16*>(g.B) + k.pos * g.N + n0;
  const float* xb = g.x + k.pos * g.P + p0;
  const int64_t n_row = (int64_t)g.H * g.N, x_row = (int64_t)g.H * g.P;
  const int tiles = (k.rows + kT - 1) / kT;
  const bool long_q = g.Q > kMaxQ;
  const double* acum_g = g.acum + k.scratch * g.Qpad;
  const double a_end = long_q ? acum_g[g.Q - 1] : 0.0;

  stage_bf16(sB, Bb, n_row, 0, k.rows, g.N - n0, g.vec_bc);
  stage_f32(sXf, kT, xb, x_row, 0, k.rows, g.P - p0, g.vec_x);
  cp_async_commit();
  if (long_q)
    tile_weights(acum_g, a_end, 0, w);
  else
    chunk_sums(g, k, acum, ws, w, ns == 0 && ps == 0);

  // the state (n rows, p columns) = B^T (w x): A = B^T and B = w x, both
  // MN-major (the positions are the k axis)
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  const uint32_t aXh = smem_u32(sXh), aXl = smem_u32(sXl);
  for (int kt = 0; kt < tiles; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();    // tile kt landed; the last products are done
    if (kt + 1 < tiles) {
      stage_bf16(sB + (st ^ 1) * kTile, Bb, n_row, (kt + 1) * kT, k.rows,
                 g.N - n0, g.vec_bc);
      stage_f32(sXf + (st ^ 1) * kT * kT, kT, xb, x_row, (kt + 1) * kT,
                k.rows, g.P - p0, g.vec_x);
      if (long_q) tile_weights(acum_g, a_end, (kt + 1) * kT, w + (st ^ 1) * kT);
    }
    cp_async_commit();
    split(sXh, sXl, sXf + st * kT * kT, long_q ? w + st * kT : w + kt * kT);
    fence_async_smem();
    __syncthreads();
    const uint32_t aB = smem_u32(sB + st * kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      wgmma_ss<1, 1>(acc, mnmajor(aB + kk * 2048, 0),
                     mnmajor(aXh + kk * 2048, 0), 1);
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk)
      wgmma_ss<1, 1>(acc, mnmajor(aB + kk * 2048, 0),
                     mnmajor(aXl + kk * 2048, 0), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait_all();

  // accumulator element j: row 16·warp + lane/4 + 8·((j/2)%2), column
  // 8·(j/4) + 2·(lane%4) + j%2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* out = g.state + k.scratch * state_size(sl) + (int64_t)n0 * sl.Pp + p0;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    const int n = 16 * warp + lane / 4 + 8 * ((j / 2) % 2);
    const int p = 8 * (j / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(out + (int64_t)n * sl.Pp + p) =
        make_float2(acc[j], acc[j + 1]);
  }
}

// 2^x by the special-function unit (2 ulp, subnormal results flushed to
// 0): the bf16 route's gate, e^d = 2^(d·log2 e), its error far under the
// bf16 output's rounding.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory for a pass of kNT columns of N (kNT / 64 tiles of each of
// C, B and the halves of h, 64 columns a tile): C, B, the bf16 halves of x
// (of h first), x as loaded (fp32; h first), then acum of the query rows
// and of two key tiles. One stage each, so that four blocks share an SM at
// kNT 64 (two at 128): the next tile's x is loaded once this tile's is
// split, its B once this tile's scores are taken, both while the products
// run.
template <int kNT>
constexpr size_t kOutSmem = 1024 + 4 * (kNT / kT) * kTile +
                            (kNT / kT) * kTileF + sizeof(double) * 3 * kT;

// Rows [r0, r0 + 64) of a bf16 operand's columns [0, kNT) into kNT / 64
// swizzled tiles, one per 64 columns (columns at or past `width` zero).
template <int kNT>
__device__ __forceinline__ void stage_bf16_cols(uint8_t* tiles,
                                                const __nv_bfloat16* src,
                                                int64_t row, int r0, int rows,
                                                int width, int vec) {
#pragma unroll
  for (int j = 0; j < kNT / kT; ++j)
    stage_bf16(tiles + j * kTile, src + j * kT, row, r0, rows, width - j * kT,
               vec);
}

// The K-major descriptor of k16 step kk of a kNT-wide operand held as
// 64-column tiles.
__device__ __forceinline__ uint64_t kstep(uint32_t tiles, int kk) {
  return kmajor(tiles + (kk / 4) * kTile + (kk % 4) * 32);
}

// One query tile of one chunk, P slice and pass of N columns [n0, n0 +
// nw), nw <= kNT.
template <typename TY, int kNT, bool kSliced>
__global__ void __launch_bounds__(kThreads, kNT == kT ? 4 : 2)
ssd_outputs(const Args g, const Slices sl) {
  constexpr int kNTiles = kNT / kT;
  extern __shared__ uint8_t smem[];
  uint8_t* base = aligned_smem(smem);
  uint8_t* sC = base;                       // [64 queries][kNT n]
  uint8_t* sB = base + kNTiles * kTile;     // [64 keys][kNT n]
  // [64 keys][64 p]; h_prev's [kNT n][64 p]
  uint8_t* sXh = base + 2 * kNTiles * kTile;
  uint8_t* sXl = base + 3 * kNTiles * kTile;
  float* sXf = reinterpret_cast<float*>(base + 4 * kNTiles * kTile);
  double* acq = reinterpret_cast<double*>(sXf + kNT * kT);      // [64]
  double* ack = acq + kT;                                       // [2][64]

  const Pass<kSliced> pass(g, sl, kNT);
  int bh, c, ps, qt;
  out_block(g, pass.np, &bh, &c, &ps, &qt);
  const Chunk k = chunk_of(g, bh, c);
  const int q0 = qt * kT, p0 = ps * kT;
  if (q0 >= k.rows) return;
  const __nv_bfloat16* Bb =
      static_cast<const __nv_bfloat16*>(g.B) + k.pos * g.N + pass.n0;
  const __nv_bfloat16* Cb =
      static_cast<const __nv_bfloat16*>(g.C) + k.pos * g.N + pass.n0;
  const float* xb = g.x + k.pos * g.P + p0;
  const float* hb =
      g.state + k.scratch * pass.state + (int64_t)pass.n0 * pass.Pp + p0;
  const int64_t n_row = (int64_t)g.H * g.N, x_row = (int64_t)g.H * g.P;
  const double* acum = g.acum + k.scratch * g.Qpad;
  const uint32_t aC = smem_u32(sC), aB = smem_u32(sB);
  const uint32_t aXh = smem_u32(sXh), aXl = smem_u32(sXl);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);

  stage_bf16_cols<kNT>(sC, Cb, n_row, q0, k.rows, pass.nw, g.vec_bc);
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    stage_f32(sXf + j * kT * kT, kT, hb + (int64_t)j * kT * pass.Pp, pass.Pp, 0,
              pass.h_rows - j * kT, kT, 1);
  cp_async_commit();
  if (threadIdx.x < kT) {
    acq[threadIdx.x] = acum[q0 + threadIdx.x];
    ack[threadIdx.x] = acum[threadIdx.x];
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    split(sXh + j * kTile, sXl + j * kTile, sXf + j * kT * kT, nullptr);
  fence_async_smem();
  __syncthreads();
  // key tile 0 loads while the carried term is taken
  stage_bf16_cols<kNT>(sB, Bb, n_row, 0, k.rows, pass.nw, g.vec_bc);
  stage_f32(sXf, kT, xb, x_row, 0, k.rows, g.P - p0, g.vec_x);
  cp_async_commit();

  // the carried term C·h (h MN-major: n is the k axis, its 64-row tiles
  // one after another), then each row times exp(acum_i)
  float o[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNT / 16; ++kk)
    wgmma_ss<0, 1>(o, kstep(aC, kk), mnmajor(aXh + kk * 2048, 0), kk);
#pragma unroll
  for (int kk = 0; kk < kNT / 16; ++kk)
    wgmma_ss<0, 1>(o, kstep(aC, kk), mnmajor(aXl + kk * 2048, 0), 1);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
  double aq[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) aq[hf] = acq[row0 + 8 * hf];
  const float gq[2] = {(float)exp(aq[0]), (float)exp(aq[1])};
#pragma unroll
  for (int j = 0; j < 32; ++j) o[j] *= gq[(j / 2) % 2];

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();    // tile kt landed; the last products are done
    split(sXh, sXl, sXf, nullptr);
    fence_async_smem();
    __syncthreads();
    if (kt < qt) {      // x of the next tile, into the buffer just split
      stage_f32(sXf, kT, xb, x_row, (kt + 1) * kT, k.rows, g.P - p0,
                g.vec_x);
      if (threadIdx.x < kT)
        ack[(st ^ 1) * kT + threadIdx.x] = acum[(kt + 1) * kT + threadIdx.x];
    }
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNT / 16; ++kk)
      wgmma_ss<0, 0>(s, kstep(aC, kk), kstep(aB, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncthreads();    // every thread's scores are taken: B may go
    if (kt < qt)
      stage_bf16_cols<kNT>(sB, Bb, n_row, (kt + 1) * kT, k.rows, pass.nw,
                           g.vec_bc);
    cp_async_commit();
    // the gate on the accumulator, the causal mask on the diagonal tile
    const bool diag = kt == qt;
    const double* akt = ack + st * kT;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int row = row0 + 8 * ((j / 2) % 2);
      const int col = 8 * (j / 4) + col0 + j % 2;
      const bool keep = !diag || col <= row;
      s[j] = keep ? s[j] * ex2((float)(aq[(j / 2) % 2] - akt[col]) * kLog2e)
                  : 0.f;
    }
    // P = P_hi + P_lo in bf16: the accumulator's 16 columns of step kk are
    // the A fragment of a k16 step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v0 = s[8 * kk + 2 * q], v1 = s[8 * kk + 2 * q + 1];
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hv);
        ph[kk][q] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[kk][q] = pack_bf16(v0 - hf.x, v1 - hf.y);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(o, ph[kk], mnmajor(aXh + kk * 2048, 0));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(o, ph[kk], mnmajor(aXl + kk * 2048, 0));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(o, pl[kk], mnmajor(aXh + kk * 2048, 0));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  cp_async_wait_all();

  TY* yb = static_cast<TY*>(g.y) + k.pos * g.P + p0;
  float* pb = sl.part + k.pos * g.P + p0;   // used only with several passes
  const int64_t y_row = (int64_t)g.H * g.P;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int row = q0 + row0 + 8 * ((j / 2) % 2);
    const int p = 8 * (j / 4) + col0 + j % 2;
    if (row < k.rows && p < g.P - p0)
      put_y<kSliced>(sl, yb, pb, row * y_row + p, o[j]);
  }
}

}  // namespace tc

// A kernel's dynamic shared memory, and a carveout of all shared; each
// caller asks once per process (a static of its own template).
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// One outputs pass of kNT columns of N.
template <typename TY, bool kTc, int kNT, bool kSliced>
cudaError_t outputs_pass(const Args& g, const Slices& sl, cudaStream_t st) {
  constexpr auto kernel = kTc ? tc::ssd_outputs<TY, kNT, kSliced>
                              : f32::ssd_outputs<TY, kNT, kSliced>;
  constexpr size_t bytes = kTc ? tc::kOutSmem<kNT> : f32::kOutSmem<kNT>;
  static const cudaError_t once = allow_smem((const void*)kernel, bytes);
  if (once != cudaSuccess) return once;
  const int64_t blocks = (int64_t)g.bh * g.nc * sl.np * (g.Qpad / kT);
  kernel<<<(unsigned)blocks, kThreads, bytes, st>>>(g, sl);
  return cudaGetLastError();
}

// One route's kernels: the sums (chunks above kMaxQ), the states, the
// carry, then the outputs in passes of up to kMaxNT columns of N.
template <typename TY, bool kTc>
cudaError_t launch(const Args& g, Slices sl, cudaStream_t st) {
  constexpr auto states = kTc ? tc::ssd_states : f32::ssd_states;
  constexpr size_t s_bytes = kTc ? tc::kStatesSmem : f32::kStatesSmem;
  static const cudaError_t once = allow_smem((const void*)states, s_bytes);
  cudaError_t e = once;
  if (e != cudaSuccess) return e;
  const unsigned chunks = (unsigned)g.bh * g.nc;
  if (g.Q > kMaxQ) ssd_sums<<<chunks, kThreads, 0, st>>>(g);
  states<<<chunks * sl.ns * sl.np, kThreads, s_bytes, st>>>(g, sl);
  const int vecs = sl.Np * sl.Pp / 4;
  ssd_carry<<<(unsigned)g.bh * (vecs / kThreads), kThreads, 0, st>>>(
      g.state, g.decay, g.nc, vecs);
  e = cudaGetLastError();
  for (int n0 = 0; n0 < g.N && e == cudaSuccess; n0 += kMaxNT) {
    sl.n0 = n0;
    sl.nw = min(kMaxNT, g.N - n0);
    sl.first = n0 == 0;
    sl.last = n0 + kMaxNT >= g.N;
    e = g.N <= kT && g.P <= kT
            ? outputs_pass<TY, kTc, kT, false>(g, sl, st)
        : sl.nw <= kT ? outputs_pass<TY, kTc, kT, true>(g, sl, st)
                      : outputs_pass<TY, kTc, kMaxNT, true>(g, sl, st);
  }
  return e;
}

}  // namespace

extern "C" {

// Scratch: acum (batch·H, chunks, Qpad) doubles, state (batch·H, chunks,
// Np, Pp) and decay (batch·H, chunks) floats, chunks = ceil(L / Q), Qpad =
// Q rounded up to 64, Np and Pp N and P rounded up to 64; part, (batch, L,
// H, P) floats where N > 128 (several outputs passes), else unused (may be
// null).
int fedadc_ssd_scan(const void* x, const void* a, const void* B,
                    const void* C, void* y, void* acum, void* state,
                    void* decay, void* part,
                    int64_t batch, int64_t L, int64_t H, int64_t P, int64_t N,
                    int64_t Q, int bc_dtype, int y_dtype, void* stream) {
  if (P < 1 || N < 1 || Q < 1 || L < 1 || batch < 1 || H < 1 ||
      (bc_dtype != kF32 && bc_dtype != kBF16) || (N > kMaxNT && !part))
    return (int)cudaErrorInvalidValue;
  Args g;
  g.x = static_cast<const float*>(x);
  g.a = static_cast<const float*>(a);
  g.B = B;
  g.C = C;
  g.y = y;
  g.acum = static_cast<double*>(acum);
  g.state = static_cast<float*>(state);
  g.decay = static_cast<float*>(decay);
  const int64_t Qpad = (Q + kT - 1) / kT * kT, nc = (L + Q - 1) / Q;
  const int64_t Np = (N + kT - 1) / kT * kT, Pp = (P + kT - 1) / kT * kT;
  const int64_t bh = batch * H;
  // every grid, and a state's float4s, in int (ssd_scan.plan's bounds)
  const int64_t blocks = bh * nc * (Qpad / kT) * (Pp / kT);
  if (blocks > INT32_MAX || bh * nc * (Np / kT) * (Pp / kT) > INT32_MAX ||
      Np * Pp > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  g.L = (int)L, g.H = (int)H, g.P = (int)P, g.N = (int)N, g.Q = (int)Q;
  g.Qpad = (int)Qpad;
  g.nc = (int)nc;
  g.bh = (int)bh;
  // 16-byte copies: 4 floats, or 8 bf16 of B and C on the bf16 route
  const bool x_al = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bc_al = reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % 16 == 0;
  g.vec_x = x_al && P % 4 == 0;
  g.vec_bc = bc_al && N % (bc_dtype == kBF16 ? 8 : 4) == 0;
  Slices sl;
  sl.part = static_cast<float*>(part);
  sl.Np = (int)Np, sl.Pp = (int)Pp;
  sl.ns = (int)(Np / kT), sl.np = (int)(Pp / kT);
  sl.n0 = 0, sl.nw = 0, sl.first = 1, sl.last = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tcore = bc_dtype == kBF16;
  if (y_dtype == kBF16)
    return (int)(tcore ? launch<__nv_bfloat16, true>(g, sl, st)
                       : launch<__nv_bfloat16, false>(g, sl, st));
  return (int)(tcore ? launch<float, true>(g, sl, st)
                     : launch<float, false>(g, sl, st));
}

const char* fedadc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
