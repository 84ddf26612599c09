// The encoder-block tail's backward for Hopper (sm_90a), fp32, its
// products on the tensor cores.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, it
// differentiates its XLA graph (whisper_tpu/train.py:65
// jax.value_and_grad). The port's train path runs every encoder layer's
// tail through encoder_tail.cu, so its gradient is this file's products
// and passes, then flash_attention_bwd.cu. The forward
// (ops/encoder_layer.py encoder_block_tail_plain, in fp32):
//
//   a   = attention(q, k, v)          (B, T, d), kept by the forward
//   h2  = h_in + (a Wo + bo)
//   y   = LN2(h2) = xhat g + b,  xhat = (h2 - mean) rstd
//   u   = y W1 + b1;   t1 = gelu_erf(u)
//   out = h2 + (t1 W2 + b2)
//
// and, with G the output's gradient, its backward:
//
//   dW2 = t1^T G;  db2 = sum G;  dt1 = G W2^T
//   du  = dt1 gelu'(u);  dW1 = y^T du;  db1 = sum du;  dy = du W1^T
//   dg  = sum dy xhat;  db = sum dy
//   dh2 = G + rstd (dy g - mean(dy g) - xhat mean(dy g xhat))
//   dWo = a^T dh2;  dbo = sum dh2;  da = dh2 Wo^T;  dh_in = dh2
//   dq, dk, dv = flash backward at (q, k, v, a, lse, da)
//
// The forward keeps only a and the rows' log-sum-exp (lse); the backward
// recomputes h2 and u with two products (z = a Wo, u = y W1) rather than
// keeping h2, y and t1 per layer (at turbo B=4, 32 layers: 10 GB).
//
// What bounds it on the H100: operations. The train path runs in fp32
// (TF32 off, as JAX's Precision.HIGHEST): 67 TFLOP/s on the CUDA cores.
// Every product here runs as split TF32 on the tensor cores, as
// flash_attention_bwd.cu's do: 495 / 3 = 165 TFLOP/s of fp32 products.
// A tiny B=16 layer (24,000 rows, d 384, ff 1536) is the attention's
// backward, 0.84 ms at that rate, plus the products, twice the forward's
// (127.4 GFLOP), 0.77 ms: 1.61 ms; a turbo B=4 layer (6,000 rows, d 1280,
// ff 5120) 0.70 + 2.14 = 2.84 ms. The two recomputed products add 35 and
// 98 GFLOP; the passes move ~0.6 GB at tiny (0.18 ms at 3.35 TB/s).
// mma.sync reaches only ~300 of the 495 TFLOP/s of TF32 on this card,
// ~100 TFLOP/s of fp32 products; wgmma m64n128k8 chains 478-488, ~160,
// with a fold every 12 products as here (tools/mma_rate.cu).
//
// The products: one tile kernel, gemm<OP>, an instantiation (and a kernel
// name, for a profile) a product. Split TF32 as flash_attention_bwd.cu's:
// each fp32 operand x is split in registers, big = x rounded to TF32
// (wt::tf32_rna), small = x - big, whose low 13 bits the tensor cores
// drop; a product is three wgmma m64n128k8 TF32 MMAs, small.big, big.small
// and big.big. The tensor cores' own fp32 sums are taken to round toward
// zero, so no accumulator sums more than one 32-deep k tile: each tile's
// twelve products start a fresh accumulator (scale-d 0), folded into the
// fp32 total by round-to-nearest FADDs.
//   A block is two warpgroups of 64 rows, 128 x 128 outputs, one block an
// SM (244 registers a thread: the total and the tile's accumulator take
// 128). A comes from registers: each thread fetches its own A fragments
// from global memory, the next tile's in flight under this tile's
// products, and splits them itself. Within each 8-deep k step the slots
// are renumbered (slot t holds k 2t, slot t + 4 k 2t + 1), so a thread's
// A values are one float2 of a row. B is fetched the same way into
// registers, split, and stored as big and small K-major tiles in the
// 128-byte swizzle (in the renumbered order), double-buffered, so that
// the layouts that wgmma cannot read (32-bit operands are K-major only)
// are transposed on the way in: a row product (M = R rows) reads its
// weight as (N, K) (z's and u's transposed once a call by the wrapper), a
// weight gradient (K = R) both operands as (K, M) and (K, N). R is no
// multiple of a tile: the ragged edge (M of a row product, K of a weight
// gradient) is fetched as zeros.
//   A weight gradient's output is a few tiles (tiny's dWo 9), so its K is
// cut into `split_k` ranges of whole tiles, enough blocks to fill the
// card's last wave to 90% and no more partials than one (R, ff)
// activation holds; each range writes a partial and `reduce_splits` sums
// them in index order: no atomics, a rerun is bit-equal.
//   Two passes ride in the products. dt1's block reads u's tile and b1's
// columns (cp.async, in flight from its start); each thread evaluates its
// own outputs' t1 = gelu(u + b1), stored over u, and gelu'(u + b1), kept
// in shared memory, with the exact erf of the elementwise pass they
// replace, a share under each of the first 8 k tiles' products, so that
// its epilogue only multiplies, du = dt1 gelu' (the GELU in the epilogue,
// with the tensor cores idle, cost 0.18 ms a turbo layer against the
// separate pass's 0.17). Each weight
// gradient's first row of blocks sums its B's columns over its k range as
// it stores them, db2 = sum G, db1 = sum du, dbo = sum dh2, in a fixed
// order. The two row-wide LN passes stay apart (a warp a row, the
// row in registers: d up to 1280 spans ten 128-column tiles), as do dg
// and db (colsum_*).
//   This design measured faster than mma.sync m16n8k8 tiles, than wgmma
// with both operands split into shared memory, and than one warpgroup a
// block at two blocks an SM (tools/flash_bwd_time.py --tail; PERF.md).
// It runs the products at 67-74 TFLOP/s of fp32 work (cuBLAS fp32 45-48),
// 42-46% of wgmma's: each 32-deep k tile of a block reads 32 KB of fp32
// operands for 1 MFLOP, which at that ceiling would take ~5 TB/s from L2.
//
// Stages, one call of wt_encoder_tail_bwd each, in the wrapper's order:
// Z, LN_FORWARD, U, DT1, DW2, DW1, DY, LN_BACKWARD, DWO, DA; then the
// wrapper launches the attention's backward on da.

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::smem_addr;
using wt::split_tf32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1280;              // a row: 5 x 8 values a lane
constexpr int LN_CHUNKS = MAX_D / 256;
constexpr int CHUNKS = 64;               // row ranges of the column sums
constexpr int JOBS = 2;                  // dg, db
constexpr int SUM_COLS = 128;            // columns a column-sum block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// The packed fp32 vectors, as the forward's misc: [bo | b1 | b2 | g | b]
struct Vecs {
  const float *bo, *b1, *b2, *g, *b;
  __device__ __host__ Vecs(const float* m, int d, int ff)
      : bo(m), b1(m + d), b2(m + d + ff), g(m + 2 * d + ff),
        b(m + 3 * d + ff) {}
};

// ---------------------------------------------------------------------------
// The products: split-TF32 wgmma tiles
// ---------------------------------------------------------------------------

namespace mm {

constexpr int BM = 128, BN = 128, BK = 32;  // a block's outputs, k a tile
constexpr int B_TILE = BN * 128;            // bytes: 128 rows of 32 fp32
constexpr int BUF = 2 * B_TILE;             // B big, B small
constexpr int ULD = BN + 8;                 // dt1's u tile rows (floats)
constexpr size_t SMEM = 2 * BUF + wt::ATOM_BYTES;
constexpr size_t SMEM_DT1 = SMEM + (size_t)(BM * ULD + BN) * sizeof(float);
constexpr int GELU_TILES = 8;               // dt1's GELU spread over k tiles

enum Op { Z, U, DT1, DW2, DW1, DY, DWO, DA, N_OPS };

// A row product (M = R) reads both operands K-major: A the activation
// rows, B the weight as (N, K); a weight gradient (K = R) reads both
// row-major, (K, M) and (K, N).
__host__ __device__ constexpr bool is_row_product(int op) {
  return op != DW2 && op != DW1 && op != DWO;
}

struct Gemm {
  const float* a;
  const float* b;
  float* c;         // (M, N); a weight gradient's: (splits, M, N) partials
  float* u;         // DT1: u (M, N) in, t1 out
  const float* b1;  // DT1: fc1's bias (N)
  float* col;       // a weight gradient's B column sums (splits, N)
  int M, N, K;
  int lda, ldb;
  int chunk;        // k a split (a multiple of BK; K for a row product)
};

// t = gelu(x) = x Phi(x) and its derivative d = Phi(x) + x phi(x), Phi by
// erf (du = dt1 d, as the elementwise pass it replaces rounded it)
__device__ __forceinline__ void gelu_pair(float x, float& t, float& d) {
  const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
  const float pdf = 0.39894228040143268f * expf(-0.5f * x * x);
  t = x * cdf;
  d = cdf + x * pdf;
}

__device__ __forceinline__ float f4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// This thread's A values of a tile: rows r and r + 8 (h) of its warp, k
// 8 j + 2 t and + 1 (j < 4); rows past `rows` and k past `cols` are 0.
// K-major source: src is the tile's first row; else its first k row.
template <bool KMAJ>
__device__ __forceinline__ void fetch_a(float2 (&a)[2][4], const float* src,
                                        long long ld, int rows, int cols,
                                        int r, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = r + 8 * h, k = 8 * j + 2 * t;
      if (KMAJ) {
        a[h][j] = m < rows && k < cols
                      ? __ldg(reinterpret_cast<const float2*>(src + m * ld + k))
                      : make_float2(0.f, 0.f);
      } else {
        a[h][j].x = m < rows && k < cols ? __ldg(src + k * ld + m) : 0.f;
        a[h][j].y =
            m < rows && k + 1 < cols ? __ldg(src + (k + 1) * ld + m) : 0.f;
      }
    }
}

// B's 16 values of a tile for this thread: two items of (column n, 8-deep
// step j), k 8 j.. 8 j + 7. K-major source (rows n): item tid + 256 i is
// n = item / 4, j = item % 4 (two 16-byte loads); else (rows k): n = tid %
// 128 for both items, j = item / 128 (eight loads, 32 lanes on 32
// consecutive columns). Past `rows` (K-major: columns n; else k) and
// `cols`, 0.
template <bool KMAJ>
__device__ __forceinline__ void fetch_b(float (&b)[16], const float* src,
                                        long long ld, int rows, int cols,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = tid + i * THREADS;
    if (KMAJ) {
      const int n = item >> 2, k = 8 * (item & 3);
      const bool live = n < rows && k < cols;
      const float4* q = reinterpret_cast<const float4*>(src + n * ld + k);
      const float4 lo = live ? __ldg(q) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 hi = live ? __ldg(q + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[8 * i + e] = f4(lo, e);
        b[8 * i + 4 + e] = f4(hi, e);
      }
    } else {
      const int n = item & (BN - 1), k = 8 * (item >> 7);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        b[8 * i + e] = k + e < rows && n < cols ? __ldg(src + (k + e) * ld + n)
                                                : 0.f;
    }
  }
}

// fetch_b's values split into B's big and small K-major tiles, slots
// renumbered: four 16-byte stores, on 32 distinct banks a quarter warp
template <bool KMAJ>
__device__ __forceinline__ void stash_b(const float (&b)[16], uint8_t* hi,
                                        uint8_t* lo, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int item = tid + i * THREADS;
    const int n = KMAJ ? item >> 2 : item & (BN - 1);
    const int j = KMAJ ? item & 3 : item >> 7;
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int at = n * 128 + (((2 * j + odd) ^ (n & 7)) << 4);
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(b[8 * i + 2 * e + odd], h[e], l[e]);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// One 128 x 128 tile of C = A B over the k range of split blockIdx.z.
// Warpgroup wg owns rows 64 wg..; its thread (warp w, lane 4 g + t)
// holds rows +16 w + g (+ 8) and columns 8 c + 2 t (+ 1), c < 16:
// accumulator 4 c + 2 h + e.
template <int OP>
__global__ void __launch_bounds__(THREADS, 1) gemm(const Gemm p) {
  constexpr bool KMAJ = is_row_product(OP);
  constexpr bool SPLIT = !KMAJ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + wt::ATOM_BYTES - 1) & ~(uint32_t)(wt::ATOM_BYTES - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int w = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = 64 * wg + 16 * w + g;      // this thread's rows r0, r0 + 8
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * p.chunk;
  const int k_end = min(p.K, k0 + p.chunk);
  const int n_tiles = (k_end - k0 + BK - 1) / BK;

  // dt1: u's tile (rows of ULD floats) and b1's columns in flight from
  // the start
  float* const us = reinterpret_cast<float*>(sm + 2 * BUF);
  float* const b1s = us + BM * ULD;
  if (OP == DT1) {
#pragma unroll
    for (int i = 0; i < BM * BN / 4 / THREADS; ++i) {
      const int id = tid + i * THREADS, r = id >> 5, c = 4 * (id & 31);
      const bool live = m0 + r < p.M && n0 + c < p.N;
      cp_async16(smem_addr(us + r * ULD + c),
                 p.u + (live ? (size_t)(m0 + r) * p.N + n0 + c : 0),
                 live ? 16 : 0);
    }
    if (tid < BN / 4) {
      const bool live = n0 + 4 * tid < p.N;
      cp_async16(smem_addr(b1s + 4 * tid), p.b1 + (live ? n0 + 4 * tid : 0),
                 live ? 16 : 0);
    }
    cp_async_commit();
  }
  // this thread's dt1 outputs as 32 column pairs (row r0 + 8 (i % 2),
  // columns 8 (i / 2) + 2 t..), a share of them under each of the first
  // GELU_TILES k tiles' products
  const int gelu_share = (32 + min(n_tiles, GELU_TILES) - 1) /
                         min(n_tiles, GELU_TILES);

  float2 sa[2][4];                          // the next tile's A, raw
  float sb[16];                             // and B's
  auto fetch = [&](int tile) {
    const int k = k0 + tile * BK;
    if (KMAJ)
      fetch_a<true>(sa, p.a + (size_t)m0 * p.lda + k, p.lda, p.M - m0,
                    k_end - k, r0, t);
    else
      fetch_a<false>(sa, p.a + (size_t)k * p.lda + m0, p.lda, p.M - m0,
                     k_end - k, r0, t);
    if (KMAJ)
      fetch_b<true>(sb, p.b + (size_t)n0 * p.ldb + k, p.ldb, p.N - n0,
                    k_end - k, tid);
    else
      fetch_b<false>(sb, p.b + (size_t)k * p.ldb + n0, p.ldb, k_end - k,
                     p.N - n0, tid);
  };
  // a weight gradient's bias: the first row of blocks sums B's columns;
  // both of this thread's items lie in column tid % 128
  const bool sums = SPLIT && p.col != nullptr && blockIdx.y == 0;
  float col_sum = 0.f;
  auto stash = [&](int buf) {
    uint8_t* b = sm + buf * BUF;
    stash_b<KMAJ>(sb, b, b + B_TILE, tid);
    if (sums)
#pragma unroll
      for (int i = 0; i < 16; ++i) col_sum += sb[i];
  };
  // A's big and small fragments of the current tile, step j at 4 j..
  uint32_t ahi[16], alo[16];
  auto split_a = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(sa[0][j].x, ahi[4 * j], alo[4 * j]);
      split_tf32(sa[1][j].x, ahi[4 * j + 1], alo[4 * j + 1]);
      split_tf32(sa[0][j].y, ahi[4 * j + 2], alo[4 * j + 2]);
      split_tf32(sa[1][j].y, ahi[4 * j + 3], alo[4 * j + 3]);
    }
  };

  float total[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
  fetch(0);
  stash(0);
  split_a();
  if (n_tiles > 1) fetch(1);
  wt::fence_proxy_async();
  __syncthreads();
  for (int it = 0; it < n_tiles; ++it) {
    const uint32_t b_hi = base + (it & 1) * BUF;
    const uint32_t b_lo = b_hi + B_TILE;
    wt::fence_regs(part);
    wt::fence_regs(ahi);
    wt::fence_regs(alo);
    wt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t hi[4] = {ahi[4 * j], ahi[4 * j + 1], ahi[4 * j + 2],
                              ahi[4 * j + 3]};
      const uint32_t lo[4] = {alo[4 * j], alo[4 * j + 1], alo[4 * j + 2],
                              alo[4 * j + 3]};
      wt::wgmma_m64n128k8_tf32_rs(part, lo, wt::sw128_desc(b_hi + 32 * j, 0),
                                  j > 0);
      wt::wgmma_m64n128k8_tf32_rs(part, hi, wt::sw128_desc(b_lo + 32 * j, 0),
                                  1);
      wt::wgmma_m64n128k8_tf32_rs(part, hi, wt::sw128_desc(b_hi + 32 * j, 0),
                                  1);
    }
    wt::wgmma_commit();
    if (OP == DT1 && it * gelu_share < 32) {
      // under these products: t1 = gelu(u + b1) out, and gelu'(u + b1)
      // over this thread's own u values for the epilogue
      if (it == 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      const int end = min(32, (it + 1) * gelu_share);
#pragma unroll 1
      for (int i = it * gelu_share; i < end; ++i) {
        const int r = r0 + 8 * (i & 1), c = 8 * (i >> 1) + 2 * t;
        if (m0 + r >= p.M || n0 + c >= p.N) continue;
        float2* ut = reinterpret_cast<float2*>(us + r * ULD + c);
        const float2 uu = *ut;
        float2 t1, d1;
        gelu_pair(uu.x + b1s[c], t1.x, d1.x);
        gelu_pair(uu.y + b1s[c + 1], t1.y, d1.y);
        *reinterpret_cast<float2*>(p.u + (size_t)(m0 + r) * p.N + n0 + c) =
            t1;
        *ut = d1;
      }
    }
    // the next tile's B into the other buffer (its products finished last
    // iteration) under these products; its A once they are done
    if (it + 1 < n_tiles) stash((it + 1) & 1);
    wt::wgmma_wait();
    wt::fence_regs(part);
    wt::fence_regs(ahi);
    wt::fence_regs(alo);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += part[i];
    if (it + 1 < n_tiles) split_a();
    if (it + 2 < n_tiles) fetch(it + 2);
    wt::fence_proxy_async();
    __syncthreads();
  }

  if (sums) {
    float* half = reinterpret_cast<float*>(sm);   // free: the loop is done
    if (tid >= BN) half[tid - BN] = col_sum;
    __syncthreads();
    if (tid < BN && n0 + tid < p.N)
      p.col[(size_t)blockIdx.z * p.N + n0 + tid] = col_sum + half[tid];
  }
  float* c = p.c + (SPLIT ? (size_t)blockIdx.z * p.M * p.N : 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int row = m0 + r;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.N) continue;
      float2 v = make_float2(total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
      const size_t at = (size_t)row * p.N + col;
      if (OP == DT1) {
        // v is dt1: du = dt1 gelu'(u + b1), the first tile's work
        const float2 d1 =
            *reinterpret_cast<const float2*>(us + r * ULD + col - n0);
        v.x *= d1.x;
        v.y *= d1.y;
      }
      *reinterpret_cast<float2*>(c + at) = v;
    }
  }
}

// out[i] = sum over s < splits of part[s n4 + i], in index order (float4s)
__global__ void __launch_bounds__(THREADS)
reduce_splits(const float4* __restrict__ part, int splits, long long n4,
              float4* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 acc = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[s * n4 + i];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    out[i] = acc;
  }
}

// A weight gradient's K (the rows) cut into ranges of whole k tiles, each
// at least 4 deep and at most K / min(M, N) of them (their partials then
// hold no more floats than an (R, max(M, N)) activation): the fewest that
// fill at least one wave of the card and its last wave to 90%, else the
// best fill
struct Split {
  int n, chunk;
};
Split split_k(int M, int N, int K, int sms) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int most = max(1, min(K / (4 * BK), K / min(M, N)));
  int want = 1;
  double best = -1.0;
  for (int s = 1; s <= most; ++s) {
    const int blocks = tiles * s;
    const double fill =
        (double)blocks / ((double)sms * ((blocks + sms - 1) / sms));
    if (blocks >= sms && fill >= 0.9) {
      want = s;
      break;
    }
    if (fill > best) {
      best = fill;
      want = s;
    }
  }
  const int chunk = ((K + want - 1) / want + BK - 1) / BK * BK;
  return {(K + chunk - 1) / chunk, chunk};
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Each product's kernel takes more than the 48 KB a launch gets without
// opting in: each instantiation opts in once per device.
template <int... OPS>
cudaError_t opt_in_all(std::integer_sequence<int, OPS...>) {
  const void* fns[] = {(const void*)gemm<OPS>...};
  const size_t bytes[] = {(OPS == DT1 ? SMEM_DT1 : SMEM)...};
  for (size_t i = 0; i < sizeof(fns) / sizeof(fns[0]); ++i) {
    const cudaError_t e = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes[i]);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  if ((e = opt_in_all(std::make_integer_sequence<int, N_OPS>())) !=
      cudaSuccess)
    return e;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int OP>
cudaError_t launch(const Gemm& p, int splits, cudaStream_t s) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  gemm<OP><<<grid, THREADS, OP == DT1 ? SMEM_DT1 : SMEM, s>>>(p);
  return cudaGetLastError();
}

cudaError_t reduce(const float* part, int splits, long long n, float* out,
                   cudaStream_t s) {
  const long long n4 = n / 4;
  const long long want = (n4 + THREADS - 1) / THREADS;
  reduce_splits<<<(int)(want < 132 * 8 ? want : 132 * 8), THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(part), splits, n4,
      reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

// C (M, N) = A B for a row product (M = rows)
template <int OP>
cudaError_t row_product(const float* a, const float* b, float* c, int M,
                        int N, int K, int lda, int ldb, cudaStream_t s,
                        float* u = nullptr, const float* b1 = nullptr) {
  const Gemm p{a, b, c, u, b1, nullptr, M, N, K, lda, ldb, K};
  return launch<OP>(p, 1, s);
}

// out (M, N) = A^T B over K = rows, and bias (N) = B's column sums, by
// split-K partials in `work` summed in index order
template <int OP>
cudaError_t weight_grad(const float* a, const float* b, int M, int N,
                        int K, float* work, float* out, float* bias,
                        cudaStream_t s) {
  const Split sp = split_k(M, N, K, sm_count());
  float* col = work + (size_t)sp.n * M * N;
  const Gemm p{a, b, work, nullptr, nullptr, col, M, N, K, M, N, sp.chunk};
  cudaError_t e = launch<OP>(p, sp.n, s);
  if (e != cudaSuccess) return e;
  if ((e = reduce(work, sp.n, (long long)M * N, out, s)) != cudaSuccess)
    return e;
  return reduce(col, sp.n, N, bias, s);
}

}  // namespace mm

// ---------------------------------------------------------------------------
// The row-wide passes
// ---------------------------------------------------------------------------

// LN_FORWARD: h2 = h_in + (z + bo) over z, mean and rstd, y = xhat g + b.
// A warp a row; lane l holds columns 256 c + 8 l .. + 7.
__global__ void __launch_bounds__(THREADS)
ln_forward(float* __restrict__ z, const float* __restrict__ h_in,
           const float* __restrict__ misc, float* __restrict__ y,
           float* __restrict__ mean_out, float* __restrict__ rstd_out,
           int rows, int d, int ff, float eps) {
  const Vecs vec(misc, d, ff);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const size_t row = (size_t)r * d;
  float x[LN_CHUNKS][8], sum = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[c][i] = 0.f;
    if (k >= d) continue;
    float zz[8], hh[8];
    load8(z + row + k, zz);
    load8(h_in + row + k, hh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[c][i] = hh[i] + (zz[i] + vec.bo[k + i]);
      sum += x[c][i];
    }
    store8(z + row + k, x[c]);
  }
  const float mean = warp_sum(sum) / d;
  float dev = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    if (256 * c + 8 * lane >= d) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) dev += (x[c][i] - mean) * (x[c][i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(dev) / d + eps);
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
    if (k >= d) continue;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = (x[c][i] - mean) * rstd * vec.g[k + i] + vec.b[k + i];
    store8(y + row + k, o);
  }
  if (lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// LN_BACKWARD: per row, xhat = (h2 - mean) rstd over y, and dh2 = G + rstd
// (dy g - mean(dy g) - xhat mean(dy g xhat)) over h2. A warp a row.
__global__ void __launch_bounds__(THREADS)
ln_backward(float* __restrict__ h2, float* __restrict__ y,
            const float* __restrict__ mean_in,
            const float* __restrict__ rstd_in, const float* __restrict__ dy,
            const float* __restrict__ gout, const float* __restrict__ misc,
            int rows, int d, int ff) {
  const Vecs vec(misc, d, ff);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const size_t row = (size_t)r * d;
  const float mean = mean_in[r], rstd = rstd_in[r];
  float xh[LN_CHUNKS][8], dx[LN_CHUNKS][8], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) xh[c][i] = dx[c][i] = 0.f;
    if (k >= d) continue;
    float dd[8];
    load8(h2 + row + k, xh[c]);
    load8(dy + row + k, dd);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xh[c][i] = (xh[c][i] - mean) * rstd;
      dx[c][i] = dd[i] * vec.g[k + i];
      s1 += dx[c][i];
      s2 += dx[c][i] * xh[c][i];
    }
    store8(y + row + k, xh[c]);
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
    if (k >= d) continue;
    float g[8];
    load8(gout + row + k, g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      g[i] += rstd * (dx[c][i] - m1 - xh[c][i] * m2);
    store8(h2 + row + k, g);
  }
}

// The column sums the products do not carry: sum over rows of a[r, n]
// (times b[r, n] where b is given), each of JOBS jobs into its place in
// `out` (the misc order).
struct Sums {
  const float* a[JOBS];
  const float* b[JOBS];
  int n[JOBS];
  int at[JOBS];
};

// Partial sums of CHUNKS fixed row ranges: one thread a column (a warp's
// loads are one 128-byte line a row), the chunk's rows in order.
__global__ void __launch_bounds__(SUM_COLS)
colsum_partial(const Sums s, float* __restrict__ partial, int rows,
               int n_max) {
  const int job = blockIdx.z, n = s.n[job];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  if (col >= n) return;
  const int per = (rows + CHUNKS - 1) / CHUNKS;
  const int r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
  const float* a = s.a[job] + col;
  const float* b = s.b[job];
  float acc = 0.f;
  if (b == nullptr) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r) acc += a[(size_t)r * n];
  } else {
    b += col;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) acc += a[(size_t)r * n] * b[(size_t)r * n];
  }
  partial[((size_t)job * CHUNKS + blockIdx.y) * n_max + col] = acc;
}

__global__ void __launch_bounds__(SUM_COLS)
colsum_reduce(const Sums s, const float* __restrict__ partial,
              float* __restrict__ out, int n_max) {
  const int job = blockIdx.y;
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  if (col >= s.n[job]) return;
  float acc = 0.f;
  for (int c = 0; c < CHUNKS; ++c)
    acc += partial[((size_t)job * CHUNKS + c) * n_max + col];
  out[s.at[job] + col] = acc;
}

bool aligned16(void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (ptrs[i] == nullptr ||
        reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return false;
  return true;
}

enum Stage { Z, LN_FORWARD, U, DT1, DW2, DW1, DY, LN_BACKWARD, DWO, DA,
             N_STAGES };

}  // namespace

// Floats of the workspace the stages share at width (d, ff) over `rows`
// rows: the weight gradients' split partials and their column sums (the
// largest of the three), or the dg/db column sums' partials.
extern "C" long long wt_encoder_tail_bwd_workspace(int rows, int d, int ff) {
  const int sms = mm::sm_count();
  long long most = (long long)JOBS * CHUNKS * d;
  const int mn[3][2] = {{ff, d}, {d, ff}, {d, d}};     // dW2, dW1, dWo
  for (const auto& s : mn) {
    const mm::Split sp = mm::split_k(s[0], s[1], rows, sms);
    const long long n = (long long)sp.n * (s[0] + 1) * s[1];
    most = n > most ? n : most;
  }
  return most;
}

// One stage of the tail's backward; returns cudaGetLastError() after its
// launches (0 on success). All buffers fp32, contiguous, 16-byte aligned;
// R = rows; misc the forward's packed [bo | b1 | b2 | g | b]; work
// wt_encoder_tail_bwd_workspace floats; vecs (4 d + ff) the bias and LN
// gradients [dbo | db1 | db2 | dg | db], each written by its stage:
//   Z:           {a (R, d); wo^T (d, d); z (R, d) out}
//   LN_FORWARD:  {z (R, d) in, h2 out; h_in (R, d); misc; y (R, d) out;
//                 mean (R) out; rstd (R) out}
//   U:           {y (R, d); fc1^T (ff, d); u (R, ff) out}
//   DT1:         {G (R, d); fc2 (ff, d); u (R, ff) in, t1 out; misc;
//                 du (R, ff) out}
//   DW2:         {t1 (R, ff); G (R, d); work; dW2 (ff, d) out; vecs: db2}
//   DW1:         {y (R, d); du (R, ff); work; dW1 (d, ff) out; vecs: db1}
//   DY:          {du (R, ff); fc1 (d, ff); dy (R, d) out}
//   LN_BACKWARD: {h2 (R, d) in, dh2 out; y (R, d) in, xhat out; mean;
//                 rstd; dy (R, d); G (R, d); misc; work; vecs: dg, db}
//   DWO:         {a (R, d); dh2 (R, d); work; dWo (d, d) out; vecs: dbo}
//   DA:          {dh2 (R, d); wo (d, d); da (R, d) out}
// d is a multiple of 64 up to 1280, ff a positive multiple of 64.
extern "C" int wt_encoder_tail_bwd(int stage, void* const* buf, int rows,
                                   int d, int ff, float eps, void* stream) {
  static const int n_bufs[N_STAGES] = {3, 6, 3, 5, 5, 5, 3, 9, 5, 3};
  if (stage < 0 || stage >= N_STAGES || rows < 1 || d < 64 || d > MAX_D ||
      d % 64 != 0 || ff < 64 || ff % 64 != 0 ||
      (rows + mm::BM - 1) / mm::BM > 65535 ||
      !aligned16(buf, n_bufs[stage]))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = mm::opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + WARPS - 1) / WARPS;
  auto f = [&](int i) { return static_cast<float*>(buf[i]); };
  switch (stage) {
    case Z:
      return (int)mm::row_product<mm::Z>(f(0), f(1), f(2), rows, d, d, d,
                                         d, s);      // B: wo^T (d, d)
    case LN_FORWARD:
      ln_forward<<<row_blocks, THREADS, 0, s>>>(f(0), f(1), f(2), f(3), f(4),
                                                f(5), rows, d, ff, eps);
      return (int)cudaGetLastError();
    case U:
      return (int)mm::row_product<mm::U>(f(0), f(1), f(2), rows, ff, d, d,
                                         d, s);      // B: fc1^T (ff, d)
    case DT1:
      return (int)mm::row_product<mm::DT1>(f(0), f(1), f(4), rows, ff, d, d,
                                           d, s, f(2), Vecs(f(3), d, ff).b1);
    case DW2:
      return (int)mm::weight_grad<mm::DW2>(f(0), f(1), ff, d, rows, f(2),
                                           f(3), f(4) + d + ff, s);
    case DW1:
      return (int)mm::weight_grad<mm::DW1>(f(0), f(1), d, ff, rows, f(2),
                                           f(3), f(4) + d, s);
    case DY:
      return (int)mm::row_product<mm::DY>(f(0), f(1), f(2), rows, d, ff, ff,
                                          ff, s);
    case DWO:
      return (int)mm::weight_grad<mm::DWO>(f(0), f(1), d, d, rows, f(2),
                                           f(3), f(4), s);
    case DA:
      return (int)mm::row_product<mm::DA>(f(0), f(1), f(2), rows, d, d, d,
                                          d, s);
    default:
      break;
  }
  // LN_BACKWARD
  ln_backward<<<row_blocks, THREADS, 0, s>>>(f(0), f(1), f(2), f(3), f(4),
                                             f(5), f(6), rows, d, ff);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dg = sum dy xhat, db = sum dy
  const Sums sums{{f(4), f(4)}, {f(1), nullptr}, {d, d},
                  {2 * d + ff, 3 * d + ff}};
  colsum_partial<<<dim3((d + SUM_COLS - 1) / SUM_COLS, CHUNKS, JOBS),
                   SUM_COLS, 0, s>>>(sums, f(7), rows, d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  colsum_reduce<<<dim3((d + SUM_COLS - 1) / SUM_COLS, JOBS), SUM_COLS, 0,
                  s>>>(sums, f(7), f(8), d);
  return (int)cudaGetLastError();
}
