// Flash attention's backward for Hopper (sm_90a), fp32, on the tensor
// cores.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, it
// differentiates its XLA graph (whisper_tpu/train.py:65
// jax.value_and_grad). The port's train path runs the forward through
// flash_attention.cu (the decoder's T > 1 reads, and every encoder tail's
// attention), so its gradient is this kernel, on the forward's numerics
// (FlashAttention-2's backward):
//
//   p     = exp(s D^-0.5 - lse)       s = q . k over the visible keys
//   delta = sum_d dO * out            a pre-pass, one value a row
//   dv   += p^T dO;   dp = dO v^T;   ds = p * (dp - delta)
//   dk   += ds^T q D^-0.5;            dq += ds k D^-0.5
//
// with lse = m D^-0.5 + ln l, the row's log-sum-exp that the fp32 forward
// kernel wrote, and p recomputed tile by tile in the forward's own form,
// 2^(s c - lse log2 e) with c = D^-0.5 log2 e, one FFMA and one ex2.approx
// on the raw score. Keys are visible as in the forward: s < kv_len and,
// under `causal`, s <= q_offset + t. No (T, S) tensor exists anywhere:
// p and ds live in registers.
//
// Products: split TF32 on the tensor cores. The train path runs in fp32
// (TF32 off, as JAX's Precision.HIGHEST), which on the CUDA cores is 67
// TFLOP/s. Here every fp32 operand x is split in registers as it is loaded:
// big = x rounded to TF32, to nearest with ties away (cvt.rna.tf32.f32's
// rounding, done with two integer instructions where the compiler's cvt
// adds a NaN test and a select), and small = x - big, exact in fp32, whose
// low 13 bits the tensor cores drop. A product a.b is three m16n8k8 TF32
// MMAs, a_small.b_big and a_big.b_small first, a_big.b_big last. big and
// small keep about 21 of x's 24 bits and each TF32 product is exact in
// fp32; the term left out, a_small.b_small, is 2^-22 of the product. So
// the sum keeps fp32's order of error, where a single TF32 pass (11 bits)
// misses the tests' 1e-5 of max |g| by 40 to 500 times
// (tests/test_torch_backward.py models both on the CPU, bit for bit in the
// operands). The tensor cores' fp32 sums are not taken to round to
// nearest (they have been measured to truncate on earlier NVIDIA parts):
// in that model a product accumulated whole drifts to 1.3-2.4 times the
// tolerance at the encoder's 1,500 keys or with scores scaled x8. So no
// MMA accumulator sums long: a score's three MMAs of one k-step (8 head
// dims) start from zero and are added to s by round-to-nearest FADDs, and
// the long sums (dv and dk over queries, dq over keys) take one 32-row
// tile in a fresh accumulator, folded into the registers' sum the same
// way.
//
// What bounds it on the H100: operations. At three MMAs a product the
// tensor cores' 495 TFLOP/s of dense TF32 give 165 TFLOP/s of fp32
// products, 2.46 times the CUDA cores' 67. The five products of the
// backward (s, dp, dv, dk, dq, 2.5 times the forward's two) at that rate:
// a tiny B=16 training step's encoder attention (H=6, T = S = 1500) 0.84
// ms, its cross read (T=224, 1500 keys) 0.125 ms, its causal self read over
// 224 keys 0.0094 ms (2.06, 0.31 and 0.023 ms on the CUDA cores). mma.sync
// reaches about 300 of the 495 TFLOP/s in TF32 on this card, so the
// kernel's own floor is 1.7 times those bounds, and its 7 products (below)
// are 1.4 times the bound's 5.
//
// Design: three launches, no atomics.
//   1. delta_kernel: delta = sum_d dO * out, 16 lanes a row;
//   2. dkdv_kernel, one block per (64-key tile, head, batch row), four
//      warps, warp w owning keys 16w..16w+15 (one MMA row block): the
//      block's K and V rows stay in shared memory while 32-query tiles of
//      q and dO, with their rows' lse and delta, stream through a
//      two-stage cp.async ring (the next tile in flight while this one is
//      computed). Per tile a warp forms s^T = K_w
//      q^T (16 keys x 32 queries) as C fragments (A: its K rows, B: the
//      tile's q rows) and p^T in place, then dv += p^T dO, then dp^T = V_w
//      dO^T, ds^T in place, and dk += ds^T q (p^T before dp^T, so that s,
//      dp and a partial are never live together). p^T and ds^T never leave
//      the registers: a C fragment holds columns 2t and 2t+1 of rows g and
//      g+8, which is an A fragment whose k slot t is column 2t and slot t+4
//      column 2t+1; the B fragment then takes rows 2t and 2t+1 of the tile
//      (the sum over k does not care how its slots are numbered). B's n
//      columns are numbered too: n-block 4m+e, column g is head dim
//      32m+4g+e, so one float4 of a row feeds four n-blocks and a lane's
//      accumulators are 8 consecutive dims of two rows (two float4 stores).
//      Under causal the loop starts at the first query tile that sees the
//      block's first key;
//   3. dq_kernel, one block per (64-query tile, head, batch row), warp w
//      owning rows 16w..16w+15: q and dO stay in shared memory while
//      32-key tiles of K and V stream past; per tile s and dp, ds in place
//      and dq += ds K the same way. This pass recomputes s and dp, which
//      the dk/dv pass also forms: 7 products against the bound's 5, the
//      price of no atomics (one launch for both passes, by an ordered dq
//      accumulation, is later work).
// Shared memory keeps plain fp32 rows padded to 68 floats, so every
// fragment read falls on 32 distinct banks: a scalar read of row g, column
// t (bank 4g + t), and a float4 of rows 2t or 2t+1 at column 4g (a quarter
// warp's eight float4 on distinct bank quads). 70,144 B a block in both
// passes. Tiles: 64 keys (and 64 queries) a block with 4 warps, three
// blocks an SM in both passes (210 KB of shared memory, 168 registers a
// thread, none spilled): the dk/dv pass holds 64 accumulators a thread
// (dk and dv, 16 x 64 each over 32 lanes) and the dq pass 32. The passes
// wait on MMA and shared-memory latency more than on issue, so the third
// block an SM (12 warps) is what pays: at two blocks and 255 registers
// both passes ran slower, at four (128 registers, one cp.async stage)
// they spilled, and 128 keys a block (8 warps) would cap a thread at 128
// registers. The score loop over the head dim is unrolled by 2, which
// keeps the dk/dv pass within 168 registers. Three blocks also fit tiny's
// training reads (T = 224: 384 dq blocks) in one wave of 396.
// Determinism: every sum has a fixed order (no atomicAdd), so a rerun is
// bit-equal. dk and dv rows at or past the last visible key are written
// as zeros: a block whose keys no query sees skips its loop; within a
// ragged or diagonal tile, masked p and ds are set to 0 (K, V, q and dO
// rows past their ends land as zeros through cp.async's source size, so
// nothing there meets a product). kv_len = 0 gives zero gradients.
//
// Layouts: q (B, T, H, D) and k, v (B, H, S, D) through their element
// strides (the decoder hands over views of its fused projections), out and
// dO (B, T, H, D) contiguous, lse and delta (B, H, T); dq (B, T, H, D), dk
// and dv (B, H, S, D), contiguous. Every pointer 16-byte aligned, every
// stride a multiple of 4 floats: the entry point refuses others (and
// ops/flash_attention.py before it).

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64
constexpr float SCALE = 0.125f;         // D^-0.5, a power of two
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE_LOG2E = SCALE * LOG2E;
constexpr int THREADS = 128;            // 4 warps
constexpr int LD = HEAD_DIM + 4;        // padded row (floats) of q, dO, K, V
constexpr int TILE = 32;                // streamed rows a tile, both passes
constexpr int NB = TILE / 8;            // a tile's 8-row MMA blocks

using wt::cp_async16;
using wt::cp_async4;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::mma_m16n8k8_tf32;
using wt::smem_addr;
using wt::split_tf32;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + ROWS) of a (rows, 64) fp32 matrix whose rows lie
// `stride` floats apart, into shared rows of LD floats: 16-byte cp.async
// copies, 16 threads a row. Rows at or past `end` are zero-filled and not
// read.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int r0, int end,
                                          int tid) {
  static_assert(ROWS * 16 % THREADS == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int chunk = tid + i * THREADS;
    const int r = chunk >> 4;
    const int c = chunk & 15;
    const bool live = r0 + r < end;
    cp_async16(smem_addr(dst + r * LD + 4 * c),
               src + (live ? r0 + r : 0) * stride + 4 * c, live ? 16 : 0);
  }
}

// lse and delta at rows [r0, r0 + TILE) of one (b, h) into shared memory,
// lse's TILE values then delta's: 4-byte cp.async, one thread a value;
// rows at or past `end` are zero-filled and not read
__device__ __forceinline__ void load_lse_delta(float* dst, const float* lse,
                                               const float* delta, int r0,
                                               int end, int tid) {
  if (tid >= 2 * TILE) return;
  const int r = r0 + (tid & (TILE - 1));
  const bool live = r < end;
  cp_async4(smem_addr(dst + tid), (tid < TILE ? lse : delta) + (live ? r : 0),
            live ? 4 : 0);
}

// ---------------------------------------------------------------------------
// Split-TF32 fragments (lane = 4 g + t) and products
// ---------------------------------------------------------------------------

struct FragA {                          // 16 x 8, big and small parts
  uint32_t hi[4], lo[4];
};
struct FragB {                          // 8 x 8
  uint32_t hi[2], lo[2];
};

// The A fragment of 8 head dims of a warp's 16 shared rows: `p` is row g,
// column k0 + t
__device__ __forceinline__ FragA load_a(const float* p) {
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * LD], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * LD + 4], f.hi[3], f.lo[3]);
  return f;
}

// The B fragment whose column g is shared row n0 + g over 8 head dims: `p`
// is row n0 + g, column k0 + t
__device__ __forceinline__ FragB load_b(const float* p) {
  FragB f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4], f.hi[1], f.lo[1]);
  return f;
}

// A C fragment (rows g, g+8; columns 2t, 2t+1) as the A fragment of a
// product over its columns: k slot t is column 2t, slot t+4 column 2t+1
__device__ __forceinline__ FragA c_as_a(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
  return f;
}

// d[n] += a . b[n] at fp32's accuracy: small.big, big.small, then big.big
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA& a,
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8_tf32(d[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8_tf32(d[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_m16n8k8_tf32(d[n], a.hi, b[n].hi);
}

// s (16 rows x TILE columns, C fragments) = X_w Y^T over the 64 head dims:
// `x` is the warp's resident row g at column t (A), `y` the tile's row g
// at column t (B, n-block j at rows 8j..8j+7). Each k-step's three MMAs
// start from zero and are added to s with round-to-nearest FADDs.
__device__ __forceinline__ void scores(float (&s)[NB][4], const float* x,
                                       const float* y) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < HEAD_DIM / 8; ++kk) {
    const FragA a = load_a(x + 8 * kk);
    FragB b[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) b[j] = load_b(y + 8 * j * LD + 8 * kk);
    float part[NB][4] = {};
    mma3(part, a, b);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] += part[j][c];
  }
}

// acc (16 rows x 64 dims) += X . R over the tile's TILE rows: X the C
// fragments of a (16, TILE) product (p^T, ds^T or ds) as A, R the tile's
// shared rows (dO, q or K) as B, `rows` its row 2t at column 4g. n-block
// 4m + e, column g is dim 32m + 4g + e: acc[4m + e][c] is row g + 8 (c / 2),
// dim 32m + 8t + 4 (c % 2) + e. One fresh partial a 32-dim half, folded
// into acc with round-to-nearest FADDs.
__device__ __forceinline__ void tile_product(float (&acc)[8][4],
                                             const float (&x)[NB][4],
                                             const float* rows) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float part[4][4] = {};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const FragA a = c_as_a(x[j]);
      const float* r = rows + 8 * j * LD + 32 * m;
      const float4 r0 = *reinterpret_cast<const float4*>(r);
      const float4 r1 = *reinterpret_cast<const float4*>(r + LD);
      FragB b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(lane4(r0, e), b[e].hi[0], b[e].lo[0]);
        split_tf32(lane4(r1, e), b[e].hi[1], b[e].lo[1]);
      }
      mma3(part, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[4 * m + e][c] += part[e][c];
  }
}

// row g (half 0) or g + 8 (half 1) of acc, scaled, into a 64-float row:
// dims 32m + 8t .. 32m + 8t + 7
__device__ __forceinline__ void store_half(float* row, const float (&acc)[8][4],
                                           int half, float scale, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = 2 * half;
    float* dst = row + 32 * m + 8 * t;
    *reinterpret_cast<float4*>(dst) = make_float4(
        acc[4 * m][c] * scale, acc[4 * m + 1][c] * scale,
        acc[4 * m + 2][c] * scale, acc[4 * m + 3][c] * scale);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(
        acc[4 * m][c + 1] * scale, acc[4 * m + 1][c + 1] * scale,
        acc[4 * m + 2][c + 1] * scale, acc[4 * m + 3][c + 1] * scale);
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] out[b, t, h, d]: 16 lanes a row of
// (B, T, H), a float4 each, summed in a fixed order
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ out, const float* __restrict__ d_out,
             float* __restrict__ delta, int rows, int t_len, int n_heads) {
  const int r = blockIdx.x * 16 + (threadIdx.x >> 4);
  const int l = threadIdx.x & 15;
  float x = 0.f;
  if (r < rows) {
    const float4 o = reinterpret_cast<const float4*>(out)[(size_t)r * 16 + l];
    const float4 g =
        reinterpret_cast<const float4*>(d_out)[(size_t)r * 16 + l];
    x = dot4(o, g, 0.f);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (r < rows && l == 0) {
    const int h = r % n_heads, bt = r / n_heads;
    const int t = bt % t_len, b = bt / t_len;
    delta[((size_t)b * n_heads + h) * t_len + t] = x;
  }
}

struct Args {
  const float *q, *k, *v, *d_out, *lse, *delta;
  float *dq, *dk, *dv;
  int t_len, s_len, n_heads, kv_len, q_offset;
  long long sq_b, sq_t, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s;
};

// Both passes: 64 resident rows (two tensors), a ring of two stages of
// TILE streamed rows (two tensors) and, in the dk/dv pass, their rows'
// lse and delta: 70,144 B
constexpr int RES_FLOATS = 64 * LD;
constexpr int STAGE_FLOATS = 2 * TILE * LD + 2 * TILE;
constexpr size_t SMEM = (size_t)(2 * RES_FLOATS + 2 * STAGE_FLOATS) *
                        sizeof(float);

// ---------------------------------------------------------------------------
// dk and dv: one block per (64-key tile, head, batch row)
// ---------------------------------------------------------------------------

namespace kv {

constexpr int BKV = 64;                 // keys a block

// warp w owns the block's keys 16w..16w+15: lane (g, t) holds keys
// 16w + g and 16w + g + 8 of every fragment
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 3) dkdv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [BKV][LD]
  float* Vs = Ks + RES_FLOATS;            // [BKV][LD]
  float* ring = Vs + RES_FLOATS;          // stage st at st * STAGE_FLOATS

  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  // one past the last key any query sees, and the first query tile that
  // sees key k0 (under causal: q_offset + t >= k0)
  const int key_end = CAUSAL ? min(a.kv_len, a.q_offset + a.t_len)
                             : a.kv_len;
  const int tile0 = CAUSAL ? max(0, k0 - a.q_offset) / TILE : 0;
  const int n_tiles =
      k0 < key_end ? (a.t_len + TILE - 1) / TILE - tile0 : 0;
  const long long sg_t = (long long)a.n_heads * HEAD_DIM;   // dO's rows
  const float* qb = a.q + b * a.sq_b + h * a.sq_h;
  const float* gb = a.d_out + (size_t)b * a.t_len * sg_t + h * HEAD_DIM;
  const float* lb = a.lse + ((size_t)b * a.n_heads + h) * a.t_len;
  const float* db = a.delta + ((size_t)b * a.n_heads + h) * a.t_len;

  if (n_tiles > 0) {
    load_rows<BKV>(Ks, a.k + b * a.sk_b + h * a.sk_h, a.sk_s, k0, key_end,
                   tid);
    load_rows<BKV>(Vs, a.v + b * a.sv_b + h * a.sv_h, a.sv_s, k0, key_end,
                   tid);
    load_rows<TILE>(ring, qb, a.sq_t, tile0 * TILE, a.t_len, tid);
    load_rows<TILE>(ring + TILE * LD, gb, sg_t, tile0 * TILE, a.t_len, tid);
    load_lse_delta(ring + 2 * TILE * LD, lb, db, tile0 * TILE, a.t_len, tid);
  }
  cp_async_commit();

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = 0.f;
  const float* kw = Ks + (16 * w + g) * LD + t;
  const float* vw = Vs + (16 * w + g) * LD + t;
  const int key = k0 + 16 * w + g;        // and key + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (tile0 + it) * TILE;
    // this tile has landed; the barrier publishes it and frees the last
    // tile's stage for the next copy, which then runs under this tile
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* dst = ring + ((it + 1) & 1) * STAGE_FLOATS;
      load_rows<TILE>(dst, qb, a.sq_t, t0 + TILE, a.t_len, tid);
      load_rows<TILE>(dst + TILE * LD, gb, sg_t, t0 + TILE, a.t_len, tid);
      load_lse_delta(dst + 2 * TILE * LD, lb, db, t0 + TILE, a.t_len, tid);
    }
    cp_async_commit();
    const float* Qs = ring + (it & 1) * STAGE_FLOATS;
    const float* Gs = Qs + TILE * LD;
    const float* Ls = Gs + TILE * LD;     // lse, then delta (0 past T)

    // s^T = K_w q^T (16 keys x 32 queries), then p^T in place: this
    // lane's queries t0 + 8j + 2t + (c & 1), keys key + 8 (c >> 1). Masks
    // only on a ragged or diagonal tile: queries past T, keys at or past
    // key_end, and under causal keys past the query's diagonal
    float p[NB][4];
    scores(p, kw, Qs + g * LD + t);
    const bool edge = t0 + TILE > a.t_len || k0 + BKV > key_end ||
                      (CAUSAL && k0 + BKV - 1 > a.q_offset + t0);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = key + 8 * (c >> 1);
        const int tq = t0 + 8 * j + 2 * t + (c & 1);
        const float l2 = Ls[8 * j + 2 * t + (c & 1)] * LOG2E;
        p[j][c] = exp2_approx(fmaf(p[j][c], SCALE_LOG2E, -l2));
        if (edge && (tq >= a.t_len || kc >= key_end ||
                     (CAUSAL && kc > a.q_offset + tq)))
          p[j][c] = 0.f;
      }
    // dv += p^T dO over the tile's queries
    tile_product(dv, p, Gs + 2 * t * LD + 4 * g);

    // dp^T = V_w dO^T, then ds^T = p^T (dp^T - delta) in place (0 where p
    // is: dp is finite)
    float ds[NB][4];
    scores(ds, vw, Gs + g * LD + t);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[j][c] =
            p[j][c] * (ds[j][c] - Ls[TILE + 8 * j + 2 * t + (c & 1)]);
    // dk += ds^T q over the tile's queries
    tile_product(dk, ds, Qs + 2 * t * LD + 4 * g);
  }
  cp_async_wait<0>();    // no copy outlives the block

  // every key row of the tile below S: zeros where no query saw the key
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kr = key + 8 * half;
    if (kr >= a.s_len) continue;
    const size_t at = (((size_t)b * a.n_heads + h) * a.s_len + kr) *
                      HEAD_DIM;
    store_half(a.dk + at, dk, half, SCALE, t);
    store_half(a.dv + at, dv, half, 1.f, t);
  }
}

}  // namespace kv

// ---------------------------------------------------------------------------
// dq: one block per (64-query tile, head, batch row)
// ---------------------------------------------------------------------------

namespace qd {

constexpr int BQ = 64;                  // query rows a block

// warp w owns the block's rows 16w..16w+15: lane (g, t) holds rows
// 16w + g and 16w + g + 8 of every fragment
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 3) dq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LD]
  float* Gs = Qs + RES_FLOATS;            // [BQ][LD], dO
  float* ring = Gs + RES_FLOATS;          // stage st at st * STAGE_FLOATS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  const int q_last = min(q0 + BQ, a.t_len) - 1;
  const int key_end = CAUSAL ? min(a.kv_len, a.q_offset + q_last + 1)
                             : a.kv_len;
  const int n_tiles = (key_end + TILE - 1) / TILE;
  const long long sg_t = (long long)a.n_heads * HEAD_DIM;
  const float* kb = a.k + b * a.sk_b + h * a.sk_h;
  const float* vb = a.v + b * a.sv_b + h * a.sv_h;

  // q, dO and the first K/V tile in flight; rows past T are zeros
  load_rows<BQ>(Qs, a.q + b * a.sq_b + h * a.sq_h, a.sq_t, q0, a.t_len,
                tid);
  load_rows<BQ>(Gs, a.d_out + (size_t)b * a.t_len * sg_t + h * HEAD_DIM,
                sg_t, q0, a.t_len, tid);
  if (n_tiles > 0) {
    load_rows<TILE>(ring, kb, a.sk_s, 0, key_end, tid);
    load_rows<TILE>(ring + TILE * LD, vb, a.sv_s, 0, key_end, tid);
  }
  cp_async_commit();

  // this lane's rows: lse in log2 units, and delta (0 past T)
  const int row = q0 + 16 * w + g;        // and row + 8
  const size_t row_base = ((size_t)b * a.n_heads + h) * a.t_len;
  float l2[2], dl[2], dq[8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tr = row + 8 * half;
    l2[half] = tr < a.t_len ? a.lse[row_base + tr] * LOG2E : 0.f;
    dl[half] = tr < a.t_len ? a.delta[row_base + tr] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[n][c] = 0.f;
  const float* qw = Qs + (16 * w + g) * LD + t;
  const float* gw = Gs + (16 * w + g) * LD + t;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) {
      float* dst = ring + ((tile + 1) & 1) * STAGE_FLOATS;
      load_rows<TILE>(dst, kb, a.sk_s, (tile + 1) * TILE, key_end, tid);
      load_rows<TILE>(dst + TILE * LD, vb, a.sv_s, (tile + 1) * TILE,
                      key_end, tid);
    }
    cp_async_commit();
    const float* Ks = ring + (tile & 1) * STAGE_FLOATS;
    const float* Vs = Ks + TILE * LD;

    // s = q_w K^T and dp = dO_w V^T (16 rows x 32 keys)
    float s[NB][4], dp[NB][4];
    scores(s, qw, Ks + g * LD + t);
    scores(dp, gw, Vs + g * LD + t);

    // ds in place of s; masks only on a ragged or diagonal tile
    const int s0 = tile * TILE;
    const bool edge =
        s0 + TILE > key_end || (CAUSAL && s0 + TILE - 1 > a.q_offset + q0);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int half = c >> 1;
        const int kc = s0 + 8 * j + 2 * t + (c & 1);
        const float p =
            exp2_approx(fmaf(s[j][c], SCALE_LOG2E, -l2[half]));
        float ds = p * (dp[j][c] - dl[half]);
        if (edge && (kc >= key_end ||
                     (CAUSAL && kc > a.q_offset + row + 8 * half)))
          ds = 0.f;
        s[j][c] = ds;
      }

    // dq += ds K over the tile's keys
    tile_product(dq, s, Ks + 2 * t * LD + 4 * g);
  }
  cp_async_wait<0>();    // no copy outlives the block

  // dq (B, T, H, D) contiguous; zeros for a row that sees no key
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tr = row + 8 * half;
    if (tr >= a.t_len) continue;
    store_half(a.dq + (((size_t)b * a.t_len + tr) * a.n_heads + h) *
                          HEAD_DIM,
               dq, half, SCALE, t);
  }
}

}  // namespace qd

// The two tiled kernels take more than the 48 KB a launch gets without
// opting in, and three blocks an SM take the largest shared-memory
// carveout: each instantiation opts in once per device.
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  const void* fns[4] = {(const void*)kv::dkdv_kernel<false>,
                        (const void*)kv::dkdv_kernel<true>,
                        (const void*)qd::dq_kernel<false>,
                        (const void*)qd::dq_kernel<true>};
  for (const void* fn : fns)
    if ((e = cudaFuncSetAttribute(
             fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(
             fn, cudaFuncAttributePreferredSharedMemoryCarveout,
             cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
      return e;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <bool CAUSAL>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 kv_grid((a.s_len + kv::BKV - 1) / kv::BKV, a.n_heads, B);
  kv::dkdv_kernel<CAUSAL><<<kv_grid, THREADS, SMEM, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((a.t_len + qd::BQ - 1) / qd::BQ, a.n_heads, B);
  qd::dq_kernel<CAUSAL><<<q_grid, THREADS, SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). q is
// (B, T, H, D) with element strides (sq_b, sq_t, sq_h); k and v are
// (B, H, S, D) with strides (s*_b, s*_h, s*_s); D = 64 is contiguous in
// all three; out, d_out and dq are contiguous (B, T, H, D), lse and the
// delta scratch contiguous (B, H, T), dk and dv contiguous (B, H, S, D);
// all fp32. 0 <= kv_len <= S and q_offset >= 0, as the forward was
// called. Every pointer is 16-byte aligned and the nine strides are
// multiples of 4 elements.
extern "C" int wt_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* d_out, void* dq, void* dk, void* dv,
    void* delta, int B, int T_len, int S, int H, int D, int kv_len,
    int q_offset, int causal, long long sq_b, long long sq_t, long long sq_h,
    long long sk_b, long long sk_h, long long sk_s, long long sv_b,
    long long sv_h, long long sv_s, void* stream) {
  if (D != HEAD_DIM || B < 1 || T_len < 1 || S < 1 || H < 1 || B > 65535 ||
      H > 65535 || kv_len < 0 || kv_len > S || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[10] = {q, k, v, out, lse, d_out, dq, dk, dv, delta};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  const long long st[9] = {sq_b, sq_t, sq_h, sk_b, sk_h, sk_s,
                           sv_b, sv_h, sv_s};
  for (long long x : st)
    if (x % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * T_len * H;
  delta_kernel<<<(rows + 15) / 16, 256, 0, s>>>(
      static_cast<const float*>(out), static_cast<const float*>(d_out),
      static_cast<float*>(delta), rows, T_len, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const Args a{static_cast<const float*>(q),
               static_cast<const float*>(k),
               static_cast<const float*>(v),
               static_cast<const float*>(d_out),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<float*>(dq),
               static_cast<float*>(dk),
               static_cast<float*>(dv),
               T_len, S, H, kv_len, q_offset,
               sq_b, sq_t, sq_h, sk_b, sk_h, sk_s, sv_b, sv_h, sv_s};
  return (int)(causal ? launch<true>(a, B, s) : launch<false>(a, B, s));
}
