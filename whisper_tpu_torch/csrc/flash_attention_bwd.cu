// Flash attention's backward for Hopper (sm_90a), fp32.
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
// p and ds live in registers and in a block's shared memory.
//
// What bounds it on the H100: operations. The train path runs in true
// fp32 (TF32 off, as JAX's Precision.HIGHEST), so every product is an
// FFMA on the CUDA cores, 67 TFLOP/s. The five products of the backward
// (s, dp, dv, dk, dq) are 2.5 times the forward's two. A tiny B=16
// training step's cross read (H=6, T=224, 1500 keys) is 0.31 ms of them at
// peak, the causal self read over 224 keys 0.023 ms; the encoder tail's
// attention at tiny B=16 (T = S = 1500) 2.06 ms.
//
// Design, on the fp32 forward's (flash_attention.cu :55-85): register
// micro-tiles, rows padded to 68 floats so that a warp's 128-bit loads are
// broadcasts or single wavefronts, 16-byte cp.async into a ring of two
// stages (the next tile is in flight while this one is computed), and
// three launches:
//   1. delta_kernel: delta = sum_d dO * out, 16 lanes a row;
//   2. dkdv_kernel, one block per (64-key tile, head, batch row), four
//      warps, warp w owning keys 16w..16w+15: the block's K and V rows stay
//      in shared memory (88 KB with the ring, two blocks an SM) while
//      32-query tiles of q, dO, lse and delta stream past. Per tile a lane
//      computes s^T and dp^T for 4 keys x 4 queries (one pass over the
//      head dim: 4 + 4 reads of K and V rows, 4 + 4 of q and dO rows per 4
//      dims feed 128 FMAs), then p^T and ds^T go through the warp's own
//      rows of two shared buffers to the lanes that accumulate dv and dk
//      (4 keys x 8 head dims a lane each, 64 accumulators), ordered by
//      __syncwarp. Under causal the loop starts at the first query tile
//      that sees the block's first key;
//   3. dq_kernel, one block per (64-query tile, head, batch row), the
//      forward's layout (warp w owning rows 16w..16w+15): q and dO stay in
//      shared memory while 32-key tiles of K and V stream past; per tile s
//      and dp (4 rows x 4 keys a lane), then ds through shared memory into
//      dq (4 rows x 8 dims a lane). This pass recomputes s and dp, which
//      the dk/dv pass also forms: 7 products against the bound's 5, the
//      price of no atomics.
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

using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::smem_addr;

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

__device__ __forceinline__ void axpy8(float (&acc)[8], float a,
                                      const float4& x0, const float4& x1) {
  acc[0] = fmaf(a, x0.x, acc[0]);
  acc[1] = fmaf(a, x0.y, acc[1]);
  acc[2] = fmaf(a, x0.z, acc[2]);
  acc[3] = fmaf(a, x0.w, acc[3]);
  acc[4] = fmaf(a, x1.x, acc[4]);
  acc[5] = fmaf(a, x1.y, acc[5]);
  acc[6] = fmaf(a, x1.z, acc[6]);
  acc[7] = fmaf(a, x1.w, acc[7]);
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

// 8 values of a 64-float row: dims 4c..4c+3 and 32+4c..32+4c+3, scaled
__device__ __forceinline__ void store_row8(float* row, const float (&x)[8],
                                           float scale, int c) {
  *reinterpret_cast<float4*>(row + 4 * c) =
      make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  *reinterpret_cast<float4*>(row + 32 + 4 * c) =
      make_float4(x[4] * scale, x[5] * scale, x[6] * scale, x[7] * scale);
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

// ---------------------------------------------------------------------------
// dk and dv: one block per (64-key tile, head, batch row)
// ---------------------------------------------------------------------------

namespace kv {

constexpr int BKV = 64;                 // keys a block
constexpr int BQ = 32;                  // queries a tile
constexpr int PLD = BQ + 4;             // padded row of p^T and ds^T
constexpr int KV_FLOATS = BKV * LD;
constexpr int STAGE_FLOATS = 2 * BQ * LD;           // q, then dO
// K, V, a ring of two q/dO stages, p^T and ds^T: 88 KB, two blocks an SM
constexpr size_t SMEM =
    (size_t)(2 * KV_FLOATS + 2 * STAGE_FLOATS + 2 * BKV * PLD) *
    sizeof(float);

// Thread layout: warp w owns the block's keys 16w..16w+15. Lane = 8 rg + c:
// its keys 16w + rg + 4i (i < 4), its queries of a tile c + 8j (j < 4), its
// head dims 4c..4c+3 and 32+4c..32+4c+3 of dk and dv.
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2) dkdv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [BKV][LD]
  float* Vs = Ks + KV_FLOATS;             // [BKV][LD]
  float* ring = Vs + KV_FLOATS;           // stage st at st * STAGE_FLOATS
  float* Ps = ring + 2 * STAGE_FLOATS;    // [BKV][PLD], p^T of this tile
  float* Ds = Ps + BKV * PLD;             // [BKV][PLD], ds^T of this tile

  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = lane & 7;
  const int row0 = 16 * (tid >> 5) + (lane >> 3);   // and row0 + 4, 8, 12

  // one past the last key any query sees, and the first query tile that
  // sees key k0 (under causal: q_offset + t >= k0)
  const int key_end = CAUSAL ? min(a.kv_len, a.q_offset + a.t_len)
                             : a.kv_len;
  const int tile0 = CAUSAL ? max(0, k0 - a.q_offset) / BQ : 0;
  const int n_tiles =
      k0 < key_end ? (a.t_len + BQ - 1) / BQ - tile0 : 0;
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
    load_rows<BQ>(ring, qb, a.sq_t, tile0 * BQ, a.t_len, tid);
    load_rows<BQ>(ring + BQ * LD, gb, sg_t, tile0 * BQ, a.t_len, tid);
  }
  cp_async_commit();

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float* krow = Ks + row0 * LD;
  const float* vrow = Vs + row0 * LD;
  float* prow = Ps + row0 * PLD;
  float* drow = Ds + row0 * PLD;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = (tile0 + it) * BQ;
    // this tile has landed; the barrier publishes it and frees the last
    // tile's stage for the next copy, which then runs under this tile
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* dst = ring + ((it + 1) & 1) * STAGE_FLOATS;
      load_rows<BQ>(dst, qb, a.sq_t, t0 + BQ, a.t_len, tid);
      load_rows<BQ>(dst + BQ * LD, gb, sg_t, t0 + BQ, a.t_len, tid);
    }
    cp_async_commit();
    const float* Qs = ring + (it & 1) * STAGE_FLOATS;
    const float* Gs = Qs + BQ * LD;

    // this lane's queries t0 + c + 8j: lse in log2 units, and delta
    float l2[4], dl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + c + 8 * j;
      l2[j] = t < a.t_len ? lb[t] * LOG2E : 0.f;
      dl[j] = t < a.t_len ? db[t] : 0.f;
    }

    // s^T = K q^T and dp^T = V dO^T for keys row0 + 4i, queries c + 8j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < HEAD_DIM / 4; ++kc) {
      float4 kf[4], vf[4], qf[4], gf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kf[i] = *reinterpret_cast<const float4*>(krow + 4 * i * LD + 4 * kc);
        vf[i] = *reinterpret_cast<const float4*>(vrow + 4 * i * LD + 4 * kc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qf[j] = *reinterpret_cast<const float4*>(Qs + (c + 8 * j) * LD +
                                                 4 * kc);
        gf[j] = *reinterpret_cast<const float4*>(Gs + (c + 8 * j) * LD +
                                                 4 * kc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(kf[i], qf[j], s[i][j]);
          dp[i][j] = dot4(vf[i], gf[j], dp[i][j]);
        }
    }

    // p^T and ds^T; masks only on a ragged or diagonal tile: queries past
    // T, keys at or past key_end, and under causal keys past the query's
    // diagonal
    const bool edge = t0 + BQ > a.t_len || k0 + BKV > key_end ||
                      (CAUSAL && k0 + BKV - 1 > a.q_offset + t0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + row0 + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + c + 8 * j;
        float p = exp2_approx(fmaf(s[i][j], SCALE_LOG2E, -l2[j]));
        float ds = p * (dp[i][j] - dl[j]);
        if (edge && (t >= a.t_len || key >= key_end ||
                     (CAUSAL && key > a.q_offset + t)))
          p = ds = 0.f;
        prow[4 * i * PLD + c + 8 * j] = p;
        drow[4 * i * PLD + c + 8 * j] = ds;
      }
    }
    __syncwarp();

    // dv += p^T dO and dk += ds^T q over the tile's queries: per 4
    // queries, 4 + 4 reads of p^T and ds^T and 4 x 4 of dO and q rows feed
    // 256 FMAs
#pragma unroll 2
    for (int qc = 0; qc < BQ / 4; ++qc) {
      float4 pf[4], sf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pf[i] = *reinterpret_cast<const float4*>(prow + 4 * i * PLD + 4 * qc);
        sf[i] = *reinterpret_cast<const float4*>(drow + 4 * i * PLD + 4 * qc);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* gr = Gs + (4 * qc + e) * LD + 4 * c;
        const float* qr = Qs + (4 * qc + e) * LD + 4 * c;
        const float4 g0 = *reinterpret_cast<const float4*>(gr);
        const float4 g1 = *reinterpret_cast<const float4*>(gr + 32);
        const float4 q0 = *reinterpret_cast<const float4*>(qr);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          axpy8(dv[i], lane4(pf[i], e), g0, g1);
          axpy8(dk[i], lane4(sf[i], e), q0, q1);
        }
      }
    }
  }
  cp_async_wait<0>();    // no copy outlives the block

  // every key row of the tile below S: zeros where no query saw the key
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + row0 + 4 * i;
    if (key >= a.s_len) continue;
    const size_t at = (((size_t)b * a.n_heads + h) * a.s_len + key) *
                      HEAD_DIM;
    store_row8(a.dk + at, dk[i], SCALE, c);
    store_row8(a.dv + at, dv[i], 1.f, c);
  }
}

}  // namespace kv

// ---------------------------------------------------------------------------
// dq: one block per (64-query tile, head, batch row)
// ---------------------------------------------------------------------------

namespace qd {

constexpr int BQ = 64;                  // query rows a block
constexpr int BK = 32;                  // keys a tile
constexpr int PLD = BK + 4;             // padded row of ds
constexpr int Q_FLOATS = BQ * LD;
constexpr int STAGE_FLOATS = 2 * BK * LD;           // K, then V
// q, dO, a ring of two K/V stages and ds: 79 KB, two blocks an SM
constexpr size_t SMEM =
    (size_t)(2 * Q_FLOATS + 2 * STAGE_FLOATS + BQ * PLD) * sizeof(float);

// Thread layout (the forward's): warp w owns the block's rows
// 16w..16w+15. Lane = 8 rg + c: its rows 16w + rg + 4i (i < 4), its keys of
// a tile c + 8j (j < 4), its head dims 4c..4c+3 and 32+4c..32+4c+3 of dq.
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2) dq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LD]
  float* Gs = Qs + Q_FLOATS;              // [BQ][LD], dO
  float* ring = Gs + Q_FLOATS;            // stage st at st * STAGE_FLOATS
  float* Ds = ring + 2 * STAGE_FLOATS;    // [BQ][PLD], ds of this tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = lane & 7;
  const int row0 = 16 * (tid >> 5) + (lane >> 3);   // and row0 + 4, 8, 12

  const int q_last = min(q0 + BQ, a.t_len) - 1;
  const int key_end = CAUSAL ? min(a.kv_len, a.q_offset + q_last + 1)
                             : a.kv_len;
  const int n_tiles = (key_end + BK - 1) / BK;
  const long long sg_t = (long long)a.n_heads * HEAD_DIM;
  const float* kb = a.k + b * a.sk_b + h * a.sk_h;
  const float* vb = a.v + b * a.sv_b + h * a.sv_h;

  // q, dO and the first K/V tile in flight; rows past T are zeros
  load_rows<BQ>(Qs, a.q + b * a.sq_b + h * a.sq_h, a.sq_t, q0, a.t_len,
                tid);
  load_rows<BQ>(Gs, a.d_out + (size_t)b * a.t_len * sg_t + h * HEAD_DIM,
                sg_t, q0, a.t_len, tid);
  if (n_tiles > 0) {
    load_rows<BK>(ring, kb, a.sk_s, 0, key_end, tid);
    load_rows<BK>(ring + BK * LD, vb, a.sv_s, 0, key_end, tid);
  }
  cp_async_commit();

  // this lane's rows: lse in log2 units, and delta (0 past T)
  float l2[4], dl[4], dq[4][8];
  const size_t row_base = ((size_t)b * a.n_heads + h) * a.t_len;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + row0 + 4 * i;
    l2[i] = t < a.t_len ? a.lse[row_base + t] * LOG2E : 0.f;
    dl[i] = t < a.t_len ? a.delta[row_base + t] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[i][e] = 0.f;
  }
  const float* qrow = Qs + row0 * LD;
  const float* grow = Gs + row0 * LD;
  float* drow = Ds + row0 * PLD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) {
      float* dst = ring + ((tile + 1) & 1) * STAGE_FLOATS;
      load_rows<BK>(dst, kb, a.sk_s, (tile + 1) * BK, key_end, tid);
      load_rows<BK>(dst + BK * LD, vb, a.sv_s, (tile + 1) * BK, key_end,
                    tid);
    }
    cp_async_commit();
    const float* Ks = ring + (tile & 1) * STAGE_FLOATS;
    const float* Vs = Ks + BK * LD;

    // s = q K^T and dp = dO V^T for rows row0 + 4i, keys c + 8j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < HEAD_DIM / 4; ++kc) {
      float4 qf[4], gf[4], kf[4], vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qf[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * LD + 4 * kc);
        gf[i] = *reinterpret_cast<const float4*>(grow + 4 * i * LD + 4 * kc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(Ks + (c + 8 * j) * LD +
                                                 4 * kc);
        vf[j] = *reinterpret_cast<const float4*>(Vs + (c + 8 * j) * LD +
                                                 4 * kc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qf[i], kf[j], s[i][j]);
          dp[i][j] = dot4(gf[i], vf[j], dp[i][j]);
        }
    }

    // ds; masks only on a ragged or diagonal tile
    const int s0 = tile * BK;
    const bool edge =
        s0 + BK > key_end || (CAUSAL && s0 + BK - 1 > a.q_offset + q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = a.q_offset + q0 + row0 + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = s0 + c + 8 * j;
        const float p = exp2_approx(fmaf(s[i][j], SCALE_LOG2E, -l2[i]));
        float ds = p * (dp[i][j] - dl[i]);
        if (edge && (key >= key_end || (CAUSAL && key > q_pos))) ds = 0.f;
        drow[4 * i * PLD + c + 8 * j] = ds;
      }
    }
    __syncwarp();

    // dq += ds K: per 4 keys, 4 reads of ds and 8 of K feed 128 FMAs
#pragma unroll 2
    for (int kc = 0; kc < BK / 4; ++kc) {
      float4 sf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sf[i] = *reinterpret_cast<const float4*>(drow + 4 * i * PLD + 4 * kc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* kr = Ks + (4 * kc + e) * LD + 4 * c;
        const float4 k0v = *reinterpret_cast<const float4*>(kr);
        const float4 k1v = *reinterpret_cast<const float4*>(kr + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) axpy8(dq[i], lane4(sf[i], e), k0v, k1v);
      }
    }
  }
  cp_async_wait<0>();    // no copy outlives the block

  // dq (B, T, H, D) contiguous; zeros for a row that sees no key
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + row0 + 4 * i;
    if (t >= a.t_len) continue;
    store_row8(a.dq + (((size_t)b * a.t_len + t) * a.n_heads + h) * HEAD_DIM,
               dq[i], SCALE, c);
  }
}

}  // namespace qd

// The two tiled kernels take more than the 48 KB a launch gets without
// opting in: each instantiation opts in once per device.
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((e = cudaFuncSetAttribute(kv::dkdv_kernel<false>, attr,
                                (int)kv::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(kv::dkdv_kernel<true>, attr,
                                (int)kv::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(qd::dq_kernel<false>, attr,
                                (int)qd::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(qd::dq_kernel<true>, attr,
                                (int)qd::SMEM)) != cudaSuccess)
    return e;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <bool CAUSAL>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 kv_grid((a.s_len + kv::BKV - 1) / kv::BKV, a.n_heads, B);
  kv::dkdv_kernel<CAUSAL><<<kv_grid, THREADS, kv::SMEM, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 q_grid((a.t_len + qd::BQ - 1) / qd::BQ, a.n_heads, B);
  qd::dq_kernel<CAUSAL><<<q_grid, THREADS, qd::SMEM, stream>>>(a);
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
