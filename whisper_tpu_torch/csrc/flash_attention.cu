// Flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/flash_attention.py:112
// flash_attention (kernel body _flash_kernel, :40):
//
//   out[b, t, h] = sum_s p(t, s) v[b, h, s] / sum_s p(t, s)
//   p(t, s)      = exp(q[b, t, h] * D^-0.5 . k[b, h, s] - m_t)
//
// over the visible keys: s < kv_len and, under `causal`, s <= q_offset + t.
// The numerics are the JAX kernel's: the scores are the fp32 products of
// q * D^-0.5 and k (:51); a masked score is -0.7 * FLT_MAX, not -inf (:37);
// the running (m, l, acc) are fp32; in bf16, p is rounded to bf16 before
// the p.v product while l sums the fp32 p (:79-84); out = acc / max(l,
// 1e-30), so a row with no visible key returns zeros (:93).
//
// Two kernels behind one C entry point, picked by the element type:
//
// bf16: tensor cores. What bounds it on the H100 is operations: one
// large-v3-turbo b32 encoder layer (B=32, H=20, T=S=1500, D=64) is
// 4*B*H*T*S*D = 3.69e11 FLOP, 0.373 ms at the 989 TFLOP/s bf16 peak,
// against 0.49 GB of q, k, v and output (0.147 ms at 3.35 TB/s); a tiny b32
// layer (H=6) is 1.11e11 FLOP, 0.112 ms. So both products run as wgmma on
// the tensor cores, K/V stream through shared memory by cp.async while the
// previous tile is computed, and p never leaves the registers:
//   - one block per (64-query tile, head, batch row), the query tile
//     fastest, so the q tiles of one (b, h) share its K/V in L2; one
//     warpgroup of 128 threads and 4 blocks per SM (at most 128 registers
//     a thread), whose products and softmaxes interleave;
//   - q is loaded once, straight into the registers as the A operand of
//     S = q.k^T (wgmma's register-A form, four k-steps over D). The fp32
//     scores are scaled by D^-0.5 afterwards: a power of two, so every
//     product and partial sum equals the JAX kernel's q * scale . k;
//   - K and V tiles of BK = 64 keys land in a ring of two shared-memory
//     stages, 16 bytes a thread through cp.async, in the 128-byte swizzle
//     that wgmma's descriptors name (D = 64 bf16 is one 128-byte row); the
//     next tile is in flight while this one is computed. Keys at or past
//     key_end load as zeros through cp.async's source size, so what lies
//     there (NaN included) never meets a p of 0;
//   - the online softmax runs on the accumulator fragments: a row's
//     values live in one quad of lanes, so its max takes two shuffles and
//     its sum is reduced once, at the end; the scale and the max enter the
//     exponent as one FFMA before ex2. p is rounded to bf16 in the
//     registers and feeds O += P.V directly as the A fragment (the m64nN
//     accumulator layout is the k16 A layout, pairwise packed); V is the
//     MN-major B operand (the transpose bit);
//   - one __syncthreads per tile both publishes the tile that landed and
//     frees the stage the next copy overwrites.
// Where the time goes: per element of a tile, one ex2 on the SFUs (16 a
// clock per SM) costs about what its 256 tensor-core FLOP do at peak, and
// each warpgroup runs S, softmax and P.V in turn; the other blocks of the
// SM fill the gaps.
//
// fp32: the CUDA cores. The parity mode (the JAX kernel runs fp32 at
// Precision.HIGHEST, :174), so every product is a true fp32 FMA: no TF32,
// no split of the operands. What bounds it is operations: 3.69e11 FLOP a
// turbo b32 layer, 5.50 ms at the 67 TFLOP/s fp32 peak (tiny b32: 1.65
// ms), against 0.98 GB of q, k, v and output (0.29 ms). An FFMA issues on
// the four sub-partitions at 4 warp instructions a clock, a shared-memory
// read at one 128-byte wavefront a clock per SM, so the design feeds many
// FMAs from each read and keeps the loads off the critical path:
//   - one block per (64-query tile, head, batch row), 4 warps, three
//     blocks an SM (59 KB of shared memory and at most 170 registers a
//     thread); warp w owns query rows 16w..16w+15 through both products
//     and the softmax;
//   - register micro-tiles of 4 rows x 4 keys for S = q.k^T and of the same
//     4 rows x 8 head dims for O += P.V. Per 4 steps of the contraction a
//     lane reads its operands as 128-bit loads, 4 of q and 4 of k for 64
//     FMAs, 4 of p and 8 of v for 128, and a warp's loads are broadcasts
//     or one 128-byte wavefront each: q and K rows are padded to 68
//     floats, P rows to 36, which puts the rows a warp reads 4 banks
//     apart. Q and K stay row-major as cp.async lands them (16 contiguous
//     bytes of one row), read along the head dim 4 values at a time; V is
//     row-major, read along its head dims;
//   - K and V tiles of BK = 32 keys in a ring of two stages, fed by 16-byte
//     cp.async: the next tile is in flight while this one is computed; one
//     __syncthreads a tile. (A 64-key tile takes 100 KB and about 205
//     registers, two blocks an SM; the third block hides more of each
//     warp's softmax and barrier.) Keys at or past key_end land as
//     zeros through cp.async's source size and are masked, so what lies
//     there (NaN included) never meets a p of 0;
//   - p = 2^(s c - m c), c = D^-0.5 log2(e), one FFMA and one ex2.approx
//     on the raw score (the scale is a power of two, so the scores are the
//     JAX kernel's q * scale . k to the last bit); p goes to the lanes of
//     the same warp that read it for P.V through the warp's own rows of a
//     shared buffer, ordered by __syncwarp;
//   - both instantiations opt into their shared memory once per device.
// Every fp32 view is then 16-byte aligned with strides of 4 elements: the
// C entry refuses others (and ops/flash_attention.py _check before it).
//
// Both: a block's keys end at
//     key_end = min(kv_len, q_offset + last query row of the tile + 1)
// (kv_len alone when not causal), and the loop runs cdiv(key_end, BK)
// tiles: key blocks at or past kv_len, and blocks past the causal diagonal
// of the tile's last query, are neither read nor computed. q (B, T, H, D)
// and k, v (B, H, S, D) are read through their element strides, with D
// contiguous: the encoder hands over the views of its fused QKV projection
// without a copy. The output is (B, T, H, D), contiguous. The encoder tail
// (encoder_tail.cu) runs its attention through this entry point too, with
// kv_len = S and no causal mask. Under autograd the fp32 kernel also
// writes each row's log-sum-exp, lse = m D^-0.5 + ln l, for the backward
// (flash_attention_bwd.cu); inference passes no buffer for it.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// D^-0.5 * log2(e): p = 2^(s * SCALE_LOG2E - m * SCALE_LOG2E) = e^((s -
// m) * D^-0.5). It is below 1, so a masked score times it stays finite.
constexpr float SCALE_LOG2E = 0.125f * 1.4426950408889634f;

using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::smem_addr;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async moves 16 bytes: every base address 16-byte aligned and every
// stride a whole number of `vec` elements (16 bytes of the element type)
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const long long* st, int vec) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % vec != 0) return false;
  return true;
}

// ---------------------------------------------------------------------------
// fp32: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 32;                  // keys per shared-memory tile
constexpr int KJ = BK / 8;              // keys of a score tile per lane
constexpr int THREADS = 128;            // 4 warps, 16 query rows each
constexpr int MIN_BLOCKS = 3;           // per SM: at most 170 registers
constexpr int LD = HEAD_DIM + 4;        // padded row (floats) of Q and K
constexpr int PLD = BK + 4;             // padded row of P
constexpr int Q_FLOATS = BQ * LD;
constexpr int P_FLOATS = BQ * PLD;
constexpr int K_FLOATS = BK * LD;
constexpr int STAGE_FLOATS = K_FLOATS + BK * HEAD_DIM;   // K, then V
// Q, P and a ring of two K/V stages: 59 KB, three blocks per SM
constexpr size_t SMEM = (size_t)(Q_FLOATS + P_FLOATS + 2 * STAGE_FLOATS) *
                        sizeof(float);

// rows [r0, r0 + ROWS) of a (rows, 64) fp32 matrix whose rows lie
// `stride` floats apart, into shared rows of `ld` floats: 16-byte cp.async
// copies, 16 threads a row. Rows at or past `end` are zero-filled and not
// read.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int end, int tid) {
  static_assert(ROWS * 16 % THREADS == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * 16 / THREADS; ++i) {
    const int chunk = tid + i * THREADS;
    const int r = chunk >> 4;
    const int c = chunk & 15;
    const bool live = r0 + r < end;
    cp_async16(smem_addr(dst + r * ld + 4 * c),
               src + (live ? r0 + r : 0) * stride + 4 * c, live ? 16 : 0);
  }
}

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Thread layout: warp w owns the block's query rows 16w..16w+15 in both
// products and in the softmax between them. Lane = 8 rg + c: its rows are
// 16w + rg + 4i (i < 4), its keys of a score tile c + 8j (j < KJ), its
// head dims 4c..4c+3 and 32+4c..32+4c+3 of the output. A row's BK scores
// lie in the 8 lanes of one quarter-warp (3 shuffles reduce it), and p
// goes from the lanes that computed it to the lanes that read it through
// the warp's own rows of a shared buffer, ordered by __syncwarp.
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
             float* __restrict__ lse, int t_len, int n_heads, int kv_len,
             int q_offset, long long sq_b, long long sq_t, long long sq_h,
             long long sk_b, long long sk_h, long long sk_s, long long sv_b,
             long long sv_h, long long sv_s) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BQ][LD], raw q
  float* Ps = Qs + Q_FLOATS;                // [BQ][PLD], p of this tile
  float* ring = Ps + P_FLOATS;              // stage st at st * STAGE_FLOATS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = lane & 7;
  const int row0 = 16 * (tid >> 5) + (lane >> 3);   // and row0 + 4, 8, 12

  const int q_last = min(q0 + BQ, t_len) - 1;
  const int key_end = CAUSAL ? min(kv_len, q_offset + q_last + 1) : kv_len;
  const int n_tiles = (key_end + BK - 1) / BK;
  const float* kb = k + b * sk_b + h * sk_h;
  const float* vb = v + b * sv_b + h * sv_h;

  // q's tile and the first K/V tile in flight; rows past T are zeros
  load_rows<BQ>(Qs, LD, q + b * sq_b + h * sq_h, sq_t, q0, t_len, tid);
  if (n_tiles > 0) {
    load_rows<BK>(ring, LD, kb, sk_s, 0, key_end, tid);
    load_rows<BK>(ring + K_FLOATS, HEAD_DIM, vb, sv_s, 0, key_end, tid);
  }
  cp_async_commit();

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }
  const float* qrow = Qs + row0 * LD;
  float* prow = Ps + row0 * PLD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    // this tile has landed; the barrier publishes it and, since every
    // thread has finished the last tile, frees that tile's stage for the
    // next copy, which then runs under this tile's products
    cp_async_wait<0>();
    __syncthreads();
    if (tile + 1 < n_tiles) {
      float* dst = ring + ((tile + 1) & 1) * STAGE_FLOATS;
      load_rows<BK>(dst, LD, kb, sk_s, (tile + 1) * BK, key_end, tid);
      load_rows<BK>(dst + K_FLOATS, HEAD_DIM, vb, sv_s, (tile + 1) * BK,
                    key_end, tid);
    }
    cp_async_commit();
    const float* Ks = ring + (tile & 1) * STAGE_FLOATS;
    const float* Vs = Ks + K_FLOATS;

    // S = q.k^T for rows row0 + 4i, keys c + 8j: per 4 head dims, 4 + KJ
    // 128-bit reads feed 16 KJ FMAs. Rows 1 apart and keys 1 apart land 4
    // banks apart (LD = 68), so neither read conflicts.
    float s[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HEAD_DIM / 4; ++kc) {
      float4 qf[4], kf[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * LD + 4 * kc);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + (c + 8 * j) * LD +
                                                 4 * kc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

    // masks: keys at or past key_end, and under causal past the row's
    // diagonal; only a ragged last tile or a diagonal tile has any
    const int s0 = tile * BK;
    if (s0 + BK > key_end || (CAUSAL && s0 + BK - 1 > q_offset + q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q_pos = q_offset + q0 + row0 + 4 * i;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int key = s0 + c + 8 * j;
          if (key >= key_end || (CAUSAL && key > q_pos))
            s[i][j] = MASK_VALUE;
        }
      }
    }

    // online softmax on the raw scores, the scale entering with the
    // exponent as one FFMA. Key 0 is visible to every row, so from the
    // first tile on m is a real score and a masked key's p is
    // 2^(-0.7 FLT_MAX * c - m * c) = 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = s[i][0];
#pragma unroll
      for (int j = 1; j < KJ; ++j) r = fmaxf(r, s[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, off));
      const float mn = fmaxf(m[i], r);
      const float alpha = exp2_approx((m[i] - mn) * SCALE_LOG2E);
      const float mc = -mn * SCALE_LOG2E;
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = exp2_approx(fmaf(s[i][j], SCALE_LOG2E, mc));
        ps += p;
        prow[4 * i * PLD + c + 8 * j] = p;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] *= alpha;
    }
    __syncwarp();

    // O += P.V: per 4 keys, 4 128-bit reads of P and 8 of V feed 128 FMAs
#pragma unroll
    for (int kc = 0; kc < BK / 4; ++kc) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(prow + 4 * i * PLD +
                                                 4 * kc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = Vs + (4 * kc + e) * HEAD_DIM + 4 * c;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane4(pf[i], e);
          o[i][0] = fmaf(p, v0.x, o[i][0]);
          o[i][1] = fmaf(p, v0.y, o[i][1]);
          o[i][2] = fmaf(p, v0.z, o[i][2]);
          o[i][3] = fmaf(p, v0.w, o[i][3]);
          o[i][4] = fmaf(p, v1.x, o[i][4]);
          o[i][5] = fmaf(p, v1.y, o[i][5]);
          o[i][6] = fmaf(p, v1.z, o[i][6]);
          o[i][7] = fmaf(p, v1.w, o[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();    // no copy outlives the block

  // the row sums over the row's 8 lanes, then out = o / max(l, 1e-30);
  // out is (B, T, H, D) contiguous. Under autograd, the row's
  // log-sum-exp in natural units, lse = m D^-0.5 + ln l, (B, H, T): the
  // backward recomputes p = 2^(s c - lse log2 e) from it
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int t = q0 + row0 + 4 * i;
    if (t >= t_len) continue;
    if (lse != nullptr && c == 0)
      lse[((size_t)b * n_heads + h) * t_len + t] = m[i] * 0.125f + logf(li);
    const float d = fmaxf(li, 1e-30f);
    float* row = out + (((size_t)b * t_len + t) * n_heads + h) * HEAD_DIM +
                 4 * c;
    *reinterpret_cast<float4*>(row) =
        make_float4(o[i][0] / d, o[i][1] / d, o[i][2] / d, o[i][3] / d);
    *reinterpret_cast<float4*>(row + 32) =
        make_float4(o[i][4] / d, o[i][5] / d, o[i][6] / d, o[i][7] / d);
  }
}

// The 59 KB of shared memory (two stages of 32-key K/V tiles, q and p)
// are above the 48 KB a launch gets without opting in: both
// instantiations opt in once per device.
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(flash_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int T_len, int H, int kv_len,
                   int q_offset, const long long* st, cudaStream_t stream) {
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<CAUSAL><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), T_len, H, kv_len, q_offset, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using wt::ATOM_BYTES;
using wt::fence_regs;
using wt::pack_bf16;
using wt::sw128_desc;
using wt::wgmma_commit;
using wt::wgmma_fence;
using wt::wgmma_wait;

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int STAGES = 2;               // K/V tiles in the ring
constexpr int THREADS = 128;            // one warpgroup
constexpr int MIN_BLOCKS = 4;           // per SM: at most 128 registers
constexpr int ROW_BYTES = HEAD_DIM * 2;             // 128: one swizzle row
constexpr int TILE_BYTES = BK * ROW_BYTES;          // one K or V tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;         // K then V
static_assert(wt::ATOM_BYTES == 8 * ROW_BYTES, "8 rows: a swizzle atom");
// + one atom, to align the ring to the 1024-byte atom the swizzle assumes;
// within the 48 KB a launch gets without opting in
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + ATOM_BYTES;
static_assert(SMEM <= 48 * 1024, "the ring fits the default shared memory");
// rows [s0, s0 + BK) of one (b, h)'s K or V into a swizzled tile: row r's
// 16-byte chunk c lands at chunk c ^ (r % 8) of the tile's row r
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int s0,
                                          int key_end, int tid) {
  static_assert(BK * 8 % THREADS == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int i = 0; i < BK * 8 / THREADS; ++i) {
    const int chunk = tid + i * THREADS;
    const int r = chunk >> 3;
    const int c = chunk & 7;
    const int s = s0 + r;
    const bool live = s < key_end;
    cp_async16(dst + r * ROW_BYTES + ((c ^ (r & 7)) << 4),
               src + (live ? s : 0) * stride + c * 8, live ? 16 : 0);
  }
}

// Fragment layout (per warp w of a warpgroup, lane = 4 g + t4): the
// m64nN accumulator holds, for each 8-column chunk c, d[4c + e] at (row
// 16w + g, column 8c + 2 t4 + e) and d[4c + 2 + e] at row 16w + g + 8; the
// k16 A fragment holds a[0] = (row g, k 2t4..+1), a[1] = (row g + 8, same),
// a[2] = (row g, k 8 + 2t4..+1), a[3] = (row g + 8, same).
template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int t_len,
             int n_heads, int kv_len, int q_offset, long long sq_b,
             long long sq_t, long long sq_h, long long sk_b, long long sk_h,
             long long sk_s, long long sv_b, long long sv_h, long long sv_s) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t ring =
      (smem_addr(smem_raw) + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const int row0 = q0 + (tid >> 5) * 16 + g;      // and row0 + 8

  const int q_last = min(q0 + BQ, t_len) - 1;
  const int key_end = CAUSAL ? min(kv_len, q_offset + q_last + 1) : kv_len;
  const int n_tiles = (key_end + BK - 1) / BK;
  const bf16* kb = k + b * sk_b + h * sk_h;
  const bf16* vb = v + b * sv_b + h * sv_h;

  // the first STAGES - 1 tiles in flight
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      const uint32_t dst = ring + st * STAGE_BYTES;
      load_tile(dst, kb, sk_s, st * BK, key_end, tid);
      load_tile(dst + TILE_BYTES, vb, sv_s, st * BK, key_end, tid);
    }
    cp_async_commit();
  }

  // q as the A operand of S = q.k^T: k-step j covers dims 16j..16j+15;
  // rows past T are zeros
  uint32_t qa[4][4];
  {
    const bf16* qr0 = q + b * sq_b + h * sq_h + row0 * sq_t + 2 * t4;
    const bf16* qr1 = qr0 + 8 * sq_t;
    const bool live0 = row0 < t_len, live1 = row0 + 8 < t_len;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qa[j][0] = live0 ? *reinterpret_cast<const uint32_t*>(qr0 + 16 * j) : 0u;
      qa[j][1] = live1 ? *reinterpret_cast<const uint32_t*>(qr1 + 16 * j) : 0u;
      qa[j][2] =
          live0 ? *reinterpret_cast<const uint32_t*>(qr0 + 16 * j + 8) : 0u;
      qa[j][3] =
          live1 ? *reinterpret_cast<const uint32_t*>(qr1 + 16 * j + 8) : 0u;
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // running max of the raw scores and this thread's share of the row sums,
  // for rows row0 and row0 + 8
  float m0 = MASK_VALUE, m1 = MASK_VALUE, l0 = 0.f, l1 = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    // this tile has landed (its copies were committed STAGES - 1 groups
    // ago); the barrier publishes it and, since every thread has finished
    // the last tile's products, frees that tile's stage for the next copy
    cp_async_wait<STAGES - 2>();
    wt::fence_proxy_async();
    __syncthreads();
    {
      const int next = tile + STAGES - 1;
      if (next < n_tiles) {
        const uint32_t dst = ring + (next % STAGES) * STAGE_BYTES;
        load_tile(dst, kb, sk_s, next * BK, key_end, tid);
        load_tile(dst + TILE_BYTES, vb, sv_s, next * BK, key_end, tid);
      }
      cp_async_commit();
    }
    const uint32_t ks = ring + (tile % STAGES) * STAGE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;

    // S = q.k^T over the 4 k-steps of D (32 bytes each along k's rows);
    // the first step overwrites s
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wt::wgmma_m64n64k16_rs<0>(s, qa[j], sw128_desc(ks + 32 * j, 0), j);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // masks: keys at or past key_end, and under causal past the row's
    // diagonal; only a ragged last tile or a diagonal tile has any
    const int s0 = tile * BK;
    if (s0 + BK > key_end || (CAUSAL && s0 + BK - 1 > q_offset + q0)) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = s0 + 8 * c + 2 * t4 + e;
          if (key >= key_end || (CAUSAL && key > q_offset + row0))
            s[4 * c + e] = MASK_VALUE;
          if (key >= key_end || (CAUSAL && key > q_offset + row0 + 8))
            s[4 * c + 2 + e] = MASK_VALUE;
        }
    }

    // online softmax on the raw scores: the scale enters with the
    // exponent, as one FFMA. Key 0 is visible to every row, so from the
    // first tile on m is a real score and a masked key's p is
    // 2^(-0.7 FLT_MAX * c - m * c) = 0 (c < 1: no overflow to -inf).
    float r0 = MASK_VALUE, r1 = MASK_VALUE;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      r0 = fmaxf(r0, fmaxf(s[4 * c], s[4 * c + 1]));
      r1 = fmaxf(r1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, off));
      r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, off));
    }
    const float mn0 = fmaxf(m0, r0), mn1 = fmaxf(m1, r1);
    const float a0 = exp2_approx((m0 - mn0) * SCALE_LOG2E);
    const float a1 = exp2_approx((m1 - mn1) * SCALE_LOG2E);
    m0 = mn0;
    m1 = mn1;
    const float mc0 = -mn0 * SCALE_LOG2E, mc1 = -mn1 * SCALE_LOG2E;

    // p in fp32 into the row sums, rounded to bf16 into P's A fragments:
    // k-step j (keys 16j..16j+15) is accumulator chunks 2j and 2j + 1
    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool upper = e & 2;           // d[4c + 2], d[4c + 3]: row + 8
        p[e] = exp2_approx(fmaf(s[8 * j + e], SCALE_LOG2E, upper ? mc1 : mc0));
        if (upper) ps1 += p[e]; else ps0 += p[e];
      }
      pa[j][0] = pack_bf16(p[0], p[1]);
      pa[j][1] = pack_bf16(p[2], p[3]);
      pa[j][2] = pack_bf16(p[4], p[5]);
      pa[j][3] = pack_bf16(p[6], p[7]);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[4 * c] *= a0;
      o[4 * c + 1] *= a0;
      o[4 * c + 2] *= a1;
      o[4 * c + 3] *= a1;
    }

    // O += P.V: k-step j reads P's keys 16j..16j+15 and V's rows
    // 16j..16j+15, two atoms further into the V tile
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wt::wgmma_m64n64k16_rs<1>(o, pa[j], sw128_desc(vs + 2 * ATOM_BYTES * j,
                                              ATOM_BYTES), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }
  cp_async_wait<0>();    // no copy outlives the block

  // the row sums over the quad, then out = o / max(l, 1e-30) in bf16
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* out0 = out + (((size_t)b * t_len + row0) * n_heads + h) * HEAD_DIM +
               2 * t4;
  bf16* out1 = out0 + (size_t)8 * n_heads * HEAD_DIM;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (row0 < t_len)
      *reinterpret_cast<uint32_t*>(out0 + 8 * c) =
          pack_bf16(o[4 * c] / d0, o[4 * c + 1] / d0);
    if (row0 + 8 < t_len)
      *reinterpret_cast<uint32_t*>(out1 + 8 * c) =
          pack_bf16(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
  }
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_len, int H, int kv_len, int q_offset,
                   const long long* st, cudaStream_t stream) {
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<CAUSAL><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T_len, H, kv_len,
      q_offset, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8]);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q is
// (B, T, H, D) with element strides (sq_b, sq_t, sq_h); k and v are
// (B, H, S, D) with strides (s*_b, s*_h, s*_s); D = 64 is contiguous in
// all three. out is a contiguous (B, T, H, D) buffer of the same type.
// 0 <= kv_len <= S and q_offset >= 0. The four pointers are 16-byte
// aligned and the nine strides multiples of 16 bytes' worth of elements
// (bf16: 8, fp32: 4): both kernels copy K/V (and fp32 q) 16 bytes at a
// time. lse, when not null, is a contiguous (B, H, T) fp32 buffer that
// receives each row's log-sum-exp (fp32 only: the train path's dtype;
// inference passes null and writes nothing more).
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int T_len,
                                  int S, int H, int D, int kv_len,
                                  int q_offset, int causal, long long sq_b,
                                  long long sq_t, long long sq_h,
                                  long long sk_b, long long sk_h,
                                  long long sk_s, long long sv_b,
                                  long long sv_h, long long sv_s,
                                  int is_bf16, void* stream) {
  if (D != HEAD_DIM || B < 1 || T_len < 1 || H < 1 || B > 65535 ||
      H > 65535 || kv_len < 0 || kv_len > S || q_offset < 0 ||
      (lse != nullptr && is_bf16))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {sq_b, sq_t, sq_h, sk_b, sk_h, sk_s,
                           sv_b, sv_h, sv_s};
  if (!aligned(q, k, v, out, st, is_bf16 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)(causal ? simt::launch<true>(q, k, v, out, lse, B, T_len,
                                             H, kv_len, q_offset, st, s)
                        : simt::launch<false>(q, k, v, out, lse, B, T_len,
                                              H, kv_len, q_offset, st, s));
  return (int)(causal ? tc::launch<true>(q, k, v, out, B, T_len, H, kv_len,
                                         q_offset, st, s)
                      : tc::launch<false>(q, k, v, out, B, T_len, H, kv_len,
                                          q_offset, st, s));
}
