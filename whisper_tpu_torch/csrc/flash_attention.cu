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
// Precision.HIGHEST, :174): one block per (64-query tile, head, batch row),
// 256 threads as 16 x 16, each owning 4 query rows x 4 keys of a score tile
// and the same 4 rows x 4 head dims of the output; every product in fp32
// FMAs (67 TFLOP/s peak; 5.50 ms bound at turbo b32).
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
// kv_len = S and no causal mask.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int THREADS = 256;            // 16 x 16: each thread 4 rows x 4 cols
constexpr int PAD = HEAD_DIM + 1;       // row stride that spreads banks
constexpr size_t SMEM =
    (size_t)(2 * BQ * PAD + BK * PAD + BK * HEAD_DIM) * sizeof(float);

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int t_len,
             int n_heads, int kv_len, int q_offset, long long sq_b,
             long long sq_t, long long sq_h, long long sk_b, long long sk_h,
             long long sk_s, long long sv_b, long long sv_h, long long sv_s,
             float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [BQ][PAD], pre-scaled
  float* Ks = Qs + BQ * PAD;                // [BK][PAD]
  float* Vs = Ks + BK * PAD;                // [BK][HEAD_DIM]
  float* Ps = Vs + BK * HEAD_DIM;           // [BQ][PAD] probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;                  // key / head-dim column group
  const int ty = tid >> 4;                  // query row group

  const int q_last = min(q0 + BQ, t_len) - 1;
  const int key_end = CAUSAL ? min(kv_len, q_offset + q_last + 1) : kv_len;
  const int n_tiles = (key_end + BK - 1) / BK;

  // loads: each thread reads head dim `c` of every ROW_STEP-th row
  constexpr int ROW_STEP = THREADS / HEAD_DIM;
  const int c = tid % HEAD_DIM;
  const int r0 = tid / HEAD_DIM;
  const float* qb = q + b * sq_b + h * sq_h + c;
  const float* kb = k + b * sk_b + h * sk_h + c;
  const float* vb = v + b * sv_b + h * sv_h + c;
  for (int r = r0; r < BQ; r += ROW_STEP) {
    const int t = q0 + r;
    Qs[r * PAD + c] = t < t_len ? qb[t * sq_t] * scale : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * BK;
    __syncthreads();  // Q is written (first pass) / the last tile is consumed
    const float* kr = kb + (s0 + r0) * sk_s;
    const float* vr = vb + (s0 + r0) * sv_s;
#pragma unroll
    for (int n = 0; n < BK / ROW_STEP; ++n) {
      const int r = r0 + n * ROW_STEP;
      float kval = 0.f, vval = 0.f;
      if (s0 + r < key_end) {
        kval = kr[n * ROW_STEP * sk_s];
        vval = vr[n * ROW_STEP * sv_s];
      }
      Ks[r * PAD + c] = kval;
      Vs[r * HEAD_DIM + c] = vval;
    }
    __syncthreads();

    // scores for rows ty + 16i, keys tx + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < HEAD_DIM; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * PAD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * PAD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax: a row's 64 keys live in the 16 lanes that share ty
    // (one half-warp), so xor-shuffles over 8, 4, 2, 1 reduce a row. Key 0
    // is visible to every row, so from the first tile on m is a real
    // score and a masked key's p is exp(-0.7 FLT_MAX - m) = 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + ty + 16 * i;
      float rmax = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        if (s >= key_end || (CAUSAL && s > q_pos)) sc[i][j] = MASK_VALUE;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * PAD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc[rows ty + 16i][dims tx + 16j] += P . V
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PAD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * HEAD_DIM + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // out is (B, T, H, D) contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = out + (((size_t)b * t_len + t) * n_heads + h) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = acc[i][j] / denom;
  }
}

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_len, int H, int kv_len, int q_offset,
                   const long long* st, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<CAUSAL><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), T_len, H,
      kv_len, q_offset, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], 1.0f / sqrtf((float)HEAD_DIM));
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int STAGES = 2;               // K/V tiles in the ring
constexpr int THREADS = 128;            // one warpgroup
constexpr int MIN_BLOCKS = 4;           // per SM: at most 128 registers
constexpr int ROW_BYTES = HEAD_DIM * 2;             // 128: one swizzle row
constexpr int TILE_BYTES = BK * ROW_BYTES;          // one K or V tile
constexpr int STAGE_BYTES = 2 * TILE_BYTES;         // K then V
constexpr int ATOM_BYTES = 8 * ROW_BYTES;           // 8 rows: a swizzle atom
// + one atom, to align the ring to the 1024-byte atom the swizzle assumes;
// within the 48 KB a launch gets without opting in
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + ATOM_BYTES;
static_assert(SMEM <= 48 * 1024, "the ring fits the default shared memory");
// D^-0.5 * log2(e): p = 2^(s * SCALE_LOG2E - m * SCALE_LOG2E) = e^((s -
// m) * D^-0.5). It is below 1, so a masked score times it stays finite.
constexpr float SCALE_LOG2E = 0.125f * 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// Shared-memory matrix descriptor of a tile of 128-byte rows in the
// 128-byte swizzle: start address, leading and stride byte offsets (in 16
// bytes) and the layout type. The stride byte offset steps over 8 rows (one
// swizzle atom); the leading byte offset is unused for K-major tiles whose
// k-extent lies in one atom, and for the MN-major V tile, whose 64 dims are
// one atom wide, it is given the same 8-row step.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(ATOM_BYTES >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product (it cannot see that wait_group writes
// them).
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64 fp32, this thread's 32) = a (64 x 16 bf16, registers) . B
// (16 x 64 bf16, shared memory), plus d unless `accumulate` is 0; TRANS_B
// 0: B is K-major (k's rows), 1: MN-major (v's rows).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred acc;\nsetp.ne.b32 acc, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, acc, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(TRANS_B), "r"(accumulate));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
      wgmma_m64n64k16<0>(s, qa[j], sw128_desc(ks + 32 * j, 0), j);
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
      wgmma_m64n64k16<1>(o, pa[j], sw128_desc(vs + 2 * ATOM_BYTES * j,
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

// cp.async moves 16 bytes: every base address 16-byte aligned and every
// stride a whole number of 8 elements
bool aligned(const void* q, const void* k, const void* v, const void* out,
             const long long* st) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

}  // namespace tc

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q is
// (B, T, H, D) with element strides (sq_b, sq_t, sq_h); k and v are
// (B, H, S, D) with strides (s*_b, s*_h, s*_s); D = 64 is contiguous in
// all three. out is a contiguous (B, T, H, D) buffer of the same type.
// 0 <= kv_len <= S and q_offset >= 0. In bf16 the four pointers are
// 16-byte aligned and the nine strides multiples of 8 elements.
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int T_len, int S, int H,
                                  int D, int kv_len, int q_offset, int causal,
                                  long long sq_b, long long sq_t,
                                  long long sq_h, long long sk_b,
                                  long long sk_h, long long sk_s,
                                  long long sv_b, long long sv_h,
                                  long long sv_s, int is_bf16, void* stream) {
  if (D != HEAD_DIM || B < 1 || T_len < 1 || H < 1 || B > 65535 ||
      H > 65535 || kv_len < 0 || kv_len > S || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {sq_b, sq_t, sq_h, sk_b, sk_h, sk_s,
                           sv_b, sv_h, sv_s};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)(causal ? simt::launch<true>(q, k, v, out, B, T_len, H,
                                             kv_len, q_offset, st, s)
                        : simt::launch<false>(q, k, v, out, B, T_len, H,
                                              kv_len, q_offset, st, s));
  if (!tc::aligned(q, k, v, out, st)) return (int)cudaErrorInvalidValue;
  return (int)(causal ? tc::launch<true>(q, k, v, out, B, T_len, H, kv_len,
                                         q_offset, st, s)
                      : tc::launch<false>(q, k, v, out, B, T_len, H, kv_len,
                                          q_offset, st, s));
}
