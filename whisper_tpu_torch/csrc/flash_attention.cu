// Flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/flash_attention.py:112
// flash_attention (kernel body _flash_kernel, :40):
//
//   out[b, t, h] = sum_s p(t, s) v[b, h, s] / sum_s p(t, s)
//   p(t, s)      = exp(q[b, t, h] * D^-0.5 . k[b, h, s] - m_t)
//
// over the visible keys: s < kv_len and, under `causal`, s <= q_offset + t.
// The numerics are the JAX kernel's: q is scaled in fp32 before the
// product (:51); a masked score is -0.7 * FLT_MAX, not -inf (:37); the
// running (m, l, acc) are fp32; in bf16, p is rounded to bf16 before the
// p.v product while l sums the fp32 p (:79-84); out = acc / max(l, 1e-30),
// so a row with no visible key returns zeros (:93).
//
// What bounds it on the H100. At large-v3-turbo b32 one encoder layer
// (B=32, H=20, T=S=1500, D=64) is 4*B*H*T*S*D = 3.7e11 FLOP against
// 0.49 GB of q, k, v and output in bf16 (123 MB each): ~750 FLOP per byte,
// compute-bound. This first version computes every product with fp32 FMAs
// on the CUDA cores (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s
// bf16), so the SIMT rate is its ceiling; mma.sync/wgmma and TMA are later
// work.
//
// Design. One block per (64-query tile, head, batch row), 256 threads as
// 16 x 16: each thread owns 4 query rows x 4 keys of a score tile and the
// same 4 rows x 4 head dims of the output. K/V stream through shared
// memory in 64-key tiles and the softmax is online, so the (T, S) score
// matrix never exists. A tile's keys end at
//     key_end = min(kv_len, q_offset + last query row of the tile + 1)
// (kv_len alone when not causal), and the loop runs cdiv(key_end, 64)
// tiles: key blocks at or past kv_len, and blocks past the causal diagonal
// of the tile's last query, are neither read nor computed. Keys of the
// last tile at or past key_end load as zeros, so what lies there (NaN
// included) never meets a p of 0.
// q (B, T, H, D) and k, v (B, H, S, D) are read through their element
// strides, with D contiguous: the encoder hands over the views of its
// fused QKV projection without a copy (a copy would be three 123 MB
// copies per layer at turbo b32). The output is (B, T, H, D), contiguous.
// The encoder tail (encoder_tail.cu) runs its attention through this
// entry point too, with kv_len = S and no causal mask.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wt::from_f32;
using wt::rnd;
using wt::to_f32;

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64
constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per shared-memory tile
constexpr int THREADS = 256;            // 16 x 16: each thread 4 rows x 4 cols
constexpr int PAD = HEAD_DIM + 1;       // row stride that spreads banks
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr size_t SMEM =
    (size_t)(2 * BQ * PAD + BK * PAD + BK * HEAD_DIM) * sizeof(float);

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int t_len,
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
  const T* qb = q + b * sq_b + h * sq_h + c;
  const T* kb = k + b * sk_b + h * sk_h + c;
  const T* vb = v + b * sv_b + h * sv_h + c;
  for (int r = r0; r < BQ; r += ROW_STEP) {
    const int t = q0 + r;
    Qs[r * PAD + c] = t < t_len ? to_f32(qb[t * sq_t]) * scale : 0.f;
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
    const T* kr = kb + (s0 + r0) * sk_s;
    const T* vr = vb + (s0 + r0) * sv_s;
#pragma unroll
    for (int n = 0; n < BK / ROW_STEP; ++n) {
      const int r = r0 + n * ROW_STEP;
      float kval = 0.f, vval = 0.f;
      if (s0 + r < key_end) {
        kval = to_f32(kr[n * ROW_STEP * sk_s]);
        vval = to_f32(vr[n * ROW_STEP * sv_s]);
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
        Ps[(ty + 16 * i) * PAD + tx + 16 * j] = rnd<T>(p);
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
    T* row = out + (((size_t)b * t_len + t) * n_heads + h) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int T_len, int H, int kv_len, int q_offset,
                   const long long* st, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<T, CAUSAL><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, H, kv_len,
      q_offset, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], 1.0f / sqrtf((float)HEAD_DIM));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int T_len, int H, int kv_len,
                         int q_offset, bool causal, const long long* st,
                         cudaStream_t stream) {
  return causal ? launch<T, true>(q, k, v, out, B, T_len, H, kv_len,
                                  q_offset, st, stream)
                : launch<T, false>(q, k, v, out, B, T_len, H, kv_len,
                                   q_offset, st, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q is
// (B, T, H, D) with element strides (sq_b, sq_t, sq_h); k and v are
// (B, H, S, D) with strides (s*_b, s*_h, s*_s); D = 64 is contiguous in
// all three. out is a contiguous (B, T, H, D) buffer of the same type.
// 0 <= kv_len <= S and q_offset >= 0.
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
  return (int)(is_bf16 ? launch_flash<__nv_bfloat16>(q, k, v, out, B, T_len,
                                                     H, kv_len, q_offset,
                                                     causal != 0, st, s)
                       : launch_flash<float>(q, k, v, out, B, T_len, H,
                                             kv_len, q_offset, causal != 0,
                                             st, s));
}
