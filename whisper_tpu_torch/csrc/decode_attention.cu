// Single-token attention over a head-major K/V cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of whisper_tpu/ops/decode_attention.py:
// :297 decode_attention_bh (kernel body _decode_kernel_bh, :247), :185
// decode_attention_bg (_decode_kernel_bg, :138), :354 decode_attention
// (_decode_kernel, :45), :464 decode_attention_q8_bh (_decode_kernel_q8_bh,
// :425) and :525 decode_attention_q8 (_decode_kernel_q8, :92). The five
// share one contract; their grids (all heads per program, block_b batch
// rows per program, one (b, h) per program) are TPU tilings, so one kernel
// serves every wrapper. For each (b, h), with q (B, 1, H, D) in fp32 or
// bf16 and k, v (B, H, S, D) in fp32, bf16 or int8 (then with per-vector
// fp32 scales ks, vs (B, H, S, 1)):
//
//   s_j = (q * D^-0.5) . k_j                    j < kv_len
//   out = sum_j p_j v_j / max(l, 1e-30),  p_j = exp(s_j - m),  l = sum_j p_j
//
// with an online softmax in fp32 and the output cast to q's dtype. Keys
// at or past kv_len are never read; kv_len = 0 gives zeros, as the Pallas
// kernels' max(l, 1e-30) does (:89, :293, :460). The numerics follow the
// JAX kernels: q is scaled in fp32 before the product, each key is
// converted element by element before its dot, masked scores are
// -0.7 * FLT_MAX. Two rounding points are template flags: KV_ROUND casts
// K/V to q's dtype first (decode_attention_bh/_bg, :203-204, :308-309; it
// rounds only fp32 K/V under a bf16 query) and P_ROUND rounds p to V's
// dtype before the p.v product (decode_attention, :82-84; it rounds only
// under bf16 V). The int8 kernels carry SCALED: k_j = k8_j * ks_j.
//
// What bounds it on the H100: bytes. Each key costs 2 x 64 values of K
// and V (plus two fp32 scales for int8) against 4 x 64 FLOP, at most 1
// FLOP per byte. At tiny b32's bf16 cross read (B=32, H=6, S=1500) that is
// 73.7 MB, 22.0 us at 3.35 TB/s; at large-v3-turbo b32 (H=20) 245.8 MB,
// 73.4 us; fp32 doubles both; int8 with scales is 39.2 MB and 130.6 MB.
//
// Design: one block per (b, h), 8 warps. A warp takes 8 consecutive keys
// per step: 4 lanes per key, each lane 16 values of K and of V in 16-byte
// loads (int8: one, bf16: two, fp32: four; a warp's loads cover 8 whole
// rows of each). A key's score is summed over its 4 lanes by shuffles;
// each warp keeps its own running max (shared by its lanes), and each lane
// its own sum and 16-wide accumulator, rescaled by the warp's alpha. At
// the end the lanes of a warp and then the 8 warps are combined, the warps
// through shared memory. decode_attention_bg's block_b rows per program
// are not carried over: at b32 x 6 heads, 8 rows per block would leave 4
// blocks for 132 SMs. Split-S (flash-decoding), TMA and more bytes in
// flight per lane are later speed work.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wt::from_f32;
using wt::to_f32;

constexpr int HEAD_DIM = 64;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LANES_PER_KEY = 4;                  // 16 dims per lane
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY; // keys per warp step
constexpr int SEG = HEAD_DIM / LANES_PER_KEY;     // 16
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// 16 consecutive K/V elements as fp32, in 16-byte loads.
template <typename KVT>
struct Row16;

template <>
struct Row16<int8_t> {
  static __device__ __forceinline__ void load(const int8_t* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = (float)static_cast<signed char>(w[i] >> (8 * b));
  }
};

// bf16: two 16-byte loads; a bf16 value is the high half of its fp32.
template <>
struct Row16<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4* u = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 x = u[i];
      const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
};

// fp32: four 16-byte loads.
template <>
struct Row16<float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4* u = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = u[i];
      out[4 * i] = x.x;
      out[4 * i + 1] = x.y;
      out[4 * i + 2] = x.z;
      out[4 * i + 3] = x.w;
    }
  }
};

template <typename QT, typename KVT, bool SCALED, bool P_ROUND = false,
          bool KV_ROUND = false>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
              const float* __restrict__ k_scale, const KVT* __restrict__ v,
              const float* __restrict__ v_scale, QT* __restrict__ out,
              int s_len, int kv_len, float scale) {
  __shared__ float m_w[WARPS], l_w[WARPS];
  __shared__ float acc_w[WARPS][HEAD_DIM];

  const long long bh = blockIdx.x;                 // b * H + h
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane % LANES_PER_KEY;            // this lane's 16 dims
  const int kl = lane / LANES_PER_KEY;             // its key in the step
  const KVT* kb = k + bh * s_len * HEAD_DIM + seg * SEG;
  const KVT* vb = v + bh * s_len * HEAD_DIM + seg * SEG;
  const float* ksb = SCALED ? k_scale + bh * s_len : nullptr;
  const float* vsb = SCALED ? v_scale + bh * s_len : nullptr;

  float qs[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    qs[i] = to_f32<QT>(q[bh * HEAD_DIM + seg * SEG + i]) * scale;

  float m = MASK_VALUE, l = 0.f, acc[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) acc[i] = 0.f;

  for (int j0 = warp * KEYS_PER_WARP; j0 < kv_len;
       j0 += WARPS * KEYS_PER_WARP) {
    const int j = j0 + kl;
    const bool valid = j < kv_len;
    float kr[SEG], vr[SEG], ks = 1.f, vs = 1.f;
    if (valid) {
      Row16<KVT>::load(kb + (long long)j * HEAD_DIM, kr);
      Row16<KVT>::load(vb + (long long)j * HEAD_DIM, vr);
      if constexpr (KV_ROUND) {
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          kr[i] = wt::rnd<QT>(kr[i]);
          vr[i] = wt::rnd<QT>(vr[i]);
        }
      }
      if (SCALED) {
        ks = ksb[j];
        vs = vsb[j];
      }
    }
    float s = 0.f;
    if (valid) {
#pragma unroll
      for (int i = 0; i < SEG; ++i) s = fmaf(qs[i], kr[i] * ks, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (!valid) s = MASK_VALUE;
    float mx = s;
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + p;
    float pv = p;
    if constexpr (P_ROUND) pv = wt::rnd<KVT>(p);
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      acc[i] = acc[i] * alpha + (valid ? pv * (vr[i] * vs) : 0.f);
    m = m_new;
  }

  // the warp's 8 key groups: each lane then holds the warp's sum and its
  // segment's accumulator
#pragma unroll
  for (int off = LANES_PER_KEY; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) acc_w[warp][seg * SEG + i] = acc[i];
    if (seg == 0) {
      m_w[warp] = m;
      l_w[warp] = l;
    }
  }
  __syncthreads();

  if (threadIdx.x < HEAD_DIM) {
    float mm = MASK_VALUE;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_w[w]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(m_w[w] - mm);
      ll += l_w[w] * a;
      o += acc_w[w][threadIdx.x] * a;
    }
    out[bh * HEAD_DIM + threadIdx.x] = from_f32<QT>(o / fmaxf(ll, 1e-30f));
  }
}

template <typename QT>
cudaError_t launch_q8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, void* out, long long bh,
                      int s_len, int kv_len, cudaStream_t stream) {
  decode_kernel<QT, int8_t, true><<<(unsigned)bh, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<QT*>(out), s_len, kv_len,
      1.0f / sqrtf((float)HEAD_DIM));
  return cudaGetLastError();
}

template <typename QT, typename KVT, bool P_ROUND, bool KV_ROUND>
cudaError_t launch_kv(const void* q, const void* k, const void* v, void* out,
                      long long bh, int s_len, int kv_len,
                      cudaStream_t stream) {
  decode_kernel<QT, KVT, false, P_ROUND, KV_ROUND>
      <<<(unsigned)bh, THREADS, 0, stream>>>(
          static_cast<const QT*>(q), static_cast<const KVT*>(k), nullptr,
          static_cast<const KVT*>(v), nullptr, static_cast<QT*>(out), s_len,
          kv_len, 1.0f / sqrtf((float)HEAD_DIM));
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q, out:
// (B, 1, H, D) fp32 or bf16 (q_is_bf16); k, v: (B, H, S, D) of one dtype,
// fp32 or bf16 (kv_is_bf16); all contiguous, k and v 16-byte aligned;
// D = 64. p_round: round p to V's dtype before the p.v product
// (decode_attention); cast_kv: K/V take q's dtype first
// (decode_attention_bh/_bg). Each flag is a no-op where its rounding is
// exact, and launches the unrounded instantiation there.
extern "C" int wt_decode_attention(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int heads, int s_len, int d, int kv_len,
                                   int q_is_bf16, int kv_is_bf16, int p_round,
                                   int cast_kv, void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch < 1 || heads < 1 || s_len < 1 || d != HEAD_DIM || kv_len < 0 ||
      kv_len > s_len || bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t e;
  if (q_is_bf16 && kv_is_bf16)
    e = p_round ? launch_kv<bf16, bf16, true, false>(q, k, v, out, bh, s_len,
                                                     kv_len, s)
                : launch_kv<bf16, bf16, false, false>(q, k, v, out, bh, s_len,
                                                      kv_len, s);
  else if (q_is_bf16)
    e = cast_kv ? launch_kv<bf16, float, false, true>(q, k, v, out, bh, s_len,
                                                      kv_len, s)
                : launch_kv<bf16, float, false, false>(q, k, v, out, bh,
                                                       s_len, kv_len, s);
  else if (kv_is_bf16)
    e = p_round ? launch_kv<float, bf16, true, false>(q, k, v, out, bh, s_len,
                                                      kv_len, s)
                : launch_kv<float, bf16, false, false>(q, k, v, out, bh,
                                                       s_len, kv_len, s);
  else
    e = launch_kv<float, float, false, false>(q, k, v, out, bh, s_len, kv_len,
                                              s);
  return (int)e;
}

// Returns cudaGetLastError() after the launch (0 on success). q, out:
// (B, 1, H, D) fp32 or bf16 (q_is_bf16); k, v: (B, H, S, D) int8; k_scale,
// v_scale: (B, H, S, 1) fp32; all contiguous and 16-byte aligned; D = 64.
extern "C" int wt_decode_attention_q8(const void* q, const void* k,
                                      const void* k_scale, const void* v,
                                      const void* v_scale, void* out,
                                      int batch, int heads, int s_len, int d,
                                      int kv_len, int q_is_bf16,
                                      void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch < 1 || heads < 1 || s_len < 1 || d != HEAD_DIM || kv_len < 0 ||
      kv_len > s_len || bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_is_bf16
                   ? launch_q8<__nv_bfloat16>(q, k, k_scale, v, v_scale, out,
                                              bh, s_len, kv_len, s)
                   : launch_q8<float>(q, k, k_scale, v, v_scale, out, bh,
                                      s_len, kv_len, s));
}
