// Single-token attention over an int8 K/V cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels whisper_tpu/ops/decode_attention.py:464
// decode_attention_q8_bh (kernel body _decode_kernel_q8_bh, :425) and
// :525 decode_attention_q8 (_decode_kernel_q8, :92). The two share one
// contract; their grids (all heads per program, or one (b, h) per
// program) are TPU tilings, so one kernel serves both wrappers. For each
// (b, h), with q (B, 1, H, D) in fp32 or bf16, k and v (B, H, S, D) int8,
// and per-vector fp32 scales ks, vs (B, H, S, 1):
//
//   s_j = (q * D^-0.5) . (k8_j * ks_j)          j < kv_len
//   out = sum_j p_j (v8_j * vs_j) / max(l, 1e-30),  p_j = exp(s_j - m)
//
// with an online softmax in fp32 and the output cast to q's dtype. Keys
// at or past kv_len are never read; kv_len = 0 gives zeros, as the Pallas
// kernel's max(l, 1e-30) does (:460). The numerics follow the JAX kernel:
// q is scaled in fp32 before the product, each key is dequantized
// element by element before its dot, masked scores are -0.7 * FLT_MAX.
//
// What bounds it on the H100: bytes. Each key costs 2 x (64 + 4) bytes of
// int8 values and fp32 scales against 4 x 64 FLOP, ~1 FLOP per byte. At
// the port's main path (Whisper-tiny b32, fp32 mode, the cross read of
// one layer: B=32, H=6, S=1500) that is 39.2 MB, 11.7 us at 3.35 TB/s;
// at large-v3-turbo b32 (H=20) 130.6 MB, 39.0 us.
//
// Design: one block per (b, h), 8 warps. A warp takes 8 consecutive keys
// per step: 4 lanes per key, each lane one 16-byte load of 16 int8 values
// of K and of V (a warp's loads cover 512 contiguous bytes of each). A
// key's score is summed over its 4 lanes by shuffles; each warp keeps its
// own running max (shared by its lanes), and each lane its own sum and
// 16-wide accumulator, rescaled by the warp's alpha. At the end the lanes
// of a warp and then the 8 warps are combined, the warps through shared
// memory. Split-S (flash-decoding) for more parallelism is later work.
//
// The kernel is a template over the query type, the K/V element type and
// whether K/V carry scales, so that the unscaled fp32/bf16 decode kernels
// (decode_attention.py:297, :354) can become further instantiations; only
// the int8 scaled ones are built now.

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

// 16 consecutive K/V elements as fp32. int8: one 16-byte load.
template <typename KVT>
struct Row16 {
  static __device__ __forceinline__ void load(const KVT* p, float* out) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) out[i] = to_f32<KVT>(p[i]);
  }
};

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

template <typename QT, typename KVT, bool SCALED>
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
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      acc[i] = acc[i] * alpha + (valid ? p * (vr[i] * vs) : 0.f);
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

}  // namespace

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
