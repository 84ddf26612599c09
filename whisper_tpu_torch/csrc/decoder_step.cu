// Fused decoder step for Hopper (sm_90a): one T==1 decode step through
// every decoder layer in ONE cooperative launch.
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/decoder_step.py:320
// fused_decoder_step (kernel body _kernel, :114). Per layer, with h the
// (B, d) hidden state (ops/decoder_step.py gives the math):
//   LN1, the fused QKV product, self-attention over the cache rows < pos
//   plus the current token, the o-projection and residual; LN2, the
//   cross-q product, cross-attention over the encoder positions, the
//   co-projection and residual; LN3, fc1, exact-erf GeLU, fc2 and
//   residual. Each layer's new K/V row comes back for the caller's append.
// The rounding points are the JAX kernel's: every product, bias and
// residual sum rounds through the compute dtype (`rnd`), LayerNorm and
// softmax statistics stay fp32, masked scores are -0.7 * FLT_MAX.
//
// What bounds it on the H100: bytes. Per step it must read every
// decoder weight once (L * 14 d^2 elements) and the cross K/V of every
// row (2 L B H S_cross D elements), which dominates: at Whisper-tiny b32
// bf16 ~321 MB, 96 us at 3.35 TB/s; at large-v3-turbo b32 bf16 ~1.2 GB,
// 358 us. Its products (2 B L 14 d^2 FLOP, 5.9 GFLOP at turbo b32) run
// here on the fp32 CUDA cores, 88 us at their 67 TFLOP/s peak.
//
// Design. On the TPU the grid (layer, phase) runs in order on one core
// with h in VMEM. Here blocks run in parallel, so the kernel is one
// persistent cooperative grid (as many blocks as fit on the card at once,
// from the occupancy calculator) that walks the layers in phases
// separated by grid-wide barriers (cooperative_groups grid sync); every
// intermediate lives in an fp32 scratch in device memory (L2-resident at
// these sizes) that the wrapper allocates:
//   rows   LN of the B rows (one block per row), fused with the epilogue
//          of the product before it: h = rnd(h + rnd(rnd(sum) + rnd(b)))
//   gemm   X (B, K) @ W (K, N): an item is a 64-column tile times a
//          K-chunk, so each weight element is read ONCE per step for all
//          B rows; the 8 warps of a block split the chunk and reduce in
//          shared memory; each item writes its partial sums, and the
//          consumer (a rows phase, an attention phase, the next gemm's
//          staging) sums the chunks in a fixed order: deterministic.
//   self   one item per (b, h): q, k, v from the QKV partials, k and v
//          written out, an online softmax seeded with the current token
//          over the rows < pos (no row at or past pos is read).
//   cross  one item per (b, h, key split): partial (m, l, acc) per split,
//          merged in the co-projection's staging.
// Per layer: rows, qkv, self, o, rows, cq, cross, co, rows, fc1, fc2:
// eleven barriers. The fc1 epilogue (bias, GeLU) runs in fc2's staging.
// Tensor cores (wgmma), TMA and fewer barriers are later work.

#include <cooperative_groups.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using wt::from_f32;
using wt::rnd;
using wt::to_f32;

constexpr int HEAD_DIM = 64;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 64;            // gemm output columns per item
constexpr int RB = 32;            // gemm rows per pass
constexpr int KC_MAX = 512;       // gemm K-chunk bounds
constexpr int KC_MIN = 128;
constexpr int NCS_MAX = 32;       // cross key splits at most
constexpr int LANES_PER_KEY = 4;  // attention: 16 dims per lane
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;
constexpr int SEG = HEAD_DIM / LANES_PER_KEY;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr size_t SMEM_BYTES = (size_t)RB * KC_MAX * sizeof(float);  // 64 KB
static_assert((size_t)WARPS * RB * NT * sizeof(float) <= SMEM_BYTES,
              "the gemm reduction overlays the staged rows");

struct GemmPlan {
  int kc, ks;   // K-chunk and number of chunks
};

template <typename T>
struct Args {
  const T *h0, *wqkv, *wcq, *wo, *wco, *fc1, *fc2;
  const float* vec;             // (L, 13d + ff)
  const T *sk, *sv, *ck, *cv;   // (L, B, H, S, D)
  T *h_out, *knew, *vnew;
  float *h, *y, *af, *parts_a, *parts_b, *cm, *cl, *cacc;   // scratch
  int L, B, H, d, ff, s_self, s_cross, n_stale, n_cs;
  float eps;
  GemmPlan qkv, dd, f1, f2;   // K=d N=3d; K=d N=d (o, cq, co); fc1; fc2
};

// 16 consecutive elements as fp32 (16-byte vector loads).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = u.x;
    out[4 * i + 1] = u.y;
    out[4 * i + 2] = u.z;
    out[4 * i + 3] = u.w;
  }
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      float* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// Two neighbouring elements as fp32.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

// parts[ks][b][n] = sum over K-chunk ks of X[b][k] W[k][n], for every
// (64-column tile, K-chunk) item. stage(b, k) gives X's values.
template <typename T, typename Stage>
__device__ void gemm_phase(const T* W, int K, int N, GemmPlan plan,
                           float* parts, int B, float* smem, Stage stage) {
  const int ntiles = (N + NT - 1) / NT;
  const int items = ntiles * plan.ks;
  const int kc = plan.kc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* xs = smem;    // [RB][kc] staged rows
  float* red = smem;   // [WARPS][RB][NT] after the K loop
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % ntiles, ks = it / ntiles;
    const int n0 = tile * NT, k0 = ks * kc, kn = min(kc, K - k0);
    const int col = n0 + 2 * lane;
    const bool live = col < N;
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int rb = min(RB, B - r0);
      __syncthreads();                       // the previous pass is read
      for (int i = threadIdx.x; i < RB * kc; i += THREADS) {
        const int r = i / kc, kk = i % kc;
        xs[i] = (r < rb && kk < kn) ? stage(r0 + r, k0 + kk) : 0.f;
      }
      __syncthreads();
      float acc[RB][2];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = 0.f;
      for (int kk = 4 * warp; kk < kn; kk += 4 * WARPS) {
        float2 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = (live && kk + u < kn)
                     ? load2<T>(W + (size_t)(k0 + kk + u) * N + col)
                     : make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(xs + r * kc + kk);
          float s0 = acc[r][0], s1 = acc[r][1];
          s0 = fmaf(x.x, w[0].x, s0);
          s1 = fmaf(x.x, w[0].y, s1);
          s0 = fmaf(x.y, w[1].x, s0);
          s1 = fmaf(x.y, w[1].y, s1);
          s0 = fmaf(x.z, w[2].x, s0);
          s1 = fmaf(x.z, w[2].y, s1);
          s0 = fmaf(x.w, w[3].x, s0);
          s1 = fmaf(x.w, w[3].y, s1);
          acc[r][0] = s0;
          acc[r][1] = s1;
        }
      }
      __syncthreads();                       // xs is no longer read
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        red[(warp * RB + r) * NT + 2 * lane] = acc[r][0];
        red[(warp * RB + r) * NT + 2 * lane + 1] = acc[r][1];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < RB * NT; i += THREADS) {
        const int r = i / NT, c = i % NT;
        if (r < rb && n0 + c < N) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) s += red[(w * RB + r) * NT + c];
          parts[((size_t)ks * B + r0 + r) * N + n0 + c] = s;
        }
      }
    }
  }
}

// The sum of a gemm's K-chunk partials for output (b, n).
__device__ __forceinline__ float part_sum(const float* parts, int ks, int B,
                                          int N, int b, int n) {
  float s = 0.f;
  for (int j = 0; j < ks; ++j) s += parts[((size_t)j * B + b) * N + n];
  return s;
}

// Per row b: h = first ? h0 : rnd(h + rnd(rnd(sum of parts) + rnd(bias)));
// then y = rnd(LN(h)), or h_out = h on the final pass.
template <typename T>
__device__ void rows_phase(const Args<T>& a, const float* parts, int ks,
                           const float* bias, const float* g,
                           const float* beta, bool first, bool final,
                           float* smem) {
  const int d = a.d;
  float* row = smem;              // [d]
  float* red = smem + d;          // [WARPS]
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float x;
      if (first) {
        x = to_f32<T>(a.h0[(size_t)b * d + c]);
      } else {
        const float delta = part_sum(parts, ks, a.B, d, b, c);
        x = rnd<T>(a.h[(size_t)b * d + c] +
                   rnd<T>(rnd<T>(delta) + rnd<T>(bias[c])));
      }
      row[c] = x;
      s += x;
      if (final)
        a.h_out[(size_t)b * d + c] = from_f32<T>(x);
      else
        a.h[(size_t)b * d + c] = x;
    }
    if (final) continue;
    const float mean = block_sum(s, red) / d;
    float ss = 0.f;
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float dv = row[c] - mean;
      ss += dv * dv;
    }
    const float inv = rsqrtf(block_sum(ss, red) / d + a.eps);
    for (int c = threadIdx.x; c < d; c += THREADS)
      a.y[(size_t)b * d + c] = rnd<T>((row[c] - mean) * inv * g[c] + beta[c]);
    __syncthreads();
  }
}

// Online softmax over keys [j0, j1) of one (b, h)'s contiguous (S, D)
// rows, q pre-scaled in shared memory. Returns the block's (m, l) and its
// 64-wide accumulator in acc_out (shared), all threads synchronised.
template <typename T>
__device__ void attend(const float* qs, const T* kb, const T* vb, int j0,
                       int j1, float* m_w, float* l_w, float* acc_w,
                       float* m_out, float* l_out, float* acc_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane % LANES_PER_KEY, kl = lane / LANES_PER_KEY;
  float q[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) q[i] = qs[seg * SEG + i];
  float m = MASK_VALUE, l = 0.f, acc[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) acc[i] = 0.f;
  for (int jb = j0 + warp * KEYS_PER_WARP; jb < j1;
       jb += WARPS * KEYS_PER_WARP) {
    const int j = jb + kl;
    const bool valid = j < j1;
    float kr[SEG], vr[SEG];
    if (valid) {
      load16<T>(kb + (size_t)j * HEAD_DIM + seg * SEG, kr);
      load16<T>(vb + (size_t)j * HEAD_DIM + seg * SEG, vr);
    }
    float s = 0.f;
    if (valid) {
#pragma unroll
      for (int i = 0; i < SEG; ++i) s = fmaf(q[i], kr[i], s);
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
      acc[i] = acc[i] * alpha + (valid ? p * vr[i] : 0.f);
    m = m_new;
  }
#pragma unroll
  for (int off = LANES_PER_KEY; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) acc_w[warp * HEAD_DIM + seg * SEG + i] = acc[i];
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
      const float e = expf(m_w[w] - mm);
      ll += l_w[w] * e;
      o += acc_w[w * HEAD_DIM + threadIdx.x] * e;
    }
    acc_out[threadIdx.x] = o;
    if (threadIdx.x == 0) {
      *m_out = mm;
      *l_out = ll;
    }
  }
  __syncthreads();
}

// Self-attention of layer l, one item per (b, h).
template <typename T>
__device__ void self_phase(const Args<T>& a, int l, const float* vec,
                           float* smem) {
  const int d = a.d, H = a.H, B = a.B;
  float* qkv = smem;                       // [3][64]
  float* qs = qkv + 3 * HEAD_DIM;          // [64]
  float* m_w = qs + HEAD_DIM;              // [WARPS]
  float* l_w = m_w + WARPS;                // [WARPS]
  float* acc_w = l_w + WARPS;              // [WARPS][64]
  float* acc = acc_w + WARPS * HEAD_DIM;   // [64]
  float* ml = acc + HEAD_DIM;              // [4]: m, l, s_new
  const float scale = rsqrtf((float)HEAD_DIM);
  for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
    const int b = it / H, h = it % H;
    if (threadIdx.x < 3 * HEAD_DIM) {
      const int which = threadIdx.x / HEAD_DIM, c = threadIdx.x % HEAD_DIM;
      const int n = which * d + h * HEAD_DIM + c;
      const float s = part_sum(a.parts_a, a.qkv.ks, B, 3 * d, b, n);
      qkv[threadIdx.x] = rnd<T>(rnd<T>(s) + rnd<T>(vec[n]));   // qkv_b at 0
    }
    __syncthreads();
    const size_t row = (((size_t)l * B + b) * H + h);
    if (threadIdx.x < HEAD_DIM) {
      const int c = threadIdx.x;
      a.knew[row * HEAD_DIM + c] = from_f32<T>(qkv[HEAD_DIM + c]);
      a.vnew[row * HEAD_DIM + c] = from_f32<T>(qkv[2 * HEAD_DIM + c]);
      qs[c] = qkv[c] * scale;
    }
    __syncthreads();
    if (threadIdx.x < 32) {      // the current token's score
      float s = qs[threadIdx.x] * qkv[HEAD_DIM + threadIdx.x] +
                qs[threadIdx.x + 32] * qkv[HEAD_DIM + threadIdx.x + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (threadIdx.x == 0) ml[2] = s;
    }
    const size_t base = row * a.s_self * HEAD_DIM;
    attend<T>(qs, a.sk + base, a.sv + base, 0, a.n_stale, m_w, l_w, acc_w,
              &ml[0], &ml[1], acc);
    if (threadIdx.x < HEAD_DIM) {
      // seed term: m = s_new, l = 1, acc = v_new (:208-214)
      const float s_new = ml[2], mm = fmaxf(ml[0], s_new);
      const float e_c = expf(ml[0] - mm), e_s = expf(s_new - mm);
      const float den = ml[1] * e_c + e_s;
      const float o = acc[threadIdx.x] * e_c + qkv[2 * HEAD_DIM + threadIdx.x] * e_s;
      a.af[(size_t)b * d + h * HEAD_DIM + threadIdx.x] =
          rnd<T>(o / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

// Cross-attention of layer l: one item per (b, h, key split), its
// partial (m, l, acc) into cm, cl, cacc.
template <typename T>
__device__ void cross_phase(const Args<T>& a, int l, const float* cq_b,
                            float* smem) {
  const int d = a.d, H = a.H, B = a.B, S = a.s_cross, n_cs = a.n_cs;
  float* qs = smem;
  float* m_w = qs + HEAD_DIM;
  float* l_w = m_w + WARPS;
  float* acc_w = l_w + WARPS;
  const float scale = rsqrtf((float)HEAD_DIM);
  const int per = (S + n_cs - 1) / n_cs;
  for (int it = blockIdx.x; it < B * H * n_cs; it += gridDim.x) {
    const int bh = it / n_cs, split = it % n_cs;
    const int b = bh / H, h = bh % H;
    if (threadIdx.x < HEAD_DIM) {
      const int n = h * HEAD_DIM + threadIdx.x;
      const float s = part_sum(a.parts_a, a.dd.ks, B, d, b, n);
      qs[threadIdx.x] = rnd<T>(rnd<T>(s) + rnd<T>(cq_b[n])) * scale;
    }
    __syncthreads();
    const size_t base = (((size_t)l * B + b) * H + h) * S * HEAD_DIM;
    const int j0 = split * per, j1 = min(S, j0 + per);
    attend<T>(qs, a.ck + base, a.cv + base, j0, j1, m_w, l_w, acc_w,
              a.cm + it, a.cl + it, a.cacc + (size_t)it * HEAD_DIM);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fused_step_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, ff = a.ff, B = a.B, H = a.H, n_cs = a.n_cs;
  const size_t P = 13 * (size_t)d + ff;
  // offsets into a layer's vec row (ops/decoder_step.py vec_offsets)
  const int o_fc1b = 3 * d, o_cqb = 3 * d + ff, o_ob = 4 * d + ff,
            o_cob = 5 * d + ff, o_fc2b = 6 * d + ff, o_ln = 7 * d + ff;
  const float* y = a.y;
  const float* af = a.af;

  for (int l = 0; l < a.L; ++l) {
    const float* vec = a.vec + l * P;
    const float* prev = l ? a.vec + (l - 1) * P : vec;
    rows_phase<T>(a, a.parts_b, a.f2.ks, prev + o_fc2b, vec + o_ln,
                  vec + o_ln + d, l == 0, false, smem);
    grid.sync();
    gemm_phase<T>(a.wqkv + (size_t)l * d * 3 * d, d, 3 * d, a.qkv, a.parts_a,
                  B, smem, [&](int b, int k) { return y[(size_t)b * d + k]; });
    grid.sync();
    self_phase<T>(a, l, vec, smem);
    grid.sync();
    gemm_phase<T>(a.wo + (size_t)l * d * d, d, d, a.dd, a.parts_b, B, smem,
                  [&](int b, int k) { return af[(size_t)b * d + k]; });
    grid.sync();
    rows_phase<T>(a, a.parts_b, a.dd.ks, vec + o_ob, vec + o_ln + 2 * d,
                  vec + o_ln + 3 * d, false, false, smem);
    grid.sync();
    gemm_phase<T>(a.wcq + (size_t)l * d * d, d, d, a.dd, a.parts_a, B, smem,
                  [&](int b, int k) { return y[(size_t)b * d + k]; });
    grid.sync();
    cross_phase<T>(a, l, vec + o_cqb, smem);
    grid.sync();
    // co-projection; its staging merges the cross splits of head k / 64
    gemm_phase<T>(a.wco + (size_t)l * d * d, d, d, a.dd, a.parts_b, B, smem,
                  [&](int b, int k) {
                    const int i0 = (b * H + k / HEAD_DIM) * n_cs;
                    float mm = MASK_VALUE;
                    for (int s = 0; s < n_cs; ++s) mm = fmaxf(mm, a.cm[i0 + s]);
                    float den = 0.f, num = 0.f;
                    for (int s = 0; s < n_cs; ++s) {
                      const float e = expf(a.cm[i0 + s] - mm);
                      den += a.cl[i0 + s] * e;
                      num += a.cacc[(size_t)(i0 + s) * HEAD_DIM + k % HEAD_DIM] * e;
                    }
                    return rnd<T>(num / fmaxf(den, 1e-30f));
                  });
    grid.sync();
    rows_phase<T>(a, a.parts_b, a.dd.ks, vec + o_cob, vec + o_ln + 4 * d,
                  vec + o_ln + 5 * d, false, false, smem);
    grid.sync();
    gemm_phase<T>(a.fc1 + (size_t)l * d * ff, d, ff, a.f1, a.parts_a, B, smem,
                  [&](int b, int k) { return y[(size_t)b * d + k]; });
    grid.sync();
    // fc2; its staging is fc1's epilogue: bias, exact-erf GeLU, rounding
    const float* fc1_b = vec + o_fc1b;
    gemm_phase<T>(a.fc2 + (size_t)l * ff * d, ff, d, a.f2, a.parts_b, B, smem,
                  [&](int b, int k) {
                    const float t = rnd<T>(
                        rnd<T>(part_sum(a.parts_a, a.f1.ks, B, ff, b, k)) +
                        rnd<T>(fc1_b[k]));
                    return rnd<T>(0.5f * t *
                                  (1.f + erff(t * 0.70710678118654752f)));
                  });
    grid.sync();
  }
  const float* last = a.vec + (a.L - 1) * P;
  rows_phase<T>(a, a.parts_b, a.f2.ks, last + o_fc2b, nullptr, nullptr, false,
                true, smem);
}

GemmPlan plan_gemm(int K, int N, int grid) {
  const int ntiles = (N + NT - 1) / NT;
  const int want = std::max(1, (grid + ntiles - 1) / ntiles);
  int kc = (K + want - 1) / want;
  kc = (kc + 31) / 32 * 32;
  kc = std::max(kc, std::min(KC_MIN, (K + 31) / 32 * 32));
  kc = std::min(kc, KC_MAX);
  return {kc, (K + kc - 1) / kc};
}

// Most K-chunks any plan gives for a reduction of depth K.
size_t max_chunks(int K) {
  const int kc_min = std::min(KC_MIN, (K + 31) / 32 * 32);
  return (size_t)((K + kc_min - 1) / kc_min);
}

struct Layout {
  size_t h, y, af, parts_a, parts_b, cm, cl, cacc, total;
};

Layout layout(int B, int H, int d, int ff) {
  Layout o;
  size_t at = 0;
  auto take = [&](size_t n) {
    const size_t start = at;
    at += (n + 3) / 4 * 4;      // 16-byte aligned pieces
    return start;
  };
  o.h = take((size_t)B * d);
  o.y = take((size_t)B * d);
  o.af = take((size_t)B * d);
  o.parts_a = take((size_t)B * max_chunks(d) * std::max(3 * d, ff));
  o.parts_b = take((size_t)B * std::max(max_chunks(d), max_chunks(ff)) * d);
  o.cm = take((size_t)B * H * NCS_MAX);
  o.cl = take((size_t)B * H * NCS_MAX);
  o.cacc = take((size_t)B * H * NCS_MAX * HEAD_DIM);
  o.total = at;
  return o;
}

template <typename T>
cudaError_t launch_step(Args<T> a, float* scratch, long long scratch_floats,
                        cudaStream_t stream) {
  const Layout lay = layout(a.B, a.H, a.d, a.ff);
  if ((size_t)scratch_floats < lay.total) return cudaErrorInvalidValue;
  a.h = scratch + lay.h;
  a.y = scratch + lay.y;
  a.af = scratch + lay.af;
  a.parts_a = scratch + lay.parts_a;
  a.parts_b = scratch + lay.parts_b;
  a.cm = scratch + lay.cm;
  a.cl = scratch + lay.cl;
  a.cacc = scratch + lay.cacc;

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fused_step_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  // every block of a cooperative grid must be resident at once
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_step_kernel<T>, THREADS, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms;

  a.qkv = plan_gemm(a.d, 3 * a.d, grid);
  a.dd = plan_gemm(a.d, a.d, grid);
  a.f1 = plan_gemm(a.d, a.ff, grid);
  a.f2 = plan_gemm(a.ff, a.d, grid);
  a.n_cs = std::max(1, std::min({NCS_MAX, a.s_cross,
                                 (4 * grid + a.B * a.H - 1) / (a.B * a.H)}));
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fused_step_kernel<T>,
                                  dim3(grid), dim3(THREADS), params,
                                  SMEM_BYTES, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// fp32 scratch floats wt_fused_decoder_step needs for these widths.
extern "C" long long wt_fused_decoder_step_scratch(int B, int H, int d,
                                                   int ff) {
  return (long long)layout(B, H, d, ff).total;
}

// Returns cudaGetLastError() after the launch (0 on success). Shapes, all
// contiguous, 16-byte aligned and in one element type (fp32 or bf16,
// is_bf16) but `vec` (fp32): h0, h_out (B, d); wqkv (L, d, 3d); wcq, wo,
// wco (L, d, d); fc1 (L, d, ff); fc2 (L, ff, d); vec (L, 13d + ff);
// self_k, self_v (L, B, H, S_self, D); cross_k, cross_v (L, B, H,
// S_cross, D); k_new, v_new (L, B, H, D). D must be 64 and d = H * D;
// kv_len in [1, S_self] counts the current token, so rows < kv_len - 1 of
// the self cache are read.
extern "C" int wt_fused_decoder_step(
    const void* h0, const void* wqkv, const void* wcq, const void* wo,
    const void* wco, const void* fc1, const void* fc2, const void* vec,
    const void* self_k, const void* self_v, const void* cross_k,
    const void* cross_v, void* h_out, void* k_new, void* v_new,
    void* scratch, long long scratch_floats, int L, int B, int H, int D,
    int d, int ff, int s_self, int s_cross, int kv_len, float eps,
    int is_bf16, void* stream) {
  if (D != HEAD_DIM || d != H * D || ff < 1 || ff % 2 != 0 || L < 1 ||
      B < 1 || s_self < 1 || s_cross < 1 || kv_len < 1 || kv_len > s_self)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  auto fill = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Args<T> a{};
    a.h0 = static_cast<const T*>(h0);
    a.wqkv = static_cast<const T*>(wqkv);
    a.wcq = static_cast<const T*>(wcq);
    a.wo = static_cast<const T*>(wo);
    a.wco = static_cast<const T*>(wco);
    a.fc1 = static_cast<const T*>(fc1);
    a.fc2 = static_cast<const T*>(fc2);
    a.vec = static_cast<const float*>(vec);
    a.sk = static_cast<const T*>(self_k);
    a.sv = static_cast<const T*>(self_v);
    a.ck = static_cast<const T*>(cross_k);
    a.cv = static_cast<const T*>(cross_v);
    a.h_out = static_cast<T*>(h_out);
    a.knew = static_cast<T*>(k_new);
    a.vnew = static_cast<T*>(v_new);
    a.L = L;
    a.B = B;
    a.H = H;
    a.d = d;
    a.ff = ff;
    a.s_self = s_self;
    a.s_cross = s_cross;
    a.n_stale = kv_len - 1;
    a.eps = eps;
    return launch_step<T>(a, sc, scratch_floats, s);
  };
  return (int)(is_bf16 ? fill((__nv_bfloat16*)nullptr) : fill((float*)nullptr));
}
