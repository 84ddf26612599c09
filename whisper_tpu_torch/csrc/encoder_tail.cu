// Fused encoder-block tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/encoder_layer.py:240
// encoder_block_tail (kernel body _tail_kernel, :57), unquantized variant:
//
//   a   = concat_h softmax(q_h k_h^T / sqrt(D)) v_h        (pad keys masked)
//   h2  = h_in + (a @ wo + o_b)
//   out = h2 + fc2(gelu_erf(fc1(LayerNorm2(h2))))
//
// with the bf16 rounding of the XLA block at the same storage points
// (_tail_kernel :88-92, :120, :136-148): attention output, each projection
// output, each bias, each residual sum, the LN2 output and the GeLU
// output are rounded through the compute dtype. Every product is computed
// here, by hand, in fp32 FMAs: q.k^T, p.v, the o-projection, fc1, fc2.
//
// What bounds it on the H100. At Whisper-tiny b32 one layer is about
// 1.1e11 FLOP of attention plus 1.3e11 FLOP of o-proj + MLP against
// ~0.3 GB of activations, ~900 FLOP per byte: compute-bound. This first
// version runs on the fp32 CUDA cores (67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16), so its ceiling is the SIMT rate; wgmma and TMA
// are the later work.
//
// Design. Two launches, one C entry point:
//   1. attention_kernel: one block per (64-query tile, head, batch row).
//      K/V stream through shared memory in 64-key tiles with an online
//      softmax, so the (T, S) score matrix never exists; the head's output
//      lands in a (B, T, H*D) buffer in the compute dtype (exact: the JAX
//      kernel rounds it there too).
//   2. tail_mlp_kernel: one block per MLP_RM = 16 rows of the flattened
//      (B*T, d) stream. The attention rows, h2 and the (16, ff) GeLU
//      intermediate stay in shared memory; the weights are read from
//      global memory, where the whole layer (2.7 MB bf16) sits in the
//      50 MB L2.
// Why two launches and not the TPU kernel's one: in one block the six
// heads run one after another and the block holds both the K/V tiles and
// the ~150 KB MLP working set, leaving one block per SM; split, the
// attention runs H times as many blocks at ~66 KB each. The price is one
// (B, T, d) round trip through device memory per layer (~74 MB at b32
// bf16).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using wt::from_f32;
using wt::rnd;
using wt::to_f32;

// ---------------------------------------------------------------------------
// 1. attention
// ---------------------------------------------------------------------------

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64
constexpr int ATT_BQ = 64;              // query rows per block
constexpr int ATT_BK = 64;              // keys per shared-memory tile
constexpr int ATT_THREADS = 256;        // 16 x 16: each thread 4 rows x 4 cols
constexpr int PAD = HEAD_DIM + 1;       // row stride that spreads banks
constexpr size_t ATT_SMEM =
    (size_t)(2 * ATT_BQ * PAD + ATT_BK * PAD + ATT_BK * HEAD_DIM) *
    sizeof(float);

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int t_len,
                 int s_len, int n_heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [ATT_BQ][PAD], pre-scaled
  float* Ks = Qs + ATT_BQ * PAD;            // [ATT_BK][PAD]
  float* Vs = Ks + ATT_BK * PAD;            // [ATT_BK][HEAD_DIM]
  float* Ps = Vs + ATT_BK * HEAD_DIM;       // [ATT_BQ][PAD] probabilities

  const int q0 = blockIdx.x * ATT_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;                  // key / head-dim column group
  const int ty = tid >> 4;                  // query row group

  // q is (B, T, H, D); the JAX kernel scales q in fp32 before the dot.
  for (int i = tid; i < ATT_BQ * HEAD_DIM; i += ATT_THREADS) {
    const int r = i / HEAD_DIM, c = i % HEAD_DIM;
    const int t = q0 + r;
    float val = 0.f;
    if (t < t_len)
      val = to_f32(q[(((size_t)b * t_len + t) * n_heads + h) * HEAD_DIM + c]) *
            scale;
    Qs[r * PAD + c] = val;
  }
  // k, v are head-major (B, H, S, D).
  const size_t kv_base = ((size_t)b * n_heads + h) * (size_t)s_len * HEAD_DIM;

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 < s_len; s0 += ATT_BK) {
    __syncthreads();  // Q is written (first pass) / the last tile is consumed
    for (int i = tid; i < ATT_BK * HEAD_DIM; i += ATT_THREADS) {
      const int r = i / HEAD_DIM, c = i % HEAD_DIM;
      const int s = s0 + r;
      float kval = 0.f, vval = 0.f;
      if (s < s_len) {
        kval = to_f32(k[kv_base + (size_t)s * HEAD_DIM + c]);
        vval = to_f32(v[kv_base + (size_t)s * HEAD_DIM + c]);
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
    // (one half-warp), so xor-shuffles over 8, 4, 2, 1 reduce a row.
    // Every tile holds key s0 < S, so the row max is finite and the first
    // tile's alpha = exp(-inf) = 0.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s0 + tx + 16 * j >= s_len) sc[i][j] = -INFINITY;
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
        // the JAX kernel feeds p to the p.v product in v's dtype, while
        // the denominator sums the fp32 p
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
    for (int kk = 0; kk < ATT_BK; ++kk) {
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

  // out is (B, T, H*D): head h's columns of the merged-head row
  const int d_model = n_heads * HEAD_DIM;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + ((size_t)b * t_len + t) * d_model + h * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

// ---------------------------------------------------------------------------
// 2. o-projection + residual + LN2 + MLP + residual
// ---------------------------------------------------------------------------

constexpr int MLP_RM = 16;                     // rows per block
constexpr int MLP_THREADS = 256;
constexpr int COL_GROUP = 128;                 // threads across a chunk's columns
constexpr int ROW_GROUPS = MLP_THREADS / COL_GROUP;
constexpr int COLS_PER_THREAD = 3;
constexpr int CHUNK = COL_GROUP * COLS_PER_THREAD;   // 384 output columns

// For every (r, n) in [0, MLP_RM) x [0, N):
// epi(r, n, sum_k A[r][k] * W[k][n]).
// A: fp32 in shared memory, row stride lda (a multiple of 4, 16-byte
// aligned); W: (K, N) row-major in global memory, K a multiple of 4.
// Thread (rg, cg) owns rows rg*MLP_RM/2 .. +MLP_RM/2 and columns
// n0 + cg + 128j of each 384-column chunk. The 32 lanes of a warp share rg, so each float4
// read of A is a broadcast, and they read 32 neighbouring columns of W.
template <typename T, typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda,
                                           const T* __restrict__ W, int K,
                                           int N, Epi epi) {
  constexpr int RPT = MLP_RM / ROW_GROUPS;
  const int cg = threadIdx.x % COL_GROUP;
  const int rg = threadIdx.x / COL_GROUP;
  const float* a_rows = A + (size_t)rg * RPT * lda;
  for (int n0 = 0; n0 < N; n0 += CHUNK) {
    int col[COLS_PER_THREAD];
    bool live[COLS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) {
      col[j] = n0 + cg + COL_GROUP * j;
      live[j] = col[j] < N;
    }
    float acc[RPT][COLS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) acc[r][j] = 0.f;

#pragma unroll 2
    for (int kk = 0; kk < K; kk += 4) {
      float w[4][COLS_PER_THREAD];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j)
          w[u][j] = live[j] ? to_f32(W[(size_t)(kk + u) * N + col[j]]) : 0.f;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 a =
            *reinterpret_cast<const float4*>(a_rows + (size_t)r * lda + kk);
#pragma unroll
        for (int j = 0; j < COLS_PER_THREAD; ++j) {
          float s = acc[r][j];
          s = fmaf(a.x, w[0][j], s);
          s = fmaf(a.y, w[1][j], s);
          s = fmaf(a.z, w[2][j], s);
          s = fmaf(a.w, w[3][j], s);
          acc[r][j] = s;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j)
        if (live[j]) epi(rg * RPT + r, col[j], acc[r][j]);
  }
}

// misc (fp32) = [o_b (d) | fc1_b (ff) | fc2_b (d) | ln2_g (d) | ln2_b (d)],
// the JAX kernel's pack (encoder_layer.py:345 pack_tail_misc).
template <typename T>
__global__ void __launch_bounds__(MLP_THREADS)
tail_mlp_kernel(const T* __restrict__ attn, const T* __restrict__ h_in,
                const T* __restrict__ wo, const T* __restrict__ fc1,
                const T* __restrict__ fc2, const float* __restrict__ misc,
                T* __restrict__ out, int rows, int d, int ff, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                  // [MLP_RM][d]: attention rows, then LN2(h2)
  float* H2 = X + MLP_RM * d;       // [MLP_RM][d]: residual after attention
  float* T1 = H2 + MLP_RM * d;      // [MLP_RM][ff]: GeLU intermediate
  const float* o_b = misc;
  const float* fc1_b = misc + d;
  const float* fc2_b = misc + d + ff;
  const float* ln_g = misc + 2 * d + ff;
  const float* ln_b = misc + 3 * d + ff;

  const int r0 = blockIdx.x * MLP_RM;
  const int live_rows = min(MLP_RM, rows - r0);
  const int tid = threadIdx.x;

  for (int i = tid; i < MLP_RM * d; i += MLP_THREADS) {
    const int r = i / d, c = i % d;
    X[i] = r < live_rows ? to_f32(attn[(size_t)(r0 + r) * d + c]) : 0.f;
  }
  __syncthreads();

  // h2 = rnd(h + rnd(rnd(a @ wo) + rnd(o_b)))
  block_gemm<T>(X, d, wo, d, d, [&](int r, int n, float acc) {
    const float hin = r < live_rows ? to_f32(h_in[(size_t)(r0 + r) * d + n]) : 0.f;
    H2[r * d + n] = rnd<T>(hin + rnd<T>(rnd<T>(acc) + rnd<T>(o_b[n])));
  });
  __syncthreads();

  // LN2 in fp32, one warp per row; y = rnd(LN(h2))
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < MLP_RM; r += MLP_THREADS / 32) {
    const float* x = H2 + r * d;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += x[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s / d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float dv = x[c] - mean;
      ss += dv * dv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / d + eps);
    for (int c = lane; c < d; c += 32)
      X[r * d + c] = rnd<T>((x[c] - mean) * inv * ln_g[c] + ln_b[c]);
  }
  __syncthreads();

  // t1 = rnd(gelu(rnd(rnd(y @ fc1) + rnd(fc1_b)))), GeLU with the exact erf
  block_gemm<T>(X, d, fc1, d, ff, [&](int r, int n, float acc) {
    const float t = rnd<T>(rnd<T>(acc) + rnd<T>(fc1_b[n]));
    T1[r * ff + n] = rnd<T>(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
  });
  __syncthreads();

  // out = h2 + rnd(rnd(t1 @ fc2) + rnd(fc2_b))
  block_gemm<T>(T1, ff, fc2, ff, d, [&](int r, int n, float acc) {
    if (r < live_rows)
      out[(size_t)(r0 + r) * d + n] =
          from_f32<T>(H2[r * d + n] + rnd<T>(rnd<T>(acc) + rnd<T>(fc2_b[n])));
  });
}

template <typename T>
cudaError_t launch_tail(const void* q, const void* k, const void* v,
                        const void* h_in, const void* wo, const void* fc1,
                        const void* fc2, const float* misc, void* attn,
                        void* out, int B, int T_len, int S, int H, int d,
                        int ff, float eps, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ATT_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((T_len + ATT_BQ - 1) / ATT_BQ, H, B);
  attention_kernel<T><<<grid, ATT_THREADS, ATT_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(attn), T_len, S, H,
      1.0f / sqrtf((float)HEAD_DIM));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  // the MLP working set of MLP_RM rows must fit the opt-in shared memory
  // (tiny: 16 * (2*384 + 1536) * 4 = 147 KB of 227 KB); wider models need
  // a smaller row tile, which no model of this slice runs
  int dev = 0, max_smem = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)MLP_RM * (2 * d + ff) * sizeof(float);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(tail_mlp_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int rows = B * T_len;
  tail_mlp_kernel<T><<<(rows + MLP_RM - 1) / MLP_RM, MLP_THREADS, smem,
                       stream>>>(
      static_cast<const T*>(attn), static_cast<const T*>(h_in),
      static_cast<const T*>(wo), static_cast<const T*>(fc1),
      static_cast<const T*>(fc2), misc, static_cast<T*>(out), rows, d, ff,
      eps);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 on success). Shapes:
// q (B,T,H,D), k/v (B,H,S,D), h_in/out (B,T,d), attn scratch (B,T,d),
// wo (d,d), fc1 (d,ff), fc2 (ff,d), all contiguous in one element type;
// misc fp32 (4d+ff). D must be 64 and d a multiple of 4.
extern "C" int wt_encoder_tail(const void* q, const void* k, const void* v,
                               const void* h_in, const void* wo,
                               const void* fc1, const void* fc2,
                               const void* misc, void* attn, void* out, int B,
                               int T_len, int S, int H, int D, int d, int ff,
                               float eps, int is_bf16, void* stream) {
  if (D != HEAD_DIM || d != H * D || d % 4 != 0 || ff % 4 != 0 || B < 1 ||
      T_len < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(misc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_tail<__nv_bfloat16>(q, k, v, h_in, wo, fc1, fc2, m,
                                                attn, out, B, T_len, S, H, d,
                                                ff, eps, s)
                   : launch_tail<float>(q, k, v, h_in, wo, fc1, fc2, m, attn,
                                        out, B, T_len, S, H, d, ff, eps, s));
}
