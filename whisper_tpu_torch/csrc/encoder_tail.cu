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
//   1. the flash-attention kernel (flash_attention.cu) with kv_len = S and
//      no causal mask: one block per (64-query tile, head, batch row), K/V
//      streamed through shared memory with an online softmax, so the
//      (T, S) score matrix never exists; the head's output lands in a
//      (B, T, H*D) buffer in the compute dtype (exact: the JAX kernel
//      rounds it there too).
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

// csrc/flash_attention.cu
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int T_len, int S, int H,
                                  int D, int kv_len, int q_offset, int causal,
                                  long long sq_b, long long sq_t,
                                  long long sq_h, long long sk_b,
                                  long long sk_h, long long sk_s,
                                  long long sv_b, long long sv_h,
                                  long long sv_s, int is_bf16, void* stream);

namespace {

constexpr int HEAD_DIM = 64;            // every Whisper size has D = 64

using wt::from_f32;
using wt::rnd;
using wt::to_f32;

// ---------------------------------------------------------------------------
// o-projection + residual + LN2 + MLP + residual
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
  // the MLP working set of MLP_RM rows must fit the opt-in shared memory
  // (tiny: 16 * (2*384 + 1536) * 4 = 147 KB of 227 KB; from small up it
  // does not, and the encoder takes its tail-off branch): checked before
  // anything is launched, so a refused shape launches nothing.
  // ops/encoder_layer.py:tail_smem_bytes is the same formula.
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)MLP_RM * (2 * d + ff) * sizeof(float);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;

  // 1. attention into the (B, T, H*D) scratch: contiguous q and k/v
  const long long D = HEAD_DIM;
  e = (cudaError_t)wt_flash_attention(
      q, k, v, attn, B, T_len, S, H, HEAD_DIM, S, 0, 0, T_len * H * D, H * D,
      D, H * S * D, S * D, D, H * S * D, S * D, D,
      sizeof(T) == 2, stream);
  if (e != cudaSuccess) return e;

  // 2. o-projection + LN2 + MLP
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
