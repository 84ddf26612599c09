// The encoder-block tail's backward for Hopper (sm_90a), fp32.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, it
// differentiates its XLA graph (whisper_tpu/train.py:65
// jax.value_and_grad). The port's train path runs every encoder layer's
// tail through encoder_tail.cu, so its gradient is this file's passes,
// around six fp32 products and flash_attention_bwd.cu. The forward
// (ops/encoder_layer.py encoder_block_tail_plain, in fp32):
//
//   a   = attention(q, k, v)          (B, T, d), kept by the forward
//   h2  = h_in + (a Wo + bo)
//   y   = LN2(h2) = xhat g + b,  xhat = (h2 - mean) rstd
//   u   = y W1 + b1;   t1 = gelu_erf(u)
//   out = h2 + (t1 W2 + b2)
//
// and, with G the output's gradient, its backward:
//
//   dW2 = t1^T G;  db2 = sum G;  dt1 = G W2^T
//   du  = dt1 gelu'(u);  dW1 = y^T du;  db1 = sum du;  dy = du W1^T
//   dg  = sum dy xhat;  db = sum dy
//   dh2 = G + rstd (dy g - mean(dy g) - xhat mean(dy g xhat))
//   dWo = a^T dh2;  dbo = sum dh2;  da = dh2 Wo^T;  dh_in = dh2
//   dq, dk, dv = flash backward at (q, k, v, a, lse, da)
//
// The forward keeps only a and the rows' log-sum-exp (lse); the backward
// recomputes h2 and u with two products (a Wo, y W1) rather than keeping
// h2, y and t1 per layer (at turbo B=4, 32 layers: 10 GB). The eight
// products stay torch.matmul, fp32 with TF32 off under the train step's
// full_fp32: no TPU kernel computes them (XLA forms this gradient), and
// the port's own fp32 tiles (encoder_tail.cu) run at parity with cuBLAS
// at these widths. What is
// hand-written is every pass between the products, in three stages of
// the one entry point wt_encoder_tail_bwd:
//   0. ln_forward (after z = a Wo): h2 = h_in + (z + bo) in place of z, the
//      row's mean and rstd, y (a warp a row, the row in registers, the
//      forward's fixed-order sums);
//   1. gelu_backward (after u = y W1 and dt1 = G W2^T): t1 = gelu(u + b1)
//      in place of u, du = dt1 gelu'(u + b1) in place of dt1 (exact erf);
//   2. ln_backward (after dW2, dW1 and dy = du W1^T): xhat in place of y,
//      dh2 in place of h2 (a warp a row); then the five column sums
//      (dbo, db1, db2, dg, db) as per-chunk partials of CHUNKS fixed row
//      ranges, reduced in index order: no atomics, so a rerun is
//      bit-equal.
// The attention's gradient is flash_attention_bwd.cu's kernel on da,
// launched by the wrapper (ops/encoder_layer.py).
//
// What bounds it on the H100: operations, the products' and the
// attention's. A tiny B=16 fp32 layer (24,000 rows, d 384, ff 1536) is
// twice the forward's products (127 GFLOP) plus the attention backward's
// 2.5 times the forward's attention (138 GFLOP): 3.96 ms at the 67
// TFLOP/s fp32 peak. The attention runs as split TF32 on the tensor cores
// (flash_attention_bwd.cu, 495 / 3 = 165 TFLOP/s of fp32 products): with
// the products at 67 and the attention at 165 the layer's bound is 1.90 +
// 0.84 = 2.74 ms. The passes here read and write ~0.6 GB (0.18 ms at
// 3.35 TB/s); the two recomputed products add 35 GFLOP.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1280;              // a row: 5 x 8 values a lane
constexpr int LN_CHUNKS = MAX_D / 256;
constexpr int CHUNKS = 64;               // row ranges of the column sums
constexpr int JOBS = 5;                  // dbo, db1, db2, dg, db
constexpr int SUM_COLS = 128;            // columns a column-sum block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// The packed fp32 vectors, as the forward's misc: [bo | b1 | b2 | g | b]
struct Vecs {
  const float *bo, *b1, *b2, *g, *b;
  __device__ __host__ Vecs(const float* m, int d, int ff)
      : bo(m), b1(m + d), b2(m + d + ff), g(m + 2 * d + ff),
        b(m + 3 * d + ff) {}
};

// Stage 0: h2 = h_in + (z + bo) over z, mean and rstd, y = xhat g + b. A
// warp a row; lane l holds columns 256 c + 8 l .. + 7.
__global__ void __launch_bounds__(THREADS)
ln_forward(float* __restrict__ z, const float* __restrict__ h_in,
           const float* __restrict__ misc, float* __restrict__ y,
           float* __restrict__ mean_out, float* __restrict__ rstd_out,
           int rows, int d, int ff, float eps) {
  const Vecs vec(misc, d, ff);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const size_t row = (size_t)r * d;
  float x[LN_CHUNKS][8], sum = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[c][i] = 0.f;
    if (k >= d) continue;
    float zz[8], hh[8];
    load8(z + row + k, zz);
    load8(h_in + row + k, hh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[c][i] = hh[i] + (zz[i] + vec.bo[k + i]);
      sum += x[c][i];
    }
    store8(z + row + k, x[c]);
  }
  const float mean = warp_sum(sum) / d;
  float dev = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    if (256 * c + 8 * lane >= d) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) dev += (x[c][i] - mean) * (x[c][i] - mean);
  }
  const float rstd = rsqrtf(warp_sum(dev) / d + eps);
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
    if (k >= d) continue;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = (x[c][i] - mean) * rstd * vec.g[k + i] + vec.b[k + i];
    store8(y + row + k, o);
  }
  if (lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// Stage 1, elementwise over (rows, ff), 4 values a thread: t1 = gelu(u +
// b1) over u, du = dt1 gelu'(u + b1) over dt1, with gelu(x) = x Phi(x) and
// gelu'(x) = Phi(x) + x phi(x), Phi by erf.
__global__ void __launch_bounds__(THREADS)
gelu_backward(float* __restrict__ u, float* __restrict__ dt,
              const float* __restrict__ misc, long long n4, int d, int ff) {
  const Vecs vec(misc, d, ff);
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const int col = (int)((4 * i) % ff);
    const float4 uu = reinterpret_cast<const float4*>(u)[i];
    const float4 gg = reinterpret_cast<const float4*>(dt)[i];
    const float x[4] = {uu.x + vec.b1[col], uu.y + vec.b1[col + 1],
                        uu.z + vec.b1[col + 2], uu.w + vec.b1[col + 3]};
    const float g[4] = {gg.x, gg.y, gg.z, gg.w};
    float t[4], du[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float cdf = 0.5f * (1.f + erff(x[e] * 0.70710678118654752f));
      const float pdf = 0.39894228040143268f * expf(-0.5f * x[e] * x[e]);
      t[e] = x[e] * cdf;
      du[e] = g[e] * (cdf + x[e] * pdf);
    }
    reinterpret_cast<float4*>(u)[i] = make_float4(t[0], t[1], t[2], t[3]);
    reinterpret_cast<float4*>(dt)[i] = make_float4(du[0], du[1], du[2],
                                                    du[3]);
  }
}

// Stage 2: per row, xhat = (h2 - mean) rstd over y, and dh2 = G + rstd
// (dy g - mean(dy g) - xhat mean(dy g xhat)) over h2. A warp a row.
__global__ void __launch_bounds__(THREADS)
ln_backward(float* __restrict__ h2, float* __restrict__ y,
            const float* __restrict__ mean_in,
            const float* __restrict__ rstd_in, const float* __restrict__ dy,
            const float* __restrict__ gout, const float* __restrict__ misc,
            int rows, int d, int ff) {
  const Vecs vec(misc, d, ff);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const size_t row = (size_t)r * d;
  const float mean = mean_in[r], rstd = rstd_in[r];
  float xh[LN_CHUNKS][8], dx[LN_CHUNKS][8], s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
#pragma unroll
    for (int i = 0; i < 8; ++i) xh[c][i] = dx[c][i] = 0.f;
    if (k >= d) continue;
    float dd[8];
    load8(h2 + row + k, xh[c]);
    load8(dy + row + k, dd);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xh[c][i] = (xh[c][i] - mean) * rstd;
      dx[c][i] = dd[i] * vec.g[k + i];
      s1 += dx[c][i];
      s2 += dx[c][i] * xh[c][i];
    }
    store8(y + row + k, xh[c]);
  }
  const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = 256 * c + 8 * lane;
    if (k >= d) continue;
    float g[8];
    load8(gout + row + k, g);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      g[i] += rstd * (dx[c][i] - m1 - xh[c][i] * m2);
    store8(h2 + row + k, g);
  }
}

// The five column sums: sum over rows of a[r, n] (times b[r, n] where b is
// given), each of JOBS jobs into its place in `out` (the misc order).
struct Sums {
  const float* a[JOBS];
  const float* b[JOBS];
  int n[JOBS];
  int at[JOBS];
};

// Partial sums of CHUNKS fixed row ranges: one thread a column (a warp's
// loads are one 128-byte line a row), the chunk's rows in order.
__global__ void __launch_bounds__(SUM_COLS)
colsum_partial(const Sums s, float* __restrict__ partial, int rows,
               int n_max) {
  const int job = blockIdx.z, n = s.n[job];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  if (col >= n) return;
  const int per = (rows + CHUNKS - 1) / CHUNKS;
  const int r0 = blockIdx.y * per, r1 = min(rows, r0 + per);
  const float* a = s.a[job] + col;
  const float* b = s.b[job];
  float acc = 0.f;
  if (b == nullptr) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r) acc += a[(size_t)r * n];
  } else {
    b += col;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) acc += a[(size_t)r * n] * b[(size_t)r * n];
  }
  partial[((size_t)job * CHUNKS + blockIdx.y) * n_max + col] = acc;
}

__global__ void __launch_bounds__(SUM_COLS)
colsum_reduce(const Sums s, const float* __restrict__ partial,
              float* __restrict__ out, int n_max) {
  const int job = blockIdx.y;
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  if (col >= s.n[job]) return;
  float acc = 0.f;
  for (int c = 0; c < CHUNKS; ++c)
    acc += partial[((size_t)job * CHUNKS + c) * n_max + col];
  out[s.at[job] + col] = acc;
}

bool aligned16(void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (ptrs[i] == nullptr ||
        reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return false;
  return true;
}

}  // namespace

// Floats of the column sums' partials for width (d, ff).
extern "C" long long wt_encoder_tail_bwd_partials(int d, int ff) {
  return (long long)JOBS * CHUNKS * (d > ff ? d : ff);
}

// One stage of the tail's backward; returns cudaGetLastError() after its
// launches (0 on success). All buffers fp32, contiguous, 16-byte aligned;
// R = rows, misc the forward's packed [bo | b1 | b2 | g | b]:
//   stage 0: buf = {z (R, d) in, h2 out; h_in (R, d); misc; y (R, d) out;
//                   mean (R) out; rstd (R) out}
//   stage 1: buf = {u (R, ff) in, t1 out; dt1 (R, ff) in, du out; misc}
//   stage 2: buf = {h2 (R, d) in, dh2 out; y (R, d), xhat out; mean; rstd;
//                   dy (R, d); G (R, d); du (R, ff); misc;
//                   partials (wt_encoder_tail_bwd_partials floats);
//                   out (4 d + ff): [dbo | db1 | db2 | dg | db]}
// d is a multiple of 64 up to 1280, ff a positive multiple of 64.
extern "C" int wt_encoder_tail_bwd(int stage, void* const* buf, int rows,
                                   int d, int ff, float eps, void* stream) {
  static const int n_bufs[3] = {6, 3, 10};
  if (stage < 0 || stage > 2 || rows < 1 || d < 64 || d > MAX_D ||
      d % 64 != 0 || ff < 64 || ff % 64 != 0 ||
      !aligned16(buf, n_bufs[stage]))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + WARPS - 1) / WARPS;
  auto f = [&](int i) { return static_cast<float*>(buf[i]); };
  if (stage == 0) {
    ln_forward<<<row_blocks, THREADS, 0, s>>>(f(0), f(1), f(2), f(3), f(4),
                                              f(5), rows, d, ff, eps);
    return (int)cudaGetLastError();
  }
  if (stage == 1) {
    const long long n4 = (long long)rows * ff / 4;
    const long long want = (n4 + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    gelu_backward<<<blocks, THREADS, 0, s>>>(f(0), f(1), f(2), n4, d, ff);
    return (int)cudaGetLastError();
  }
  ln_backward<<<row_blocks, THREADS, 0, s>>>(f(0), f(1), f(2), f(3), f(4),
                                             f(5), f(7), rows, d, ff);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // dbo = sum dh2, db1 = sum du, db2 = sum G, dg = sum dy xhat, db = sum dy
  const Sums sums{{f(0), f(6), f(5), f(4), f(4)},
                  {nullptr, nullptr, nullptr, f(1), nullptr},
                  {d, ff, d, d, d},
                  {0, d, d + ff, 2 * d + ff, 3 * d + ff}};
  const int n_max = d > ff ? d : ff;
  colsum_partial<<<dim3((n_max + SUM_COLS - 1) / SUM_COLS, CHUNKS, JOBS),
                   SUM_COLS, 0, s>>>(sums, f(8), rows, n_max);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  colsum_reduce<<<dim3((n_max + SUM_COLS - 1) / SUM_COLS, JOBS), SUM_COLS, 0,
                  s>>>(sums, f(8), f(9), n_max);
  return (int)cudaGetLastError();
}
