// The encoder-block tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/encoder_layer.py:240
// encoder_block_tail (kernel body _tail_kernel, :57) at every Whisper
// width, d = 384 (tiny) to 1280 (large, turbo), in its unquantized form
// (fp32, bf16; entry point wt_encoder_tail) and its int8 form (mlp_q, o_q;
// bf16, wt_encoder_tail_q8):
//
//   a   = concat_h softmax(q_h k_h^T / sqrt(D)) v_h
//   h2  = rnd(h + rnd(rnd(a @ wo) + rnd(o_b)))
//   y   = rnd(LN2(h2))                        fp32 statistics
//   t1  = rnd(gelu_erf(rnd(rnd(y @ fc1) + rnd(fc1_b))))
//   out = h2 + rnd(rnd(t1 @ fc2) + rnd(fc2_b))
//
// with rnd the rounding to the compute dtype at the JAX kernel's storage
// points (_tail_kernel :88-92, :120, :136-148; the identity in fp32).
// Every A operand of the three products (a, y, t1) is rounded to the
// compute dtype already, so in bf16 the tensor cores' bf16 x bf16 products
// with fp32 accumulation are the JAX kernel's products; only the order of
// summation differs. The int8 form takes each product of the MLP, and of
// the o-projection under o_q, as qdot (:120-129): the activation rows
// quantized per row (s = max(max|x| / 127, 1e-10), round half to even,
// clip to +-127), an exact int32 product with the int8 weights, rescaled
// by (row scale x column scale) in fp32; the int32 sums equal JAX's
// whatever their order.
//
// What bounds it on the H100: operations. One layer is 4 B H T^2 D FLOP of
// attention and 2 B T (d^2 + 2 d ff) of o-projection and MLP: at tiny b32
// 0.241 ms at the 989 TFLOP/s bf16 peak, at turbo b32 1.80 ms; the int8
// form's products at the 1,979 TOPS int8 peak (tiny 0.176 ms, turbo
// 1.09); fp32, the parity mode (true fp32 FMAs, no TF32), at the 67
// TFLOP/s fp32 peak (turbo 26.6 ms).
//
// Design. The attention is the flash-attention kernel (flash_attention.cu,
// kv_len = S, no mask) into a (B, T, H*D) buffer in the compute dtype
// (exact: the JAX kernel rounds the heads there too). The rest cannot keep
// a block's rows whole from small's d = 768 up: 64 rows of fc2's fp32 sum
// are 192 / 256 / 320 KiB at d = 768 / 1024 / 1280 (the register file
// holds 256), the A tile alone 96 / 128 / 160 KiB in bf16; and the int8
// form's fc2 needs each row's max |t1| over all of ff before any of it is
// quantized. So the MLP is cut where the JAX kernel rounds t1 to the
// compute dtype (which makes storing t1 exact) and runs as tiles of 128
// rows x 128 output columns that stream both operands through shared
// memory, in four launches (six in the int8 form):
//   1. O_PROJ (a block per 128 rows x 128 d columns): h2 to `out`;
//   2. ln_kernel (a block per 128 rows, a warp a row, the row in
//      registers, fixed-order sums): y = rnd(LN2(h2)) to the workspace
//      (the int8 form: y quantized per row, its scale, and t1's row maxima
//      zeroed);
//   3. FC1 (a block per 128 rows x 128 ff columns): t1 to the workspace
//      (the int8 form: each row's max |t1| raised by one atomicMax a quad;
//      a maximum has no order);
//   4. (the int8 form) quant_rows: t1 quantized per row with that maximum;
//   5. FC2 (a block per 128 rows x 128 d columns): out = h2 + ..., h2 read
//      from `out` by the thread that wrote it; fc2's sum over ff stays one
//      accumulator, rounded once, as the JAX kernel's one dot.
// Under o_q the attention rows are quantized per row first (quant_rows).
// Every sum has a fixed order, so runs are bitwise repeatable. Consecutive
// blocks share their rows (blockIdx.x is the column tile), so a row
// block's A stays in L2 while its column tiles run.
//
// The products: bf16 is wgmma m64n128k16 (two warpgroups of 64 rows), A
// K-major and the weights MN-major (K-major bf16 for the int8 form's bf16
// o-projection), both in the 128-byte swizzle; the int8 form is wgmma
// m64n128k32 on s8, both operands K-major (the encoder hands it K-major
// int8 weights); a stage is 128 bytes of k of both operands (64 bf16 or
// 128 int8 values), three stages in a cp.async ring, 97 KB, two blocks an
// SM (128 registers a thread: the loads address the tile from one base
// that every thread shares). fp32 runs on the CUDA cores: each
// thread an 8 x 8 register tile, A rows and weight rows of 16 k a stage,
// three stages, 48 KB.
//
// What holds it above its bound: every tile re-reads its operands from
// L2 (64 FLOP a byte at 128 x 128 in bf16, 128 in int8), y and t1 go
// through device memory (at turbo b32 t1 is 0.49 GB each way in bf16),
// and the int8 form reads t1 once more to quantize it.

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

// csrc/flash_attention.cu
extern "C" int wt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int T_len,
                                  int S, int H, int D, int kv_len,
                                  int q_offset, int causal, long long sq_b,
                                  long long sq_t, long long sq_h,
                                  long long sk_b, long long sk_h,
                                  long long sk_s, long long sv_b,
                                  long long sv_h, long long sv_s,
                                  int is_bf16, void* stream);

namespace {

using bf16 = __nv_bfloat16;
using wt::ATOM_BYTES;
using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::smem_addr;
using wt::sw128_desc;

constexpr int HEAD_DIM = 64;             // every Whisper size has D = 64

constexpr int BM = 128;                  // rows a block
constexpr int BN = 128;                  // output columns a tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1280;              // LN2's row: 5 x 8 values a lane
constexpr int LN_CHUNKS = MAX_D / 256;
constexpr int TILE_BYTES = 128 * 128;    // 128 rows of 128 bytes of k
constexpr int BLOCK_BYTES = 64 * 128;    // MN-major: 64 k-rows x 64 bf16
constexpr int TC_STAGE = 2 * TILE_BYTES; // A, then B
constexpr int TC_STAGES = 3;
constexpr int KS = 16;                   // fp32: k a stage
constexpr int SIMT_STAGE = (BM * KS + KS * BN) * 4;
constexpr int SIMT_STAGES = 3;

size_t smem_bytes(bool tc) {
  return tc ? (size_t)TC_STAGES * TC_STAGE + ATOM_BYTES
            : (size_t)SIMT_STAGES * SIMT_STAGE;
}

__device__ __forceinline__ float gelu_erf(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

enum Epi { O_PROJ, FC1, FC2 };

// One launch's operands: A (rows x K, row-major), the weights (K, N)
// row-major (MN-major) or (N, K) (K-major), and what its epilogue reads
// and writes.
struct Args {
  const void* a;
  const void* w;
  const float* a_scale;   // int8 A: the rows' scales
  const float* w_scale;   // int8 weights: the columns' scales
  const float* bias;      // (N,)
  const void* h;          // O_PROJ: the block's residual input
  void* out;              // O_PROJ: h2; FC1: t1; FC2: h2 in, the output out
  const float* ln_g;      // O_PROJ: LN2's scale and shift
  const float* ln_b;
  void* y;                // O_PROJ: y, int8 in the int8 form
  float* y_scale;         // the int8 form: y's row scales
  unsigned* t_max;        // the int8 form: t1's row maxima (float bits)
  int rows, K, N;
  float eps;
};

// The forms: E the compute dtype, TC the tensor cores (else fp32 FMAs),
// INT8 int8 operands, KB K-major weights, A_BYTES an A element's bytes,
// BLOCKS the blocks an SM holds (two take 128 registers a thread).
struct F32 {
  using E = float;
  static constexpr bool TC = false, INT8 = false, KB = false;
  static constexpr int A_BYTES = 4, BLOCKS = 1;
};
struct BF16 {
  using E = bf16;
  static constexpr bool TC = true, INT8 = false, KB = false;
  static constexpr int A_BYTES = 2, BLOCKS = 2;
};
struct BF16_KB {   // the int8 form's bf16 o-projection (no o_q)
  using E = bf16;
  static constexpr bool TC = true, INT8 = false, KB = true;
  static constexpr int A_BYTES = 2, BLOCKS = 2;
};
struct I8 {
  using E = bf16;
  static constexpr bool TC = true, INT8 = true, KB = true;
  static constexpr int A_BYTES = 1, BLOCKS = 2;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// JAX's row quantization (qdot, _rowquant_dyn): s = max(max|x| / 127,
// 1e-10), each value clip(round(x / s), -127, 127), IEEE division and
// round half to even
__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(absmax / 127.f, 1e-10f);
}
__device__ __forceinline__ uint32_t quant(float x, float s) {
  return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(x / s), -127.f),
                                          127.f);
}
__device__ __forceinline__ uint2 quant8(const float (&x)[8], float s) {
  uint2 r;
  r.x = quant(x[0], s) | quant(x[1], s) << 8 | quant(x[2], s) << 16 |
        quant(x[3], s) << 24;
  r.y = quant(x[4], s) | quant(x[5], s) << 8 | quant(x[6], s) << 16 |
        quant(x[7], s) << 24;
  return r;
}

// eight consecutive values (16-byte aligned for bf16, 32 for fp32)
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float (&x)[8]) {
  uint4 r;
  r.x = wt::pack_bf16(x[0], x[1]);
  r.y = wt::pack_bf16(x[2], x[3]);
  r.z = wt::pack_bf16(x[4], x[5]);
  r.w = wt::pack_bf16(x[6], x[7]);
  *reinterpret_cast<uint4*>(p) = r;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
// two consecutive values (4-byte aligned for bf16, 8 for fp32)
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = wt::pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Bytes [kb, kb + 128) of the first n_rows rows (at most 128 are read)
// of a row-major matrix from `src`, the tile's first row (rows of `len`
// bytes), into a K-major tile in the 128-byte swizzle; rows and bytes past
// the matrix land as zeros. `src` is the same in every thread, so only
// the offsets within the tile (int: 128 rows of at most 20 KB) take a
// thread's registers.
__device__ __forceinline__ void load_rows(uint32_t dst, const uint8_t* src,
                                          int len, int n_rows, int kb,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < TILE_BYTES / 16 / THREADS; ++i) {
    const int id = tid + i * THREADS, r = id >> 3, c = id & 7;
    const bool live = r < n_rows && kb + 16 * c < len;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + (live ? r * len + kb + 16 * c : 0), live ? 16 : 0);
  }
}

// k-rows [k0, k0 + 64) x the first 128 columns (of n_cols) of a row-major
// bf16 matrix with row length N from `src`, the tile's first column, into
// two 64-column blocks of 64 k-rows, BLOCK_BYTES apart, in the 128-byte
// swizzle (the MN-major B operand): thread tid copies chunk tid % 8 of
// rows tid / 8 and tid / 8 + 32 of each block. k-rows past K and columns
// past n_cols land as zeros; offsets in int (a weight matrix holds fewer
// than 2^31 values).
__device__ __forceinline__ void load_w_mn(uint32_t dst, const bf16* src,
                                          int N, int K, int n_cols, int k0,
                                          int tid) {
  const int r = tid >> 3, c = tid & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r + 32 * (i & 1), blk = i >> 1;
    const bool live = k0 + rr < K && 64 * blk + 8 * c < n_cols;
    cp_async16(dst + blk * BLOCK_BYTES + rr * 128 + ((c ^ (rr & 7)) << 4),
               src + (live ? (k0 + rr) * N + 64 * blk + 8 * c : 0),
               live ? 16 : 0);
  }
}

// acc = A[rows row0.., all K] . W[all K, columns n0 .. n0 + 127] for this
// warpgroup's 64 rows, on the tensor cores: a stage is 128 bytes of k of
// both operands.
template <class F, typename Acc>
__device__ __forceinline__ void tc_tile(Acc (&acc)[64], const Args& p,
                                        int row0, int n0, uint32_t ring,
                                        int tid) {
  const int wg = tid >> 7;
  const int len = p.K * F::A_BYTES;      // bytes of k a row (A and K-major W)
  const int n_k = (len + 127) / 128;
  // the tile's first row of A, and of W (K-major) or its first column
  // (MN-major)
  const uint8_t* a_tile =
      static_cast<const uint8_t*>(p.a) + (size_t)row0 * len;
  const uint8_t* w_tile = static_cast<const uint8_t*>(p.w) +
                          (size_t)n0 * (F::KB ? len : 2);
  auto load = [&](int s, uint32_t dst) {
    load_rows(dst, a_tile, len, p.rows - row0, 128 * s, tid);
    if constexpr (F::KB)
      load_rows(dst + TILE_BYTES, w_tile, len, p.N - n0, 128 * s, tid);
    else
      load_w_mn(dst + TILE_BYTES, reinterpret_cast<const bf16*>(w_tile), p.N,
                p.K, p.N - n0, 64 * s, tid);
  };
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_k) load(s, ring + s * TC_STAGE);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    // stage i has landed; the barrier publishes it and frees stage i - 1's
    // buffer (every warpgroup waited for its products) for stage i + 2
    cp_async_wait<TC_STAGES - 2>();
    wt::fence_proxy_async();
    __syncthreads();
    const int ahead = i + TC_STAGES - 1;
    if (ahead < n_k) load(ahead, ring + (ahead % TC_STAGES) * TC_STAGE);
    cp_async_commit();
    const uint32_t a = ring + (i % TC_STAGES) * TC_STAGE + wg * (TILE_BYTES / 2);
    const uint32_t b = ring + (i % TC_STAGES) * TC_STAGE + TILE_BYTES;
    wt::fence_regs(acc);
    wt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int accumulate = i > 0 || j > 0;
      if constexpr (F::INT8)
        wt::wgmma_m64n128k32_s8_ss(acc, sw128_desc(a + 32 * j, 0),
                                   sw128_desc(b + 32 * j, 0), accumulate);
      else if constexpr (F::KB)
        wt::wgmma_m64n128k16_ss<0>(acc, sw128_desc(a + 32 * j, 0),
                                   sw128_desc(b + 32 * j, 0), accumulate);
      else
        wt::wgmma_m64n128k16_ss<1>(
            acc, sw128_desc(a + 32 * j, 0),
            sw128_desc(b + 2 * ATOM_BYTES * j, BLOCK_BYTES), accumulate);
    }
    wt::wgmma_commit();
    wt::wgmma_wait();
    wt::fence_regs(acc);
  }
  cp_async_wait<0>();     // the trailing groups are empty
}

// acc[i][j] = A[row 8 tr + i] . W[column 4 tc + j (j < 4), 64 + 4 tc + j -
// 4 (j >= 4)] on the CUDA cores, tr = tid / 16, tc = tid % 16: a stage is
// 16 k of A (rows of 16 floats) and of W (16 rows of 128 columns); per k
// four float4 reads feed 64 FMAs (A's reads are broadcasts within a
// quarter warp).
__device__ __forceinline__ void simt_tile(float (&acc)[8][8], const Args& p,
                                          int row0, int n0, float* ring,
                                          int tid) {
  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);
  const int n_k = (p.K + KS - 1) / KS;
  const int tr = tid >> 4, tc = tid & 15;
  constexpr int STAGE = SIMT_STAGE / 4;
  auto load = [&](int s, float* dst) {
    const int k0 = s * KS;
#pragma unroll
    for (int i = 0; i < BM * KS / 4 / THREADS; ++i) {
      const int id = tid + i * THREADS, r = id >> 2, c = id & 3;
      const bool live = row0 + r < p.rows && k0 + 4 * c < p.K;
      cp_async16(smem_addr(dst + r * KS + 4 * c),
                 A + (live ? (size_t)(row0 + r) * p.K + k0 + 4 * c : 0),
                 live ? 16 : 0);
    }
    float* wd = dst + BM * KS;
#pragma unroll
    for (int i = 0; i < KS * BN / 4 / THREADS; ++i) {
      const int id = tid + i * THREADS, r = id >> 5, c = id & 31;
      const bool live = k0 + r < p.K && n0 + 4 * c < p.N;
      cp_async16(smem_addr(wd + r * BN + 4 * c),
                 W + (live ? (size_t)(k0 + r) * p.N + n0 + 4 * c : 0),
                 live ? 16 : 0);
    }
  };
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int s = 0; s < SIMT_STAGES - 1; ++s) {
    if (s < n_k) load(s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<SIMT_STAGES - 2>();
    __syncthreads();
    const int ahead = i + SIMT_STAGES - 1;
    if (ahead < n_k) load(ahead, ring + (ahead % SIMT_STAGES) * STAGE);
    cp_async_commit();
    const float* a = ring + (i % SIMT_STAGES) * STAGE + 8 * tr * KS;
    const float* w = ring + (i % SIMT_STAGES) * STAGE + BM * KS + 4 * tc;
#pragma unroll
    for (int k4 = 0; k4 < KS / 4; ++k4) {
      float av[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(a + r * KS + 4 * k4);
        av[r][0] = x.x; av[r][1] = x.y; av[r][2] = x.z; av[r][3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w0 =
            *reinterpret_cast<const float4*>(w + (4 * k4 + q) * BN);
        const float4 w1 =
            *reinterpret_cast<const float4*>(w + (4 * k4 + q) * BN + 64);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[r][j] = fmaf(av[r][q], wv[j], acc[r][j]);
      }
    }
  }
  cp_async_wait<0>();
}

// LN2: y = rnd(LN2(h2)) for blockIdx.x's 128 rows, a warp a row, h2 read
// from `out`: the row in registers (lane l holds columns 256 c + 8 l ..),
// its mean, then the mean of squared deviations, each summed in a fixed
// order. The int8 form quantizes y per row, keeps the scale and zeroes
// t1's row maximum. The arguments are O_PROJ's.
template <typename E, bool Q8>
__global__ void __launch_bounds__(THREADS) ln_kernel(const Args p) {
  const int tid = threadIdx.x, row0 = blockIdx.x * BM;
  const int warp = tid >> 5, lane = tid & 31, d = p.N;
  const E* h2 = static_cast<const E*>(p.out);
  for (int r = warp; r < BM && row0 + r < p.rows; r += WARPS) {
    const size_t row = row0 + r;
    float x[LN_CHUNKS][8], sum = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int k = 256 * c + 8 * lane;
      if (k < d) {
        load8(h2 + row * d + k, x[c]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[c][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += x[c][i];
    }
    const float mean = warp_sum(sum) / d;
    float dev = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      if (256 * c + 8 * lane >= d) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) dev += (x[c][i] - mean) * (x[c][i] - mean);
    }
    const float inv = rsqrtf(warp_sum(dev) / d + p.eps);
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int k = 256 * c + 8 * lane;
      if (k >= d) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[c][i] = wt::rnd<E>((x[c][i] - mean) * inv * p.ln_g[k + i] +
                             p.ln_b[k + i]);
        m = fmaxf(m, fabsf(x[c][i]));
      }
    }
    if constexpr (Q8) {
      const float s = scale_of(warp_max(m));
#pragma unroll
      for (int c = 0; c < LN_CHUNKS; ++c) {
        const int k = 256 * c + 8 * lane;
        if (k < d)
          *reinterpret_cast<uint2*>(static_cast<uint8_t*>(p.y) + row * d +
                                    k) = quant8(x[c], s);
      }
      if (lane == 0) {
        p.y_scale[row] = s;
        p.t_max[row] = 0u;
      }
    } else {
#pragma unroll
      for (int c = 0; c < LN_CHUNKS; ++c) {
        const int k = 256 * c + 8 * lane;
        if (k < d) store8(static_cast<E*>(p.y) + row * d + k, x[c]);
      }
    }
  }
}

// One launch of the tail's MLP: the 128 rows of blockIdx.y by the 128
// columns of blockIdx.x (consecutive blocks share the rows, so a block
// row's A stays in L2 while its column tiles run), then the epilogue.
template <class F, int EPI>
__global__ void __launch_bounds__(THREADS, F::BLOCKS)
tile_kernel(const Args p) {
  using E = typename F::E;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const E* h = static_cast<const E*>(p.h);
  E* out = static_cast<E*>(p.out);

  // the epilogue of columns n0 + c, n0 + c + 1 of local row r; returns the
  // larger |t1| written (FC1)
  auto epi = [&](int r, int c, float v0, float v1) -> float {
    const int row = row0 + r, n = n0 + c;
    if (row >= p.rows || n >= p.N) return 0.f;
    const size_t at = (size_t)row * p.N + n;
    float v[2] = {v0, v1};
    if constexpr (F::INT8) {
      const float sr = p.a_scale[row];
      v[0] *= sr * p.w_scale[n];
      v[1] *= sr * p.w_scale[n + 1];
    }
    float b[2] = {wt::rnd<E>(p.bias[n]), wt::rnd<E>(p.bias[n + 1])};
    if constexpr (EPI == O_PROJ) {
      const float2 hv = load2(h + at);
      v[0] = wt::rnd<E>(hv.x + wt::rnd<E>(wt::rnd<E>(v[0]) + b[0]));
      v[1] = wt::rnd<E>(hv.y + wt::rnd<E>(wt::rnd<E>(v[1]) + b[1]));
    } else if constexpr (EPI == FC1) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = wt::rnd<E>(gelu_erf(wt::rnd<E>(wt::rnd<E>(v[e]) + b[e])));
    } else {
      const float2 hv = load2(out + at);
      v[0] = hv.x + wt::rnd<E>(wt::rnd<E>(v[0]) + b[0]);
      v[1] = hv.y + wt::rnd<E>(wt::rnd<E>(v[1]) + b[1]);
    }
    store2(out + at, v[0], v[1]);
    // FC1: one pair's GeLU at a time (its temporaries beside the 64
    // accumulators would spill if the compiler interleaved pairs)
    if constexpr (EPI == FC1) asm volatile("" ::: "memory");
    return fmaxf(fabsf(v[0]), fabsf(v[1]));
  };
  if constexpr (F::TC) {
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t ring =
        (raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);
    using Acc = std::conditional_t<F::INT8, int, float>;
    Acc acc[64];
    tc_tile<F>(acc, p, row0, n0, ring, tid);
    // element (c, e) of the m64n128 accumulator: row 16 w + g (+ 8 for
    // e >= 2) of the warpgroup's 64, column 8 c + 2 t4 + (e & 1)
    const int lane = tid & 31, t4 = lane & 3;
    const int ra = 64 * (tid >> 7) + 16 * ((tid & 127) >> 5) + (lane >> 2);
    float ma = 0.f, mb = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = 8 * c + 2 * t4;
      ma = fmaxf(ma, epi(ra, col, (float)acc[4 * c], (float)acc[4 * c + 1]));
      mb = fmaxf(mb, epi(ra + 8, col, (float)acc[4 * c + 2],
                         (float)acc[4 * c + 3]));
    }
    if constexpr (EPI == FC1 && F::INT8) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      }
      if (t4 == 0 && row0 + ra < p.rows)
        atomicMax(&p.t_max[row0 + ra], __float_as_uint(ma));
      if (t4 == 0 && row0 + ra + 8 < p.rows)
        atomicMax(&p.t_max[row0 + ra + 8], __float_as_uint(mb));
    }
  } else {
    float acc[8][8];
    simt_tile(acc, p, row0, n0, reinterpret_cast<float*>(smem_raw), tid);
    const int tr = tid >> 4, tc = tid & 15;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        epi(8 * tr + r, 64 * (j >> 2) + 4 * tc + (j & 3), acc[r][j],
            acc[r][j + 1]);
  }
}

// Row quantization of bf16 rows (rows x K) into int8 rows and scales, a
// warp a row: with the row maxima given (t1's, from FC1), or from a first
// pass over the row (the attention rows under o_q).
__global__ void __launch_bounds__(THREADS)
quant_rows(const bf16* __restrict__ src, const unsigned* __restrict__ given,
           uint8_t* __restrict__ dst, float* __restrict__ scale, int rows,
           int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const bf16* row = src + (size_t)r * K;
  float m = 0.f;
  if (given != nullptr) {
    m = __uint_as_float(given[r]);
  } else {
    for (int k = 8 * lane; k < K; k += 256) {
      float x[8];
      load8(row + k, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(x[i]));
    }
    m = warp_max(m);
  }
  const float s = scale_of(m);
  for (int k = 8 * lane; k < K; k += 256) {
    float x[8];
    load8(row + k, x);
    *reinterpret_cast<uint2*>(dst + (size_t)r * K + k) = quant8(x, s);
  }
  if (lane == 0) scale[r] = s;
}

// The workspace's pieces, 256-byte aligned: y and t1 (unquantized: in the
// compute dtype; the int8 form: y int8, t1 bf16, and the int8 attention
// rows and t1, three row-scale vectors and t1's row maxima). With base
// null, only the size.
struct Work {
  uint8_t *y, *t1, *aq, *t1q;
  float *sa, *sy, *st;
  unsigned* tmax;
};
size_t carve(uint8_t* base, int rows, int d, int ff, int elem, bool q8,
             Work* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    uint8_t* at = base != nullptr ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return at;
  };
  const size_t R = rows;
  w->y = take(R * d * (q8 ? 1 : elem));
  w->t1 = take(R * ff * (q8 ? 2 : elem));
  w->aq = w->t1q = nullptr;
  w->sa = w->sy = w->st = nullptr;
  w->tmax = nullptr;
  if (q8) {
    w->aq = take(R * d);
    w->t1q = take(R * ff);
    w->sa = reinterpret_cast<float*>(take(R * 4));
    w->sy = reinterpret_cast<float*>(take(R * 4));
    w->st = reinterpret_cast<float*>(take(R * 4));
    w->tmax = reinterpret_cast<unsigned*>(take(R * 4));
  }
  return off;
}

template <class F, int EPI>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(F::TC);
  cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<F, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + BN - 1) / BN, (a.rows + BM - 1) / BM);
  tile_kernel<F, EPI><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// O_PROJ, then LN2 on the rows it wrote (the same arguments)
template <class F, bool Q8>
cudaError_t run_o_proj(const Args& a, cudaStream_t stream) {
  cudaError_t e = run<F, O_PROJ>(a, stream);
  if (e != cudaSuccess) return e;
  ln_kernel<typename F::E, Q8>
      <<<(a.rows + BM - 1) / BM, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// The unquantized MLP after the attention launch (F32 or BF16).
template <class F>
cudaError_t mlp(const void* attn, const void* h_in, const void* wo,
                const void* fc1, const void* fc2, const float* misc,
                void* out, void* work, int rows, int d, int ff, float eps,
                cudaStream_t s) {
  Work w;
  carve(static_cast<uint8_t*>(work), rows, d, ff, sizeof(typename F::E),
        false, &w);
  const float *o_b = misc, *fc1_b = misc + d, *fc2_b = misc + d + ff;
  const float *ln_g = misc + 2 * d + ff, *ln_b = misc + 3 * d + ff;
  cudaError_t e = run_o_proj<F, false>(
      {attn, wo, nullptr, nullptr, o_b, h_in, out, ln_g, ln_b, w.y, nullptr,
       nullptr, rows, d, d, eps}, s);
  if (e != cudaSuccess) return e;
  e = run<F, FC1>({w.y, fc1, nullptr, nullptr, fc1_b, nullptr, w.t1,
                   nullptr, nullptr, nullptr, nullptr, nullptr, rows, d, ff,
                   eps}, s);
  if (e != cudaSuccess) return e;
  return run<F, FC2>({w.t1, fc2, nullptr, nullptr, fc2_b, nullptr, out,
                      nullptr, nullptr, nullptr, nullptr, nullptr, rows, ff,
                      d, eps}, s);
}

// The int8 form's MLP after the attention launch: misc is [o_b | fc1_b |
// fc2_b | ln2_g | ln2_b | fc1_s | fc2_s (| wo_s)].
cudaError_t mlp_q8(const void* attn, const void* h_in, const void* wo,
                   const void* fc1, const void* fc2, const float* misc,
                   void* out, void* work, int rows, int d, int ff, float eps,
                   bool o_q, cudaStream_t s) {
  Work w;
  carve(static_cast<uint8_t*>(work), rows, d, ff, 2, true, &w);
  const float *o_b = misc, *fc1_b = misc + d, *fc2_b = misc + d + ff;
  const float *ln_g = misc + 2 * d + ff, *ln_b = misc + 3 * d + ff;
  const float *fc1_s = misc + 4 * d + ff, *fc2_s = fc1_s + ff;
  const float* wo_s = fc2_s + d;
  const int row_blocks = (rows + WARPS - 1) / WARPS;
  cudaError_t e;
  if (o_q) {
    quant_rows<<<row_blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(attn), nullptr, w.aq, w.sa, rows, d);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = run_o_proj<I8, true>({w.aq, wo, w.sa, wo_s, o_b, h_in, out, ln_g,
                              ln_b, w.y, w.sy, w.tmax, rows, d, d, eps}, s);
  } else {
    e = run_o_proj<BF16_KB, true>({attn, wo, nullptr, nullptr, o_b, h_in,
                                   out, ln_g, ln_b, w.y, w.sy, w.tmax, rows,
                                   d, d, eps}, s);
  }
  if (e != cudaSuccess) return e;
  e = run<I8, FC1>({w.y, fc1, w.sy, fc1_s, fc1_b, nullptr, w.t1, nullptr,
                    nullptr, nullptr, nullptr, w.tmax, rows, d, ff, eps}, s);
  if (e != cudaSuccess) return e;
  quant_rows<<<row_blocks, THREADS, 0, s>>>(
      reinterpret_cast<const bf16*>(w.t1), w.tmax, w.t1q, w.st, rows, ff);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return run<I8, FC2>({w.t1q, fc2, w.st, fc2_s, fc2_b, nullptr, out,
                       nullptr, nullptr, nullptr, nullptr, nullptr, rows, ff,
                       d, eps}, s);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// the shared memory a form's tiles take against the block's opt-in limit
cudaError_t fits_smem(bool tc) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  return smem_bytes(tc) > (size_t)max_smem ? cudaErrorInvalidValue
                                           : cudaSuccess;
}

// The attention launch: flash over the whole key range into the (B, T,
// H*D) scratch, from contiguous q (B,T,H,D) and k/v (B,H,S,D); lse, when
// not null (fp32 under autograd), receives the rows' log-sum-exp.
cudaError_t attention(const void* q, const void* k, const void* v,
                      void* attn, void* lse, int B, int T_len, int S, int H,
                      int is_bf16, cudaStream_t stream) {
  const long long D = HEAD_DIM;
  return (cudaError_t)wt_flash_attention(
      q, k, v, attn, lse, B, T_len, S, H, HEAD_DIM, S, 0, 0, T_len * H * D,
      H * D, D, H * S * D, S * D, D, H * S * D, S * D, D, is_bf16, stream);
}

bool takes(int D, int d, int H, int ff, int B, int T_len, int S) {
  return D == HEAD_DIM && d == H * D && d <= MAX_D && ff % 64 == 0 &&
         ff >= 64 && B >= 1 && T_len >= 1 && S >= 1;
}

}  // namespace

// Shared memory of the tail's MLP launches (bytes) in the unquantized
// form (int8_form = 0: the larger of the bf16 and fp32 rings) or the int8
// form, for ops/encoder_layer.py's gate to be checked against. The tiles
// hold no row whole, so neither d nor ff enters.
extern "C" long long wt_encoder_tail_smem(int d, int ff, int int8_form) {
  (void)d;
  (void)ff;
  return (long long)(int8_form ? smem_bytes(true)
                               : std::max(smem_bytes(true),
                                          smem_bytes(false)));
}

// Bytes of the workspace for `rows` rows of width (d, ff): y and t1 in
// elem-byte values, or the int8 form's y, t1 and int8 rows and scales.
extern "C" long long wt_encoder_tail_workspace(int rows, int d, int ff,
                                               int elem, int int8_form) {
  Work w;
  return (long long)carve(nullptr, rows, d, ff, elem, int8_form != 0, &w);
}

// Returns cudaGetLastError() after the launches (0 on success). Shapes:
// q (B,T,H,D), k/v (B,H,S,D), h_in/out (B,T,d), attn scratch (B,T,d),
// wo (d,d), fc1 (d,ff), fc2 (ff,d), all contiguous and 16-byte aligned in
// one element type; misc fp32 [o_b | fc1_b | fc2_b | ln2_g | ln2_b]; work:
// wt_encoder_tail_workspace's bytes, 16-byte aligned. D must be 64, d =
// 64 H <= 1280, ff a multiple of 64. lse: null, or (fp32, under autograd)
// a (B, H, T) fp32 buffer for the attention rows' log-sum-exp, which the
// backward (encoder_tail_bwd.cu) reads with the attention rows `attn`.
extern "C" int wt_encoder_tail(const void* q, const void* k, const void* v,
                               const void* h_in, const void* wo,
                               const void* fc1, const void* fc2,
                               const void* misc, void* attn, void* lse,
                               void* work, void* out, int B, int T_len,
                               int S, int H, int D, int d, int ff, float eps,
                               int is_bf16, void* stream) {
  if (!takes(D, d, H, ff, B, T_len, S) ||
      !aligned16({q, k, v, h_in, wo, fc1, fc2, attn, work, out}))
    return (int)cudaErrorInvalidValue;
  // checked before anything is launched, so a refused call launches
  // nothing
  cudaError_t e = fits_smem(is_bf16 != 0);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = attention(q, k, v, attn, lse, B, T_len, S, H, is_bf16, s);
  if (e != cudaSuccess) return (int)e;
  const float* m = static_cast<const float*>(misc);
  const int rows = B * T_len;
  return (int)(is_bf16 ? mlp<BF16>(attn, h_in, wo, fc1, fc2, m, out, work,
                                   rows, d, ff, eps, s)
                       : mlp<F32>(attn, h_in, wo, fc1, fc2, m, out, work,
                                  rows, d, ff, eps, s));
}

// The int8 form (bf16 only). Returns cudaGetLastError() after the launches
// (0 on success). Shapes: q (B,T,H,D), k/v (B,H,S,D), h_in/out (B,T,d),
// attn scratch (B,T,d), all bf16; wo (d, d) K-major, int8 under o_q, else
// bf16; fc1 (ff, d) and fc2 (d, ff) int8, K-major; all contiguous and
// 16-byte aligned; misc fp32 [o_b | fc1_b | fc2_b | ln2_g | ln2_b | fc1_s
// | fc2_s (| wo_s)]; work: wt_encoder_tail_workspace's bytes. D must be
// 64, d = 64 H <= 1280, ff a multiple of 64.
extern "C" int wt_encoder_tail_q8(const void* q, const void* k, const void* v,
                                  const void* h_in, const void* wo,
                                  const void* fc1, const void* fc2,
                                  const void* misc, void* attn, void* work,
                                  void* out, int B, int T_len, int S, int H,
                                  int D, int d, int ff, float eps, int o_q,
                                  void* stream) {
  if (!takes(D, d, H, ff, B, T_len, S) ||
      !aligned16({q, k, v, h_in, wo, fc1, fc2, attn, work, out}))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = fits_smem(true);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = attention(q, k, v, attn, nullptr, B, T_len, S, H, 1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)mlp_q8(attn, h_in, wo, fc1, fc2,
                     static_cast<const float*>(misc), out, work, B * T_len,
                     d, ff, eps, o_q != 0, s);
}
