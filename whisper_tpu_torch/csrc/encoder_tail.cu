// Fused encoder-block tail for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/encoder_layer.py:240
// encoder_block_tail (kernel body _tail_kernel, :57). Its int8 form (mlp_q,
// o_q) is the q8 namespace below, with its own note and entry point
// (wt_encoder_tail_q8); the unquantized variant:
//
//   a   = concat_h softmax(q_h k_h^T / sqrt(D)) v_h        (pad keys masked)
//   h2  = h_in + (a @ wo + o_b)
//   out = h2 + fc2(gelu_erf(fc1(LayerNorm2(h2))))
//
// with the bf16 rounding of the XLA block at the same storage points
// (_tail_kernel :88-92, :120, :136-148):
//   h2  = rnd(h + rnd(rnd(a @ wo) + rnd(o_b)))
//   y   = rnd(LN2(h2))                        fp32 statistics
//   t1  = rnd(gelu_erf(rnd(rnd(y @ fc1) + rnd(fc1_b))))
//   out = h2 + rnd(rnd(t1 @ fc2) + rnd(fc2_b))
// Every A operand of the three products (a, y, t1) is rounded to the
// compute dtype already, so in bf16 the tensor cores' bf16 x bf16 products
// with fp32 accumulation are the JAX kernel's products; only the order of
// summation differs.
//
// What bounds it on the H100: operations. At Whisper-tiny b32 one layer is
// 1.11e11 FLOP of attention and 1.27e11 FLOP of o-projection and MLP
// (2 B T (d^2 + 2 d ff)) against ~0.2 GB of activations: 0.241 ms at the
// 989 TFLOP/s bf16 peak. In fp32 (the parity mode, true fp32 FMAs: no TF32)
// the MLP alone is 1.9 ms at the 67 TFLOP/s fp32 peak.
//
// Design. Two launches, one C entry point:
//   1. the flash-attention kernel (flash_attention.cu) with kv_len = S and
//      no causal mask; the head outputs land in a (B, T, H*D) buffer in the
//      compute dtype (exact: the JAX kernel rounds them there too).
//   2. mlp_kernel: one block per BM = 64 rows of the flattened (B*T, d)
//      stream, one warpgroup (128 threads) per 128 output columns of d
//      (d = 384: 3 warpgroups; 512: 4). The block streams the weights
//      through a shared-memory ring of cp.async copies (16 bytes a thread;
//      bf16 three stages up to 3 warpgroups, else two; fp32 two; the next
//      stages in flight while this one is computed, one barrier a stage)
//      in one fixed order: the o-projection's row slices,
//      then per ff chunk of 64 columns a warpgroup, fc1's row slices and
//      the chunk's fc2 rows. Neither h2's LayerNorm input nor the (rows,
//      ff) GeLU intermediate goes to device memory:
//        - o-projection: a warpgroup's 64 x 128 accumulator; the epilogue
//          adds the bias and the residual, writes h2 to `out` (exact in
//          the compute dtype, read back by the same thread at the end),
//          reduces LN2's row statistics across the warpgroups through
//          shared memory (two passes, fixed order), and writes y over the
//          attention rows;
//        - per ff chunk: fc1 into a 64 x 64 accumulator per warpgroup, its
//          bias, exact-erf GeLU and rounding in registers, landing as the
//          chunk's t1 in shared memory; then fc2 accumulates t1_chunk @
//          fc2[chunk rows] into the o-projection's registers, so its sum
//          over ff is rounded once, as the JAX kernel's one dot is;
//        - the last epilogue adds fc2's bias and h2.
//      bf16: the products are wgmma (m64n128k16 for the o-projection and
//      fc2, m64n64k16 for fc1) with both operands in shared memory: the A
//      tiles (attention rows, y, t1) K-major and the weight tiles MN-major
//      (W is (K, N) row-major, as flash's V tile), all in the 128-byte
//      swizzle, 64 k-rows a stage. The block re-reads every weight from L2
//      (2.7 MB at tiny): at 64 rows a block that is ~64 FLOP a byte, so L2,
//      not the tensor cores, sets its pace (the third stage moved it by
//      less than the spread between runs: chip_smoke.py tail_time).
//      fp32: the same tiles and stage order on the CUDA cores. The
//      attention rows, y and t1 are held transposed (column k is 64
//      contiguous rows), weight stages are 8 k-rows, and each thread owns a
//      register micro-tile of 8 rows x 8 columns (o-projection, fc2: per k,
//      two 128-bit reads of A and two of W feed 64 FMAs) or 4 x 4 of the
//      32 fc1 columns a warpgroup takes of a chunk (one read each, 16
//      FMAs), which keeps the 4-warpgroup launch within its 128 registers.
// Shared memory: tail_smem_bytes() below, the larger of the two kernels'
// needs (ops/encoder_layer.py tail_smem_bytes is the same formula). It
// fits the 227 KB a block may opt into for d <= 512 (tiny 217 KB with a
// three-stage bf16 ring, base 225 KB with two); from d = 576 up it does
// not, and at most MAX_WG warpgroups are launched: there the encoder takes
// its tail-off branch.

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

constexpr int HEAD_DIM = 64;      // every Whisper size has D = 64
constexpr int BM = 64;            // rows of the (B*T, d) stream a block
constexpr int WG_COLS = 128;      // o-projection / fc2 columns a warpgroup
constexpr int WG_FF = 64;         // fc1 columns of an ff chunk a warpgroup
constexpr int MAX_WG = 4;         // d <= 512

using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::smem_addr;

int n_wg(int d) { return (d + WG_COLS - 1) / WG_COLS; }

__device__ __forceinline__ float gelu_erf(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return wt::rnd<__nv_bfloat16>(x);
}

// The stage order both kernels stream the weights in: the o-projection's
// n_o row slices, then per ff chunk fc1's n_f1 row slices and the chunk's
// n_f2 fc2 row slices.
struct Plan {
  int n_o, n_f1, n_f2, n_chunks;
  __device__ int total() const { return n_o + n_chunks * (n_f1 + n_f2); }
};
enum Kind { O_PROJ, FC1, FC2 };
struct Stage {
  int kind, chunk, s;
};
__device__ __forceinline__ Stage stage_of(int i, const Plan& p) {
  if (i < p.n_o) return {O_PROJ, 0, i};
  const int j = i - p.n_o, per = p.n_f1 + p.n_f2;
  const int c = j / per, s = j % per;
  return s < p.n_f1 ? Stage{FC1, c, s} : Stage{FC2, c, s - p.n_f1};
}

// misc (fp32) = [o_b (d) | fc1_b (ff) | fc2_b (d) | ln2_g (d) | ln2_b (d)],
// the JAX kernel's pack (encoder_layer.py:345 pack_tail_misc).
struct Vecs {
  const float *o_b, *fc1_b, *fc2_b, *ln_g, *ln_b;
  __device__ Vecs(const float* m, int d, int ff)
      : o_b(m), fc1_b(m + d), fc2_b(m + d + ff), ln_g(m + 2 * d + ff),
        ln_b(m + 3 * d + ff) {}
};

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using wt::ATOM_BYTES;
using wt::fence_regs;
using wt::pack_bf16;
using wt::sw128_desc;
using wt::sw128_offset;

constexpr int KS = 64;                       // k-rows of a weight stage
constexpr int SLICE_BYTES = 64 * 128;        // 64 rows x 64 bf16, swizzled
constexpr int WG_STAGE_BYTES = KS * WG_COLS * 2;   // a warpgroup's 16 KB

// weight stages in the ring: three where they fit beside the A tile (up
// to three warpgroups, d <= 384), else two
__host__ __device__ constexpr int stages(int nwg) {
  return nwg <= 3 ? 3 : 2;
}

size_t smem_bytes(int d) {
  const int wg = n_wg(d);
  return (size_t)stages(wg) * wg * WG_STAGE_BYTES + (size_t)BM * d * 2 +
         (size_t)BM * WG_FF * wg * 2 + ATOM_BYTES;
}

// Rows [k0, k0 + KS) x columns [n0, n0 + 64 * blocks) of the (K, N)
// row-major W into `blocks` swizzled 64-column blocks at dst, SLICE_BYTES
// apart: the MN-major B operand. Rows at or past k_end and columns at or
// past N land as zeros; PER_THREAD = blocks * 512 / threads copies a thread.
template <int PER_THREAD>
__device__ __forceinline__ void load_w(uint32_t dst, const bf16* W, int N,
                                       int k0, int k_end, int n0, int tid,
                                       int threads) {
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int id = tid + i * threads;
    const int blk = id >> 9, r = (id >> 3) & 63, c = id & 7;
    const int k = k0 + r, n = n0 + blk * 64 + c * 8;
    const bool live = k < k_end && n < N;
    cp_async16(dst + blk * SLICE_BYTES + r * 128 + ((c ^ (r & 7)) << 4),
               W + (live ? (size_t)k * N + n : 0), live ? 16 : 0);
  }
}

// The totals of rows ra and rb over every warpgroup's columns, from this
// thread's partial sums: over the quad, then through red[wg][row] and one
// barrier, summed in warpgroup order. Every thread of the block calls it.
__device__ __forceinline__ float2 row_totals(float sa, float sb, float* red,
                                             int wg, int nwg, int ra, int rb,
                                             int t4) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (t4 == 0) {
    red[wg * BM + ra] = sa;
    red[wg * BM + rb] = sb;
  }
  __syncthreads();
  float2 t{0.f, 0.f};
  for (int w = 0; w < nwg; ++w) {
    t.x += red[w * BM + ra];
    t.y += red[w * BM + rb];
  }
  return t;
}

template <int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
mlp_kernel(const bf16* __restrict__ attn, const bf16* __restrict__ h_in,
           const bf16* __restrict__ wo, const bf16* __restrict__ fc1,
           const bf16* __restrict__ fc2, const float* __restrict__ misc,
           bf16* __restrict__ out, int rows, int d, int ff, float eps) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM_BYTES - 1) & ~(uint32_t)(ATOM_BYTES - 1);
  uint8_t* const base_ptr = smem_raw + (base - raw);
  constexpr int threads = 128 * NWG, nwg = NWG;
  constexpr int stage_bytes = nwg * WG_STAGE_BYTES, STAGES = stages(NWG);
  const uint32_t ring = base;                       // the weight stages
  const uint32_t xs = ring + STAGES * stage_bytes;  // attention rows, then y
  const uint32_t ts = xs + (d / 64) * SLICE_BYTES;  // t1 of the chunk
  // LN2's partial row sums, [2][nwg][BM], in t1's space before fc1
  float* const red = reinterpret_cast<float*>(base_ptr + (ts - base));

  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = 16 * ((tid & 127) >> 5) + g, rb = ra + 8;   // tile rows
  const int row0 = blockIdx.x * BM;
  const bool live_a = row0 + ra < rows, live_b = row0 + rb < rows;
  const int col0 = WG_COLS * wg + 2 * t4;   // + 8c: o-projection, fc2
  constexpr int fc = WG_FF * nwg;           // ff columns a chunk
  const Vecs vec(misc, d, ff);
  const Plan plan{d / KS, d / KS, fc / KS, (ff + fc - 1) / fc};
  const int n_stages = plan.total();

  auto load_stage = [&](int i, uint32_t dst) {
    const Stage st = stage_of(i, plan);
    if (st.kind == O_PROJ)
      load_w<8>(dst, wo, d, st.s * KS, d, 0, tid, threads);
    else if (st.kind == FC1)
      load_w<4>(dst, fc1, ff, st.s * KS, d, st.chunk * fc, tid, threads);
    else
      load_w<8>(dst, fc2, d, st.chunk * fc + st.s * KS, ff, 0, tid, threads);
  };

  // the attention rows (K-major A tiles of 64 columns) and the first
  // STAGES - 1 stages in flight; rows past `rows` are zeros
  for (int id = tid; id < BM * d / 8; id += threads) {
    const int r = id / (d / 8), cc = id % (d / 8);
    const bool live = row0 + r < rows;
    cp_async16(xs + (cc >> 3) * SLICE_BYTES + r * 128 +
                   (((cc & 7) ^ (r & 7)) << 4),
               attn + (live ? (size_t)(row0 + r) * d + cc * 8 : 0),
               live ? 16 : 0);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_stages) load_stage(st, ring + st * stage_bytes);
    cp_async_commit();
  }

  // Stage i (and every shared write before it) has landed; the barrier
  // publishes it and, every warpgroup having waited for its products of
  // stage i - 1, frees that stage's buffer for the copy of stage i +
  // STAGES - 1, issued here. Returns stage i's address.
  int i = 0;
  auto next_stage = [&]() {
    cp_async_wait<STAGES - 2>();
    wt::fence_proxy_async();
    __syncthreads();
    const int ahead = i + STAGES - 1;
    if (ahead < n_stages)
      load_stage(ahead, ring + (ahead % STAGES) * stage_bytes);
    cp_async_commit();
    return ring + (i++ % STAGES) * stage_bytes;
  };
  // acc (+)= A[:, 64-column slice] . W[64 stage rows, this warpgroup's 128]
  auto gemm128 = [&](float (&acc)[64], uint32_t a, uint32_t w, bool first) {
    fence_regs(acc);
    wt::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wt::wgmma_m64n128k16_ss(
          acc, sw128_desc(a + 32 * j, 0),
          sw128_desc(w + 2 * wg * SLICE_BYTES + 2 * ATOM_BYTES * j,
                     SLICE_BYTES),
          !first || j > 0);
    wt::wgmma_commit();
    wt::wgmma_wait();
    fence_regs(acc);
  };

  // the o-projection: a warpgroup's 64 x 128
  float acc[64];
  for (int s = 0; s < plan.n_o; ++s)
    gemm128(acc, xs + s * SLICE_BYTES, next_stage(), s == 0);

  // h2 = rnd(h + rnd(rnd(a.wo) + rnd(o_b))) into `out` and acc; LN2's row
  // sums over this thread's columns
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int n = col0 + 8 * c;
    if (n >= d) continue;
    const size_t ia = (size_t)(row0 + ra) * d + n, ib = ia + 8 * (size_t)d;
    const float2 ha = live_a ? __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(h_in + ia)) : float2{};
    const float2 hb = live_b ? __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(h_in + ib)) : float2{};
    const float h[4] = {ha.x, ha.y, hb.x, hb.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = rnd_bf16(h[e] + rnd_bf16(rnd_bf16(acc[4 * c + e]) +
                                               rnd_bf16(vec.o_b[n + (e & 1)])));
      acc[4 * c + e] = v;
      if (e < 2) sa += v; else sb += v;
    }
    if (live_a)
      *reinterpret_cast<uint32_t*>(out + ia) =
          pack_bf16(acc[4 * c], acc[4 * c + 1]);
    if (live_b)
      *reinterpret_cast<uint32_t*>(out + ib) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
  const float2 mean = row_totals(sa, sb, red, wg, nwg, ra, rb, t4);
  const float mean_a = mean.x / d, mean_b = mean.y / d;
  sa = sb = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (col0 + 8 * c >= d) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float da = acc[4 * c + e] - mean_a, db = acc[4 * c + 2 + e] - mean_b;
      sa += da * da;
      sb += db * db;
    }
  }
  const float2 var = row_totals(sa, sb, red + MAX_WG * BM, wg, nwg, ra, rb, t4);
  const float inv_a = rsqrtf(var.x / d + eps);
  const float inv_b = rsqrtf(var.y / d + eps);
  // y = rnd(LN2(h2)) over the attention rows (every warpgroup's products
  // of them are done: it passed the barriers above)
  {
    uint8_t* y = base_ptr + (xs - base);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = col0 + 8 * c;
      if (n >= d) continue;
      const int k = n & 63;
      uint8_t* slice = y + (n >> 6) * SLICE_BYTES;
      const float ga = vec.ln_g[n], gb = vec.ln_g[n + 1];
      const float ba = vec.ln_b[n], bb = vec.ln_b[n + 1];
      *reinterpret_cast<uint32_t*>(slice + sw128_offset(ra, k)) = pack_bf16(
          (acc[4 * c] - mean_a) * inv_a * ga + ba,
          (acc[4 * c + 1] - mean_a) * inv_a * gb + bb);
      *reinterpret_cast<uint32_t*>(slice + sw128_offset(rb, k)) = pack_bf16(
          (acc[4 * c + 2] - mean_b) * inv_b * ga + ba,
          (acc[4 * c + 3] - mean_b) * inv_b * gb + bb);
    }
  }

  // per ff chunk: fc1 into acc1, its epilogue into the chunk's t1, then
  // acc (+)= t1 . fc2[chunk rows]; acc1 lives within the chunk only
  uint8_t* const t1 = base_ptr + (ts - base) + wg * SLICE_BYTES;
  for (int chunk = 0; chunk < plan.n_chunks; ++chunk) {
    float acc1[32];     // this warpgroup's 64 x 64 of the chunk
    for (int s = 0; s < plan.n_f1; ++s) {
      const uint32_t w = next_stage();
      fence_regs(acc1);
      wt::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wt::wgmma_m64n64k16_ss(
            acc1, sw128_desc(xs + s * SLICE_BYTES + 32 * j, 0),
            sw128_desc(w + wg * SLICE_BYTES + 2 * ATOM_BYTES * j, ATOM_BYTES),
            s > 0 || j > 0);
      wt::wgmma_commit();
      wt::wgmma_wait();
      fence_regs(acc1);
    }
    // t1 = rnd(gelu(rnd(rnd(y.fc1) + rnd(fc1_b)))), zero past ff, into this
    // warpgroup's 64-column slice (every warpgroup is past the last chunk's
    // fc2 reads of t1: the barrier of the stage above)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int nl = 8 * c + 2 * t4;
      const int n = chunk * fc + WG_FF * wg + nl;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ne = n + (e & 1);
        const float t = rnd_bf16(rnd_bf16(acc1[4 * c + e]) +
                                 rnd_bf16(ne < ff ? vec.fc1_b[ne] : 0.f));
        v[e] = ne < ff ? gelu_erf(t) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(t1 + sw128_offset(ra, nl)) =
          pack_bf16(v[0], v[1]);
      *reinterpret_cast<uint32_t*>(t1 + sw128_offset(rb, nl)) =
          pack_bf16(v[2], v[3]);
    }
    for (int s = 0; s < plan.n_f2; ++s)
      gemm128(acc, ts + s * SLICE_BYTES, next_stage(), chunk == 0 && s == 0);
  }
  cp_async_wait<0>();    // no copy outlives the block

  // out = h2 + rnd(rnd(t1.fc2) + rnd(fc2_b)), h2 read back from `out`
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int n = col0 + 8 * c;
    if (n >= d) continue;
    const float b0 = rnd_bf16(vec.fc2_b[n]), b1 = rnd_bf16(vec.fc2_b[n + 1]);
    const size_t ia = (size_t)(row0 + ra) * d + n, ib = ia + 8 * (size_t)d;
    if (live_a) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(out + ia));
      *reinterpret_cast<uint32_t*>(out + ia) =
          pack_bf16(h.x + rnd_bf16(rnd_bf16(acc[4 * c]) + b0),
                    h.y + rnd_bf16(rnd_bf16(acc[4 * c + 1]) + b1));
    }
    if (live_b) {
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(out + ib));
      *reinterpret_cast<uint32_t*>(out + ib) =
          pack_bf16(h.x + rnd_bf16(rnd_bf16(acc[4 * c + 2]) + b0),
                    h.y + rnd_bf16(rnd_bf16(acc[4 * c + 3]) + b1));
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: register micro-tiles on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int KS = 8;               // k-rows of a weight stage
constexpr int FF_WG = 32;           // fc1 columns of an ff chunk a warpgroup

size_t smem_bytes(int d) {
  const size_t wg = n_wg(d);
  return ((size_t)d * BM + FF_WG * wg * BM + 2 * KS * WG_COLS * wg) *
         sizeof(float);
}

// Rows [k0, k0 + KS) x columns [n0, n0 + COLS) of the (K, N) row-major W
// into shared rows of COLS floats; rows at or past k_end and columns at or
// past N land as zeros.
template <int COLS, int THREADS>
__device__ __forceinline__ void load_w(float* dst, const float* W, int N,
                                       int k0, int k_end, int n0, int tid) {
  constexpr int per_row = COLS / 4, pieces = KS * per_row;
#pragma unroll
  for (int i = 0; i < (pieces + THREADS - 1) / THREADS; ++i) {
    const int id = tid + i * THREADS;
    if (pieces % THREADS != 0 && id >= pieces) break;
    const int r = id / per_row, c = id % per_row;
    const int k = k0 + r, n = n0 + 4 * c;
    const bool live = k < k_end && n < N;
    cp_async16(smem_addr(dst + r * COLS + 4 * c),
               W + (live ? (size_t)k * N + n : 0), live ? 16 : 0);
  }
}

// The totals of rows r0 .. r0 + 7 over every warpgroup's columns, from
// this thread's partial sums: over the 16 lanes of its tr, then through
// red[wg][row] and one barrier, summed in warpgroup order. Every thread of
// the block calls it.
__device__ __forceinline__ void rows_total(float (&s)[8], float* red, int wg,
                                           int nwg, int r0, int tc) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
    if (tc == 0) red[wg * BM + r0 + r] = s[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    s[r] = 0.f;
    for (int w = 0; w < nwg; ++w) s[r] += red[w * BM + r0 + r];
  }
}

// Thread layout: warpgroup wg = tid / 128 owns o-projection and fc2
// columns 128 wg + [0, 128) and fc1 columns 32 wg + [0, 32) of each chunk.
// Within it, for the o-projection and fc2, tr = (tid % 128) / 16 and tc =
// tid % 16 give rows 8 tr + i (i < 8) and columns 4 tc + e and 64 + 4 tc +
// e (e < 4); for fc1, fr = (tid % 128) / 8 and fq = tid % 8 give rows 4 fr
// + i and columns 4 fq + e (i, e < 4), so its accumulator is 16 registers
// beside the o-projection's 64. A (attention rows, then y) and t1 are held
// transposed, row k of the shared array the 64 rows' values at column k,
// so a thread's rows are float4 reads and a warp's reads of A fall in one
// 128-byte wavefront.
template <int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
mlp_kernel(const float* __restrict__ attn, const float* __restrict__ h_in,
           const float* __restrict__ wo, const float* __restrict__ fc1,
           const float* __restrict__ fc2, const float* __restrict__ misc,
           float* __restrict__ out, int rows, int d, int ff, float eps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int threads = 128 * NWG, nwg = NWG;
  constexpr int fc = FF_WG * nwg, wcols = WG_COLS * nwg;
  float* const xt = smem;                  // [d][BM]: attention rows, then y
  float* const t1t = xt + d * BM;          // [fc][BM]: t1 of the chunk
  float* const ring = t1t + fc * BM;       // two stages of [KS][wcols]
  float* const red = t1t;                  // LN2 sums [2][nwg][BM] before fc1

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tr = (tid & 127) >> 4, tc = tid & 15;
  const int r0 = 8 * tr;                   // this thread's first tile row
  const int row0 = blockIdx.x * BM;
  const int colo = WG_COLS * wg + 4 * tc;  // and colo + 64: o-proj, fc2
  const int f0 = 4 * ((tid & 127) >> 3);   // fc1: first tile row
  const int col1 = FF_WG * wg + 4 * (tid & 7);   // within the fc1 chunk
  const Vecs vec(misc, d, ff);
  const Plan plan{d / KS, d / KS, fc / KS, (ff + fc - 1) / fc};
  const int n_stages = plan.total();

  auto load_stage = [&](int i, float* dst) {
    const Stage st = stage_of(i, plan);
    if (st.kind == O_PROJ)
      load_w<wcols, threads>(dst, wo, d, st.s * KS, d, 0, tid);
    else if (st.kind == FC1)
      load_w<fc, threads>(dst, fc1, ff, st.s * KS, d, st.chunk * fc, tid);
    else
      load_w<wcols, threads>(dst, fc2, d, st.chunk * fc + st.s * KS, ff, 0,
                             tid);
  };

  load_stage(0, ring);
  cp_async_commit();
  // the attention rows, transposed, four columns of one row a thread
  // (neighbouring lanes write neighbouring rows); rows past `rows` are zeros
  for (int id = tid; id < BM * d / 4; id += threads) {
    const int r = id % BM, k = 4 * (id / BM);
    const float4 x = row0 + r < rows ? *reinterpret_cast<const float4*>(
        attn + (size_t)(row0 + r) * d + k) : float4{};
    xt[k * BM + r] = x.x;
    xt[(k + 1) * BM + r] = x.y;
    xt[(k + 2) * BM + r] = x.z;
    xt[(k + 3) * BM + r] = x.w;
  }

  int i = 0;
  auto next_stage = [&]() -> const float* {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_stages) load_stage(i + 1, ring + ((i + 1) & 1) * KS * wcols);
    cp_async_commit();
    return ring + (i++ & 1) * KS * wcols;
  };
  // acc (+)= A[:, KS columns] . W[KS stage rows, this warpgroup's 128]: per
  // k, two float4 of A (8 rows) and two of W (8 columns) feed 64 FMAs
  float acc[8][8];    // rows r0 + i; columns colo + j, colo + 64 + j - 4
  // (four warpgroups hold 128 registers a thread: half the unrolling)
  auto gemm128 = [&](const float* a, const float* w) {
#pragma unroll(NWG == 4 ? 2 : 4)
    for (int kk = 0; kk < KS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * BM + r0);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * BM + r0 + 4);
      const float4 w0 = *reinterpret_cast<const float4*>(w + kk * wcols + colo);
      const float4 w1 =
          *reinterpret_cast<const float4*>(w + kk * wcols + colo + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], wv[j], acc[r][j]);
    }
  };

  // the o-projection
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  for (int s = 0; s < plan.n_o; ++s) gemm128(xt + s * KS * BM, next_stage());

  // h2 = h + (a.wo + o_b) into `out` and acc; LN2's row sums, then the
  // means (mean) and the sums of squared deviations, then 1/std (dev)
  float mean[8], dev[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    mean[r] = 0.f;
    const bool live = row0 + r0 + r < rows;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = colo + 64 * half;
      if (n >= d) continue;
      const size_t at = (size_t)(row0 + r0 + r) * d + n;
      const float4 h = live ? *reinterpret_cast<const float4*>(h_in + at)
                            : float4{};
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][4 * half + j] =
            hv[j] + (acc[r][4 * half + j] + vec.o_b[n + j]);
        mean[r] += acc[r][4 * half + j];
      }
      if (live)
        *reinterpret_cast<float4*>(out + at) = make_float4(
            acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2],
            acc[r][4 * half + 3]);
    }
  }
  rows_total(mean, red, wg, nwg, r0, tc);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    mean[r] /= d;
    dev[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (colo + 64 * (j >> 2) >= d) continue;
      const float dv = acc[r][j] - mean[r];
      dev[r] += dv * dv;
    }
  }
  rows_total(dev, red + MAX_WG * BM, wg, nwg, r0, tc);
#pragma unroll
  for (int r = 0; r < 8; ++r) dev[r] = rsqrtf(dev[r] / d + eps);
  // y = LN2(h2) over the attention rows (every thread is past its products
  // of them: the barriers in rows_total)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = colo + 64 * (j >> 2) + (j & 3);
    if (n >= d) continue;
    const float gn = vec.ln_g[n], bn = vec.ln_b[n];
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = (acc[r][j] - mean[r]) * dev[r] * gn + bn;
    float* dst = xt + n * BM + r0;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }

  // per ff chunk: fc1 into acc1 (4 rows x 4 columns a thread), its
  // epilogue into the chunk's t1, then acc += t1 . fc2[chunk rows]
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  for (int chunk = 0; chunk < plan.n_chunks; ++chunk) {
    float acc1[4][4];   // rows f0 + i; fc1 columns col1 + j
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[r][j] = 0.f;
    for (int s = 0; s < plan.n_f1; ++s) {
      const float* w = next_stage();
      const float* a = xt + s * KS * BM + f0;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + kk * BM);
        const float4 w0 = *reinterpret_cast<const float4*>(w + kk * fc + col1);
        const float av[4] = {a0.x, a0.y, a0.z, a0.w};
        const float wv[4] = {w0.x, w0.y, w0.z, w0.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc1[r][j] = fmaf(av[r], wv[j], acc1[r][j]);
      }
    }
    // t1 = gelu(y.fc1 + fc1_b), zero past ff, into t1t's columns (every
    // thread is past the last chunk's fc2 reads of t1t: the barrier of the
    // stage above)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = chunk * fc + col1 + j;
      const float b = n < ff ? vec.fc1_b[n] : 0.f;
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = n < ff ? gelu_erf(acc1[r][j] + b) : 0.f;
      *reinterpret_cast<float4*>(t1t + (col1 + j) * BM + f0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int s = 0; s < plan.n_f2; ++s) gemm128(t1t + s * KS * BM, next_stage());
  }
  cp_async_wait<0>();    // no copy outlives the block

  // out = h2 + (t1.fc2 + fc2_b), h2 read back from `out`
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (row0 + r0 + r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = colo + 64 * half;
      if (n >= d) continue;
      float* o = out + (size_t)(row0 + r0 + r) * d + n;
      const float4 h = *reinterpret_cast<const float4*>(o);
      const int j = 4 * half;
      *reinterpret_cast<float4*>(o) = make_float4(
          h.x + (acc[r][j] + vec.fc2_b[n]),
          h.y + (acc[r][j + 1] + vec.fc2_b[n + 1]),
          h.z + (acc[r][j + 2] + vec.fc2_b[n + 2]),
          h.w + (acc[r][j + 3] + vec.fc2_b[n + 3]));
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// The int8 form (mlp_q, o_q): mma.sync on s8 operands
// ---------------------------------------------------------------------------
//
// Replaces _tail_kernel with mlp_q and o_q (encoder_layer.py:57, the qdot
// of :120-129): every product of the MLP, and of the o-projection under
// o_q, is
//   qdot(x, W) = f32(int32 sum of round(x / sx) * W_q) * (sx * w_s),
//   sx = max(max|x_row| / 127, 1e-10),
// at the kernel's rounding points:
//   h2  = rnd(h + rnd(rnd(o) + rnd(o_b)))    o = qdot(a, wo) or a . wo (bf16)
//   y   = rnd(LN2(h2))
//   t1  = rnd(gelu_erf(rnd(rnd(qdot(y, fc1)) + rnd(fc1_b))))
//   out = h2 + rnd(rnd(qdot(t1, fc2)) + rnd(fc2_b))
// The int32 sums are exact, so the products equal JAX's whatever the order;
// the quantization divides and rounds as JAX does (IEEE division, round half
// to even).
//
// What bounds it on the H100: operations. At Whisper-tiny b32 one layer is
// 1.11e11 FLOP of attention (the flash kernel, bf16, 0.112 ms at 989
// TFLOP/s) and 1.27e11 int8 operations of o-projection and MLP (0.064 ms at
// 1,979 TOPS): 0.176 ms.
//
// Design (a simple kernel that is right; its speed is later work). One
// block of 8 warps per 32 rows of the flattened (B*T, d) stream, after the
// same flash-attention launch as the unquantized tail. A row's activation
// scale needs the row's maximum before any of it is quantized, and fc2's
// input row is all ff columns of t1: so the block keeps its 32 rows whole in
// shared memory, t1 included (t1 in bf16, 32 x ff, then its int8 values
// written over it, each warp converting its own rows), instead of streaming
// ff in chunks as the bf16 form does. That costs 135 KB at tiny and 180 KB
// at base, and one block an SM. The phases, each behind a barrier:
//   1. the attention rows: each warp quantizes whole rows (row maximum by
//      shuffles) into the int8 A tile (o_q), or copies them in bf16;
//   2. o-projection: warp w takes the 8-column tiles w, w + 8, ... of d for
//      all 32 rows; epilogue h2 into shared memory in bf16;
//   3. LN2 per row (a warp a row), y rounded and quantized into the A tile;
//   4. fc1: warp w takes the 64-column chunks w, w + 8, ... of ff; epilogue
//      t1 (bf16) into shared memory and the rows' |t1| maxima (a shared
//      atomicMax on the bits of non-negative floats, which order as
//      integers);
//   5. t1 quantized in place, a warp a row (reads, __syncwarp, writes);
//   6. fc2 over K = ff, tiles as in 2; epilogue h2 + t2 to `out`.
// The products are mma.sync.m16n8k32 (s8 x s8 -> s32; bf16 m16n8k16 for
// the bf16 o-projection) with A fragments from shared memory and B
// fragments straight from device memory (L2): the weights arrive K-major
// (transposed once when the encoder quantizes them; an 8-bit operand must
// be K-major), so a lane's 16-byte read covers its k values for two
// products. A and B take the same permutation of k within each 64-byte
// step (lane t4 reads bytes 16 t4 .. 16 t4 + 15), which leaves the sum
// unchanged. Shared rows are padded by 64 bytes, so the 16-byte A reads of
// a quarter warp fall in distinct banks.

namespace q8 {

using bf16 = __nv_bfloat16;

constexpr int BM = 32;                 // rows a block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 64;                // bytes after each shared row
constexpr int MAX_D = 512;             // a lane holds 2 x 8 values of a row
constexpr int MAX_FF = 2048;           // a lane holds 8 x 8 values of t1
constexpr int NT = 8;                  // 8-column tiles a warp holds

size_t smem_bytes(int d, int ff) {
  return (size_t)BM * ((d + PAD) + 2 * d + (2 * ff + PAD) + 16);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  wt::mma_m16n8k16(d, a, b);
}

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

// JAX's row quantization of one value: clip(round(x / s), -127, 127)
__device__ __forceinline__ uint32_t quant(float x, float s) {
  return (uint32_t)(uint8_t)(int8_t)fminf(fmaxf(rintf(x / s), -127.f),
                                          127.f);
}
// eight values -> eight int8 bytes
__device__ __forceinline__ uint2 quant8(const float (&x)[8], float s) {
  uint2 r;
  r.x = quant(x[0], s) | quant(x[1], s) << 8 | quant(x[2], s) << 16 |
        quant(x[3], s) << 24;
  r.y = quant(x[4], s) | quant(x[5], s) << 8 | quant(x[6], s) << 16 |
        quant(x[7], s) << 24;
  return r;
}
__device__ __forceinline__ void unpack8(uint4 raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(absmax / 127.f, 1e-10f);
}

// acc[m][j] = the 32 rows of A (shared, row stride a_stride bytes) times the
// 8 columns of tile t = tile0 + j * tstep of W (device memory, K-major: row
// n holds column n's kbytes bytes), j < nt; m is the 16-row half. 64 bytes
// of k a step: two products (32 int8 or 16 bf16 values each).
template <typename Acc>
__device__ __forceinline__ void warp_gemm(Acc (&acc)[2][NT][4],
                                          const uint8_t* A, int a_stride,
                                          const uint8_t* __restrict__ W,
                                          int kbytes, int tile0, int tstep,
                                          int nt, int g, int t4) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
  auto load_b = [&](uint4 (&b)[NT], int k0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt)
        b[j] = __ldg(reinterpret_cast<const uint4*>(
            W + (size_t)((tile0 + j * tstep) * 8 + g) * kbytes + k0 +
            16 * t4));
  };
  uint4 b[NT], nb[NT];
  load_b(b, 0);
  for (int k0 = 0; k0 < kbytes; k0 += 64) {
    if (k0 + 64 < kbytes) load_b(nb, k0 + 64);
    uint4 a[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[m][h] = *reinterpret_cast<const uint4*>(
            A + (16 * m + 8 * h + g) * a_stride + k0 + 16 * t4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
      const uint32_t b0[2] = {b[j].x, b[j].y}, b1[2] = {b[j].z, b[j].w};
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t a0[4] = {a[m][0].x, a[m][1].x, a[m][0].y, a[m][1].y};
        const uint32_t a1[4] = {a[m][0].z, a[m][1].z, a[m][0].w, a[m][1].w};
        mma(acc[m][j], a0, b0);
        mma(acc[m][j], a1, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = nb[j];
  }
}

// Element (m, j, e) of a warp_gemm accumulator: row 16 m + g + 8 (e >> 1),
// column 8 t + 2 t4 + (e & 1) of tile t.
template <bool OQ>
__global__ void __launch_bounds__(THREADS, 1)
mlp_kernel(const bf16* __restrict__ attn, const bf16* __restrict__ h_in,
           const uint8_t* __restrict__ wo, const uint8_t* __restrict__ fc1,
           const uint8_t* __restrict__ fc2, const float* __restrict__ misc,
           bf16* __restrict__ out, int rows, int d, int ff, float eps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int xstride = d + PAD, tstride = 2 * ff + PAD;
  uint8_t* const xs = smem;                        // int8 A rows: a, then y
  bf16* const h2s = reinterpret_cast<bf16*>(smem + BM * xstride);
  uint8_t* const ts = smem + BM * xstride + BM * 2 * d;  // t1; bf16 a (!OQ)
  float* const sa = reinterpret_cast<float*>(ts + BM * tstride);
  float* const sy = sa + BM;                       // row scales of a, y, t1
  float* const st = sy + BM;
  unsigned* const tmax = reinterpret_cast<unsigned*>(st + BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BM;
  const Vecs vec(misc, d, ff);
  const float* const fc1_s = misc + 4 * d + ff;
  const float* const fc2_s = fc1_s + ff;
  const float* const wo_s = fc2_s + d;
  const int nt = d / 64;                 // o-projection / fc2 tiles a warp

  // 1. the attention rows: lane piece p holds columns 256 p + 8 lane ..
  for (int r = warp; r < BM; r += WARPS) {
    const bool live = row0 + r < rows;
    uint4 raw[2];
    float x[2][8], m = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k = 256 * p + 8 * lane;
      raw[p] = live && k < d ? *reinterpret_cast<const uint4*>(
                                   attn + (size_t)(row0 + r) * d + k)
                             : make_uint4(0, 0, 0, 0);
      unpack8(raw[p], x[p]);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(x[p][i]));
    }
    if (OQ) {
      const float s = scale_of(warp_max(m));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int k = 256 * p + 8 * lane;
        if (k < d)
          *reinterpret_cast<uint2*>(xs + r * xstride + k) = quant8(x[p], s);
      }
      if (lane == 0) sa[r] = s;
    } else {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int k = 256 * p + 8 * lane;
        if (k < d) *reinterpret_cast<uint4*>(ts + r * tstride + 2 * k) = raw[p];
      }
    }
    if (lane == 0) tmax[r] = 0u;
  }
  __syncthreads();

  // 2. o-projection: h2 = rnd(h + rnd(rnd(o) + rnd(o_b))) into h2s
  {
    using Acc = std::conditional_t<OQ, int, float>;
    Acc acc[2][NT][4];
    if constexpr (OQ)
      warp_gemm(acc, xs, xstride, wo, d, warp, WARPS, nt, g, t4);
    else
      warp_gemm(acc, ts, tstride, wo, 2 * d, warp, WARPS, nt, g, t4);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + 8 * h + g;
          const int n = (warp + j * WARPS) * 8 + 2 * t4;
          const bool live = row0 + r < rows;
          const float2 hv = live ? __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  h_in + (size_t)(row0 + r) * d + n)) : float2{0.f, 0.f};
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float o = OQ ? (float)acc[m][j][2 * h + e] *
                                     (sa[r] * wo_s[n + e])
                               : (float)acc[m][j][2 * h + e];
            v[e] = rnd_bf16((e ? hv.y : hv.x) +
                            rnd_bf16(rnd_bf16(o) + rnd_bf16(vec.o_b[n + e])));
          }
          *reinterpret_cast<uint32_t*>(h2s + r * d + n) =
              wt::pack_bf16(v[0], v[1]);
        }
      }
  }
  __syncthreads();

  // 3. y = rnd(LN2(h2)), quantized per row into the A tile
  for (int r = warp; r < BM; r += WARPS) {
    float x[2][8], sum = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k = 256 * p + 8 * lane;
      unpack8(k < d ? *reinterpret_cast<const uint4*>(h2s + r * d + k)
                    : make_uint4(0, 0, 0, 0), x[p]);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += x[p][i];
    }
    const float mean = warp_sum(sum) / d;
    float dev = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (256 * p + 8 * lane >= d) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) dev += (x[p][i] - mean) * (x[p][i] - mean);
    }
    const float inv = rsqrtf(warp_sum(dev) / d + eps);
    float m = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k = 256 * p + 8 * lane;
      if (k >= d) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[p][i] = rnd_bf16((x[p][i] - mean) * inv * vec.ln_g[k + i] +
                           vec.ln_b[k + i]);
        m = fmaxf(m, fabsf(x[p][i]));
      }
    }
    const float s = scale_of(warp_max(m));
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int k = 256 * p + 8 * lane;
      if (k < d)
        *reinterpret_cast<uint2*>(xs + r * xstride + k) = quant8(x[p], s);
    }
    if (lane == 0) sy[r] = s;
  }
  __syncthreads();

  // 4. fc1: t1 = rnd(gelu(rnd(rnd(qdot(y, fc1)) + rnd(fc1_b)))) into ts in
  //    bf16, and each row's max |t1|
  {
    float tm[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c = warp; c < ff / 64; c += WARPS) {
      int acc[2][NT][4];
      warp_gemm(acc, xs, xstride, fc1, d, c * NT, 1, NT, g, t4);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * m + 8 * h + g;
            const int n = (c * NT + j) * 8 + 2 * t4;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float o = (float)acc[m][j][2 * h + e] *
                              (sy[r] * fc1_s[n + e]);
              v[e] = rnd_bf16(gelu_erf(rnd_bf16(
                  rnd_bf16(o) + rnd_bf16(vec.fc1_b[n + e]))));
              tm[m][h] = fmaxf(tm[m][h], fabsf(v[e]));
            }
            *reinterpret_cast<uint32_t*>(ts + r * tstride + 2 * n) =
                wt::pack_bf16(v[0], v[1]);
          }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = tm[m][h];
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t4 == 0) atomicMax(&tmax[16 * m + 8 * h + g], __float_as_uint(v));
      }
  }
  __syncthreads();

  // 5. t1 quantized in place: row r's int8 values over the start of its
  //    bf16 values, a warp a row, all reads before any write
  for (int r = warp; r < BM; r += WARPS) {
    const float s = scale_of(__uint_as_float(tmax[r]));
    uint8_t* const row = ts + r * tstride;
    uint4 raw[MAX_FF / 256];
#pragma unroll
    for (int p = 0; p < MAX_FF / 256; ++p) {
      const int k = 256 * p + 8 * lane;
      if (k < ff) raw[p] = *reinterpret_cast<const uint4*>(row + 2 * k);
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < MAX_FF / 256; ++p) {
      const int k = 256 * p + 8 * lane;
      if (k >= ff) continue;
      float x[8];
      unpack8(raw[p], x);
      *reinterpret_cast<uint2*>(row + k) = quant8(x, s);
    }
    if (lane == 0) st[r] = s;
  }
  __syncthreads();

  // 6. fc2: out = h2 + rnd(rnd(qdot(t1, fc2)) + rnd(fc2_b))
  {
    int acc[2][NT][4];
    warp_gemm(acc, ts, tstride, fc2, ff, warp, WARPS, nt, g, t4);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + 8 * h + g;
          if (row0 + r >= rows) continue;
          const int n = (warp + j * WARPS) * 8 + 2 * t4;
          const float2 h2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(h2s + r * d + n));
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float o = (float)acc[m][j][2 * h + e] * (st[r] * fc2_s[n + e]);
            v[e] = (e ? h2.y : h2.x) +
                   rnd_bf16(rnd_bf16(o) + rnd_bf16(vec.fc2_b[n + e]));
          }
          *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + r) * d + n) =
              wt::pack_bf16(v[0], v[1]);
        }
      }
  }
}

template <bool OQ>
cudaError_t launch(const void* attn, const void* h_in, const void* wo,
                   const void* fc1, const void* fc2, const float* misc,
                   void* out, int rows, int d, int ff, float eps, size_t smem,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_kernel<OQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mlp_kernel<OQ><<<(rows + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const bf16*>(attn), static_cast<const bf16*>(h_in),
      static_cast<const uint8_t*>(wo), static_cast<const uint8_t*>(fc1),
      static_cast<const uint8_t*>(fc2), misc, static_cast<bf16*>(out), rows, d,
      ff, eps);
  return cudaGetLastError();
}

}  // namespace q8

// The larger of the two kernels' shared memory at width d (ff streams in
// chunks and does not enter).
size_t tail_smem_bytes(int d) {
  return std::max(tc::smem_bytes(d), simt::smem_bytes(d));
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, int NWG>
cudaError_t launch_mlp(const void* attn, const void* h_in, const void* wo,
                       const void* fc1, const void* fc2, const float* misc,
                       void* out, int rows, int d, int ff, float eps,
                       size_t smem, cudaStream_t stream) {
  using E = std::conditional_t<sizeof(T) == 2, __nv_bfloat16, float>;
  const auto kernel = sizeof(T) == 2
      ? reinterpret_cast<const void*>(tc::mlp_kernel<NWG>)
      : reinterpret_cast<const void*>(simt::mlp_kernel<NWG>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + BM - 1) / BM), block(128 * NWG);
  const E* args[5] = {static_cast<const E*>(attn), static_cast<const E*>(h_in),
                      static_cast<const E*>(wo), static_cast<const E*>(fc1),
                      static_cast<const E*>(fc2)};
  if constexpr (sizeof(T) == 2)
    tc::mlp_kernel<NWG><<<grid, block, smem, stream>>>(
        args[0], args[1], args[2], args[3], args[4], misc,
        static_cast<E*>(out), rows, d, ff, eps);
  else
    simt::mlp_kernel<NWG><<<grid, block, smem, stream>>>(
        args[0], args[1], args[2], args[3], args[4], misc,
        static_cast<E*>(out), rows, d, ff, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tail(const void* q, const void* k, const void* v,
                        const void* h_in, const void* wo, const void* fc1,
                        const void* fc2, const float* misc, void* attn,
                        void* out, int B, int T_len, int S, int H, int d,
                        int ff, float eps, cudaStream_t stream) {
  // the MLP tile must fit the opt-in shared memory (tiny 173 KB, base 230
  // KB of 227 KB; from d = 640 up it does not, and the encoder takes its
  // tail-off branch): checked before anything is launched, so a refused
  // shape launches nothing. ops/encoder_layer.py:tail_smem_bytes is the
  // same formula.
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t smem = tail_smem_bytes(d);
  if (n_wg(d) > MAX_WG || smem > (size_t)max_smem)
    return cudaErrorInvalidValue;

  // 1. attention into the (B, T, H*D) scratch: contiguous q and k/v
  const long long D = HEAD_DIM;
  e = (cudaError_t)wt_flash_attention(
      q, k, v, attn, B, T_len, S, H, HEAD_DIM, S, 0, 0, T_len * H * D, H * D,
      D, H * S * D, S * D, D, H * S * D, S * D, D,
      sizeof(T) == 2, stream);
  if (e != cudaSuccess) return e;

  // 2. o-projection + LN2 + MLP, one warpgroup per 128 columns of d
  const int rows = B * T_len;
  switch (n_wg(d)) {
    case 1: return launch_mlp<T, 1>(attn, h_in, wo, fc1, fc2, misc, out, rows, d, ff, eps, smem, stream);
    case 2: return launch_mlp<T, 2>(attn, h_in, wo, fc1, fc2, misc, out, rows, d, ff, eps, smem, stream);
    case 3: return launch_mlp<T, 3>(attn, h_in, wo, fc1, fc2, misc, out, rows, d, ff, eps, smem, stream);
    default: return launch_mlp<T, 4>(attn, h_in, wo, fc1, fc2, misc, out, rows, d, ff, eps, smem, stream);
  }
}

}  // namespace

// Shared memory the tail's MLP launch needs at width (d, ff) (bytes), in
// the unquantized form (q8 = 0) or the int8 form, for
// ops/encoder_layer.py's gate to be checked against.
extern "C" long long wt_encoder_tail_smem(int d, int ff, int int8_form) {
  return (long long)(int8_form ? q8::smem_bytes(d, ff) : tail_smem_bytes(d));
}

// Returns cudaGetLastError() after the launches (0 on success). Shapes:
// q (B,T,H,D), k/v (B,H,S,D), h_in/out (B,T,d), attn scratch (B,T,d),
// wo (d,d), fc1 (d,ff), fc2 (ff,d), all contiguous and 16-byte aligned in
// one element type; misc fp32 (4d+ff). D must be 64 (so d = 64 H) and ff a
// multiple of 64.
extern "C" int wt_encoder_tail(const void* q, const void* k, const void* v,
                               const void* h_in, const void* wo,
                               const void* fc1, const void* fc2,
                               const void* misc, void* attn, void* out, int B,
                               int T_len, int S, int H, int D, int d, int ff,
                               float eps, int is_bf16, void* stream) {
  if (D != HEAD_DIM || d != H * D || ff % 64 != 0 || ff < 64 || B < 1 ||
      T_len < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, h_in, wo, fc1, fc2, attn, out}))
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

// The int8 form (bf16 only). Returns cudaGetLastError() after the launches
// (0 on success). Shapes: q (B,T,H,D), k/v (B,H,S,D), h_in/out (B,T,d),
// attn scratch (B,T,d), all bf16; wo (d, d) K-major, int8 under o_q, else
// bf16; fc1 (ff, d) and fc2 (d, ff) int8, K-major; all contiguous and
// 16-byte aligned; misc fp32 [o_b | fc1_b | fc2_b | ln2_g | ln2_b | fc1_s
// | fc2_s (| wo_s)]. D must be 64, d = 64 H <= 512, ff a multiple of 64
// with d <= ff <= 2048.
extern "C" int wt_encoder_tail_q8(const void* q, const void* k, const void* v,
                                  const void* h_in, const void* wo,
                                  const void* fc1, const void* fc2,
                                  const void* misc, void* attn, void* out,
                                  int B, int T_len, int S, int H, int D, int d,
                                  int ff, float eps, int o_q, void* stream) {
  if (D != HEAD_DIM || d != H * D || d > q8::MAX_D || ff % 64 != 0 ||
      ff < d || ff > q8::MAX_FF || B < 1 || T_len < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16({q, k, v, h_in, wo, fc1, fc2, attn, out}))
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = q8::smem_bytes(d, ff);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long Dl = HEAD_DIM;
  e = (cudaError_t)wt_flash_attention(
      q, k, v, attn, B, T_len, S, H, HEAD_DIM, S, 0, 0, T_len * H * Dl,
      H * Dl, Dl, H * S * Dl, S * Dl, Dl, H * S * Dl, S * Dl, Dl, 1, s);
  if (e != cudaSuccess) return (int)e;
  const float* m = static_cast<const float*>(misc);
  const int rows = B * T_len;
  return (int)(o_q ? q8::launch<true>(attn, h_in, wo, fc1, fc2, m, out, rows,
                                      d, ff, eps, smem, s)
                   : q8::launch<false>(attn, h_in, wo, fc1, fc2, m, out, rows,
                                       d, ff, eps, smem, s));
}
