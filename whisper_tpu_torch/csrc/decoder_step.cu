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
// 358 us. Its products (2 B L 14 d^2 FLOP, 5.9 GFLOP at turbo b32) would
// take 88 us at the fp32 CUDA cores' 67 TFLOP/s peak: in bf16 they run on
// the tensor cores, in fp32 (the parity mode) on the CUDA cores.
//
// Design. On the TPU the grid (layer, phase) runs in order on one core
// with h in VMEM. Here blocks run in parallel, so the kernel is one
// persistent cooperative grid (two blocks an SM, from the occupancy
// calculator) that walks the layers in phases separated by grid-wide
// barriers (cooperative_groups grid sync); every intermediate lives in a
// scratch in device memory (L2-resident at these sizes) that the wrapper
// allocates. A barrier costs ~1.3 us on the H100; what the first version
// lost was each phase's chain of dependent loads (chip_smoke.py
// fused_phases breaks a step down by phase). So:
//   - every phase issues its loads at once (16-byte cp.async into shared
//     memory) and waits once;
//   - the products' X arrays (h, qkv, the attention output, the cross q,
//     t1) hold T (bf16 values are rounded there anyway), so bf16 rows land
//     ready for the tensor cores;
//   - work that needs every block's results is done by the block that
//     finishes last (a counter in the scratch, after a fence) instead of
//     in a phase of its own;
//   - the card places consecutive blocks on a few SMs, so a phase of a
//     few items would run two to an SM on a few SMs: the prologue records
//     each block's SM and the phases hand items out SM by SM (grid_slot);
//   - staging and normalising loops index rows x lanes (no division by a
//     runtime width) and stay rolled: unrolled, they cost registers (and
//     spills) the products need.
// Phases:
//   gemm   X (B, K) @ W (K, N): an item is a 64-column tile times a
//          K-chunk; the item stages its weight chunk and X rows in shared
//          memory and normalises a LayerNorm'd X (h) there, from h's
//          per-tile statistics. bf16 products run on the tensor cores
//          (mma.sync m16n8k16 fed by ldmatrix, each 16-deep block summed
//          from zero and added in fp32), one chunk a tile where K fits the
//          shared memory (tiny: every K = d gemm); fp32 ones on the CUDA
//          cores, about one item a block. A tile of several chunks writes
//          partial sums that its last item sums in chunk order. The tile's
//          epilogue: bias and rounding (qkv, cross q), exact-erf GeLU (fc1:
//          t1 is made once), or the residual (o, co, fc2), which also
//          writes the tile's share of the next LayerNorm's statistics
//          (mean and squared deviations of its 64 values a row), merged in
//          tile order where they are used: no rows phase. Every sum runs
//          in a fixed order, so two calls are bitwise equal.
//   self   one item per (b, h): q, k, v from the qkv product, k and v
//          written out, an online softmax seeded with the current token
//          over the rows < pos (no row at or past pos is read).
//   cross  one item per (b, h), or per key split where the SMs would
//          otherwise idle (small batch); the last split of a (b, h) to
//          finish merges the partials in split order.
// The attention reads stream each warp's keys through its own ring in
// shared memory (16-byte cp.async, 4 lanes a key, STAGES - 1 groups of 8
// keys in flight), so the warps need no block barrier while they read.
// Per layer: qkv, self, o, cq, cross, co, fc1, fc2: eight barriers (seven
// after the last layer, plus one after the prologue), against the first
// version's eleven.

#include <cooperative_groups.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using wt::cp_async16;
using wt::cp_async_commit;
using wt::cp_async_wait;
using wt::from_f32;
using wt::rnd;
using wt::smem_addr;
using wt::to_f32;

constexpr int HEAD_DIM = 64;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 64;            // gemm output columns per item
constexpr int RB = 32;            // gemm rows per pass: 4 a warp
constexpr int KC_MIN = 32;        // gemm K-chunk bounds
constexpr int KS_TARGET = 4;      // K-chunks a tile where the chunk fits
constexpr int MAX_KS = 32;        // K-chunks a tile at most
constexpr int T_MAX = 32;         // 64-column tiles of d at most (d <= 2048)
constexpr int NCS_MAX = 8;        // cross key splits at most
constexpr int LANES_PER_KEY = 4;  // attention: 16 dims per lane
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;
constexpr int SEG = HEAD_DIM / LANES_PER_KEY;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr size_t TILE_BYTES = 108 * 1024;  // a phase's tiles: two blocks an SM
constexpr int GK = 12;            // partial sums a tile's sum stages at once
constexpr int MAX_GRID = 2048;    // blocks of the cooperative grid at most

// A gemm item's shared memory: the row statistics' per-tile partials of
// the rows of a pass (T_d tiles) and their merge, the weight chunk (kc
// rows of WLD elements), the X rows (xld elements apart, in T), the
// LayerNorm vectors, and the tile's sums when the item owns the whole K.
// bf16: weight rows padded by 16 bytes and X rows by 16, so that the 8
// rows an ldmatrix reads fall in distinct banks; fp32: X rows by 4 floats.
template <typename T>
struct ItemLayout {
  static constexpr bool TC = sizeof(T) == 2;
  static constexpr int WLD = TC ? NT + 8 : NT;
  int xld;
  size_t st, ws, xs, lnv, sums, total;
  __host__ __device__ ItemLayout(int kc, int T_d) {
    xld = TC ? kc + 8 : kc + 4;
    st = (size_t)2 * RB * T_d * 4;
    ws = st + 2 * RB * 4;
    xs = ws + (size_t)kc * WLD * sizeof(T);
    lnv = xs + (size_t)RB * xld * sizeof(T);
    sums = lnv + (size_t)2 * kc * 4;
    total = sums + (size_t)RB * NT * 4;
  }
};

// The largest K-chunk (a multiple of 32) whose item fits TILE_BYTES.
template <typename T>
int kc_max(int T_d) {
  int kc = 32;
  while (ItemLayout<T>(kc + 32, T_d).total <= TILE_BYTES) kc += 32;
  return kc;
}

// The attention reads' rings in shared memory, one a warp: groups of a
// warp's 8 keys (K rows, then V rows) fed by 16-byte cp.async, STAGES - 1
// groups in flight (bf16 4 stages of 2 KB a warp, fp32 3 of 4 KB).
template <typename T>
struct WarpRing {
  static constexpr int ROW = HEAD_DIM * sizeof(T); // bytes a key row
  static constexpr int GROUP = 2 * KEYS_PER_WARP * ROW;
  static constexpr int STAGES =
      (int)(TILE_BYTES / WARPS / GROUP) < 4 ? (int)(TILE_BYTES / WARPS / GROUP)
                                            : 4;
};

// The small shared state of the attention phases and the counters.
struct Small {
  float qkv[3 * HEAD_DIM];   // self: q, k, v; cross: q
  float qs[HEAD_DIM];        // q * D^-0.5
  float m_w[WARPS], l_w[WARPS];
  float acc_w[WARPS][HEAD_DIM];
  float acc[HEAD_DIM + 2];   // a read's accumulator, m, l
  float s_new;
  int flag;
};
constexpr size_t SMEM_BYTES = TILE_BYTES + (sizeof(Small) + 15) / 16 * 16;

// Phase kinds of the optional timeline (ops/decoder_step.py PHASES).
enum Phase { P_START, P_ROWS, P_QKV, P_SELF, P_O, P_CQ, P_CROSS, P_CO,
             P_FC1, P_FC2, P_FINAL, P_SYNC };
constexpr int SYNC_PROBES = 8;    // back-to-back barriers timed at the end

// Block 0's timeline, when the caller passes a buffer: (kind, %globaltimer
// ns) pairs, written by one thread as it leaves each grid barrier, then a
// kind of -1. Without a buffer (every normal call) it writes nothing.
struct Timeline {
  long long* out;
  int cap, n;
  __device__ void stamp(int kind) {
    if (out == nullptr || blockIdx.x != 0 || threadIdx.x != 0 || n + 1 >= cap)
      return;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    out[2 * n] = kind;
    out[2 * n + 1] = (long long)t;
    ++n;
    out[2 * n] = -1;
  }
};

struct GemmPlan {
  int kc, ks;   // K-chunk and number of chunks
};

template <typename T>
struct Args {
  const T *h0, *wqkv, *wcq, *wo, *wco, *fc1, *fc2;
  const float* vec;             // (L, 13d + ff)
  const T *sk, *sv, *ck, *cv;   // (L, B, H, S, D)
  T *h_out, *knew, *vnew;
  // scratch: the residual h, the LayerNorm statistics (mean, 1/std) of
  // each row, the qkv product, the attention output, the cross q, t1, the
  // gemm partial sums, the cross splits' partials; counters
  // The X arrays of the products (the residual h, the qkv product, the
  // attention output, the cross q, t1) hold values rounded to T, in T;
  // pstats: per 64-column tile t of h and row b, (mean, sum of squared
  // deviations) of the tile's 64 values, at (t * bp + b) * 2
  T *h, *qkv, *af, *qc, *t1;
  float *pstats, *parts, *cm, *cl, *cacc;
  int* ctr;                     // [tiles][(b, h)]
  int* place;                   // each block's SM ([MAX_GRID])
  int L, B, bp, H, d, ff, s_self, s_cross, n_stale, n_cs, max_tiles;
  float eps;
  GemmPlan qkv_p, dd_p, f1_p, f2_p;   // K=d N=3d; K=d N=d; fc1; fc2
  long long* stamps;          // the timeline's buffer, or nullptr
  int n_stamps;               // its capacity in (kind, time) pairs
};

// 16 consecutive K/V elements of one key, as loaded (16-byte loads).
template <typename T>
struct Row16 {
  static constexpr int WORDS = 16 * sizeof(T) / 16;
  uint4 w[WORDS];
  __device__ __forceinline__ void fetch(const T* p) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void unpack(float* out) const {
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        out[4 * i] = __uint_as_float(w[i].x);
        out[4 * i + 1] = __uint_as_float(w[i].y);
        out[4 * i + 2] = __uint_as_float(w[i].z);
        out[4 * i + 3] = __uint_as_float(w[i].w);
      }
    } else {   // a bf16 value is the high half of its fp32
#pragma unroll
      for (int i = 0; i < WORDS; ++i) {
        const unsigned u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
          out[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
        }
      }
    }
  }
};

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

// 8 consecutive T values from global memory through L2, as fp32
__device__ __forceinline__ void ldcg8(const float* p, float (&v)[8]) {
  *reinterpret_cast<float4*>(v) = __ldcg(reinterpret_cast<const float4*>(p));
  *reinterpret_cast<float4*>(v + 4) =
      __ldcg(reinterpret_cast<const float4*>(p + 4));
}
__device__ __forceinline__ void ldcg8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
// ... and 8 fp32 values (exact in T) stored as T
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(wt::pack_bf16(v[0], v[1]), wt::pack_bf16(v[2], v[3]),
                 wt::pack_bf16(v[4], v[5]), wt::pack_bf16(v[6], v[7]));
}
template <typename T>
__device__ __forceinline__ float ldcg1(const T* p) {
  if constexpr (sizeof(T) == 4) return __ldcg(p);
  else return __uint_as_float((unsigned)__ldcg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ float gelu_erf(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// Whether this block is the last of `n` to arrive at *counter (which it
// then resets to 0). Every thread calls it after its writes: the block
// barrier orders them before thread 0's fence and arrival (the pattern of
// a grid barrier), and the last block's fence orders its later reads
// (through L2: cp.async, __ldcg) after everyone's writes.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n,
                                               int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int last = atomicAdd(counter, 1) == n - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

// `count` floats from global src (16-byte aligned; read through L2) to
// shared dst, 16 bytes a thread-copy; the last copy may read up to three
// floats past `count`, which the scratch layout pads.
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int count) {
  for (int i = threadIdx.x; 4 * i < count; i += THREADS)
    cp_async16(smem_addr(dst + 4 * i), src + 4 * i, 16);
}

// Row b's LayerNorm (mean, 1/std) from the per-tile partials of its T
// tiles of 64 values, p[t * stride] = (mean_t, M2_t), merged in tile
// order: mean = sum mean_t / T, M2 = sum M2_t + 64 sum (mean_t - mean)^2,
// var = M2 / d (the JAX kernel's _ln: the mean of the squared deviations).
__device__ __forceinline__ float2 merge_stats(const float* p, int stride,
                                             int T, float eps) {
  float mean = 0.f;
  for (int t = 0; t < T; ++t) mean += p[t * stride];
  mean /= T;
  float m2 = 0.f, dev = 0.f;
  for (int t = 0; t < T; ++t) {
    const float dm = p[t * stride] - mean;
    m2 += p[t * stride + 1];
    dev += dm * dm;
  }
  return make_float2(mean, rsqrtf((m2 + NT * dev) / (T * NT) + eps));
}

// (mean, M2) of 64 values spread 8 a lane over 8 neighbouring lanes (lane
// % 8), reduced in a fixed order; every lane of the warp calls it.
__device__ __forceinline__ float2 tile_stats(const float (&v)[8]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s += v[e];
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / NT;
  float m2 = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) m2 += (v[e] - mean) * (v[e] - mean);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  return make_float2(mean, m2);
}

enum Epi { E_QKV, E_RESID, E_GELU };

// out (B, N) from X (B, K) @ W (K, N) for every 64-column tile. X is an
// fp32 scratch array (row stride K); with `ln_g` it is h, normalised as it
// is staged with the row statistics merged from h's per-tile partials and
// (ln_g, ln_b). The tile's epilogue: v = rnd(rnd(sum) + rnd(bias)), then
// E_QKV: out = v; E_GELU: out = rnd(gelu(v)); E_RESID: h = rnd(h + v) and
// the tile's partial statistics for the next LayerNorm (h_out = h instead
// when `last`). bf16 products run on the tensor cores (mma.sync: warp w
// owns columns 8w..8w+7 of the 32 rows of a pass); fp32 ones on the CUDA
// cores (warp w owns rows 4w..4w+3, each lane two columns).
template <typename T, int EPI>
__device__ void gemm_phase(const Args<T>& a, const T* W, int K, int N,
                           GemmPlan plan, const T* x, const float* ln_g,
                           const float* ln_b, const float* bias, T* out,
                           bool last, int slot, uint8_t* tile, int* flag) {
  constexpr bool TC = sizeof(T) == 2;
  constexpr int WLD = ItemLayout<T>::WLD;
  const int ntiles = N / NT, kc = plan.kc, ks = plan.ks, B = a.B;
  const int items = ntiles * ks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int T_d = a.d / NT;                       // tiles of h
  const ItemLayout<T> lay(kc, T_d);
  const int xld = lay.xld;
  float* pst = reinterpret_cast<float*>(tile);              // [T_d][RB][2]
  float* st = reinterpret_cast<float*>(tile + lay.st);      // [RB][2]
  T* ws = reinterpret_cast<T*>(tile + lay.ws);              // [kc][WLD]
  T* xs = reinterpret_cast<T*>(tile + lay.xs);              // [RB][xld]
  float* lnv = reinterpret_cast<float*>(tile + lay.lnv);    // g[kc], b[kc]
  float* sums = reinterpret_cast<float*>(tile + lay.sums);  // [RB][NT]
  float* fs = reinterpret_cast<float*>(tile);               // partial sums
  constexpr int W_PIECES = NT * sizeof(T) / 16;   // 16-byte copies a row
  const int g = lane >> 2, t4 = lane & 3;         // mma fragment lane
  const int fr = tid / 8, fc = 8 * (tid % 8);     // epilogue: row, columns

  // The epilogue of row r0 + fr, columns n0 + fc .. + 7, from their sums.
  // Every thread of the block calls it (tile_stats shuffles).
  auto finish = [&](int r0, int rb, int n0, int tile_i, const float (&sum)[8]) {
    float o[8] = {};
    if (fr < rb) {
      const size_t at = (size_t)(r0 + fr) * N + n0 + fc;
      float bv[8], hv[8] = {};
      *reinterpret_cast<float4*>(bv) = __ldg(reinterpret_cast<const float4*>(bias + n0 + fc));
      *reinterpret_cast<float4*>(bv + 4) =
          __ldg(reinterpret_cast<const float4*>(bias + n0 + fc + 4));
      if (EPI == E_RESID) ldcg8(a.h + at, hv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = rnd<T>(rnd<T>(sum[e]) + rnd<T>(bv[e]));
        if constexpr (EPI == E_QKV) o[e] = v;
        else if constexpr (EPI == E_GELU) o[e] = rnd<T>(gelu_erf(v));
        else o[e] = rnd<T>(hv[e] + v);
      }
      st8((EPI == E_RESID ? a.h : out) + at, o);
      if (EPI == E_RESID && last) st8(a.h_out + at, o);
    }
    if (EPI == E_RESID && !last) {
      // this tile's share of the next LayerNorm's statistics
      const float2 ts = tile_stats(o);
      if (fr < rb && tid % 8 == 0)
        *reinterpret_cast<float2*>(a.pstats +
                                   ((size_t)tile_i * a.bp + r0 + fr) * 2) = ts;
    }
  };

  for (int it = slot; it < items; it += gridDim.x) {
    const int tile_i = it % ntiles, q = it / ntiles;
    const int n0 = tile_i * NT, k0 = q * kc, kn = min(kc, K - k0);
    // the weight chunk (rows past K zero-filled) and LayerNorm vectors
    for (int id = tid; id < kc * W_PIECES; id += THREADS) {
      const int r = id / W_PIECES, c = id % W_PIECES;
      const bool live = r < kn;
      cp_async16(smem_addr(ws + r * WLD) + 16 * c,
                 W + (live ? (size_t)(k0 + r) * N + n0 : 0) +
                     c * (16 / sizeof(T)),
                 live ? 16 : 0);
    }
    if (ln_g != nullptr) {
      copy_floats(lnv, ln_g + k0, kn);
      copy_floats(lnv + kc, ln_b + k0, kn);
    }
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int rb = min(RB, B - r0);
      // X rows [r0, r0 + rb) x columns [k0, k0 + kn) of T, through L2
      // (rows past rb, columns past kn: zeros)
      constexpr int EPP = 16 / sizeof(T);         // elements a 16-byte copy
#pragma unroll 1
      for (int r = warp; r < RB; r += WARPS)
#pragma unroll 1
        for (int c = EPP * lane; c < kc; c += 32 * EPP) {
          const bool live = r < rb && c < kn;
          cp_async16(smem_addr(xs + r * xld + c),
                     x + (live ? (size_t)(r0 + r) * K + k0 + c : 0),
                     live ? 16 : 0);
        }
      if (ln_g != nullptr)
        for (int t = 0; t < T_d; ++t)
          copy_floats(pst + t * 2 * RB, a.pstats + (t * a.bp + r0) * 2,
                      2 * rb);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (ln_g != nullptr) {      // y = rnd(LN(h)) in place, from the
        if (tid < rb) {           // merged row statistics
          const float2 ms = merge_stats(pst + 2 * tid, 2 * RB, T_d, a.eps);
          st[2 * tid] = ms.x;
          st[2 * tid + 1] = ms.y;
        }
        __syncthreads();
#pragma unroll 1
        for (int r = warp; r < rb; r += WARPS) {
          const float mean = st[2 * r], inv = st[2 * r + 1];
#pragma unroll 1
          for (int k = 2 * lane; k < kn; k += 64) {
            T* p = xs + r * xld + k;
            const float y0 =
                (to_f32<T>(p[0]) - mean) * inv * lnv[k] + lnv[kc + k];
            const float y1 =
                (to_f32<T>(p[1]) - mean) * inv * lnv[k + 1] + lnv[kc + k + 1];
            p[0] = from_f32<T>(y0);
            p[1] = from_f32<T>(y1);
          }
        }
        __syncthreads();
      }
      // the chunk's products: 8 sums a thread, v[i] at row pr(i), columns
      // pc(i), pc(i) + 1 of the tile
      float v[4][2] = {};
      const auto pr = [&](int i) {
        return TC ? 16 * (i / 2) + g + 8 * (i % 2) : 4 * warp + i;
      };
      const int pc = TC ? 8 * warp + 2 * t4 : 2 * lane;
      if constexpr (TC) {
#pragma unroll 1
        for (int k = 0; k < kn; k += 16) {
          uint32_t bf[2];
          wt::ldmatrix_x2_trans(
              bf, smem_addr(ws + (k + (lane & 15)) * WLD + 8 * warp));
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // A's four 8 x 8 blocks: rows 16m + (0..7 | 8..15), columns
            // k + (0..7 | 8..15), lanes 8j..8j+7 giving block j's rows
            uint32_t af[4];
            wt::ldmatrix_x4(af, smem_addr(xs + (16 * m + 8 * ((lane >> 3) & 1) +
                                               (lane & 7)) * xld +
                                          k + 8 * (lane >> 4)));
            // each 16-deep product from zero, then an fp32 add: the
            // tensor core sums within the block only
            float d[4] = {};
            wt::mma_m16n8k16(d, af, bf);
            v[2 * m][0] += d[0];
            v[2 * m][1] += d[1];
            v[2 * m + 1][0] += d[2];
            v[2 * m + 1][1] += d[3];
          }
        }
      } else {
        const float* xr = reinterpret_cast<const float*>(xs) + 4 * warp * xld;
#pragma unroll 1
        for (int k = 0; k < kn; k += 4) {
          float2 w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = load2<T>(ws + (k + u) * WLD + pc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + i * xld + k);
            float s0 = v[i][0], s1 = v[i][1];
            s0 = fmaf(xv.x, w[0].x, s0);
            s1 = fmaf(xv.x, w[0].y, s1);
            s0 = fmaf(xv.y, w[1].x, s0);
            s1 = fmaf(xv.y, w[1].y, s1);
            s0 = fmaf(xv.z, w[2].x, s0);
            s1 = fmaf(xv.z, w[2].y, s1);
            s0 = fmaf(xv.w, w[3].x, s0);
            s1 = fmaf(xv.w, w[3].y, s1);
            v[i][0] = s0;
            v[i][1] = s1;
          }
        }
      }
      if (ks > 1) {               // partial sums, for the tile's last item
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (pr(i) < rb)
            *reinterpret_cast<float2*>(a.parts +
                                       ((size_t)q * B + r0 + pr(i)) * N + n0 +
                                       pc) = make_float2(v[i][0], v[i][1]);
      } else {                    // the whole K: the epilogue here, the
        __syncthreads();          // sums passing through shared memory
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float2*>(sums + pr(i) * NT + pc) =
              make_float2(v[i][0], v[i][1]);
        __syncthreads();
        float sum[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[e] = sums[fr * NT + fc + e];
        finish(r0, rb, n0, tile_i, sum);
      }
      __syncthreads();            // xs (and ws after the last pass) read
    }
    if (ks == 1) continue;

    // The tile's last item to finish sums its ks partials in chunk order,
    // staged GK at a time in shared memory; thread t owns row t / 8 and 8
    // columns of each pass.
    if (!last_to_arrive(a.ctr + tile_i, ks, flag)) continue;
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int rb = min(RB, B - r0);
      float sum[8] = {};
      for (int g0 = 0; g0 < ks; g0 += GK) {
        const int ng = min(GK, ks - g0);
        // rows (j, rr) of 64 floats, 16 copies a row, a warp 2 rows
#pragma unroll 1
        for (int row = 2 * warp + lane / 16; row < ng * RB; row += 2 * WARPS) {
          const int j = row / RB, rr = row % RB, cc = 4 * (lane % 16);
          if (rr < rb)
            cp_async16(smem_addr(fs + row * NT + cc),
                       a.parts + ((size_t)(g0 + j) * B + r0 + rr) * N + n0 + cc,
                       16);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (fr < rb)
#pragma unroll 1
          for (int j = 0; j < ng; ++j)
#pragma unroll
            for (int e = 0; e < 8; ++e) sum[e] += fs[(j * RB + fr) * NT + fc + e];
        __syncthreads();
      }
      finish(r0, rb, n0, tile_i, sum);
    }
  }
}

// Online softmax over keys [j0, j1) of one (b, h)'s contiguous (S, D)
// rows, q pre-scaled in sm.qs. Warp w reads the keys j0 + 64 g + 8 w ..
// + 7 (g = 0, 1, ...), 4 lanes a key (16 dims each), through its own
// WarpRing with STAGES - 1 groups in flight, so the warps need no block
// barrier while they read. Leaves the block's 64-wide accumulator, m and l
// in sm.acc, all threads synchronised.
template <typename T>
__device__ void attend(const T* kb, const T* vb, int j0, int j1,
                       uint8_t* ring, Small& sm) {
  using R = WarpRing<T>;
  constexpr int PIECES = R::ROW / 16;              // 16-byte copies a row
  constexpr int STEP = WARPS * KEYS_PER_WARP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane % LANES_PER_KEY, kl = lane / LANES_PER_KEY;
  const int first = j0 + warp * KEYS_PER_WARP;     // this warp's first key
  const int n_groups = j1 > first ? (j1 - first + STEP - 1) / STEP : 0;
  uint8_t* wring = ring + warp * R::STAGES * R::GROUP;
  auto load = [&](int g) {
    uint8_t* dst = wring + (g % R::STAGES) * R::GROUP;
#pragma unroll
    for (int i = 0; i < 2 * KEYS_PER_WARP * PIECES / 32; ++i) {
      const int id = lane + 32 * i;
      const int row = id / PIECES, c = id % PIECES;   // rows: 8 K, then 8 V
      const int j = first + g * STEP + row % KEYS_PER_WARP;
      const bool live = j < j1;
      cp_async16(smem_addr(dst + row * R::ROW + 16 * c),
                 (row < KEYS_PER_WARP ? kb : vb) +
                     (size_t)(live ? j : j0) * HEAD_DIM + c * (16 / sizeof(T)),
                 live ? 16 : 0);
    }
  };
#pragma unroll
  for (int g = 0; g < R::STAGES - 1; ++g) {
    if (g < n_groups) load(g);
    cp_async_commit();
  }
  float q[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) q[i] = sm.qs[seg * SEG + i];
  float m = MASK_VALUE, l = 0.f, acc[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int g = 0; g < n_groups; ++g) {
    // group g has landed (every lane's copies); the warp barrier also
    // frees group g - 1's stage
    cp_async_wait<R::STAGES - 2>();
    __syncwarp();
    if (g + R::STAGES - 1 < n_groups) load(g + R::STAGES - 1);
    cp_async_commit();
    const uint8_t* grp = wring + (g % R::STAGES) * R::GROUP;
    Row16<T> kr16, vr16;
    kr16.fetch(reinterpret_cast<const T*>(grp + kl * R::ROW) + seg * SEG);
    vr16.fetch(reinterpret_cast<const T*>(grp + (KEYS_PER_WARP + kl) * R::ROW) +
               seg * SEG);
    float kr[SEG], vr[SEG];
    kr16.unpack(kr);
    vr16.unpack(vr);
    const bool valid = first + g * STEP + kl < j1;
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
  cp_async_wait<0>();
#pragma unroll
  for (int off = LANES_PER_KEY; off < 32; off *= 2) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (kl == 0) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) sm.acc_w[warp][seg * SEG + i] = acc[i];
    if (seg == 0) {
      sm.m_w[warp] = m;
      sm.l_w[warp] = l;
    }
  }
  __syncthreads();
  if (threadIdx.x < HEAD_DIM) {
    float mm = MASK_VALUE;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm.m_w[w]);
    float ll = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sm.m_w[w] - mm);
      ll += sm.l_w[w] * e;
      o += sm.acc_w[w][threadIdx.x] * e;
    }
    sm.acc[threadIdx.x] = o;
    if (threadIdx.x == 0) {
      sm.acc[HEAD_DIM] = mm;
      sm.acc[HEAD_DIM + 1] = ll;
    }
  }
  __syncthreads();
}

// Self-attention of layer l, one item per (b, h).
template <typename T>
__device__ void self_phase(const Args<T>& a, int l, int slot, uint8_t* ring,
                           Small& sm) {
  const int d = a.d, H = a.H, B = a.B;
  const float scale = rsqrtf((float)HEAD_DIM);
  for (int it = slot; it < B * H; it += gridDim.x) {
    const int b = it / H, h = it % H;
    if (threadIdx.x < 3 * HEAD_DIM) {
      const int which = threadIdx.x / HEAD_DIM, c = threadIdx.x % HEAD_DIM;
      sm.qkv[threadIdx.x] =
          ldcg1(a.qkv + (size_t)b * 3 * d + which * d + h * HEAD_DIM + c);
    }
    __syncthreads();
    const size_t row = (((size_t)l * B + b) * H + h);
    if (threadIdx.x < HEAD_DIM) {
      const int c = threadIdx.x;
      a.knew[row * HEAD_DIM + c] = from_f32<T>(sm.qkv[HEAD_DIM + c]);
      a.vnew[row * HEAD_DIM + c] = from_f32<T>(sm.qkv[2 * HEAD_DIM + c]);
      sm.qs[c] = sm.qkv[c] * scale;
    }
    __syncthreads();
    if (threadIdx.x < 32) {      // the current token's score
      float s = sm.qs[threadIdx.x] * sm.qkv[HEAD_DIM + threadIdx.x] +
                sm.qs[threadIdx.x + 32] * sm.qkv[HEAD_DIM + threadIdx.x + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (threadIdx.x == 0) sm.s_new = s;
    }
    const size_t base = row * a.s_self * HEAD_DIM;
    attend<T>(a.sk + base, a.sv + base, 0, a.n_stale, ring, sm);
    if (threadIdx.x < HEAD_DIM) {
      // seed term: m = s_new, l = 1, acc = v_new (:208-214)
      const float m = sm.acc[HEAD_DIM], s_new = sm.s_new;
      const float mm = fmaxf(m, s_new);
      const float e_c = expf(m - mm), e_s = expf(s_new - mm);
      const float den = sm.acc[HEAD_DIM + 1] * e_c + e_s;
      const float o = sm.acc[threadIdx.x] * e_c +
                      sm.qkv[2 * HEAD_DIM + threadIdx.x] * e_s;
      a.af[(size_t)b * d + h * HEAD_DIM + threadIdx.x] =
          from_f32<T>(o / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

// Cross-attention of layer l: one item per (b, h, key split); the last
// split of a (b, h) to finish merges the partials in split order into af.
template <typename T>
__device__ void cross_phase(const Args<T>& a, int l, int slot, uint8_t* ring,
                            Small& sm) {
  const int d = a.d, H = a.H, B = a.B, S = a.s_cross, n_cs = a.n_cs;
  int* bh_ctr = a.ctr + a.max_tiles;
  const float scale = rsqrtf((float)HEAD_DIM);
  const int per = (S + n_cs - 1) / n_cs;
  for (int it = slot; it < B * H * n_cs; it += gridDim.x) {
    const int bh = it / n_cs, split = it % n_cs;
    const int b = bh / H, h = bh % H;
    if (threadIdx.x < HEAD_DIM)
      sm.qs[threadIdx.x] =
          ldcg1(a.qc + (size_t)b * d + h * HEAD_DIM + threadIdx.x) * scale;
    __syncthreads();
    const size_t base = (((size_t)l * B + b) * H + h) * S * HEAD_DIM;
    const int j0 = split * per, j1 = min(S, j0 + per);
    attend<T>(a.ck + base, a.cv + base, j0, j1, ring, sm);
    T* out = a.af + (size_t)b * d + h * HEAD_DIM;
    if (n_cs == 1) {
      if (threadIdx.x < HEAD_DIM)
        out[threadIdx.x] = from_f32<T>(sm.acc[threadIdx.x] /
                                       fmaxf(sm.acc[HEAD_DIM + 1], 1e-30f));
      __syncthreads();
      continue;
    }
    if (threadIdx.x < HEAD_DIM) {
      a.cacc[(size_t)it * HEAD_DIM + threadIdx.x] = sm.acc[threadIdx.x];
      if (threadIdx.x == 0) {
        a.cm[it] = sm.acc[HEAD_DIM];
        a.cl[it] = sm.acc[HEAD_DIM + 1];
      }
    }
    if (last_to_arrive(bh_ctr + bh, n_cs, &sm.flag) &&
        threadIdx.x < HEAD_DIM) {
      const int i0 = bh * n_cs;
      float mm = MASK_VALUE;
      for (int s = 0; s < n_cs; ++s) mm = fmaxf(mm, __ldcg(a.cm + i0 + s));
      float den = 0.f, num = 0.f;
      for (int s = 0; s < n_cs; ++s) {
        const float e = expf(__ldcg(a.cm + i0 + s) - mm);
        den += __ldcg(a.cl + i0 + s) * e;
        num += __ldcg(a.cacc + (size_t)(i0 + s) * HEAD_DIM + threadIdx.x) * e;
      }
      out[threadIdx.x] = from_f32<T>(num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

// This block's slot: the order in which the phases hand it items. The
// card places consecutive blocks on a few SMs, so a phase of a few items
// would run two to an SM on a few SMs;
// instead the first block on every SM takes the first items, in SM order,
// then the second blocks. From the SM ids the prologue left in a.place:
// rank = the blocks before this one on its SM, slot = the blocks of lower
// (rank, SM). Every thread of the block calls it; `ids` holds 2 MAX_GRID
// ints of shared memory.
template <typename T>
__device__ int grid_slot(const Args<T>& a, int* ids) {
  const int G = gridDim.x;
  for (int b = threadIdx.x; b < G; b += THREADS) ids[b] = __ldcg(a.place + b);
  __syncthreads();
  int* rank = ids + MAX_GRID;
  for (int b = threadIdx.x; b < G; b += THREADS) {
    int r = 0;
    for (int c = 0; c < b; ++c) r += ids[c] == ids[b];
    rank[b] = r;
  }
  __syncthreads();
  const int me = blockIdx.x, my_rank = rank[me], my_sm = ids[me];
  int slot = 0;
  for (int b0 = 0; b0 < G; b0 += THREADS) {
    const int b = b0 + threadIdx.x;
    slot += __syncthreads_count(
        b < G && (rank[b] < my_rank || (rank[b] == my_rank && ids[b] < my_sm)));
  }
  return slot;
}

// Prologue: h = h0 in fp32 and its per-tile statistics for LN1, the
// counters zeroed. Block per row; warp w takes the row's tiles w, w + 8, ...
template <typename T>
__device__ void prologue(const Args<T>& a) {
  const int d = a.d, lane = threadIdx.x % 32;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.max_tiles + a.B * a.H; i += THREADS)
      a.ctr[i] = 0;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    a.place[blockIdx.x] = (int)sm;
  }
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    for (int t = threadIdx.x / 32; t < d / NT; t += WARPS) {
      // lanes 8k..8k+7 of the warp: the tile's 64 values, 8 a lane, as
      // tile_stats takes them (each 8-lane group reduces the same tile)
      const int n = t * NT + 8 * (lane % 8);
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = to_f32<T>(a.h0[(size_t)b * d + n + e]);
      const float2 ts = tile_stats(v);
      if (lane < 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) a.h[(size_t)b * d + n + e] = a.h0[(size_t)b * d + n + e];
      }
      if (lane == 0)
        *reinterpret_cast<float2*>(a.pstats + ((size_t)t * a.bp + b) * 2) = ts;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fused_step_kernel(const Args<T> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tile = smem;                                  // TILE_BYTES
  Small& sm = *reinterpret_cast<Small*>(smem + TILE_BYTES);
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, ff = a.ff;
  const size_t P = 13 * (size_t)d + ff;
  // offsets into a layer's vec row (ops/decoder_step.py vec_offsets)
  const int o_fc1b = 3 * d, o_cqb = 3 * d + ff, o_ob = 4 * d + ff,
            o_cob = 5 * d + ff, o_fc2b = 6 * d + ff, o_ln = 7 * d + ff;
  Timeline tl{a.stamps, a.n_stamps, 0};
  tl.stamp(P_START);

  prologue(a);
  grid.sync();
  tl.stamp(P_ROWS);
  const int slot = grid_slot(a, reinterpret_cast<int*>(tile));
  for (int l = 0; l < a.L; ++l) {
    const float* vec = a.vec + l * P;
    const bool last = l == a.L - 1;
    gemm_phase<T, E_QKV>(a, a.wqkv + (size_t)l * d * 3 * d, d, 3 * d, a.qkv_p,
                         a.h, vec + o_ln, vec + o_ln + d, vec, a.qkv, false,
                         slot, tile, &sm.flag);
    grid.sync();
    tl.stamp(P_QKV);
    self_phase<T>(a, l, slot, tile, sm);
    grid.sync();
    tl.stamp(P_SELF);
    gemm_phase<T, E_RESID>(a, a.wo + (size_t)l * d * d, d, d, a.dd_p, a.af,
                           nullptr, nullptr, vec + o_ob, nullptr, false, slot,
                           tile, &sm.flag);
    grid.sync();
    tl.stamp(P_O);
    gemm_phase<T, E_QKV>(a, a.wcq + (size_t)l * d * d, d, d, a.dd_p, a.h,
                         vec + o_ln + 2 * d, vec + o_ln + 3 * d, vec + o_cqb,
                         a.qc, false, slot, tile, &sm.flag);
    grid.sync();
    tl.stamp(P_CQ);
    cross_phase<T>(a, l, slot, tile, sm);
    grid.sync();
    tl.stamp(P_CROSS);
    gemm_phase<T, E_RESID>(a, a.wco + (size_t)l * d * d, d, d, a.dd_p, a.af,
                           nullptr, nullptr, vec + o_cob, nullptr, false, slot,
                           tile, &sm.flag);
    grid.sync();
    tl.stamp(P_CO);
    gemm_phase<T, E_GELU>(a, a.fc1 + (size_t)l * d * ff, d, ff, a.f1_p, a.h,
                          vec + o_ln + 4 * d, vec + o_ln + 5 * d,
                          vec + o_fc1b, a.t1, false, slot, tile, &sm.flag);
    grid.sync();
    tl.stamp(P_FC1);
    gemm_phase<T, E_RESID>(a, a.fc2 + (size_t)l * ff * d, ff, d, a.f2_p, a.t1,
                           nullptr, nullptr, vec + o_fc2b, nullptr, last, slot,
                           tile, &sm.flag);
    if (!last) {
      grid.sync();
      tl.stamp(P_FC2);
    }
  }
  if (a.stamps != nullptr) {       // the last fc2, then one barrier alone
    grid.sync();
    tl.stamp(P_FINAL);
    for (int i = 0; i < SYNC_PROBES; ++i) {
      grid.sync();
      tl.stamp(P_SYNC);
    }
  }
}

// K-chunk and chunk count of a gemm. bf16 (tensor-core products): as few
// chunks as the shared memory allows, one where the whole K fits, since
// every further chunk costs the tile a round of partial sums; fp32 (the
// CUDA cores): about one item a block, at most KS_TARGET chunks a tile
// where the shared memory allows, at least KC_MIN deep.
GemmPlan plan_gemm(int K, int N, int grid, int kc_limit, bool tc) {
  const auto up32 = [](int x) { return (x + 31) / 32 * 32; };
  int kc;
  if (tc) {
    kc = std::min(kc_limit, up32(K));
  } else {
    const int ntiles = N / NT;
    const int want = std::max(1, (grid + ntiles - 1) / ntiles);
    kc = up32((K + want - 1) / want);
    kc = std::max({kc, KC_MIN, up32((K + KS_TARGET - 1) / KS_TARGET)});
    kc = std::min({kc, kc_limit, up32(K)});
  }
  const int ks = (K + kc - 1) / kc;
  return {up32((K + ks - 1) / ks), ks};   // chunks of even depth
}

// Cross key splits: the count whose reads finish soonest. Items go to
// the SMs in turn (grid_slot), so an SM streams ceil(items / SMs) of
// them; each costs its keys plus a fixed overhead (the ring's ramp, the
// block's reduction, the merge) of about SPLIT_COST keys: on the H100,
// two splits of tiny b32's 1500-key reads lost to one (chip_smoke.py
// fused_phases), so b32 reads are not split; batch 1 is.
constexpr int SPLIT_COST = 750;
int plan_splits(int rows, int s_cross, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int n = 1; n <= std::min(NCS_MAX, s_cross); ++n) {
    const long long rounds = ((long long)rows * n + sms - 1) / sms;
    const long long cost = rounds * ((s_cross + n - 1) / n + SPLIT_COST);
    if (best_cost < 0 || cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  return best;
}

// Most K-chunks any plan gives for a reduction of depth K.
size_t max_chunks(int K) {
  return (size_t)std::min((K + KC_MIN - 1) / KC_MIN, MAX_KS);
}

struct Layout {
  size_t h, pstats, qkv, af, qc, t1, parts, cm, cl, cacc, ctr, place, total;
  int max_tiles;
};

Layout layout(int B, int H, int d, int ff) {
  Layout o;
  size_t at = 0;
  auto take = [&](size_t n) {
    const size_t start = at;
    at += (n + 3) / 4 * 4;      // 16-byte aligned pieces
    return start;
  };
  o.max_tiles = std::max(3 * d, ff) / NT;
  o.h = take((size_t)B * d);
  o.pstats = take((size_t)2 * ((B + 1) / 2 * 2) * (d / NT));
  o.qkv = take((size_t)B * 3 * d);
  o.af = take((size_t)B * d);
  o.qc = take((size_t)B * d);
  o.t1 = take((size_t)B * ff);
  o.parts = take((size_t)B * std::max({max_chunks(d) * 3 * d,
                                       max_chunks(d) * ff,
                                       max_chunks(ff) * d}));
  o.cm = take((size_t)B * H * NCS_MAX);
  o.cl = take((size_t)B * H * NCS_MAX);
  o.cacc = take((size_t)B * H * NCS_MAX * HEAD_DIM);
  o.ctr = take((size_t)o.max_tiles + B * H);
  o.place = take(MAX_GRID);
  o.total = at;
  return o;
}

template <typename T>
cudaError_t launch_step(Args<T> a, float* scratch, long long scratch_floats,
                        cudaStream_t stream) {
  const Layout lay = layout(a.B, a.H, a.d, a.ff);
  if ((size_t)scratch_floats < lay.total) return cudaErrorInvalidValue;
  a.h = reinterpret_cast<T*>(scratch + lay.h);
  a.pstats = scratch + lay.pstats;
  a.bp = (a.B + 1) / 2 * 2;
  a.qkv = reinterpret_cast<T*>(scratch + lay.qkv);
  a.af = reinterpret_cast<T*>(scratch + lay.af);
  a.qc = reinterpret_cast<T*>(scratch + lay.qc);
  a.t1 = reinterpret_cast<T*>(scratch + lay.t1);
  a.parts = scratch + lay.parts;
  a.cm = scratch + lay.cm;
  a.cl = scratch + lay.cl;
  a.cacc = scratch + lay.cacc;
  a.ctr = reinterpret_cast<int*>(scratch + lay.ctr);
  a.place = reinterpret_cast<int*>(scratch + lay.place);
  a.max_tiles = lay.max_tiles;

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
  if (grid > MAX_GRID) return cudaErrorInvalidConfiguration;

  const int kc_limit = kc_max<T>(a.d / NT);
  const bool tc = sizeof(T) == 2;
  a.qkv_p = plan_gemm(a.d, 3 * a.d, grid, kc_limit, tc);
  a.dd_p = plan_gemm(a.d, a.d, grid, kc_limit, tc);
  a.f1_p = plan_gemm(a.d, a.ff, grid, kc_limit, tc);
  a.f2_p = plan_gemm(a.ff, a.d, grid, kc_limit, tc);
  a.n_cs = plan_splits(a.B * a.H, a.s_cross, sms);
  // the partial sums' room (layout) holds every plan's chunks
  if ((size_t)a.qkv_p.ks > max_chunks(a.d) ||
      (size_t)a.f2_p.ks > max_chunks(a.ff))
    return cudaErrorInvalidValue;
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
// S_cross, D); k_new, v_new (L, B, H, D). D must be 64 and d = H * D, ff
// a multiple of 64; kv_len in [1, S_self] counts the current token, so
// rows < kv_len - 1 of the self cache are read. `stamps`, nullptr in
// every normal call, is a device buffer of n_stamps (kind, ns) int64 pairs
// that receives block 0's timeline (Timeline above).
extern "C" int wt_fused_decoder_step(
    const void* h0, const void* wqkv, const void* wcq, const void* wo,
    const void* wco, const void* fc1, const void* fc2, const void* vec,
    const void* self_k, const void* self_v, const void* cross_k,
    const void* cross_v, void* h_out, void* k_new, void* v_new,
    void* scratch, long long scratch_floats, int L, int B, int H, int D,
    int d, int ff, int s_self, int s_cross, int kv_len, float eps,
    int is_bf16, long long* stamps, int n_stamps, void* stream) {
  if (D != HEAD_DIM || d != H * D || d > T_MAX * NT || ff < 1 ||
      ff % NT != 0 || L < 1 ||
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
    a.stamps = stamps;
    a.n_stamps = n_stamps;
    return launch_step<T>(a, sc, scratch_floats, s);
  };
  return (int)(is_bf16 ? fill((__nv_bfloat16*)nullptr) : fill((float*)nullptr));
}
