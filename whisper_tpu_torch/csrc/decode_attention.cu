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
// Design: a split-key read (flash-decoding). The grid is (B*H, n_split): block
// (bh, s) reads keys [s*chunk, min((s+1)*chunk, kv_len)), n_split and chunk
// being the wrapper's plan (ops/decode_attention.py _split_plan). A read whose
// B*H rows give every SM a block is not split: on the H100 one block per row
// read tiny b32's cross cache (192 rows of 1500 keys) and turbo b32's (640)
// faster than 2 to 8 splits (chip_smoke.py --profile, decode_split_sweep), and
// turbo B=4's 80 rows faster than 4 splits (decode_split_ab). At most half as
// many rows as SMs, as a cross read at batch 1 or a long cache at batch 4,
// split into at most one block an SM, of >= 256 keys each. A block has 8
// warps, or 12 where the read is long and its grid fits two 12-warp blocks an
// SM (tiny b32's cross read: 192 blocks; 12 warps shorten each warp's chain of
// key groups, the cost that sets a one-wave read's time); turbo's 640 blocks
// keep 8 (12 would take three waves), as does a short self read, which is
// launch-bound. A warp takes 8 consecutive keys per step, 4 lanes per key,
// each lane 16 values of K and of V in 16-byte loads (int8: one, bf16: two,
// fp32: four; a warp's loads cover 8 whole rows of each). A lane issues the
// loads of its next key group before the arithmetic of this one, so each warp
// keeps two groups in flight (4 KB a warp in bf16; deeper register rings cost
// the registers of a third block an SM, and lost). A key's score is summed
// over its 4 lanes by shuffles; each warp keeps its own running max (shared by
// its lanes), and each lane its own sum and 16-wide accumulator, rescaled by
// the warp's alpha. At the end of the split the lanes of a warp and then the
// block's warps are combined, the warps through shared memory, into the
// split's (m, l, acc[64]) in fp32.
//
// With one split the block writes out = acc / max(l, 1e-30) itself. With
// more, the n_split blocks of one (b, h) are one thread-block cluster
// (Hopper's, at most 8 blocks: MAX_SPLITS): each leaves its partial in its
// own shared memory, and after a cluster barrier the first block reads
// them all through distributed shared memory and merges them in index
// order (two calls and a graph replay are bitwise equal) and writes out; a
// second barrier keeps every block resident until then. No workspace, no
// counter and nothing in global memory but out, so a read shares no state
// with any other read, on any stream or in any graph. Under P_ROUND, p is
// rounded at the running max of its warp within the split (a single-block
// read rounds it at its warp's over all keys): the rounding moves p by at
// most a bf16 ulp either way, inside the bf16 tolerance.
// decode_attention_bg's block_b rows per program are not a launch shape
// here: at b32 x 6 heads, 8 rows per block would leave 4 blocks for 132
// SMs.

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using wt::from_f32;
using wt::to_f32;

constexpr int HEAD_DIM = 64;
constexpr int MAX_WARPS = 12;                     // a block: 8 or 12 warps
constexpr int LANES_PER_KEY = 4;                  // 16 dims per lane
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY; // keys per warp step
constexpr int SEG = HEAD_DIM / LANES_PER_KEY;     // 16
constexpr int MAX_SPLITS = 8;   // blocks in a portable cluster
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// 16 consecutive K/V elements of one key: `load` fetches their bytes in
// WORDS 16-byte loads, `unpack` turns them into fp32.
template <typename KVT>
struct Row16;

template <>
struct Row16<int8_t> {
  static constexpr int WORDS = 1;
  static __device__ __forceinline__ void unpack(const uint4 (&u)[WORDS],
                                                float* out) {
    const unsigned w[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = (float)static_cast<signed char>(w[i] >> (8 * b));
  }
};

// bf16: a bf16 value is the high half of its fp32.
template <>
struct Row16<__nv_bfloat16> {
  static constexpr int WORDS = 2;
  static __device__ __forceinline__ void unpack(const uint4 (&u)[WORDS],
                                                float* out) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const unsigned w[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
        out[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
};

template <>
struct Row16<float> {
  static constexpr int WORDS = 4;
  static __device__ __forceinline__ void unpack(const uint4 (&u)[WORDS],
                                                float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = __uint_as_float(u[i].x);
      out[4 * i + 1] = __uint_as_float(u[i].y);
      out[4 * i + 2] = __uint_as_float(u[i].z);
      out[4 * i + 3] = __uint_as_float(u[i].w);
    }
  }
};

// One lane's share of one key: its 16 values of K and of V as loaded, and
// the key's scales (int8).
template <typename KVT, bool SCALED>
struct KeyLoad {
  static constexpr int WORDS = Row16<KVT>::WORDS;
  uint4 k[WORDS], v[WORDS];
  float ks, vs;

  __device__ __forceinline__ void fetch(const KVT* kp, const KVT* vp,
                                        const float* ksp, const float* vsp,
                                        int j) {
    const uint4* ku = reinterpret_cast<const uint4*>(kp + (long long)j *
                                                     HEAD_DIM);
    const uint4* vu = reinterpret_cast<const uint4*>(vp + (long long)j *
                                                     HEAD_DIM);
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      k[i] = ku[i];
      v[i] = vu[i];
    }
    if (SCALED) {
      ks = ksp[j];
      vs = vsp[j];
    }
  }
};

template <typename QT, typename KVT, bool SCALED, bool P_ROUND,
          bool KV_ROUND, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
              const float* __restrict__ k_scale, const KVT* __restrict__ v,
              const float* __restrict__ v_scale, QT* __restrict__ out,
              int s_len, int kv_len, int chunk, float scale) {
  __shared__ float m_w[WARPS], l_w[WARPS];
  __shared__ float acc_w[WARPS][HEAD_DIM];
  __shared__ float part[HEAD_DIM + 2];             // acc[64], m, l

  const long long bh = blockIdx.x;                 // b * H + h
  const int split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int keys_per_step = WARPS * KEYS_PER_WARP;
  const int seg = lane % LANES_PER_KEY;            // this lane's 16 dims
  const int kl = lane / LANES_PER_KEY;             // its key in the step
  const KVT* kb = k + bh * s_len * HEAD_DIM + seg * SEG;
  const KVT* vb = v + bh * s_len * HEAD_DIM + seg * SEG;
  const float* ksb = SCALED ? k_scale + bh * s_len : nullptr;
  const float* vsb = SCALED ? v_scale + bh * s_len : nullptr;
  const int j_begin = split * chunk;
  const int j_end = min(j_begin + chunk, kv_len);

  float qs[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i)
    qs[i] = to_f32<QT>(q[bh * HEAD_DIM + seg * SEG + i]) * scale;

  float m = MASK_VALUE, l = 0.f, acc[SEG];
#pragma unroll
  for (int i = 0; i < SEG; ++i) acc[i] = 0.f;

  // two key groups in flight: group g + 1's loads are issued before group
  // g's arithmetic
  KeyLoad<KVT, SCALED> cur, nxt;
  {
    const int j = j_begin + warp * KEYS_PER_WARP + kl;
    if (j < j_end) cur.fetch(kb, vb, ksb, vsb, j);
  }
  for (int j0 = j_begin + warp * KEYS_PER_WARP; j0 < j_end;
       j0 += keys_per_step) {
    const int j = j0 + kl;
    const bool valid = j < j_end;
    if (j + keys_per_step < j_end)
      nxt.fetch(kb, vb, ksb, vsb, j + keys_per_step);
    float kr[SEG], vr[SEG], ks = 1.f, vs = 1.f;
    Row16<KVT>::unpack(cur.k, kr);
    Row16<KVT>::unpack(cur.v, vr);
    if constexpr (KV_ROUND) {
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        kr[i] = wt::rnd<QT>(kr[i]);
        vr[i] = wt::rnd<QT>(vr[i]);
      }
    }
    if (SCALED) {
      ks = cur.ks;
      vs = cur.vs;
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
    cur = nxt;
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

  // the block's warps: thread d < 64 holds the split's (mm, ll, o) for dim
  // d
  const int d = threadIdx.x;
  float mm = MASK_VALUE, ll = 0.f, o = 0.f;
  if (d < HEAD_DIM) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_w[w]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(m_w[w] - mm);
      ll += l_w[w] * a;
      o += acc_w[w][d] * a;
    }
  }
  if (n_split == 1) {
    if (d < HEAD_DIM)
      out[bh * HEAD_DIM + d] = from_f32<QT>(o / fmaxf(ll, 1e-30f));
    return;
  }

  // the split's partial stays in this block's shared memory; the
  // cluster's first block merges the n_split partials in index order
  if (d < HEAD_DIM) part[d] = o;
  if (d == 0) {
    part[HEAD_DIM] = mm;
    part[HEAD_DIM + 1] = ll;
  }
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && d < HEAD_DIM) {
    float big = MASK_VALUE;
    for (int s = 0; s < n_split; ++s)
      big = fmaxf(big, cluster.map_shared_rank(part, s)[HEAD_DIM]);
    float lt = 0.f, ot = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = cluster.map_shared_rank(part, s);
      const float a = expf(ps[HEAD_DIM] - big);
      lt += ps[HEAD_DIM + 1] * a;
      ot += ps[d] * a;
    }
    out[bh * HEAD_DIM + d] = from_f32<QT>(ot / fmaxf(lt, 1e-30f));
  }
  cluster.sync();        // each block's partial stays until it was read
}

// The plan the wrapper passes: 8 or 12 warps a block, and one split or
// 2..MAX_SPLITS splits of `chunk` keys, none empty, covering [0, kv_len).
bool plan_ok(int kv_len, int n_split, int chunk, int warps) {
  if (warps != 8 && warps != MAX_WARPS) return false;
  if (n_split == 1) return chunk >= kv_len;
  return n_split > 1 && n_split <= MAX_SPLITS && chunk > 0 &&
         (long long)(n_split - 1) * chunk < kv_len &&
         (long long)n_split * chunk >= kv_len;
}

struct Split {
  int n, chunk, warps;
};

template <typename QT, typename KVT, bool SCALED, bool P_ROUND, bool KV_ROUND,
          int WARPS>
cudaError_t launch_warps(const void* q, const void* k, const void* ks,
                         const void* v, const void* vs, void* out,
                         long long bh, int s_len, int kv_len, Split sp,
                         cudaStream_t stream) {
  auto kernel = decode_kernel<QT, KVT, SCALED, P_ROUND, KV_ROUND, WARPS>;
  const float scale = 1.0f / sqrtf((float)HEAD_DIM);
  if (sp.n == 1) {
    kernel<<<(unsigned)bh, 32 * WARPS, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const KVT*>(k),
        static_cast<const float*>(ks), static_cast<const KVT*>(v),
        static_cast<const float*>(vs), static_cast<QT*>(out), s_len, kv_len,
        sp.chunk, scale);
    return cudaGetLastError();
  }
  // the n splits of one (b, h) as one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bh, sp.n);
  cfg.blockDim = dim3(32 * WARPS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = sp.n;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const float*>(ks), static_cast<const KVT*>(v),
      static_cast<const float*>(vs), static_cast<QT*>(out), s_len, kv_len,
      sp.chunk, scale);
}

// One launch of the instantiation for these types and flags, with the
// plan's 8 or MAX_WARPS warps a block.
template <typename QT, typename KVT, bool SCALED, bool P_ROUND = false,
          bool KV_ROUND = false>
cudaError_t launch(const void* q, const void* k, const void* ks,
                   const void* v, const void* vs, void* out, long long bh,
                   int s_len, int kv_len, Split sp, cudaStream_t stream) {
  return sp.warps == MAX_WARPS
             ? launch_warps<QT, KVT, SCALED, P_ROUND, KV_ROUND, MAX_WARPS>(
                   q, k, ks, v, vs, out, bh, s_len, kv_len, sp, stream)
             : launch_warps<QT, KVT, SCALED, P_ROUND, KV_ROUND, 8>(
                   q, k, ks, v, vs, out, bh, s_len, kv_len, sp, stream);
}

template <typename QT, typename KVT, bool P_ROUND, bool KV_ROUND>
cudaError_t launch_kv(const void* q, const void* k, const void* v, void* out,
                      long long bh, int s_len, int kv_len, Split sp,
                      cudaStream_t stream) {
  return launch<QT, KVT, false, P_ROUND, KV_ROUND>(
      q, k, nullptr, v, nullptr, out, bh, s_len, kv_len, sp, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). q, out:
// (B, 1, H, D) fp32 or bf16 (q_is_bf16); k, v: (B, H, S, D) of one dtype,
// fp32 or bf16 (kv_is_bf16); all contiguous, k and v 16-byte aligned;
// D = 64. p_round: round p to V's dtype before the p.v product
// (decode_attention); cast_kv: K/V take q's dtype first
// (decode_attention_bh/_bg). Each flag is a no-op where its rounding is
// exact, and launches the unrounded instantiation there. n_split, chunk,
// warps: the plan.
extern "C" int wt_decode_attention(const void* q, const void* k,
                                   const void* v, void* out, int batch,
                                   int heads, int s_len, int d, int kv_len,
                                   int q_is_bf16, int kv_is_bf16, int p_round,
                                   int cast_kv, int n_split, int chunk,
                                   int warps, void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch < 1 || heads < 1 || s_len < 1 || d != HEAD_DIM || kv_len < 0 ||
      kv_len > s_len || bh > 0x7fffffffLL ||
      !plan_ok(kv_len, n_split, chunk, warps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp{n_split, chunk, warps};
  using bf16 = __nv_bfloat16;
  cudaError_t e;
  if (q_is_bf16 && kv_is_bf16)
    e = p_round ? launch_kv<bf16, bf16, true, false>(q, k, v, out, bh, s_len,
                                                     kv_len, sp, s)
                : launch_kv<bf16, bf16, false, false>(q, k, v, out, bh, s_len,
                                                      kv_len, sp, s);
  else if (q_is_bf16)
    e = cast_kv ? launch_kv<bf16, float, false, true>(q, k, v, out, bh, s_len,
                                                      kv_len, sp, s)
                : launch_kv<bf16, float, false, false>(q, k, v, out, bh,
                                                       s_len, kv_len, sp, s);
  else if (kv_is_bf16)
    e = p_round ? launch_kv<float, bf16, true, false>(q, k, v, out, bh, s_len,
                                                      kv_len, sp, s)
                : launch_kv<float, bf16, false, false>(q, k, v, out, bh,
                                                       s_len, kv_len, sp, s);
  else
    e = launch_kv<float, float, false, false>(q, k, v, out, bh, s_len, kv_len,
                                              sp, s);
  return (int)e;
}

// Returns cudaGetLastError() after the launch (0 on success). q, out:
// (B, 1, H, D) fp32 or bf16 (q_is_bf16); k, v: (B, H, S, D) int8; k_scale,
// v_scale: (B, H, S, 1) fp32; all contiguous and 16-byte aligned; D = 64.
// n_split, chunk, warps: the plan, as wt_decode_attention.
extern "C" int wt_decode_attention_q8(const void* q, const void* k,
                                      const void* k_scale, const void* v,
                                      const void* v_scale, void* out,
                                      int batch, int heads, int s_len, int d,
                                      int kv_len, int q_is_bf16, int n_split,
                                      int chunk, int warps,
                                      void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch < 1 || heads < 1 || s_len < 1 || d != HEAD_DIM || kv_len < 0 ||
      kv_len > s_len || bh > 0x7fffffffLL ||
      !plan_ok(kv_len, n_split, chunk, warps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split sp{n_split, chunk, warps};
  return (int)(q_is_bf16
                   ? launch<__nv_bfloat16, int8_t, true>(
                         q, k, k_scale, v, v_scale, out, bh, s_len, kv_len,
                         sp, s)
                   : launch<float, int8_t, true>(q, k, k_scale, v, v_scale,
                                                 out, bh, s_len, kv_len, sp,
                                                 s));
}
