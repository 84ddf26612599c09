// In-place KV-cache row append for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel whisper_tpu/ops/cache_append.py:62
// cache_append_rows (kernel body _append_kernel, :44), for fp32 and bf16
// caches: write every layer's new K and V row, (L, B, H, D), at row `pos`
// of the (L, B, H, S, D) caches, touching nothing else.
//
// What bounds it on the H100: launch latency. At Whisper-tiny b32 it moves
// 2 x 768 rows x 64 values (~200 KB bf16) per decode step, a sliver of
// what the card streams in the time a launch takes. The design therefore
// does all layers and both caches in ONE launch (the JAX step's single
// batched append after the layer loop), with writes coalesced along D.
//
// Design: one block per 8 consecutive (l, b, h) rows; its 256 threads walk
// the 8 x D elements, so neighbouring threads write neighbouring values of
// a row. The caller checks 0 <= pos < S.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int APPEND_ROWS = 8;      // (l, b, h) rows per block
constexpr int APPEND_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(APPEND_THREADS)
cache_append_kernel(T* __restrict__ cache_k, T* __restrict__ cache_v,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    long long rows, int s_len, int d, int pos) {
  const long long row0 = (long long)blockIdx.x * APPEND_ROWS;
  const int n = APPEND_ROWS * d;
  for (int i = threadIdx.x; i < n; i += APPEND_THREADS) {
    const long long row = row0 + i / d;
    if (row >= rows) return;        // i / d only grows along the loop
    const int c = i % d;
    const size_t src = (size_t)row * d + c;
    const size_t dst = ((size_t)row * s_len + pos) * d + c;
    cache_k[dst] = k_new[src];
    cache_v[dst] = v_new[src];
  }
}

template <typename T>
cudaError_t launch_append(void* ck, void* cv, const void* kn, const void* vn,
                          long long rows, int s_len, int d, int pos,
                          cudaStream_t stream) {
  const long long blocks = (rows + APPEND_ROWS - 1) / APPEND_ROWS;
  cache_append_kernel<T><<<(unsigned)blocks, APPEND_THREADS, 0, stream>>>(
      static_cast<T*>(ck), static_cast<T*>(cv), static_cast<const T*>(kn),
      static_cast<const T*>(vn), rows, s_len, d, pos);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). cache_k,
// cache_v: (rows, S, D); k_new, v_new: (rows, D); rows = L*B*H; all
// contiguous in one element type.
extern "C" int wt_cache_append(void* cache_k, void* cache_v,
                               const void* k_new, const void* v_new,
                               long long rows, int s_len, int d, int pos,
                               int is_bf16, void* stream) {
  if (rows < 1 || d < 1 || pos < 0 || pos >= s_len ||
      (rows + APPEND_ROWS - 1) / APPEND_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_append<__nv_bfloat16>(cache_k, cache_v, k_new,
                                                      v_new, rows, s_len, d,
                                                      pos, s)
                       : launch_append<float>(cache_k, cache_v, k_new, v_new,
                                              rows, s_len, d, pos, s));
}

// Message for a code returned by any wt_* entry point.
extern "C" const char* wt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
