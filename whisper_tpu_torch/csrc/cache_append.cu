// In-place KV-cache row appends for Hopper (sm_90a): the scalar and the
// ragged (per-row position) forms.
//
// wt_cache_append replaces the Pallas TPU kernel
// whisper_tpu/ops/cache_append.py:62 cache_append_rows (kernel body
// _append_kernel, :44), for fp32, bf16 and int8 caches: write every
// layer's new K and V row, (L, B, H, D), at row `pos` of the
// (L, B, H, S, D) caches, touching nothing else. The int8 rows of an int8
// self cache (self_kv_quant) arrive quantized, and their scale rows are
// written beside the launch, as the JAX step does
// (models/whisper.py:1328-1351).
//
// wt_cache_append_ragged replaces :133 cache_append_rows_ragged (body
// _append_ragged_kernel, :117), the continuous-batching engine's append:
// batch row b of every layer lands at its OWN position pos[b]. It takes
// the same three element types; on an int8 self cache (the engine under
// self_kv_quant) the rows arrive quantized and the caller writes their
// scale rows beside the launch, as the JAX step does
// (models/whisper.py:1492-1497).
//
// What bounds it on the H100: launch latency. At Whisper-tiny b32 it moves
// 2 x 768 rows x 64 values (~200 KB bf16) per decode step, a sliver of
// what the card streams in the time a launch takes. The design therefore
// does all layers and both caches in ONE launch (the JAX step's single
// batched append after the layer loop), with writes coalesced along D.
//
// Design: one block per 8 consecutive (l, b, h) rows; its 256 threads walk
// the 8 x D elements, so neighbouring threads write neighbouring values of
// a row. The scalar form's caller checks 0 <= pos < S.
//
// The ragged form has the same bound: at the engine's tiny shape (L=4,
// B=32, H=6, D=64, bf16) it moves 2 x 49,152 values in and out, ~0.39 MB,
// ~0.12 us at 3.35 TB/s, so launch latency sets its time too. Its blocks
// read pos[b] from device memory (the TPU kernel prefetches it as a
// scalar), so the host never reads the positions and the engine step
// needs no device sync. A row whose pos[b] lies outside [0, S) is left
// untouched, as the plain version leaves it.

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
__global__ void __launch_bounds__(APPEND_THREADS)
cache_append_ragged_kernel(T* __restrict__ cache_k, T* __restrict__ cache_v,
                           const T* __restrict__ k_new,
                           const T* __restrict__ v_new,
                           const long long* __restrict__ pos,
                           long long rows, int batch, int heads, int s_len,
                           int d) {
  const long long row0 = (long long)blockIdx.x * APPEND_ROWS;
  const int n = APPEND_ROWS * d;
  for (int i = threadIdx.x; i < n; i += APPEND_THREADS) {
    const long long row = row0 + i / d;   // row = (l * batch + b) * heads + h
    if (row >= rows) return;
    const int b = (int)((row / heads) % batch);
    const long long p = pos[b];
    if (p < 0 || p >= s_len) continue;
    const int c = i % d;
    const size_t src = (size_t)row * d + c;
    const size_t dst = ((size_t)row * s_len + p) * d + c;
    cache_k[dst] = k_new[src];
    cache_v[dst] = v_new[src];
  }
}

template <typename T>
cudaError_t launch_append_ragged(void* ck, void* cv, const void* kn,
                                 const void* vn, const long long* pos,
                                 long long rows, int batch, int heads,
                                 int s_len, int d, cudaStream_t stream) {
  const long long blocks = (rows + APPEND_ROWS - 1) / APPEND_ROWS;
  cache_append_ragged_kernel<T><<<(unsigned)blocks, APPEND_THREADS, 0,
                                  stream>>>(
      static_cast<T*>(ck), static_cast<T*>(cv), static_cast<const T*>(kn),
      static_cast<const T*>(vn), pos, rows, batch, heads, s_len, d);
  return cudaGetLastError();
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
// contiguous in one element type: elem 0 fp32, 1 bf16, 2 int8.
extern "C" int wt_cache_append(void* cache_k, void* cache_v,
                               const void* k_new, const void* v_new,
                               long long rows, int s_len, int d, int pos,
                               int elem, void* stream) {
  if (rows < 1 || d < 1 || pos < 0 || pos >= s_len ||
      (rows + APPEND_ROWS - 1) / APPEND_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 0:
      return (int)launch_append<float>(cache_k, cache_v, k_new, v_new, rows,
                                       s_len, d, pos, s);
    case 1:
      return (int)launch_append<__nv_bfloat16>(cache_k, cache_v, k_new,
                                               v_new, rows, s_len, d, pos, s);
    case 2:
      return (int)launch_append<int8_t>(cache_k, cache_v, k_new, v_new, rows,
                                        s_len, d, pos, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Returns cudaGetLastError() after the launch (0 on success). cache_k,
// cache_v: (L, B, H, S, D); k_new, v_new: (L, B, H, D); pos: (B,) int64
// on the device; rows = L*B*H; all contiguous, the caches and rows in one
// element type: elem 0 fp32, 1 bf16, 2 int8.
extern "C" int wt_cache_append_ragged(void* cache_k, void* cache_v,
                                      const void* k_new, const void* v_new,
                                      const long long* pos, long long rows,
                                      int batch, int heads, int s_len, int d,
                                      int elem, void* stream) {
  if (rows < 1 || batch < 1 || heads < 1 || d < 1 || s_len < 1 ||
      rows % ((long long)batch * heads) != 0 ||
      (rows + APPEND_ROWS - 1) / APPEND_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case 0:
      return (int)launch_append_ragged<float>(cache_k, cache_v, k_new, v_new,
                                              pos, rows, batch, heads, s_len,
                                              d, s);
    case 1:
      return (int)launch_append_ragged<__nv_bfloat16>(
          cache_k, cache_v, k_new, v_new, pos, rows, batch, heads, s_len, d,
          s);
    case 2:
      return (int)launch_append_ragged<int8_t>(cache_k, cache_v, k_new, v_new,
                                               pos, rows, batch, heads, s_len,
                                               d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Message for a code returned by any wt_* entry point.
extern "C" const char* wt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
