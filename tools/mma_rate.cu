// Peak rate of one warp-level mma.sync on the card: m16n8k8 with tf32
// operands and m16n8k16 with bf16, fp32 accumulation, at several chain
// counts (independent accumulators a warp) and warps an SM. A standalone
// program (no PyTorch):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate \
//       tools/mma_rate.cu && ./mma_rate
//
// Prints one line a configuration: the operation, chains, warps an SM and
// TFLOP/s (2 x m x n x k a product) over one launch of 2,048 iterations on
// 132 SMs' worth of blocks, timed by CUDA events after a short warm-up.

#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS, bool TF32>
__global__ void chains(float* out, int iters) {
  float acc[CHAINS][4];
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c000000u + threadIdx.x + i;
  b[0] = 0x3c000000u + threadIdx.x;
  b[1] = 0x3c100000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (TF32)
        mma_tf32(acc[c], a, b);
      else
        mma_bf16(acc[c], a, b);
    }
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS, bool TF32>
void run(int blocks_per_sm, int threads) {
  const int sms = 132, iters = 2048;
  const int blocks = sms * blocks_per_sm;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  chains<CHAINS, TF32><<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<CHAINS, TF32><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * (TF32 ? 8 : 16) * (double)CHAINS *
                      iters * blocks * (threads / 32);
  printf("%s chains=%d warps_per_sm=%d tflops=%.1f ms=%.3f %s\n",
         TF32 ? "tf32_m16n8k8" : "bf16_m16n8k16", CHAINS,
         blocks_per_sm * threads / 32, flop / ms / 1e9, ms,
         cudaGetErrorString(cudaGetLastError()));
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  cudaFree(out);
}

int main() {
  run<8, true>(2, 128);
  run<8, true>(3, 128);
  run<8, true>(4, 128);
  run<2, true>(4, 128);
  run<4, true>(4, 128);
  run<16, true>(4, 128);
  run<8, true>(8, 128);
  run<8, false>(4, 128);
  run<8, false>(8, 128);
  return 0;
}
