// Peak rate of one warp-level mma.sync on the card: m16n8k8 with tf32
// operands and m16n8k16 with bf16, fp32 accumulation, at several chain
// counts (independent accumulators a warp) and warps an SM; and of wgmma
// m64n128k8 tf32 with A in registers and B in shared memory (the tail
// backward's product), chained into one accumulator a warpgroup and
// waited for every 12 products (with the fold into a total that the tail
// backward does every 32-deep k tile) or every 96. A standalone program
// (no PyTorch; the wgmma wrappers from the port's csrc/hopper.cuh):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate \
//       tools/mma_rate.cu && ./mma_rate
//
// Prints one line a configuration: the operation, chains (or warpgroups a
// block and products a wait), warps an SM and TFLOP/s (2 x m x n x k a
// product) over one launch on 132 SMs' worth of blocks, timed by CUDA
// events after a short warm-up.

#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

#include "../whisper_tpu_torch/csrc/hopper.cuh"

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

// `rounds` times: `per_wait` wgmma m64n128k8 tf32 products into one
// accumulator (the first of each round starting it afresh), then wait
// and, with `fold`, add it to a total by FADDs
__global__ void __launch_bounds__(384, 1)
wgmma_chain(float* out, int rounds, int per_wait, int fold) {
  __shared__ __align__(1024) uint32_t b_tile[4096];   // 128 rows x 32 k
  for (int i = threadIdx.x; i < 4096; i += blockDim.x)
    b_tile[i] = 0x3c000000u + (i & 255);
  wt::fence_proxy_async();
  __syncthreads();
  float acc[64], total[64];
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
  const uint32_t a[4] = {0x3c000000u + threadIdx.x, 0x3c100000u,
                         0x3c200000u, 0x3c300000u};
  const uint32_t b = wt::smem_addr(b_tile);
  for (int r = 0; r < rounds; ++r) {
    wt::fence_regs(acc);
    wt::wgmma_fence();
    for (int j = 0; j < per_wait; ++j)
      wt::wgmma_m64n128k8_tf32_rs(acc, a, wt::sw128_desc(b + 32 * (j & 3), 0),
                                  !fold || j > 0);
    wt::wgmma_commit();
    wt::wgmma_wait();
    wt::fence_regs(acc);
    if (fold)
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i] + total[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

void run_wgmma(int blocks_per_sm, int warpgroups, int per_wait, int fold) {
  const int sms = 132, rounds = 12288 / per_wait;
  const int blocks = sms * blocks_per_sm, threads = 128 * warpgroups;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  wgmma_chain<<<blocks, threads>>>(out, 4, per_wait, fold);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  wgmma_chain<<<blocks, threads>>>(out, rounds, per_wait, fold);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 64 * 128 * 8 * (double)rounds * per_wait *
                      blocks * warpgroups;
  printf("wgmma_tf32_m64n128k8_rs warpgroups=%d per_wait=%d fold=%d "
         "warps_per_sm=%d tflops=%.1f ms=%.3f %s\n",
         warpgroups, per_wait, fold, blocks_per_sm * warpgroups * 4,
         flop / ms / 1e9, ms, cudaGetErrorString(cudaGetLastError()));
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
  run_wgmma(1, 2, 12, 1);      // the tail backward's block and fold
  run_wgmma(1, 2, 96, 0);
  run_wgmma(2, 1, 12, 1);
  run_wgmma(1, 3, 96, 0);
  run_wgmma(2, 2, 96, 0);
  return 0;
}
