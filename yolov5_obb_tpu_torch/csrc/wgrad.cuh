// Second stage of the two-stage reductions (the weight gradients of
// stem_train.cu, down_train.cu and train_fused_1x1.cu; the statistics of the
// fused train passes).  The first stage has each CTA sum its share of the
// pixels into its own float32 partial row; these kernels add the partials in
// a fixed order.  No float atomics: repeated runs agree bit for bit.
#pragma once

#include "common.cuh"

// out[i] = Σ_{p < parts} partial[p * n + i], summed in the order of p.
// One thread per output; a warp reads 32 consecutive floats of each partial.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n, int parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * n + i];
  out[i] = s;
}

static cudaError_t launch_sum_partials(const float* partial, float* out, int n,
                                       int parts, cudaStream_t stream) {
  constexpr int kThreads = 256;
  sum_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, n, parts);
  return cudaGetLastError();
}

// The same sum for many partial rows and few columns (one partial per tile):
// a block of 32 columns x 32 row lanes; lane l sums rows l, l+32, ... in
// order, then lane 0 adds the 32 lane sums in order.
__global__ void sum_rows_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int n, int rows) {
  __shared__ float part[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x, lane = threadIdx.y;
  float s = 0.f;
  if (col < n)
    for (int r = lane; r < rows; r += 32) s += partial[(size_t)r * n + col];
  part[lane][threadIdx.x] = s;
  __syncthreads();
  if (lane == 0 && col < n) {
    float t = 0.f;
    for (int l = 0; l < 32; ++l) t += part[l][threadIdx.x];
    out[col] = t;
  }
}

static cudaError_t launch_sum_rows(const float* partial, float* out, int n,
                                   int rows, cudaStream_t stream) {
  sum_rows_kernel<<<(n + 31) / 32, dim3(32, 32), 0, stream>>>(partial, out, n,
                                                               rows);
  return cudaGetLastError();
}
