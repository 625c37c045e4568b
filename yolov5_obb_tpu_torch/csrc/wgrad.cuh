// Second stage of the two-stage weight gradients (stem_train.cu,
// down_train.cu).  The first stage has each CTA sum its share of the output
// pixels into its own float32 partial dW; this kernel adds the partials in a
// fixed order.  No float atomics: repeated runs agree bit for bit.
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
