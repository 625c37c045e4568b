// Helpers shared by the port's kernels (each .cu builds into its own .so).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 bf16 values (16 bytes) → 8 floats.  `p` must be 16-byte aligned.
__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p, float* f) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// read-only path for weights that every block reads (L1/L2 resident)
__device__ __forceinline__ void ldg8_bf16(const __nv_bfloat16* p, float* f) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// acc[0..8) += Σ_ci in[ci] · w[ci*co + 0..8): one input pixel's channels
// (shared memory, `c` even, 4-byte aligned) against an 8-wide column group of
// a (c, co) bf16 weight matrix in global memory (16-byte aligned rows).
// float32 accumulation; every thread of a warp reads the same weights.
__device__ __forceinline__ void fma_pixel(const __nv_bfloat16* in, int c,
                                          const __nv_bfloat16* w, int co,
                                          float* acc) {
  for (int ci = 0; ci < c; ci += 2) {
    float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(in + ci));
    float wa[8], wb[8];
    ldg8_bf16(w + (size_t)ci * co, wa);
    ldg8_bf16(w + (size_t)(ci + 1) * co, wb);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(v.y, wb[j], fmaf(v.x, wa[j], acc[j]));
  }
}

// 8 floats → 8 bf16 (16 bytes) at a 16-byte aligned address.
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 floats → 8 bf16 at a 4-byte aligned address (padded shared tiles).
__device__ __forceinline__ void store8_bf16_a4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
}

// Row stride (in bf16 elements) of a pixel-major shared tile with `c`
// channels: padded so consecutive pixels start in different banks (an odd
// number of 32-bit words) and each pixel row stays 4-byte aligned.
__host__ __device__ __forceinline__ int smem_stride(int c) {
  int words = (c + 1) / 2;
  return 2 * (words | 1);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
