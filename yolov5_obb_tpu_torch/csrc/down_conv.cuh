// The Conv(3x3, s2, p1) body shared by the inference downsample (down.cu:
// BatchNorm scale/shift + SiLU epilogue) and the train-mode forward
// (down_train.cu: raw epilogue).
//
// x (B, H, W, ci) bf16; taps w (9*ci, co) bf16, row (3*dy + dx)*ci + c.
// Output (B, (H+1)/2, (W+1)/2, co) bf16, float32 accumulation.
//
// Design: one block per 8x8 output tile of one image.  The block stages the
// 17x17 input patch under the tile (zero outside the image: the conv's
// padding) in a padded bf16 shared tile, then each thread computes 8 output
// channels of one pixel from it; a warp covers 32 pixels of one channel
// group, so the weight reads are warp-uniform broadcasts.
#pragma once

#include "common.cuh"

namespace down_conv {

constexpr int T = 8;           // outputs per block side
constexpr int IT = 2 * T + 1;  // input pixels per block side
constexpr int kThreads = 256;

// epi(acc, k0) maps the float32 sums of output channels k0 .. k0+7 in place
template <typename Epilogue>
__global__ void __launch_bounds__(kThreads)
kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
       Epilogue epi, __nv_bfloat16* __restrict__ out, int H, int W, int ci,
       int co, int Ho, int Wo) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int st = smem_stride(ci);
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * T, ox0 = blockIdx.x * T;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * ci;

  // stage the patch two channels at a time
  const int half = ci / 2;
  for (int idx = threadIdx.x; idx < IT * IT * half; idx += kThreads) {
    int p = idx / half, c2 = idx - p * half;
    int r = p / IT, q = p - r * IT;
    int gy = iy0 + r, gx = ix0 + q;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = reinterpret_cast<const __nv_bfloat162*>(
          xb + ((size_t)gy * W + gx) * ci)[c2];
    reinterpret_cast<__nv_bfloat162*>(tile + p * st)[c2] = v;
  }
  __syncthreads();

  const int groups = co / 8;
  for (int item = threadIdx.x; item < T * T * groups; item += kThreads) {
    int g = item / (T * T), p = item - g * (T * T);
    int py = p / T, px = p - py * T;
    int oy = oy0 + py, ox = ox0 + px;
    if (oy >= Ho || ox >= Wo) continue;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        fma_pixel(tile + ((2 * py + dy) * IT + 2 * px + dx) * st, ci,
                  w + (size_t)(dy * 3 + dx) * ci * co + g * 8, co, acc);
    epi(acc, g * 8);
    store8_bf16(out + (((size_t)b * Ho + oy) * Wo + ox) * co + g * 8, acc);
  }
}

template <typename Epilogue>
cudaError_t launch(const void* x, const void* w, Epilogue epi, void* out,
                   int B, int H, int W, int ci, int co, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (B == 0 || Ho == 0 || Wo == 0) return cudaSuccess;
  size_t smem = (size_t)IT * IT * smem_stride(ci) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(kernel<Epilogue>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Wo + T - 1) / T, (Ho + T - 1) / T, B);
  kernel<Epilogue><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const __nv_bfloat16*>(w), epi,
      reinterpret_cast<__nv_bfloat16*>(out), H, W, ci, co, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace down_conv
