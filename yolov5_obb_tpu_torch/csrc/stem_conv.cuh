// The scalar stem Conv(6x6, s2, p2) body of the inference stem alone
// (stem.cu: bias + SiLU epilogue); the train-mode stem's weight gradient
// (stem_train.cu) stages the same patches.  (The stem+L1 kernel and the
// train-mode forward run the tensor-core stem of stem_mma.cuh.)
//
// x (B, H, 3W) uint8 — a free view of the NHWC batch — and the taps
// w (108, c2) float32, row (6*dy + dx)*3 + c (the /255 normalize folded in).
// Output pixel (oy, ox) of image b reads image rows 2*oy - 2 .. 2*oy + 3 and
// pixels 2*ox - 2 .. 2*ox + 3, zero outside the image (the conv's padding);
// Hs = (H - 2)/2 + 1, Ws = (W - 2)/2 + 1.  The exact uint8 values times the
// float32 weights, float32 accumulation.
//
// Design: one block per 8x32 tile of stem outputs of one image.  The block
// stages the 20x68x3 image patch under the tile (as float) in shared memory;
// each thread then computes 8 output channels of one pixel.  A warp covers
// 32 pixels of one channel group, so the weight reads are warp-uniform
// broadcasts from the read-only cache.
#pragma once

#include "common.cuh"

namespace stem_conv {

constexpr int TY = 8, TX = 32;                  // stem outputs per tile
constexpr int IY = 2 * TY + 4, IX = 2 * TX + 4;  // image pixels per tile
constexpr int kImg = IY * IX * 3;                // floats of a staged patch
constexpr int kThreads = 256;

// image patch of the tile at stem outputs (oy0, ox0): rows 2*oy0 - 2 ..,
// pixels 2*ox0 - 2 .., zero outside the image
__device__ __forceinline__ void stage_patch(const uint8_t* xb, float* img,
                                            int H, int W, int oy0, int ox0) {
  const int gy0 = 2 * oy0 - 2, gc0 = (2 * ox0 - 2) * 3;
  for (int idx = threadIdx.x; idx < kImg; idx += blockDim.x) {
    int r = idx / (IX * 3), c = idx - r * (IX * 3);
    int gy = gy0 + r, gc = gc0 + c;
    img[idx] = (gy >= 0 && gy < H && gc >= 0 && gc < 3 * W)
                   ? (float)xb[(size_t)gy * 3 * W + gc]
                   : 0.f;
  }
}

// The tile of block (blockIdx.x, blockIdx.y) of image blockIdx.z (grid
// (ceil(Ws/TX), ceil(Hs/TY), B), kThreads threads).  epi(acc, g, off) maps
// the float32 sums of output channels 8g .. 8g+7 of the pixel whose
// channel-0 output element is `off` and stores them.
template <typename Epilogue>
__device__ __forceinline__ void tile_conv(const uint8_t* __restrict__ x,
                                          const float* __restrict__ w,
                                          const Epilogue& epi, float* img,
                                          int H, int W, int c2, int Hs,
                                          int Ws) {
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  stage_patch(x + (size_t)b * H * W * 3, img, H, W, oy0, ox0);
  __syncthreads();

  const int groups = c2 / 8;
  for (int item = threadIdx.x; item < TY * TX * groups; item += kThreads) {
    int g = item / (TY * TX), p = item - g * (TY * TX);
    int r = p / TX, q = p - r * TX;
    int oy = oy0 + r, ox = ox0 + q;
    if (oy >= Hs || ox >= Ws) continue;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < 6; ++dy) {
      const float* irow = img + (2 * r + dy) * IX * 3 + 2 * q * 3;
      const float* wrow = w + (size_t)(dy * 18) * c2 + g * 8;
#pragma unroll 6
      for (int t = 0; t < 18; ++t) {  // t = 3*dx + c
        float v = irow[t];
        float4 wa = __ldg(reinterpret_cast<const float4*>(wrow + t * c2));
        float4 wb = __ldg(reinterpret_cast<const float4*>(wrow + t * c2 + 4));
        acc[0] = fmaf(v, wa.x, acc[0]); acc[1] = fmaf(v, wa.y, acc[1]);
        acc[2] = fmaf(v, wa.z, acc[2]); acc[3] = fmaf(v, wa.w, acc[3]);
        acc[4] = fmaf(v, wb.x, acc[4]); acc[5] = fmaf(v, wb.y, acc[5]);
        acc[6] = fmaf(v, wb.z, acc[6]); acc[7] = fmaf(v, wb.w, acc[7]);
      }
    }
    epi(acc, g, (((size_t)b * Hs + oy) * Ws + ox) * c2 + g * 8);
  }
}

}  // namespace stem_conv
