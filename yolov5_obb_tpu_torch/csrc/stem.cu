// Inference stem: image ingest + Conv(6x6, s2, p2) + folded BatchNorm + SiLU
// on the packed uint8 image, for models whose layer 1 cannot join the stem
// in the stem+L1 kernel (a GhostConv layer 1; PACKED_L1=0).
//
// Replaces: yolov5_obb_tpu/ops/pallas/stem_kernel.py:153 fused_stem
//   (Pallas body _kernel :74, pallas_call :204).
//
// x (B, H, 3W) uint8 — a free view of the NHWC batch; w (108, c2) float32,
// row (6*dy + dx)*3 + c, with the BatchNorm scale and the /255 normalize
// folded in; bias (c2,) float32 → y (B, Hs, Ws, c2) bf16, Hs = (H - 2)/2 + 1.
// As in the TPU kernel: the exact uint8 values times float32 weights, float32
// accumulation, bias and SiLU in float32, one rounding to bf16 after the
// activation.  The TPU kernel's deinterleaved x6 layout, its tap remap
// (remap_w6) and the _ROWS / (H/2) % 32 limits of Mosaic have no
// counterpart: the kernel reads the 6x6 taps directly and takes every shape.
//
// Bound on this card at yolov5m b16 1024² (c2 = 48, 4.2 M output pixels):
// 43.5 GFLOP of float32 work, 0.65 ms at 67 TFLOP/s, against 453 MB moved
// (50 MB image, 403 MB y), 0.135 ms: operations bound it.  This first
// version does them in scalar float32 FMAs.
//
// Design: the tile body of stem_conv.cuh (one block per 8x32 tile of stem
// outputs, the image patch staged as float in shared memory, 8 output
// channels of one pixel per thread) with a bias + SiLU epilogue.
#include "stem_conv.cuh"

namespace {

struct BiasSilu {
  const float* bias;
  __nv_bfloat16* y;
  __device__ __forceinline__ void operator()(float* acc, int g,
                                             size_t off) const {
    const float4 ba = __ldg(reinterpret_cast<const float4*>(bias + 8 * g));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + 8 * g + 4));
    const float b8[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = silu(acc[j] + b8[j]);
    store8_bf16(y + off, acc);
  }
};

__global__ void __launch_bounds__(stem_conv::kThreads)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
            int H, int W, int c2, int Hs, int Ws) {
  __shared__ float img[stem_conv::kImg];
  stem_conv::tile_conv(x, w, BiasSilu{bias, y}, img, H, W, c2, Hs, Ws);
}

}  // namespace

extern "C" int stem_launch(const uint8_t* x, const float* w, const float* bias,
                           void* y, int B, int H, int W, int c2,
                           void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  if (B == 0 || Hs <= 0 || Ws <= 0) return 0;
  dim3 grid((Ws + stem_conv::TX - 1) / stem_conv::TX,
            (Hs + stem_conv::TY - 1) / stem_conv::TY, B);
  stem_kernel<<<grid, stem_conv::kThreads, 0, (cudaStream_t)stream>>>(
      x, w, bias, reinterpret_cast<__nv_bfloat16*>(y), H, W, c2, Hs, Ws);
  return (int)cudaGetLastError();
}
