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
// the 43.5 GFLOP run as three bf16 products (130.5 GFLOP, 0.13 ms at the
// tensor-core peak) against 453 MB moved (50 MB image, 403 MB y), 0.135 ms:
// bytes bound it, barely.
//
// Design: stem_mma.cuh's tensor-core stem (each float32 weight split once
// per CTA into three bf16 terms, the uint8 image exact in bf16, three
// mma.sync products into one float32 accumulator) on its persistent 8x32
// rectangles, the train-mode forward's body (stem_train.cu), with a bias +
// SiLU epilogue (IEEE expf and division, then one rounding to bf16) before
// mma.cuh's staged 16-byte stores.  A c2 past 80 runs in chunks of 80
// columns.
#include "stem_mma.cuh"

namespace {

template <int CP>
__global__ void __launch_bounds__(stem_mma::kRectThreads,
                                  stem_mma::RectGemm<CP>::kPerSm)
stem_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
            stem_mma::RectGrid g) {
  stem_mma::rects<CP>(x, w, BiasSilu{bias}, y, g);
}

}  // namespace

// Requires c2 % 8 == 0.
extern "C" int stem_launch(const uint8_t* x, const float* w, const float* bias,
                           void* y, int B, int H, int W, int c2,
                           void* stream) {
  const stem_mma::RectGrid g = stem_mma::rect_grid(x, B, H, W, c2);
  if (B == 0 || g.Hs <= 0 || g.Ws <= 0) return 0;
  auto yb = reinterpret_cast<__nv_bfloat16*>(y);
  return (int)stem_mma::by_width(c2, [&](auto cp) {
    constexpr int CP = decltype(cp)::value;
    return stem_mma::launch_rects<CP>(stem_kernel<CP>, g,
                                      (cudaStream_t)stream, x, w, bias, yb);
  });
}
