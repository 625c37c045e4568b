// Fused downsample Conv(3x3, s2, p1) + BatchNorm (as scale/shift) + SiLU.
//
// Replaces: yolov5_obb_tpu/ops/pallas/down_kernel.py:326 fused_down
//   (Pallas body _kernel :54, pallas_call :356).
//
// Inputs: x (B, H, W, ci) bf16; taps w (9*ci, co) bf16, row (3*dy + dx)*ci + c,
// BN scale NOT folded; ss (2, co) float32 = [scale; shift] applied after the
// conv.  Output (B, (H+1)/2, (W+1)/2, co) bf16.  float32 accumulation.
//
// Bound on this card at yolov5m b16 1024² layer 3 (256² x 96 → 128² x 192):
// ~302 MB moved take 0.090 ms at 3.35 TB/s, ~87 GFLOP take 0.088 ms at the
// bf16 tensor-core peak: bytes bound it, by a hair.  This first version uses
// scalar float32 FMAs, so in practice operations limit it.
//
// Design: the tiled conv of down_conv.cuh at stride 2 with a scale/shift +
// SiLU epilogue.
#include "down_conv.cuh"

// (at namespace scope: the type is a template argument of a kernel)
struct BnSilu {
  const float* ss;  // (2, co): scale row, then shift row
  int co;
  __device__ __forceinline__ void operator()(float* acc, int k0) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = silu(acc[j] * ss[k0 + j] + ss[co + k0 + j]);
  }
};

extern "C" int down_launch(const void* x, const void* w, const float* ss,
                           void* out, int B, int H, int W, int ci, int co,
                           void* stream) {
  return (int)down_conv::launch<2>(x, w, down_conv::Identity{},
                                   BnSilu{ss, co}, out, nullptr, B, H, W,
                                   ci, co, (cudaStream_t)stream);
}
