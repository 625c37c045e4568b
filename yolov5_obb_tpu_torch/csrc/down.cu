// Fused downsample Conv(3x3, s2, p1) + BatchNorm (as scale/shift) + SiLU.
//
// Replaces: yolov5_obb_tpu/ops/pallas/down_kernel.py:326 fused_down
//   (Pallas body _kernel :54, pallas_call :356).
//
// Inputs: x (B, H, W, ci) bf16; taps w (9*ci, co) bf16, row (3*dy + dx)*ci + c,
// BN scale NOT folded; ss (2, co) float32 = [scale; shift] applied after the
// conv.  Output (B, (H+1)/2, (W+1)/2, co) bf16: silu(acc * scale + shift) in
// float32 of the float32 accumulator, rounded once.
//
// Bound on this card at yolov5m b16 1024² layer 3 (256² x 96 → 128² x 192):
// ~302 MB moved take 0.090 ms at 3.35 TB/s, ~87 GFLOP take 0.088 ms at the
// bf16 tensor-core peak: bytes bound it, by a hair.
//
// Design: the tensor-core implicit GEMM of conv3x3_mma.cuh at stride 2 (the
// same conv as the train-mode downsample forward), without prologue or
// statistics, with its BnSilu epilogue on the float32 accumulators before
// the one bf16 rounding (IEEE expf: the output is held to one bf16 ulp of
// the plain version).  Requires ci % 2 == 0, co % 8 == 0 and 16-byte
// aligned x and w; any H, W.
#include "conv3x3_mma.cuh"

extern "C" int down_launch(const void* x, const void* w, const float* ss,
                           void* out, int B, int H, int W, int ci, int co,
                           void* stream) {
  return (int)conv3x3_mma::launch<2, false, false>(
      x, nullptr, w, out, nullptr, B, H, W, ci, co, (cudaStream_t)stream,
      conv3x3_mma::BnSilu{ss, co});
}
