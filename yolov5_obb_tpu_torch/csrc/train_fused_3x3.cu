// The 3x3 passes of the fused train region: the previous conv's BatchNorm +
// SiLU applied to the input as it is staged, a SAME 3x3 conv at stride 1 or
// 2, the raw bf16 output and the per-channel Σz, Σz² of the float32
// accumulator.  Their backward is a library conv gradient outside any
// kernel, as on the TPU (train_fused.py:523).
//
// Replaces: yolov5_obb_tpu/ops/pallas/train_fused.py:489 pass_3x3s1 (body
//   _k3x3s1 :438, pallas_call :502) and :664 pass_3x3s2 (body _k3x3s2 :622,
//   pallas_call :681).
//
// z_in (B, H, W, ci) bf16; gb (2, ci) float32 = [g; b]; taps w (9*ci, co)
// bf16, row (3*dy + dx)*ci + c → z (B, (H-1)/S + 1, (W-1)/S + 1, co) bf16
// and stats (2, co) float32.  The activation silu(z·g + b) is computed in
// float32 and rounded to bf16 (the TPU kernels round it for the MXU);
// positions outside the image are zero after the activation.
//
// Bounds on this card at yolov5m b16 1024²: down1 (512² x 48 → 256² x 96)
// moves 604 MB (0.18 ms at 3.35 TB/s) for 87 GFLOP of bf16 products (0.088
// ms at the tensor-core peak); down2 (256² x 96 → 128² x 192) 302 MB (0.090
// ms) for 87 GFLOP; a bottleneck 3x3 s1 (256² x 48 → 48) 201 MB (0.060 ms)
// for 43.5 GFLOP: bytes bound all three.
//
// Design: the tensor-core implicit GEMM of conv3x3_mma.cuh at the pass's
// stride, with its activating prologue (cp.async staging activated in
// place, or register staging where ci % 8 != 0) and statistics (one partial
// row of 2*co floats per 8x16 output tile).  The stride-1 bottleneck (co =
// 48) runs on 48-channel chunks, the stride-2 passes (co = 96, 192) on
// 96-channel chunks.  No float atomics: wgrad.cuh's sum_rows adds the
// partials in a fixed order, so repeated runs agree bit for bit.
#include "conv3x3_mma.cuh"
#include "wgrad.cuh"

namespace {

template <int S>
int pass_launch(const void* z_in, const float* gb, const void* w, void* z,
                float* partial, float* stats, int B, int H, int W, int ci,
                int co, cudaStream_t stream) {
  cudaError_t err = conv3x3_mma::launch<S, true, true>(
      z_in, gb, w, z, partial, B, H, W, ci, co, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, stats, 2 * co,
                              conv3x3_mma::tiles<S>(B, H, W), stream);
}

}  // namespace

// partial: conv3x3_mma::tiles<S>(B, H, W) rows of 2*co floats (one per 8x16
// output tile) of scratch; stats: 2*co floats.
extern "C" int pass3x3s1_launch(const void* z_in, const float* gb,
                                const void* w, void* z, float* partial,
                                float* stats, int B, int H, int W, int ci,
                                int co, void* stream) {
  return pass_launch<1>(z_in, gb, w, z, partial, stats, B, H, W, ci, co,
                        (cudaStream_t)stream);
}

extern "C" int pass3x3s2_launch(const void* z_in, const float* gb,
                                const void* w, void* z, float* partial,
                                float* stats, int B, int H, int W, int ci,
                                int co, void* stream) {
  return pass_launch<2>(z_in, gb, w, z, partial, stats, B, H, W, ci, co,
                        (cudaStream_t)stream);
}
