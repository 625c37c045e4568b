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
// Design.  Stride 2: the tensor-core implicit GEMM of conv3x3_mma.cuh with
// its activating prologue (register staging) and statistics (one partial
// row of 2*co floats per 8x16 output tile).  Stride 1: the scalar float32
// tiled conv of down_conv.cuh (8x8 output tiles, the patch staged in shared
// memory) with the same prologue and a statistics epilogue (one partial row
// per 8x8 tile), so in practice operations limit it.  Neither uses float
// atomics: wgrad.cuh's sum_rows adds the partials in a fixed order, so
// repeated runs agree bit for bit.
#include "conv3x3_mma.cuh"
#include "down_conv.cuh"
#include "wgrad.cuh"

// (at namespace scope: the type is a template argument of a kernel)
struct BnSiluIn {
  const float* gb;  // (2, ci): g row, then b row
  int ci;
  __device__ __forceinline__ __nv_bfloat162 operator()(__nv_bfloat162 v,
                                                       int c2) const {
    const float2 f = __bfloat1622float2(v);
    const int c = 2 * c2;
    const float a0 = f.x * __ldg(gb + c) + __ldg(gb + ci + c);
    const float a1 = f.y * __ldg(gb + c + 1) + __ldg(gb + ci + c + 1);
    return __floats2bfloat162_rn(silu(a0), silu(a1));
  }
};

namespace {

template <int S>
int pass_launch(const void* z_in, const float* gb, const void* w, void* z,
                float* partial, float* stats, int B, int H, int W, int ci,
                int co, cudaStream_t stream) {
  cudaError_t err = down_conv::launch<S>(z_in, w, BnSiluIn{gb, ci},
                                         down_conv::Raw{}, z, partial, B, H,
                                         W, ci, co, stream);
  if (err != cudaSuccess) return (int)err;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tiles = B * ((Ho + down_conv::T - 1) / down_conv::T) *
                    ((Wo + down_conv::T - 1) / down_conv::T);
  return (int)launch_sum_rows(partial, stats, 2 * co, tiles, stream);
}

}  // namespace

// partial: one row of 2*co floats per 8x8 output tile (B * ceil(Ho/8) *
// ceil(Wo/8) rows) of scratch; stats: 2*co floats.
extern "C" int pass3x3s1_launch(const void* z_in, const float* gb,
                                const void* w, void* z, float* partial,
                                float* stats, int B, int H, int W, int ci,
                                int co, void* stream) {
  return pass_launch<1>(z_in, gb, w, z, partial, stats, B, H, W, ci, co,
                        (cudaStream_t)stream);
}

// partial: conv3x3_mma::tiles<2>(B, H, W) rows of 2*co floats (one per 8x16
// output tile) of scratch; stats: 2*co floats.
extern "C" int pass3x3s2_launch(const void* z_in, const float* gb,
                                const void* w, void* z, float* partial,
                                float* stats, int B, int H, int W, int ci,
                                int co, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = conv3x3_mma::launch<2, true, true>(
      z_in, gb, w, z, partial, B, H, W, ci, co, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, stats, 2 * co,
                              conv3x3_mma::tiles<2>(B, H, W), st);
}
