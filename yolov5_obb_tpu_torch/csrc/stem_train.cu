// Train-mode stem: the raw Conv(6x6, s2, p2) from the packed uint8 image
// (no BatchNorm, no activation) and its weight gradient.
//
// Replaces: yolov5_obb_tpu/ops/pallas/stem_kernel.py:428 stem_conv_train
//   (custom VJP _stem_train_p :367): forward body _kernel_raw :267
//   (pallas_call :382), weight-grad body _wgrad_kernel :291 (pallas_call :406).
//
// Forward: x (B, H, 3W) uint8 — a free view of the NHWC batch — and the stem
// taps w (108, c2) float32, row (6*dy + dx)*3 + c, with the /255 normalize
// folded in → z (B, Hs, Ws, c2) bf16, Hs = (H - 2)/2 + 1.  As in the TPU
// kernel: the exact uint8 values times float32 weights, float32
// accumulation, one rounding to bf16.
// Weight gradient: dz (B, Hs, Ws, c2) bf16 → dW (108, c2) float32, same row
// order.  The image values (exact in bf16) times dz, float32 accumulation.
// The image takes no gradient.
//
// Bounds on this card at yolov5m b16 1024² (c2 = 48, 4.2 M output pixels):
// forward 43.5 GFLOP of float32 work, 0.65 ms at 67 TFLOP/s, against 453 MB
// moved (50 MB image, 403 MB z), 0.135 ms: operations bound it.  The weight
// gradient reads the same 453 MB (0.135 ms) for the same 43.5 GFLOP of
// bf16 products (0.044 ms at the tensor-core peak): bytes bound it.  This
// first version does both in scalar float32 FMAs.
//
// Design.  Forward: the tile body of stem_conv.cuh (one block per 8x32 tile
// of stem outputs, the image patch staged as float in shared memory, 8
// output channels of one pixel per thread), stored as it is.
// Weight gradient: two stages, no atomics.  Stage 1: a fixed number of CTAs
// (`parts`, from the wrapper) each walk the 8x32 pixel tiles tile_id ≡
// blockIdx.x (mod parts), staging the tile's image patch and its dz rows
// (float) in shared memory; thread (tap, k-group) keeps dW rows
// (tap, c = 0..2) x 8 output channels in registers over every pixel of every
// tile, then writes its CTA's partial.  Stage 2 (wgrad.cuh) sums the
// partials in order.
#include "stem_conv.cuh"
#include "wgrad.cuh"

namespace {

using stem_conv::IX;
using stem_conv::kImg;
using stem_conv::kThreads;
using stem_conv::stage_patch;
using stem_conv::TX;
using stem_conv::TY;

// the forward's epilogue: one rounding to bf16
struct StoreRaw {
  __nv_bfloat16* z;
  __device__ __forceinline__ void operator()(const float* acc, int,
                                             size_t off) const {
    store8_bf16(z + off, acc);
  }
};

__global__ void __launch_bounds__(kThreads)
stem_fwd_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                __nv_bfloat16* __restrict__ z, int H, int W, int c2, int Hs,
                int Ws) {
  __shared__ float img[kImg];
  stem_conv::tile_conv(x, w, StoreRaw{z}, img, H, W, c2, Hs, Ws);
}

// Stage 1 of the weight gradient; blockDim.x >= 36 * c2/8 (one thread per
// (tap, k-group)), dynamic shared memory = patch + TY*TX*c2 floats of dz.
__global__ void stem_wgrad_kernel(const uint8_t* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ dz,
                                  float* __restrict__ partial, int H, int W,
                                  int c2, int Hs, int Ws, int tiles_x,
                                  int tiles_y, int ntiles) {
  extern __shared__ float4 smem4[];
  float* img = reinterpret_cast<float*>(smem4);
  float* dzs = img + kImg;  // kImg * 4 bytes is a multiple of 16
  const int groups = c2 / 8;
  const int tid = threadIdx.x;
  const bool active = tid < 36 * groups;
  const int kg = tid / 36, tap = tid - kg * 36;
  const int dy = tap / 6, dx = tap - dy * 6;

  float acc[3][8];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int oy0 = (rem / tiles_x) * TY, ox0 = (rem % tiles_x) * TX;
    __syncthreads();  // the previous tile's reads are done
    stage_patch(x + (size_t)b * H * W * 3, img, H, W, oy0, ox0);
    for (int idx = tid; idx < TY * TX * groups; idx += blockDim.x) {
      int p = idx / groups, g = idx - p * groups;
      int oy = oy0 + p / TX, ox = ox0 + p % TX;
      float f[8];
      if (oy < Hs && ox < Ws) {
        load8_bf16(dz + (((size_t)b * Hs + oy) * Ws + ox) * c2 + g * 8, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      float4* d = reinterpret_cast<float4*>(dzs + p * c2 + g * 8);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    if (!active) continue;
    for (int p = 0; p < TY * TX; ++p) {
      const int r = p / TX, q = p - r * TX;
      const float* ip = img + (2 * r + dy) * IX * 3 + (2 * q + dx) * 3;
      const float v[3] = {ip[0], ip[1], ip[2]};
      const float4 d0 = *reinterpret_cast<const float4*>(dzs + p * c2 + kg * 8);
      const float4 d1 =
          *reinterpret_cast<const float4*>(dzs + p * c2 + kg * 8 + 4);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[c][0] = fmaf(v[c], d0.x, acc[c][0]);
        acc[c][1] = fmaf(v[c], d0.y, acc[c][1]);
        acc[c][2] = fmaf(v[c], d0.z, acc[c][2]);
        acc[c][3] = fmaf(v[c], d0.w, acc[c][3]);
        acc[c][4] = fmaf(v[c], d1.x, acc[c][4]);
        acc[c][5] = fmaf(v[c], d1.y, acc[c][5]);
        acc[c][6] = fmaf(v[c], d1.z, acc[c][6]);
        acc[c][7] = fmaf(v[c], d1.w, acc[c][7]);
      }
    }
  }
  if (!active) return;
  float* out = partial + (size_t)blockIdx.x * 108 * c2;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float4* o = reinterpret_cast<float4*>(out + (tap * 3 + c) * c2 + kg * 8);
    o[0] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    o[1] = make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
  }
}

}  // namespace

extern "C" int stem_train_fwd_launch(const uint8_t* x, const float* w, void* z,
                                     int B, int H, int W, int c2,
                                     void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  if (B == 0 || Hs <= 0 || Ws <= 0) return 0;
  dim3 grid((Ws + TX - 1) / TX, (Hs + TY - 1) / TY, B);
  stem_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, reinterpret_cast<__nv_bfloat16*>(z), H, W, c2, Hs, Ws);
  return (int)cudaGetLastError();
}

// partial: parts * 108 * c2 floats of scratch; dw: 108 * c2 floats.
extern "C" int stem_train_wgrad_launch(const uint8_t* x, const void* dz,
                                       float* partial, float* dw, int B, int H,
                                       int W, int c2, int parts,
                                       void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  const int tiles_x = (Ws + TX - 1) / TX, tiles_y = (Hs + TY - 1) / TY;
  const int threads = (36 * (c2 / 8) + 31) / 32 * 32;
  const size_t smem = (size_t)(kImg + TY * TX * c2) * sizeof(float);
  cudaError_t err = allow_smem(stem_wgrad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  stem_wgrad_kernel<<<parts, threads, smem, (cudaStream_t)stream>>>(
      x, reinterpret_cast<const __nv_bfloat16*>(dz), partial, H, W, c2, Hs, Ws,
      tiles_x, tiles_y, B * tiles_x * tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, dw, 108 * c2, parts,
                                  (cudaStream_t)stream);
}
