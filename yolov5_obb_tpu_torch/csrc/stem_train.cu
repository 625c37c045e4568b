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
// Design.  Forward: one block per 8x32 tile of stem outputs of one image.
// The block stages the 20x68x3 image patch under the tile (as float, zero
// outside the image: the conv's padding) in shared memory; each thread then
// computes 8 output channels of one pixel.  A warp covers 32 pixels of one
// channel group, so the weight reads are warp-uniform broadcasts from the
// read-only cache.
// Weight gradient: two stages, no atomics.  Stage 1: a fixed number of CTAs
// (`parts`, from the wrapper) each walk the 8x32 pixel tiles tile_id ≡
// blockIdx.x (mod parts), staging the tile's image patch and its dz rows
// (float) in shared memory; thread (tap, k-group) keeps dW rows
// (tap, c = 0..2) x 8 output channels in registers over every pixel of every
// tile, then writes its CTA's partial.  Stage 2 (wgrad.cuh) sums the
// partials in order.
#include "wgrad.cuh"

namespace {

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

__global__ void __launch_bounds__(kThreads)
stem_fwd_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                __nv_bfloat16* __restrict__ z, int H, int W, int c2, int Hs,
                int Ws) {
  __shared__ float img[kImg];
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
    store8_bf16(z + (((size_t)b * Hs + oy) * Ws + ox) * c2 + g * 8, acc);
  }
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
