// Fused image ingest + stem Conv(6x6, s2, p2) + layer-1 Conv(3x3, s2, p1),
// each with its BatchNorm folded and SiLU; the stem activation stays on chip.
//
// Replaces: yolov5_obb_tpu/ops/pallas/stem_kernel.py:599 fused_stem_l1
//   (Pallas body _kernel_l1 :511, pallas_call :640).
//
// Inputs: the packed uint8 image (B, H, 3W) — a free view of NHWC — the
// stem weights w0 (108, c2) float32 with the /255 and the BN scale folded,
// row (6*dy + dx)*3 + c; the stem shift b0 (c2); layer-1 taps w1 (9*c2, c3)
// bf16, row (3*dy + dx)*c2 + ci, BN scale folded; the shift b1 (c3).
// Output (B, Ho, Wo, c3) bf16.  Numerics follow the TPU kernel: the stem is
// computed in float32 from the exact uint8 values, rounded to bf16 before
// layer 1, and layer 1 accumulates in float32.
//
// Bound on this card at yolov5m b16 1024² (c2=48, c3=96): operations.
// The stem's 43.5 GFLOP are float32 (uint8 values times float32 weights):
// 0.65 ms at 67 TFLOP/s; layer 1's 87 GFLOP are bf16: 0.09 ms at the
// 989 TFLOP/s tensor-core peak; together 0.74 ms, against 0.08 ms for the
// ~251 MB moved (50 MB image in, 201 MB out).  This first version does all
// of it in scalar float32 FMAs; tensor cores for layer 1 are the next step.
//
// Design: one block per 8x16 tile of layer-1 outputs of one image.  The
// block stages the 38x70 image patch it needs (as float) in shared memory,
// computes the 17x33 stem pixels under the tile into a padded bf16 shared
// tile (stem pixels outside the stem image are layer 1's zero padding), then
// computes the layer-1 tile from it.  Each thread owns 8 output channels of
// one pixel; a warp covers 32 pixels of the same channel group, so weight
// reads are warp-uniform broadcasts from the read-only cache.
#include "common.cuh"

namespace {

constexpr int TY = 8, TX = 16;               // layer-1 outputs per block
constexpr int SY = 2 * TY + 1, SX = 2 * TX + 1;  // stem pixels per block
constexpr int IY = 2 * SY + 4, IX = 2 * SX + 4;  // image pixels per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stem_l1_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w0,
               const float* __restrict__ b0, const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
               int H, int W, int c2, int c3, int Hs, int Ws, int Ho, int Wo) {
  extern __shared__ float4 smem4[];
  float* img = reinterpret_cast<float*>(smem4);                  // IY x IX*3
  __nv_bfloat16* stem = reinterpret_cast<__nv_bfloat16*>(img + IY * IX * 3);
  const int sst = smem_stride(c2);

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  const uint8_t* xb = x + (size_t)b * H * W * 3;

  // image patch: rows 4*oy0-4 .., pixels 4*ox0-4 .. (zero outside: stem pad)
  const int gy0 = 4 * oy0 - 4, gx0 = 4 * ox0 - 4;
  for (int idx = threadIdx.x; idx < IY * IX * 3; idx += kThreads) {
    int r = idx / (IX * 3), c = idx - r * (IX * 3);
    int gy = gy0 + r, gc = gx0 * 3 + c;
    img[idx] = (gy >= 0 && gy < H && gc >= 0 && gc < 3 * W)
                   ? (float)xb[(size_t)gy * 3 * W + gc]
                   : 0.f;
  }
  __syncthreads();

  // stem pixels: rows 2*oy0-1 .., cols 2*ox0-1 ..
  const int g2 = c2 / 8;
  for (int item = threadIdx.x; item < SY * SX * g2; item += kThreads) {
    int g = item / (SY * SX), p = item - g * (SY * SX);
    int r = p / SX, q = p - r * SX;
    int sy = 2 * oy0 - 1 + r, sx = 2 * ox0 - 1 + q;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    if (sy >= 0 && sy < Hs && sx >= 0 && sx < Ws) {
      for (int dy = 0; dy < 6; ++dy) {
        const float* irow = img + (2 * r + dy) * IX * 3 + 2 * q * 3;
        const float* wrow = w0 + (size_t)(dy * 18) * c2 + g * 8;
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
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = silu(acc[j] + b0[g * 8 + j]);
    }
    store8_bf16_a4(stem + p * sst + g * 8, acc);
  }
  __syncthreads();

  // layer 1: output (oy0+py, ox0+px) reads stem tile rows 2*py+dy, cols 2*px+dx
  const int g3 = c3 / 8;
  for (int item = threadIdx.x; item < TY * TX * g3; item += kThreads) {
    int g = item / (TY * TX), p = item - g * (TY * TX);
    int py = p / TX, px = p - py * TX;
    int oy = oy0 + py, ox = ox0 + px;
    if (oy >= Ho || ox >= Wo) continue;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        fma_pixel(stem + ((2 * py + dy) * SX + 2 * px + dx) * sst, c2,
                  w1 + (size_t)(dy * 3 + dx) * c2 * c3 + g * 8, c3, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = silu(acc[j] + b1[g * 8 + j]);
    store8_bf16(out + (((size_t)b * Ho + oy) * Wo + ox) * c3 + g * 8, acc);
  }
}

}  // namespace

extern "C" int stem_l1_launch(const uint8_t* x, const float* w0,
                              const float* b0, const void* w1, const float* b1,
                              void* out, int B, int H, int W, int c2, int c3,
                              void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  const int Ho = (Hs + 1) / 2, Wo = (Ws + 1) / 2;
  if (B == 0 || Ho <= 0 || Wo <= 0) return 0;
  size_t smem = (size_t)IY * IX * 3 * sizeof(float) +
                (size_t)SY * SX * smem_stride(c2) * sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(stem_l1_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wo + TX - 1) / TX, (Ho + TY - 1) / TY, B);
  stem_l1_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w0, b0, reinterpret_cast<const __nv_bfloat16*>(w1), b1,
      reinterpret_cast<__nv_bfloat16*>(out), H, W, c2, c3, Hs, Ws, Ho, Wo);
  return (int)cudaGetLastError();
}
