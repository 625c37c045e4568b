// Train-mode downsample: the raw Conv(3x3, s2, p1) (no BatchNorm, no
// activation) and its weight gradient.  The input gradient is not a kernel
// here, as on the TPU: the wrapper takes the transposed conv.
//
// Replaces: yolov5_obb_tpu/ops/pallas/down_kernel.py:295 fused_down_train
//   (custom VJP _down_train_p :210): forward body _kernel_raw :147
//   (pallas_call :227), weight-grad body _wgrad_kernel :169 (pallas_call :263).
//
// Forward: x (B, H, W, ci) bf16, taps w (9*ci, co) bf16, row (3*dy + dx)*ci
// + c → z (B, (H+1)/2, (W+1)/2, co) bf16; float32 accumulation.
// Weight gradient: dz (B, Ho, Wo, co) bf16 → dW (9*ci, co) float32 in the
// same tap layout; bf16 taps times bf16 dz, float32 accumulation.
//
// Bounds on this card at yolov5m b16 1024²: layer 1 (512² x 48 → 256² x 96)
// and layer 3 (256² x 96 → 128² x 192) are 87 GFLOP of bf16 products each
// (0.088 ms at the tensor-core peak) against 604 MB and 302 MB moved (0.18
// and 0.09 ms): bytes bound both, forward and weight gradient alike.  The
// weight gradient uses scalar float32 FMAs, so in practice operations limit
// it.
//
// Design.  Forward: the tensor-core implicit GEMM of conv3x3_mma.cuh,
// without prologue or statistics (the patch staged by cp.async).
// Weight gradient, two stages and no atomics.  dW is a product of the
// im2col matrix (pixels x 9*ci) transposed with dz (pixels x co) over the
// 1 M / 262 k output pixels.  Stage 1: grid (channel chunks, parts); a CTA
// owns 16 input channels x 32 output channels of every tap and walks the
// 8x16 output-pixel tiles tile_id ≡ blockIdx.y (mod parts).  Per tile it
// stages the 17x33 input patch of its 16 channels and the tile's dz rows of
// its 32 channels (as float) in shared memory; thread (tap, 4 input
// channels, 8 output channels) keeps a 4x8 block of dW in registers over
// every pixel, so each pixel costs it three 16-byte shared loads for 32
// FMAs.  The CTA then writes its partial dW; stage 2 (wgrad.cuh) sums the
// partials in order.
#include "conv3x3_mma.cuh"
#include "wgrad.cuh"

namespace {

constexpr int CC = 16;                   // input channels per CTA
constexpr int KC = 32;                   // output channels per CTA
constexpr int WY = 8, WX = 16;           // output pixels per tile
constexpr int PY = 2 * WY + 1, PX = 2 * WX + 1;  // input pixels per tile
constexpr int XS = CC + 4;               // floats per staged input pixel
constexpr int kXs = PY * PX * XS;        // floats of the staged patch
constexpr int kWThreads = 9 * (CC / 4) * (KC / 8);

__global__ void __launch_bounds__(kWThreads)
down_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dz,
                  float* __restrict__ partial, int H, int W, int ci, int co,
                  int Ho, int Wo, int tiles_x, int tiles_y, int ntiles,
                  int nkc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* dzs = xs + kXs;  // kXs * 4 bytes is a multiple of 16
  const int cc0 = (blockIdx.x / nkc) * CC, kc0 = (blockIdx.x % nkc) * KC;
  const int tid = threadIdx.x;
  const int kg = tid % (KC / 8);
  const int cg = (tid / (KC / 8)) % (CC / 4);
  const int tap = tid / ((KC / 8) * (CC / 4));
  const int dy = tap / 3, dx = tap - dy * 3;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int oy0 = (rem / tiles_x) * WY, ox0 = (rem % tiles_x) * WX;
    __syncthreads();  // the previous tile's reads are done
    // input patch rows 2*oy0 - 1 .., cols 2*ox0 - 1 .. (zero outside the
    // image: the conv's padding), channels cc0 .. cc0+15 (zero past ci)
    for (int idx = tid; idx < PY * PX * (CC / 8); idx += kWThreads) {
      int p = idx / (CC / 8), h = idx - p * (CC / 8);
      int r = p / PX, q = p - r * PX;
      int gy = 2 * oy0 - 1 + r, gx = 2 * ox0 - 1 + q, c = cc0 + h * 8;
      float f[8];
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < ci) {
        load8_bf16(x + (((size_t)b * H + gy) * W + gx) * ci + c, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      float4* d = reinterpret_cast<float4*>(xs + p * XS + h * 8);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    // dz of the tile's pixels, output channels kc0 .. kc0+31 (zero past co
    // and outside the output)
    for (int idx = tid; idx < WY * WX * (KC / 8); idx += kWThreads) {
      int p = idx / (KC / 8), g = idx - p * (KC / 8);
      int oy = oy0 + p / WX, ox = ox0 + p % WX, k = kc0 + g * 8;
      float f[8];
      if (oy < Ho && ox < Wo && k < co) {
        load8_bf16(dz + (((size_t)b * Ho + oy) * Wo + ox) * co + k, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
      float4* d = reinterpret_cast<float4*>(dzs + p * KC + g * 8);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    for (int p = 0; p < WY * WX; ++p) {
      const int py = p / WX, px = p - py * WX;
      const float4 xv = *reinterpret_cast<const float4*>(
          xs + ((2 * py + dy) * PX + 2 * px + dx) * XS + cg * 4);
      const float4 d0 = *reinterpret_cast<const float4*>(dzs + p * KC + kg * 8);
      const float4 d1 =
          *reinterpret_cast<const float4*>(dzs + p * KC + kg * 8 + 4);
      const float v[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(v[i], d0.x, acc[i][0]);
        acc[i][1] = fmaf(v[i], d0.y, acc[i][1]);
        acc[i][2] = fmaf(v[i], d0.z, acc[i][2]);
        acc[i][3] = fmaf(v[i], d0.w, acc[i][3]);
        acc[i][4] = fmaf(v[i], d1.x, acc[i][4]);
        acc[i][5] = fmaf(v[i], d1.y, acc[i][5]);
        acc[i][6] = fmaf(v[i], d1.z, acc[i][6]);
        acc[i][7] = fmaf(v[i], d1.w, acc[i][7]);
      }
    }
  }
  const int k = kc0 + kg * 8;
  if (k >= co) return;
  float* out = partial + (size_t)blockIdx.y * 9 * ci * co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = cc0 + cg * 4 + i;
    if (c >= ci) break;
    float4* o = reinterpret_cast<float4*>(out + (size_t)(tap * ci + c) * co + k);
    o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

extern "C" int down_train_fwd_launch(const void* x, const void* w, void* z,
                                     int B, int H, int W, int ci, int co,
                                     void* stream) {
  return (int)conv3x3_mma::launch<2, false, false>(
      x, nullptr, w, z, nullptr, B, H, W, ci, co, (cudaStream_t)stream);
}

// partial: parts * 9*ci*co floats of scratch; dw: 9*ci*co floats.
extern "C" int down_train_wgrad_launch(const void* x, const void* dz,
                                       float* partial, float* dw, int B, int H,
                                       int W, int ci, int co, int parts,
                                       void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_x = (Wo + WX - 1) / WX, tiles_y = (Ho + WY - 1) / WY;
  const int ncc = (ci + CC - 1) / CC, nkc = (co + KC - 1) / KC;
  const size_t smem = (size_t)(kXs + WY * WX * KC) * sizeof(float);
  cudaError_t err = allow_smem(down_wgrad_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ncc * nkc, parts);
  down_wgrad_kernel<<<grid, kWThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const __nv_bfloat16*>(dz), partial, H, W, ci, co, Ho,
      Wo, tiles_x, tiles_y, B * tiles_x * tiles_y, nkc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, dw, 9 * ci * co, parts,
                                  (cudaStream_t)stream);
}
