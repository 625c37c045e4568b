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
// the forward's 43.5 GFLOP run as three bf16 products (130.5 GFLOP, 0.13 ms
// at the tensor-core peak) against 453 MB moved (50 MB image, 403 MB z),
// 0.135 ms: bytes bound it, barely.  The weight gradient reads the same 453
// MB (0.135 ms) for the same 43.5 GFLOP of bf16 products (0.044 ms): bytes
// bound it.
//
// Design.  Forward: stem_mma.cuh's tensor-core stem (each float32 weight
// split into three bf16 terms, the uint8 image exact in bf16) on kRows x
// kCols rectangles of stem outputs, no halo; the raw sums rounded once to
// bf16 go through mma.cuh's stage_outputs and store_outputs (16-byte
// coalesced stores).  Persistent CTAs (as many as are resident at once)
// walk the rectangles, so each splits its weights once for ~40 of them
// (1024², b16).  A c2 past 80 runs in chunks of 80 columns (a grid axis).
// Weight gradient (scalar float32 FMAs): two stages, no atomics.  Stage 1:
// a fixed number of CTAs (`parts`, from the wrapper) each walk the 8x32
// pixel tiles tile_id ≡ blockIdx.x (mod parts), staging the tile's image
// patch and its dz rows (float) in shared memory (stem_conv.cuh's
// stage_patch); thread (tap, k-group) keeps dW rows (tap, c = 0..2) x 8
// output channels in registers over every pixel of every tile, then
// writes its CTA's partial.  Stage 2 (wgrad.cuh) sums the partials in
// order.
#include "stem_conv.cuh"
#include "stem_mma.cuh"
#include "wgrad.cuh"

namespace {

using stem_conv::IX;
using stem_conv::kImg;
using stem_conv::stage_patch;
using stem_conv::TX;
using stem_conv::TY;

// the forward's rectangle of stem outputs and its warps
constexpr int kRows = 8, kCols = 32;
constexpr int kFwdWarps = 4, kFwdThreads = 32 * kFwdWarps;
// a rectangle's image bytes start at 6*sx0 - 6, 2 mod 4 (sx0 is a multiple
// of 32): staged from 2 bytes earlier
using FwdRect = stem_mma::Rect<kRows, kCols, 2>;

// m16 tiles a warp step: 4 (64 pixels) up to 48 columns, else 2; both give
// each warp the same number of units of an 8x32 rectangle
template <int CP> struct Fwd {
  static constexpr int kM = CP <= 48 ? 4 : 2;
  using G = stem_mma::Gemm<CP, kM, FwdRect::kPx>;
  static constexpr int kOs = CP + 8;  // bf16 per staged output pixel
  static constexpr size_t kSmem =
      ((size_t)G::kSplit + FwdRect::kPx * kOs) * 2 +
      FwdRect::kImgRows * FwdRect::kImgPitch;
};

// the forward's epilogue: the float32 sums as they are (rounded once by
// stage_outputs)
struct Raw {
  struct Pair {};
  __device__ __forceinline__ Pair at(int) const { return {}; }
  __device__ __forceinline__ float2 operator()(const Pair&, float2 v) const {
    return v;
  }
};

// CTA (blockIdx.x, blockIdx.y): the rectangles blockIdx.x, + gridDim.x, ..
// (rectangle t: image t / per_image), columns blockIdx.y * CP ..
template <int CP>
__global__ void __launch_bounds__(kFwdThreads, CP <= 48 ? 3 : 2)
stem_fwd_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                __nv_bfloat16* __restrict__ z, int H, int W, int c2, int Hs,
                int Ws, int tiles_x, int per_image, int ntiles, int vec) {
  using F = Fwd<CP>;
  extern __shared__ float4 smem4[];
  auto* wsplit = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ot = wsplit + F::G::kSplit;
  auto* img = reinterpret_cast<uint8_t*>(ot + FwdRect::kPx * F::kOs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * CP;
  stem_mma::split_weights<CP, kFwdThreads>(w, c2, n0, wsplit);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / per_image, rem = t - b * per_image;
    const int sy0 = (rem / tiles_x) * kRows, sx0 = (rem % tiles_x) * kCols;
    __syncthreads();  // the previous rectangle's products and stores are done
    stem_mma::stage_image<FwdRect, kFwdThreads>(
        x + (size_t)b * H * W * 3, H, W, 2 * sy0 - 2, 3 * (2 * sx0 - 2), img,
        vec);
    __syncthreads();  // the image (and the split weights) for all
    auto valid = [&](int p) {
      return p < FwdRect::kPx && sy0 + p / kCols < Hs && sx0 + p % kCols < Ws;
    };
    auto epi = [&](int u, const auto& sacc) {
      stage_outputs<F::kM, F::G::kNT, CP, F::kOs, false>(
          sacc, Raw{}, valid, ot, nullptr, u, 0, lane, n0, c2);
    };
    stem_mma::products<CP, F::kM, FwdRect, kFwdWarps>(wsplit, img, warp,
                                                      lane, epi);
    __syncthreads();
    auto dst = [&](int p) -> __nv_bfloat16* {
      const int sy = sy0 + p / kCols, sx = sx0 + p % kCols;
      return sy < Hs && sx < Ws ? z + (((size_t)b * Hs + sy) * Ws + sx) * c2
                                : nullptr;
    };
    store_outputs<FwdRect::kPx, CP, F::kOs, kFwdThreads>(ot, dst, tid, n0,
                                                         c2);
  }
}

template <int CP>
cudaError_t fwd_launch(const uint8_t* x, const float* w, void* z, int B,
                       int H, int W, int c2, cudaStream_t stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  const int tiles_x = (Ws + kCols - 1) / kCols;
  const int per_image = tiles_x * ((Hs + kRows - 1) / kRows);
  const int ntiles = B * per_image;
  auto kern = stem_fwd_kernel<CP>;
  cudaError_t err = allow_smem(kern, Fwd<CP>::kSmem);
  if (err != cudaSuccess) return err;
  // persistent CTAs: as many as are resident at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, kFwdThreads, Fwd<CP>::kSmem);
  if (err != cudaSuccess) return err;
  const int grid = min(ntiles, (per_sm > 0 ? per_sm : 1) * sms);
  // 4-byte image loads: every staged row starts on a 4-byte boundary
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  kern<<<dim3(grid, (c2 + CP - 1) / CP), kFwdThreads, Fwd<CP>::kSmem,
         stream>>>(x, w, reinterpret_cast<__nv_bfloat16*>(z), H, W, c2, Hs,
                   Ws, tiles_x, per_image, ntiles, vec);
  return cudaGetLastError();
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

// Requires c2 % 8 == 0.
extern "C" int stem_train_fwd_launch(const uint8_t* x, const float* w, void* z,
                                     int B, int H, int W, int c2,
                                     void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  if (B == 0 || Hs <= 0 || Ws <= 0) return 0;
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((c2 + 15) / 16 * 16) {
    case 16: err = fwd_launch<16>(x, w, z, B, H, W, c2, st); break;
    case 32: err = fwd_launch<32>(x, w, z, B, H, W, c2, st); break;
    case 48: err = fwd_launch<48>(x, w, z, B, H, W, c2, st); break;
    case 64: err = fwd_launch<64>(x, w, z, B, H, W, c2, st); break;
    default: err = fwd_launch<80>(x, w, z, B, H, W, c2, st);  // chunks of 80
  }
  return (int)err;
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
