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
// order.  The image values (exact in bf16) times dz, float32 accumulation,
// as the TPU kernel's bf16 x bf16 MXU product.  The image takes no gradient.
//
// Bounds on this card at yolov5m b16 1024² (c2 = 48, 4.2 M output pixels):
// the forward's 43.5 GFLOP run as three bf16 products (130.5 GFLOP, 0.13 ms
// at the tensor-core peak) against 453 MB moved (50 MB image, 403 MB z),
// 0.135 ms: bytes bound it, barely.  The weight gradient reads the same 453
// MB (0.135 ms) for the same 43.5 GFLOP of bf16 products (0.044 ms): bytes
// bound it.
//
// Design.  Forward: stem_mma.cuh's tensor-core stem on its persistent 8x32
// rectangles (stem.cu's body), the raw sums rounded once to bf16.
// Weight gradient: a split-K GEMM on mma.sync m16n8k16 (bf16 in, float32
// accumulation), two stages and no atomics.  dW = patchᵀ · dz: M = the taps
// in the forward's K order k = 18*dy + 3*dx + c (108, padded to 128: each
// of the 4 warps holds two m16 tiles; rows past 108 are never written), N =
// c2 (CP columns a CTA, chunks of 80 past 80 on grid axis y), K = the
// output pixels, one 8x32 rectangle (16 k16 steps) a tile.  The `parts`
// CTAs (as many as reside on the card, by the occupancy query of
// stem_train_wgrad_parts, which the wrapper sizes its partial by) each
// walk the tiles t ≡ blockIdx.x (mod parts), their dW block in registers.
// A tile's image rows (uint8, staged as stem_mma.cuh's stage_image does,
// by 4-byte cp.async where the rows allow) and its dz rows (c2 + 8 bf16 a
// pixel: an odd number of 16-byte units) are staged by cp.async (zero
// outside the image and the output and past c2), double-buffered, so the
// next tile's copies land behind this tile's products.  A: an A register's
// pair is one tap at two neighbouring pixels, two bytes 6 apart in the
// staged row, turned exactly into a bf16 pair; the per-lane tap offsets
// are computed once.  B: the dz rows by ldmatrix.x4.trans.  The CTA then
// writes its partial dW; stage 2 (wgrad.cuh's sum_partials) sums the
// partials in order.
#include "stem_mma.cuh"
#include "wgrad.cuh"

namespace {

using stem_mma::kRectCols;
using stem_mma::kRectRows;
using stem_mma::Rect8x32;
using stem_mma::RectGrid;

template <int CP>
__global__ void __launch_bounds__(stem_mma::kRectThreads,
                                  stem_mma::RectGemm<CP>::kPerSm)
stem_fwd_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                __nv_bfloat16* __restrict__ z, RectGrid g) {
  stem_mma::rects<CP>(x, w, Raw{}, z, g);
}

// The weight gradient's CTA: 4 warps, warp w holding dW rows (taps) 32w ..
// 32w + 31 (kWgMT m16 tiles) x the CP columns of its chunk.
constexpr int kWgWarps = 4, kWgThreads = 32 * kWgWarps, kWgMT = 2;
constexpr int kSteps = kRectRows * kRectCols / 16;  // k16 steps a tile

template <int CP> struct Wgrad {
  static_assert(CP % 16 == 0 && CP <= 80, "c2 padded to 16, at most 80");
  static constexpr int kNT = CP / 8;
  static constexpr int kDs = CP + 8;  // bf16 per staged dz pixel
  // CTAs per SM: what the shared memory allows
  static constexpr int kPerSm = CP <= 48 ? 3 : 2;
  static constexpr int kDzBytes = Rect8x32::kPx * kDs * 2;
  // bytes of one stage: dz rows, then image rows (a multiple of 16)
  static constexpr int kStage =
      kDzBytes + Rect8x32::kImgRows * Rect8x32::kImgPitch;
  static constexpr size_t kSmem = 2 * (size_t)kStage;
};

// the image bytes at p and p + 6 (one tap at two neighbouring stem pixels)
// → the bf16 pair of an A register, exactly: byte v is the float whose bits
// are 0x4b0000vv (2^23 + v) less 2^23, and its bf16 is that float's upper
// half
__device__ __forceinline__ uint32_t u8s6_bf16x2(const uint8_t* p) {
  const float lo = __uint_as_float(0x4b000000u | p[0]) - 8388608.f;
  const float hi = __uint_as_float(0x4b000000u | p[6]) - 8388608.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Stage 1 of the weight gradient: CTA (blockIdx.x, blockIdx.y) sums the
// tiles blockIdx.x, + gridDim.x, .. at columns blockIdx.y * CP .. into its
// partial dW (partial + blockIdx.x * 108 * c2).
template <int CP>
__global__ void __launch_bounds__(kWgThreads, Wgrad<CP>::kPerSm)
stem_wgrad_kernel(const uint8_t* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dz,
                  float* __restrict__ partial, RectGrid g) {
  using Wg = Wgrad<CP>;
  constexpr int kDs = Wg::kDs, kPitch = Rect8x32::kImgPitch;
  extern __shared__ float4 smem4[];
  auto* sm = reinterpret_cast<uint8_t*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * CP;

  // tile t's dz rows (columns n0 .., zero past the stem image and c2) and
  // image rows into stage buffer buf
  auto stage = [&](int t, int buf) {
    uint8_t* st = sm + buf * Wg::kStage;
    auto* dzs = reinterpret_cast<__nv_bfloat16*>(st);
    const int b = t / g.per_image, rem = t - b * g.per_image;
    const int sy0 = (rem / g.tiles_x) * kRectRows;
    const int sx0 = (rem % g.tiles_x) * kRectCols;
    constexpr int kG = CP / 8;
    for (int i = tid; i < Rect8x32::kPx * kG; i += kWgThreads) {
      const int p = i / kG, q = i - p * kG;
      const int sy = sy0 + p / kRectCols, sx = sx0 + p % kRectCols;
      const int n = n0 + 8 * q;
      const bool in = sy < g.Hs && sx < g.Ws && n < g.c2;
      cp_async16(dzs + p * kDs + 8 * q,
                 in ? dz + (((size_t)b * g.Hs + sy) * g.Ws + sx) * g.c2 + n
                    : dz,
                 in);
    }
    stem_mma::stage_image<Rect8x32, kWgThreads, true>(
        x + (size_t)b * g.H * g.W * 3, g.H, g.W, 2 * sy0 - 2,
        3 * (2 * sx0 - 2), st + Wg::kDzBytes, g.vec);
  };

  float acc[kWgMT][Wg::kNT][4];
#pragma unroll
  for (int i = 0; i < kWgMT; ++i)
#pragma unroll
    for (int j = 0; j < Wg::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // per lane: the image offsets of its A rows' taps (k = 18*dy + t: row
  // dy, byte t; taps past 108 read byte 0 and are never written) and of
  // its pixel 2*(lane%4) in a k16 step; its B row (pixel lane % 16) and
  // column half
  const int gq = lane >> 2, c4 = lane & 3;
  int toff[kWgMT][2];
#pragma unroll
  for (int i = 0; i < kWgMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * (kWgMT * warp + i) + gq + 8 * h;
      toff[i][h] = k < stem_mma::kTaps ? k / 18 * kPitch + k % 18 : 0;
    }
  const int aoff = Wg::kDzBytes + 12 * c4 + Rect8x32::kOff;
  const int boff = (lane & 15) * kDs + (lane >> 4) * 8;

  int t = blockIdx.x;
  if (t < g.ntiles) stage(t, 0);
  cp_async_commit();
  for (int k = 0; t < g.ntiles; t += gridDim.x, ++k) {
    if (t + (int)gridDim.x < g.ntiles) stage(t + gridDim.x, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies landed (this thread's) ...
    __syncthreads();     // ... and everyone's
    const uint8_t* st = sm + (k & 1) * Wg::kStage;
    const auto* dzs = reinterpret_cast<const __nv_bfloat16*>(st) + boff;
#pragma unroll 1
    for (int ks = 0; ks < kSteps; ++ks) {
      // pixels 16*ks .. + 15: tile row ks / 2, columns 16 * (ks % 2) ..
      uint32_t bf[Wg::kNT / 2][4];
#pragma unroll
      for (int p = 0; p < Wg::kNT / 2; ++p)
        ldsm_x4_trans(bf[p], dzs + 16 * ks * kDs + 16 * p);
      const uint8_t* ap =
          st + aoff + (ks >> 1) * 2 * kPitch + (ks & 1) * 96;
#pragma unroll
      for (int i = 0; i < kWgMT; ++i) {
        uint32_t a[4];
        a[0] = u8s6_bf16x2(ap + toff[i][0]);
        a[1] = u8s6_bf16x2(ap + toff[i][1]);
        a[2] = u8s6_bf16x2(ap + 48 + toff[i][0]);
        a[3] = u8s6_bf16x2(ap + 48 + toff[i][1]);
#pragma unroll
        for (int p = 0; p < Wg::kNT / 2; ++p) {
          mma16816(acc[i][2 * p], a, bf[p][0], bf[p][1]);
          mma16816(acc[i][2 * p + 1], a, bf[p][2], bf[p][3]);
        }
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }

  // the CTA's dW block (rows: taps lane/4 and lane/4 + 8 of each m16 tile;
  // columns 2*(lane%4), +1 of each n8 tile) into its partial
  float* out = partial + (size_t)blockIdx.x * stem_mma::kTaps * g.c2;
#pragma unroll
  for (int i = 0; i < kWgMT; ++i)
#pragma unroll
    for (int j = 0; j < Wg::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tap = 16 * (kWgMT * warp + i) + gq + 8 * h;
        const int n = n0 + 8 * j + 2 * c4;
        if (tap < stem_mma::kTaps && n < g.c2)
          *reinterpret_cast<float2*>(out + tap * g.c2 + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// CTAs along the pixel axis: as many as reside on the card at once (the
// occupancy query: shared memory and registers) beside the column chunks,
// at most one per tile.  Fixed for a card and a shape, so repeated runs add
// the same partials in the same order.
template <int CP>
cudaError_t wgrad_parts(const RectGrid& g, int* parts) {
  auto kern = stem_wgrad_kernel<CP>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = allow_smem(kern, Wgrad<CP>::kSmem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kWgThreads, Wgrad<CP>::kSmem)) != cudaSuccess)
    return err;
  const int chunks = (g.c2 + CP - 1) / CP;
  const int fit = (sms * per_sm + chunks - 1) / chunks;
  *parts = fit < g.ntiles ? fit : g.ntiles;
  if (*parts < 1) *parts = 1;
  return cudaSuccess;
}

}  // namespace

// Requires c2 % 8 == 0.
extern "C" int stem_train_fwd_launch(const uint8_t* x, const float* w, void* z,
                                     int B, int H, int W, int c2,
                                     void* stream) {
  const RectGrid g = stem_mma::rect_grid(x, B, H, W, c2);
  if (B == 0 || g.Hs <= 0 || g.Ws <= 0) return 0;
  auto zb = reinterpret_cast<__nv_bfloat16*>(z);
  return (int)stem_mma::by_width(c2, [&](auto cp) {
    constexpr int CP = decltype(cp)::value;
    return stem_mma::launch_rects<CP>(stem_fwd_kernel<CP>, g,
                                      (cudaStream_t)stream, x, w, zb);
  });
}

// The rows of the weight gradient's partial for a shape (its `parts`), or
// minus a CUDA error.  Launches nothing.
extern "C" int stem_train_wgrad_parts(int B, int H, int W, int c2) {
  const RectGrid g = stem_mma::rect_grid(nullptr, B, H, W, c2);
  int parts = 0;
  const cudaError_t err = stem_mma::by_width(
      c2, [&](auto cp) { return wgrad_parts<decltype(cp)::value>(g, &parts); });
  return err != cudaSuccess ? -(int)err : parts;
}

// partial: parts * 108 * c2 floats of scratch, parts from
// stem_train_wgrad_parts; dw: 108 * c2 floats.  Requires c2 % 8 == 0 and a
// 16-byte aligned dz.
extern "C" int stem_train_wgrad_launch(const uint8_t* x, const void* dz,
                                       float* partial, float* dw, int B, int H,
                                       int W, int c2, int parts,
                                       void* stream) {
  const RectGrid g = stem_mma::rect_grid(x, B, H, W, c2);
  auto st = (cudaStream_t)stream;
  const cudaError_t err = stem_mma::by_width(c2, [&](auto cp) {
    constexpr int CP = decltype(cp)::value;
    auto kern = stem_wgrad_kernel<CP>;
    cudaError_t e = allow_smem(kern, Wgrad<CP>::kSmem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(parts, (c2 + CP - 1) / CP), kWgThreads, Wgrad<CP>::kSmem,
           st>>>(x, reinterpret_cast<const __nv_bfloat16*>(dz), partial, g);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, dw, stem_mma::kTaps * c2, parts,
                                  st);
}
