// The stem Conv(6x6, s2, p2) of the packed uint8 image as a tensor-core GEMM
// with float32 products: the stem of the stem+L1 kernel (stem_l1.cu), of
// the stem-only kernel (stem.cu) and of the train-mode stem's forward
// (stem_train.cu, whose weight gradient stages the image as here).
//
// x (B, H, 3W) uint8 — a free view of the NHWC batch — and the taps w0
// (108, c2) float32, row (6*dy + dx)*3 + c.  Stem pixel (sy, sx) reads image
// rows 2*sy - 2 .. 2*sy + 3 and pixels 2*sx - 2 .. 2*sx + 3, zero outside
// the image (the conv's padding).
//
// A uint8 value is exact in bf16; each float32 weight is split once per CTA
// into three bf16 terms w = hi + mid + lo (3 x 8 significant bits:
// float32's 24) in shared memory, and the three products add into the same
// float32 accumulators (mma.sync m16n8k16).  GEMM view: M = the stem pixels
// of an SR x SC rectangle, N = c2 (padded to 16; CP columns from n0), K =
// 6 image rows x 18 contiguous packed bytes (108, padded to 112 with zero
// weights), so K is the weights' own row order.  The image rows the
// rectangle needs are staged as uint8; each A register is one 2-byte load
// of two neighbouring packed bytes turned into a bf16 pair (the pair never
// crosses a tap row: 18 is even).  B (the split weights, [k][CP + 8]: an
// odd number of 16-byte units) by ldmatrix.x4.trans, conflict-free.  A warp
// takes kM m16 tiles at a time (a unit); the units go round the warps.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace stem_mma {

constexpr int kTaps = 108;  // 6 rows x 18 bytes
constexpr int kK = 112;     // K padded to k16 steps

// An SR x SC rectangle of stem pixels and the image bytes under it, staged
// from kShift bytes before its first (so that 4-byte loads start on a
// 4-byte boundary of an image row).
template <int SR, int SC, int kShift = 0> struct Rect {
  static constexpr int kRows = SR, kCols = SC, kOff = kShift;
  static constexpr int kPx = SR * SC;
  static constexpr int kImgRows = 2 * SR + 4;
  static constexpr int kImgBytes = 3 * (2 * SC + 4) + kShift;  // a row
  static constexpr int kImgWords = (kImgBytes + 3) / 4;
  static constexpr int kImgPitch = 4 * kImgWords;  // bytes a staged row
};

// The GEMM of CP columns over kPx pixels, kM m16 tiles a unit: n8 tiles,
// units, and the bf16 per row and in all of the three split weights.
template <int CP, int kM, int kPx> struct Gemm {
  static_assert(CP % 16 == 0 && CP <= 80, "c2 padded to 16, at most 80");
  static constexpr int kNT = CP / 8;
  static constexpr int kUnits = (kPx + 16 * kM - 1) / (16 * kM);
  static constexpr int kWp = CP + 8;
  static constexpr int kSplit = 3 * kK * kWp;
};

// w0's columns n0 .. n0 + CP - 1 split into three bf16 terms, [term][k][n]
// (Gemm::kWp per row), zero past 108 and c2
template <int CP, int kThreads>
__device__ __forceinline__ void split_weights(const float* __restrict__ w0,
                                              int c2, int n0,
                                              __nv_bfloat16* wsplit) {
  constexpr int kWp = CP + 8;
  for (int i = threadIdx.x; i < kK * CP; i += kThreads) {
    const int k = i / CP, n = i - k * CP;
    const float w =
        k < kTaps && n0 + n < c2 ? __ldg(w0 + k * c2 + n0 + n) : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16(w);
    const float r1 = w - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16(r1);
    const __nv_bfloat16 lo = __float2bfloat16(r1 - __bfloat162float(mid));
    wsplit[k * kWp + n] = hi;
    wsplit[(kK + k) * kWp + n] = mid;
    wsplit[(2 * kK + k) * kWp + n] = lo;
  }
}

// The rectangle's image rows gy0 .. and packed bytes gc0 - R::kOff .. of
// one image xb into img (zero outside the image: the stem's padding); 4
// bytes a load where the rows allow (vec: W % 4 == 0, a 4-byte aligned
// image and gc0 - R::kOff a multiple of 4), by cp.async with kAsync (the
// caller commits and waits), else byte by byte.
template <typename R, int kThreads, bool kAsync = false>
__device__ __forceinline__ void stage_image(const uint8_t* __restrict__ xb,
                                            int H, int W, int gy0, int gc0,
                                            uint8_t* img, int vec) {
  const int W3 = 3 * W;
  gc0 -= R::kOff;
  if (vec) {
    for (int i = threadIdx.x; i < R::kImgRows * R::kImgWords; i += kThreads) {
      const int r = i / R::kImgWords, u = i - r * R::kImgWords;
      const int gy = gy0 + r, gc = gc0 + 4 * u;
      if (kAsync) {
        const bool in = gy >= 0 && gy < H && gc >= 0 && gc < W3;
        cp_async4(img + r * R::kImgPitch + 4 * u,
                  in ? xb + (size_t)gy * W3 + gc : xb, in);
        continue;
      }
      uint32_t v = 0u;
      if (gy >= 0 && gy < H && gc >= 0 && gc < W3)
        v = __ldg(reinterpret_cast<const unsigned int*>(
            xb + (size_t)gy * W3 + gc));
      *reinterpret_cast<uint32_t*>(img + r * R::kImgPitch + 4 * u) = v;
    }
  } else {
    for (int i = threadIdx.x; i < R::kImgRows * R::kImgBytes; i += kThreads) {
      const int r = i / R::kImgBytes, c = i - r * R::kImgBytes;
      const int gy = gy0 + r, gc = gc0 + c;
      img[r * R::kImgPitch + c] = gy >= 0 && gy < H && gc >= 0 && gc < W3
                                      ? __ldg(xb + (size_t)gy * W3 + gc)
                                      : (uint8_t)0;
    }
  }
}

// two neighbouring packed bytes → the bf16 pair of an A register (exact)
__device__ __forceinline__ uint32_t u8x2_bf16x2(const uint8_t* p) {
  const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
  __nv_bfloat162 h =
      __floats2bfloat162_rn((float)(v & 0xffu), (float)(v >> 8));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The stem sums of the rectangle R (rows of R::kCols pixels) from the
// staged split weights and image: warp `warp` of kWarps takes units warp, warp +
// kWarps, ...; for each, epi(u, sacc) gets the float32 sums of pixels
// (u*kM + i)*16 + lane/4 (+ 8) at the mma.sync C fragment's columns
// (sacc[i][j][2h + e]: pixel (u*kM + i)*16 + lane/4 + 8h, column 8j +
// 2*(lane%4) + e).  A pixel past the rectangle reads pixel 0.
template <int CP, int kM, typename R, int kWarps, typename Epi>
__device__ __forceinline__ void products(const __nv_bfloat16* wsplit,
                                         const uint8_t* img, int warp,
                                         int lane, const Epi& epi) {
  constexpr int SC = R::kCols;
  using G = Gemm<CP, kM, R::kPx>;
  // per lane: its A rows (pixels lane/4 and lane/4 + 8 of each m16 tile)
  // and k pair, its B row and column
  const int g = lane >> 2, c4 = lane & 3;
  const int brow = lane & 15, bcol = (lane >> 4) * 8;
#pragma unroll 1
  for (int u = warp; u < G::kUnits; u += kWarps) {
    float sacc[kM][G::kNT][4];
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < G::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
    int pb[kM][2];  // image offset of the pixel's tap (0, 0)
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = (u * kM + i) * 16 + g + 8 * h;
        m = m < R::kPx ? m : 0;  // past the last pixel: never stored
        const int r = m / SC, q = m - r * SC;
        pb[i][h] = 2 * r * R::kImgPitch + 6 * q + R::kOff;
      }
#pragma unroll 1
    for (int ks = 0; ks < kK / 16; ++ks) {
      // k = 18*dy + t: image row dy, packed byte t of the pixel's 6
      const int ka = 16 * ks + 2 * c4, kb = ka + 8;
      const int oa = ka < kTaps ? ka / 18 * R::kImgPitch + ka % 18 : 0;
      const int ob = kb < kTaps ? kb / 18 * R::kImgPitch + kb % 18 : 0;
      uint32_t a[kM][4];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        a[i][0] = u8x2_bf16x2(img + pb[i][0] + oa);
        a[i][1] = u8x2_bf16x2(img + pb[i][1] + oa);
        a[i][2] = u8x2_bf16x2(img + pb[i][0] + ob);
        a[i][3] = u8x2_bf16x2(img + pb[i][1] + ob);
      }
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int p = 0; p < G::kNT / 2; ++p) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, wsplit + (s * kK + 16 * ks + brow) * G::kWp +
                                bcol + 16 * p);
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            mma16816(sacc[i][2 * p], a[i], bf[0], bf[1]);
            mma16816(sacc[i][2 * p + 1], a[i], bf[2], bf[3]);
          }
        }
    }
    epi(u, sacc);
  }
}

// ---------------------------------------------------------------------------
// The stem alone on persistent CTAs: stem.cu (+ bias, SiLU) and
// stem_train.cu's forward (the raw sums).  As many CTAs as are resident at
// once walk the kRectRows x kRectCols rectangles of stem pixels (no halo),
// so each splits its weights once for all of its rectangles (~40 at 1024²,
// b16).  A c2 past 80 runs in chunks of 80 columns (grid axis y).  The sums
// go through an epilogue functor and mma.cuh's stage_outputs (one rounding
// to bf16) and leave in 16-byte coalesced stores (store_outputs).
// ---------------------------------------------------------------------------

constexpr int kRectRows = 8, kRectCols = 32;
constexpr int kRectThreads = 128, kRectWarps = kRectThreads / 32;
// a rectangle's image bytes start at 6*sx0 - 6, 2 mod 4 (sx0 is a multiple
// of 32): staged from 2 bytes earlier
using Rect8x32 = Rect<kRectRows, kRectCols, 2>;

// The GEMM of CP columns over a rectangle: m16 tiles a warp step, 4 (64
// pixels) up to 48 columns, else 2 (both give each warp the same number of
// units); CTAs per SM (what the shared memory allows); shared memory: the
// split weights, the staged outputs and the image.
template <int CP> struct RectGemm {
  static constexpr int kM = CP <= 48 ? 4 : 2;
  static constexpr int kPerSm = CP <= 48 ? 3 : 2;
  using G = Gemm<CP, kM, Rect8x32::kPx>;
  static constexpr int kOs = CP + 8;  // bf16 per staged output pixel
  static constexpr size_t kSmem =
      ((size_t)G::kSplit + Rect8x32::kPx * kOs) * 2 +
      Rect8x32::kImgRows * Rect8x32::kImgPitch;
};

// A shape's 8x32 rectangles of stem pixels: rectangle t is in image t /
// per_image, at rectangle row (t % per_image) / tiles_x and column
// t % tiles_x.
struct RectGrid {
  int H, W, c2, Hs, Ws, tiles_x, per_image, ntiles;
  int vec;  // 4-byte image loads: every staged row starts on a 4-byte boundary
};

inline RectGrid rect_grid(const uint8_t* x, int B, int H, int W, int c2) {
  RectGrid g;
  g.H = H;
  g.W = W;
  g.c2 = c2;
  g.Hs = (H - 2) / 2 + 1;
  g.Ws = (W - 2) / 2 + 1;
  g.tiles_x = (g.Ws + kRectCols - 1) / kRectCols;
  g.per_image = g.tiles_x * ((g.Hs + kRectRows - 1) / kRectRows);
  g.ntiles = B * g.per_image;
  g.vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  return g;
}

// f(std::integral_constant<int, CP>{}) for c2 padded to 16; past 80, CP = 80
// (chunks of 80 columns)
template <typename F>
auto by_width(int c2, const F& f) {
  switch ((c2 + 15) / 16 * 16) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, 80>{});
  }
}

// The body of CTA (blockIdx.x, blockIdx.y) of kRectThreads threads: the
// rectangles blockIdx.x, + gridDim.x, .., columns blockIdx.y * CP .. of
// y (B, Hs, Ws, c2) bf16 = epi(the stem sums w·x), rounded once.
template <int CP, typename Epi>
__device__ __forceinline__ void rects(const uint8_t* __restrict__ x,
                                      const float* __restrict__ w,
                                      const Epi& epi,
                                      __nv_bfloat16* __restrict__ y,
                                      const RectGrid& g) {
  using RG = RectGemm<CP>;
  extern __shared__ float4 smem4[];
  auto* wsplit = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ot = wsplit + RG::G::kSplit;
  auto* img = reinterpret_cast<uint8_t*>(ot + Rect8x32::kPx * RG::kOs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * CP;
  split_weights<CP, kRectThreads>(w, g.c2, n0, wsplit);
  for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x) {
    const int b = t / g.per_image, rem = t - b * g.per_image;
    const int sy0 = (rem / g.tiles_x) * kRectRows;
    const int sx0 = (rem % g.tiles_x) * kRectCols;
    __syncthreads();  // the previous rectangle's products and stores are done
    stage_image<Rect8x32, kRectThreads>(x + (size_t)b * g.H * g.W * 3, g.H,
                                        g.W, 2 * sy0 - 2, 3 * (2 * sx0 - 2),
                                        img, g.vec);
    __syncthreads();  // the image (and the split weights) for all
    auto valid = [&](int p) {
      return p < Rect8x32::kPx && sy0 + p / kRectCols < g.Hs &&
             sx0 + p % kRectCols < g.Ws;
    };
    auto to_ot = [&](int u, const auto& sacc) {
      stage_outputs<RG::kM, RG::G::kNT, CP, RG::kOs, false>(
          sacc, epi, valid, ot, nullptr, u, 0, lane, n0, g.c2);
    };
    products<CP, RG::kM, Rect8x32, kRectWarps>(wsplit, img, warp, lane,
                                               to_ot);
    __syncthreads();
    auto dst = [&](int p) -> __nv_bfloat16* {
      const int sy = sy0 + p / kRectCols, sx = sx0 + p % kRectCols;
      return sy < g.Hs && sx < g.Ws
                 ? y + (((size_t)b * g.Hs + sy) * g.Ws + sx) * g.c2
                 : nullptr;
    };
    store_outputs<Rect8x32::kPx, CP, RG::kOs, kRectThreads>(ot, dst, tid, n0,
                                                            g.c2);
  }
}

// The launch of kern, a kernel whose body is rects<CP> and whose arguments
// are args then g: as many CTAs as are resident at once (the occupancy
// query: shared memory and registers), at most one per rectangle, times
// the chunks of CP columns.
template <int CP, typename K, typename... Args>
cudaError_t launch_rects(K kern, const RectGrid& g, cudaStream_t stream,
                         Args... args) {
  constexpr size_t smem = RectGemm<CP>::kSmem;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = allow_smem(kern, smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kRectThreads, smem)) != cudaSuccess)
    return err;
  const int grid = min(g.ntiles, (per_sm > 0 ? per_sm : 1) * sms);
  kern<<<dim3(grid, (g.c2 + CP - 1) / CP), kRectThreads, smem, stream>>>(
      args..., g);
  return cudaGetLastError();
}

}  // namespace stem_mma
