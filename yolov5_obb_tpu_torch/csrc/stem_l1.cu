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
// the float32 products of the exact uint8 values and the float32 weights,
// rounded to bf16 before layer 1, and layer 1 accumulates in float32.
//
// Bound on this card at yolov5m b16 1024² (c2=48, c3=96): operations.  The
// stem's 43.5 GFLOP run here as three bf16 products (130.5 GFLOP, 0.13 ms at
// the 989 TFLOP/s tensor-core peak), layer 1's 87 GFLOP take 0.09 ms:
// together 0.22 ms, against 0.075 ms for the ~251 MB moved (50 MB image in,
// 201 MB out).
//
// Design: one CTA per 8x16 tile of layer-1 outputs of one image, the 4 warps
// of conv3x3_mma.cuh's body.
// 1. The stem on the tensor cores with float32 products (stem_mma.cuh: the
//    uint8 image exact in bf16, each float32 weight split once per CTA into
//    three bf16 terms, K in the weights' row order) over the 17x33 stem
//    pixels under the tile (layer 1's stride-2 patch, 9.6% more than the
//    tile's 4 x 128).  The image rows the tile needs (38 x 210 bytes) are
//    staged as uint8.  Each warp takes 3 m16 tiles at a time (2 at c2 >
//    48): 12 steps of 48 pixels share the 4 warps evenly.
// 2. The stem epilogue: + b0, SiLU (IEEE expf), one rounding to bf16,
//    written straight into the layer-1 patch in the layout the body's
//    stride-2 gather reads (Patch<2>: even and odd columns apart, a slot of
//    c2 + 8 channels: an odd number of 16-byte units).  A stem pixel outside
//    the stem image, and a channel past c2, is written as zero: layer 1's
//    padding.
// 3. Layer 1 on conv3x3_mma.cuh's main loop (patch_mainloop), its patch
//    filled by step 2 instead of copied from device memory (one chunk of all
//    c2 channels; the loop's patch hook does nothing), the taps streaming
//    through the body's cp.async ring,
//    which takes the room of the split weights and the image once the stem
//    is done.  Epilogue: + b1, SiLU (IEEE expf), one rounding, 16-byte
//    stores through shared memory (mma.cuh's).  A c3 wider than one N chunk
//    (chunk_n: 48 or 96) runs its chunks one after the other on the same
//    patch, so the stem is computed once per tile.
// Shared memory at yolov5m: 64.7 KB of patch + 45.7 KB for the stem's
// operands (the ring needs 30.0): 110.4 KB, two CTAs per SM.  c2 may be at
// most 80 (yolov5x): the patch, the split weights and the image must fit a
// block's shared memory.
#include "conv3x3_mma.cuh"
#include "stem_mma.cuh"

namespace {

using conv3x3_mma::kStages;
using conv3x3_mma::kThreads;
using conv3x3_mma::kTileX;
using conv3x3_mma::kTileY;
using conv3x3_mma::Split;
using P2 = conv3x3_mma::Patch<2>;
using Img = stem_mma::Rect<P2::rows, P2::cols>;  // the stem pixels per CTA

constexpr int kWarps = kThreads / 32;

// The stem GEMM for c2 padded to CP: m16 tiles per warp step.
template <int CP> struct Stem {
  static constexpr int kM = CP <= 48 ? 3 : 2;
  using G = stem_mma::Gemm<CP, kM, Img::kPx>;
};

// Shared memory, in bf16 elements from its start: the patch (whose room
// the last chunk's outputs reuse), then either the stem's split weights and
// image (bytes) or layer 1's tap ring and, with more than one N chunk, the
// other chunks' output staging.
template <int CP, int N> struct Smem {
  static constexpr int kPatchIn = P2::rows * P2::row_slots * (CP + 8);
  static constexpr int kOt = kTileY * kTileX * Split<N>::kOs;
  static constexpr int kPatch = kPatchIn > kOt ? kPatchIn : kOt;
  static constexpr int kRing = kStages * CP * Split<N>::kWs;
  static constexpr int kStemBytes =
      Stem<CP>::G::kSplit * 2 + Img::kImgRows * Img::kImgPitch;
  static size_t bytes(int n_chunks) {
    const size_t l1 = (size_t)(kRing + (n_chunks > 1 ? kOt : 0)) * 2;
    return (size_t)kPatch * 2 + (l1 > kStemBytes ? l1 : kStemBytes);
  }
};

// (two CTAs per SM: what the shared memory allows at yolov5m; ptxas may then
// use up to 255 registers and needs no spill)
template <int CP, int N>
__global__ void __launch_bounds__(kThreads, 2)
stem_l1_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w0,
               const float* __restrict__ b0,
               const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
               int H, int W, int c2, int c3, int Hs, int Ws, int Ho, int Wo,
               int tiles_x, int vec) {
  using St = Stem<CP>;
  using Sm = Smem<CP, N>;
  using Sp = Split<N>;
  constexpr int ps = CP + 8;  // bf16 per patch slot
  extern __shared__ float4 smem4[];
  auto* patch = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* wsplit = patch + Sm::kPatch;   // the stem's operands ...
  auto* img = reinterpret_cast<uint8_t*>(wsplit + St::G::kSplit);
  __nv_bfloat16* wbuf = patch + Sm::kPatch;     // ... then layer 1's ring
  __nv_bfloat16* ot_mid = wbuf + Sm::kRing;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTileY;
  const int ox0 = (blockIdx.x % tiles_x) * kTileX;

  // the stem of the tile's 17x33 stem pixels (rows 2*oy0 - 1 .., columns
  // 2*ox0 - 1 ..) into the patch
  auto stem = [&]() {
    stem_mma::split_weights<CP, kThreads>(w0, c2, 0, wsplit);
    // image rows 4*oy0 - 4 .., packed bytes 3*(4*ox0 - 4) ..
    stem_mma::stage_image<Img, kThreads>(x + (size_t)b * H * W * 3, H, W,
                                         4 * oy0 - 4, 3 * (4 * ox0 - 4), img,
                                         vec);
    __syncthreads();
    // + b0, SiLU, one rounding to bf16, into the pixel's patch slot; zero
    // outside the stem image (layer 1's padding) and past c2
    const int g = lane >> 2, c4 = lane & 3;
    auto epi = [&](int u, const auto& sacc) {
#pragma unroll
      for (int i = 0; i < St::kM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (u * St::kM + i) * 16 + g + 8 * h;
          if (m >= Img::kPx) continue;
          const int r = m / P2::cols, q = m - r * P2::cols;
          const int sy = 2 * oy0 - 1 + r, sx = 2 * ox0 - 1 + q;
          const bool in = sy >= 0 && sy < Hs && sx >= 0 && sx < Ws;
          __nv_bfloat16* dst =
              patch + (r * P2::row_slots + P2::slot(q)) * ps + 2 * c4;
#pragma unroll
          for (int j = 0; j < St::G::kNT; ++j) {
            const int n = 8 * j + 2 * c4;
            float2 v = make_float2(0.f, 0.f);
            if (in && n < c2)
              v = make_float2(silu(sacc[i][j][2 * h] + __ldg(b0 + n)),
                              silu(sacc[i][j][2 * h + 1] + __ldg(b0 + n + 1)));
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(v.x, v.y);
          }
        }
    };
    stem_mma::products<CP, St::kM, Img, kWarps>(wsplit, img, warp, lane,
                                                epi);
    __syncthreads();  // the patch is whole; the stem's operands are dead
  };

  const int wm = warp % Sp::kWarpsM, wn = warp / Sp::kWarpsM;
  auto valid = [&](int p) {
    return oy0 + p / kTileX < Ho && ox0 + p % kTileX < Wo;
  };
  auto dst = [&](int p) -> __nv_bfloat16* {
    const int oy = oy0 + p / kTileX, ox = ox0 + p % kTileX;
    return oy < Ho && ox < Wo ? out + (((size_t)b * Ho + oy) * Wo + ox) * c3
                              : nullptr;
  };
  // the stem once, before (not inside) the chunks' main loops, so none of
  // its values stays live through them
  stem();
  const int n_chunks = (c3 + N - 1) / N;
  // one K chunk of all c2 channels (padded to 16: CP), passed as a run-time
  // value like the other 3x3 kernels' chunk, so the main loop's k16 steps
  // stay a loop with an exit and the compiler does not preload them all
  const int ck = (c2 + 15) / 16 * 16;
  for (int nc = 0; nc < n_chunks; ++nc) {
    const int n0 = nc * N;
    float acc[Sp::kMTiles][Sp::kNTiles][4];
    conv3x3_mma::patch_mainloop<2, N, CP>(acc, patch, wbuf, w1, c2, c3, n0,
                                          ck, [](int) {}, [](int) {});
    __syncthreads();  // the products have read the patch and the ring
    __nv_bfloat16* ot = nc + 1 == n_chunks ? patch : ot_mid;
    stage_outputs<Sp::kMTiles, Sp::kNTiles, N, Sp::kOs, false>(
        acc, BiasSilu{b1}, valid, ot, nullptr, wm, wn, lane, n0, c3);
    __syncthreads();
    store_outputs<kTileY * kTileX, N, Sp::kOs, kThreads>(ot, dst, tid, n0,
                                                         c3);
  }
}

template <int CP, int N>
cudaError_t launch_cp(const uint8_t* x, const float* w0, const float* b0,
                      const void* w1, const float* b1, void* out, int B,
                      int H, int W, int c2, int c3, cudaStream_t stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  const int Ho = (Hs + 1) / 2, Wo = (Ws + 1) / 2;
  const int tiles_x = (Wo + kTileX - 1) / kTileX;
  const int tiles_y = (Ho + kTileY - 1) / kTileY;
  const size_t smem = Smem<CP, N>::bytes((c3 + N - 1) / N);
  auto kern = stem_l1_kernel<CP, N>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  // 4-byte image loads: every staged row starts on a 4-byte boundary
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  kern<<<dim3(tiles_x * tiles_y, B), kThreads, smem, stream>>>(
      x, w0, b0, reinterpret_cast<const __nv_bfloat16*>(w1), b1,
      reinterpret_cast<__nv_bfloat16*>(out), H, W, c2, c3, Hs, Ws, Ho, Wo,
      tiles_x, vec);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_n(const uint8_t* x, const float* w0, const float* b0,
                     const void* w1, const float* b1, void* out, int B, int H,
                     int W, int c2, int c3, cudaStream_t stream) {
  return conv3x3_mma::chunk_n(c3) == 48
             ? launch_cp<CP, 48>(x, w0, b0, w1, b1, out, B, H, W, c2, c3,
                                 stream)
             : launch_cp<CP, 96>(x, w0, b0, w1, b1, out, B, H, W, c2, c3,
                                 stream);
}

}  // namespace

// Requires c2 % 8 == 0, c2 <= 80, c3 % 8 == 0, 16-byte aligned w1.
extern "C" int stem_l1_launch(const uint8_t* x, const float* w0,
                              const float* b0, const void* w1, const float* b1,
                              void* out, int B, int H, int W, int c2, int c3,
                              void* stream) {
  const int Hs = (H - 2) / 2 + 1, Ws = (W - 2) / 2 + 1;
  const int Ho = (Hs + 1) / 2, Wo = (Ws + 1) / 2;
  if (B == 0 || Ho <= 0 || Wo <= 0) return 0;
  auto st = (cudaStream_t)stream;
  cudaError_t err;
  switch ((c2 + 15) / 16 * 16) {
    case 16: err = launch_n<16>(x, w0, b0, w1, b1, out, B, H, W, c2, c3, st); break;
    case 32: err = launch_n<32>(x, w0, b0, w1, b1, out, B, H, W, c2, c3, st); break;
    case 48: err = launch_n<48>(x, w0, b0, w1, b1, out, B, H, W, c2, c3, st); break;
    case 64: err = launch_n<64>(x, w0, b0, w1, b1, out, B, H, W, c2, c3, st); break;
    case 80: err = launch_n<80>(x, w0, b0, w1, b1, out, B, H, W, c2, c3, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
