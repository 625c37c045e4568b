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
// and 0.09 ms): bytes bound both, forward and weight gradient alike.
//
// Design.  Forward: the tensor-core implicit GEMM of conv3x3_mma.cuh,
// without prologue or statistics (the patch staged by cp.async).
// Weight gradient: a split-K implicit GEMM on mma.sync m16n8k16 (bf16 in,
// float32 accumulation), two stages and no atomics.  dW = patchᵀ · dz over
// the 1 M / 262 k output pixels: M = input channels (per tap), N = output
// channels, K = output pixels.  A CTA owns a chunk of CK = 16 or 32 input
// channels (32 where the channels padded to 16 split into 32s) x all 9 taps
// x a chunk of N = 48 or 96 output channels (conv3x3_mma::chunk_n) and
// walks the 8x16 output tiles tile ≡ blockIdx.y (mod parts), its dW block
// in registers throughout (parts: as many as reside on the card beside the
// channel-chunk CTAs, by the occupancy query of down_train_wgrad_parts,
// which the wrapper sizes its partial by): warps along M (one m16 tile of
// channels each) x along N (3 n8 tiles, 24 channels, each), 9 x 3 x 4 =
// 108 float32 accumulators per thread.  The channel-chunk grid axis is the fastest, so
// the CTAs that share a tile run together and the re-reads of x (once per
// output chunk) and of dz (once per input chunk) come from L2.  A tile's
// 17x33 input patch (bf16, conv3x3_mma::Patch<2>'s even/odd column split,
// a slot of CK + 8 channels) and its dz rows (N + 8 channels per pixel: an
// odd number of 16-byte units, as the patch slot) are staged by cp.async
// (zero outside the image or the output and past ci or co), double-buffered
// so the next tile's copies land behind this tile's products.  Per output
// row r of the tile (16 pixels: one k16 step) and tap (dy, dx): A = the
// patch pixels (2r + dy, 2px + dx)ᵀ by ldmatrix.x4.trans from per-lane
// pixel addresses (the stride-2 gather costs nothing), B = the dz rows by
// ldmatrix.x4.trans + .x2.trans, loaded once per r for all 9 taps: 10.5
// ldmatrix per 27 mma.  The CTA then writes its partial dW; stage 2
// (wgrad.cuh's sum_partials) sums the partials in order.
#include "conv3x3_mma.cuh"
#include "wgrad.cuh"

namespace {

using conv3x3_mma::kTileX;
using conv3x3_mma::kTileY;
using Patch2 = conv3x3_mma::Patch<2>;

constexpr int kWgradNTiles = 3;  // n8 tiles (24 output channels) per warp

// The weight gradient's CTA for CK input x N output channels.
template <int CK, int N> struct WSplit {
  static_assert((CK == 16 || CK == 32) && (N == 48 || N == 96), "chunks");
  static constexpr int kWarpsM = CK / 16;
  static constexpr int kWarpsN = N / (8 * kWgradNTiles);
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kPs = CK + 8;  // bf16 per patch slot
  static constexpr int kDs = N + 8;   // bf16 per staged dz pixel
  static constexpr int kPatch = Patch2::rows * Patch2::row_slots * kPs;
  static constexpr int kStage = kPatch + kTileY * kTileX * kDs;
};

// input channels per CTA: 32 where ci padded to 16 is a multiple of 32
inline int wgrad_chunk_k(int ci) {
  return (ci + 15) / 16 * 16 % 32 == 0 ? 32 : 16;
}

template <int CK, int N>
__global__ void __launch_bounds__(WSplit<CK, N>::kThreads)
down_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dz,
                  float* __restrict__ partial, int H, int W, int ci, int co,
                  int Ho, int Wo, int tiles_x, int tiles_y, int ntiles,
                  int n_chunks) {
  using Sp = WSplit<CK, N>;
  constexpr int kThreads = Sp::kThreads, kPs = Sp::kPs, kDs = Sp::kDs;
  static_assert(kWgradNTiles == 3, "B fragments: one x4 and one x2 load");
  extern __shared__ float4 smem4[];
  auto* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Sp::kWarpsM, wn = warp / Sp::kWarpsM;
  const int c0 = (blockIdx.x / n_chunks) * CK;
  const int n0 = (blockIdx.x % n_chunks) * N;

  // tile t's patch (channels c0 .., zero outside the image and past ci)
  // and dz rows (channels n0 .., zero outside the output and past co)
  // into stage buffer buf
  auto stage = [&](int t, int buf) {
    __nv_bfloat16* patch = sm + buf * Sp::kStage;
    __nv_bfloat16* dzs = patch + Sp::kPatch;
    const int b = t / (tiles_y * tiles_x), rem = t - b * tiles_y * tiles_x;
    const int oy0 = (rem / tiles_x) * kTileY, ox0 = (rem % tiles_x) * kTileX;
    constexpr int kG = CK / 8, kDG = N / 8;
    for (int i = tid; i < Patch2::rows * Patch2::cols * kG; i += kThreads) {
      const int p = i / kG, g = i - p * kG;
      const int r = p / Patch2::cols, q = p - r * Patch2::cols;
      const int gy = 2 * oy0 - 1 + r, gx = 2 * ox0 - 1 + q, c = c0 + 8 * g;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < ci;
      cp_async16(patch + (r * Patch2::row_slots + Patch2::slot(q)) * kPs +
                     8 * g,
                 in ? x + (((size_t)b * H + gy) * W + gx) * ci + c : x, in);
    }
    for (int i = tid; i < kTileY * kTileX * kDG; i += kThreads) {
      const int p = i / kDG, g = i - p * kDG;
      const int oy = oy0 + p / kTileX, ox = ox0 + p % kTileX, n = n0 + 8 * g;
      const bool in = oy < Ho && ox < Wo && n < co;
      cp_async16(dzs + p * kDs + 8 * g,
                 in ? dz + (((size_t)b * Ho + oy) * Wo + ox) * co + n : dz,
                 in);
    }
  };

  float acc[9][kWgradNTiles][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < kWgradNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // per lane: A rows (pixel k of an output row at tap (0, 0): lanes 0-7 and
  // 8-15 pixels 0-7, 16-31 pixels 8-15; lanes 8-15 and 24-31 the upper 8
  // channels of the warp's m16 tile); B rows (pixel lane % 16) and columns
  const int pk = (lane & 7) + ((lane >> 4) << 3);
  const int aoff = Patch2::slot(2 * pk) * kPs + wm * 16 + ((lane >> 3) & 1) * 8;
  const int bcol = wn * (8 * kWgradNTiles);
  const int boff = (lane & 15) * kDs + bcol + (lane >> 4) * 8;
  const int boff2 = (lane & 15) * kDs + bcol + 16;

  int t = blockIdx.y;
  if (t < ntiles) stage(t, 0);
  cp_async_commit();
  for (int k = 0; t < ntiles; t += gridDim.y, ++k) {
    if (t + (int)gridDim.y < ntiles) stage(t + gridDim.y, (k + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies landed (this thread's) ...
    __syncthreads();     // ... and everyone's
    const __nv_bfloat16* patch = sm + (k & 1) * Sp::kStage;
    const __nv_bfloat16* dzs = patch + Sp::kPatch;
#pragma unroll 1
    for (int r = 0; r < kTileY; ++r) {
      uint32_t bf[2 * kWgradNTiles];
      ldsm_x4_trans(bf, dzs + r * kTileX * kDs + boff);
      ldsm_x2_trans(bf + 4, dzs + r * kTileX * kDs + boff2);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        uint32_t a[4];
        ldsm_x4_trans(a, patch + ((2 * r + dy) * Patch2::row_slots +
                                  Patch2::slot(dx)) * kPs + aoff);
#pragma unroll
        for (int j = 0; j < kWgradNTiles; ++j)
          mma16816(acc[tap][j], a, bf[2 * j], bf[2 * j + 1]);
      }
    }
    __syncthreads();  // this buffer is read before it is staged again
  }

  // the CTA's dW block (rows: channel lane/4 and lane/4 + 8 of the warp's
  // m16 tile; columns 2*(lane%4), +1 of each n8 tile) into its partial
  float* out = partial + (size_t)blockIdx.y * 9 * ci * co;
  const int nl = n0 + bcol + 2 * (lane & 3);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < kWgradNTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 16 + (lane >> 2) + 8 * h, n = nl + 8 * j;
        if (c < ci && n < co)
          *reinterpret_cast<float2*>(out + ((size_t)tap * ci + c) * co + n) =
              make_float2(acc[tap][j][2 * h], acc[tap][j][2 * h + 1]);
      }
}

// The weight gradient's grid for a shape: the output tiles and the
// channel-chunk CTAs (input chunks x output chunks, blockIdx.x), and its
// shared memory (two stages).
struct WgradGrid {
  int Ho, Wo, tiles_x, tiles_y, ntiles, n_chunks, chunks;
  size_t smem;
};

template <int CK, int N>
WgradGrid wgrad_grid(int B, int H, int W, int ci, int co) {
  WgradGrid g;
  g.Ho = (H + 1) / 2;
  g.Wo = (W + 1) / 2;
  g.tiles_x = (g.Wo + kTileX - 1) / kTileX;
  g.tiles_y = (g.Ho + kTileY - 1) / kTileY;
  g.ntiles = B * g.tiles_x * g.tiles_y;
  g.n_chunks = (co + N - 1) / N;
  g.chunks = (ci + 15) / 16 * 16 / CK * g.n_chunks;
  g.smem = 2 * (size_t)WSplit<CK, N>::kStage * sizeof(__nv_bfloat16);
  return g;
}

// CTAs along the pixel axis: as many as reside on the card at once (the
// occupancy query: shared memory and registers) beside the channel-chunk
// CTAs, at most one per tile.  Fixed for a card and a shape, so repeated
// runs add the same partials in the same order.
template <int CK, int N>
cudaError_t wgrad_parts(int B, int H, int W, int ci, int co, int* parts) {
  const WgradGrid g = wgrad_grid<CK, N>(B, H, W, ci, co);
  auto kern = down_wgrad_kernel<CK, N>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = allow_smem(kern, g.smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, WSplit<CK, N>::kThreads, g.smem)) != cudaSuccess)
    return err;
  const int fit = (sms * per_sm + g.chunks - 1) / g.chunks;
  *parts = fit < g.ntiles ? fit : g.ntiles;
  if (*parts < 1) *parts = 1;
  return cudaSuccess;
}

template <int CK, int N>
cudaError_t wgrad_launch(const void* x, const void* dz, float* partial,
                         int B, int H, int W, int ci, int co, int parts,
                         cudaStream_t stream) {
  using Sp = WSplit<CK, N>;
  const WgradGrid g = wgrad_grid<CK, N>(B, H, W, ci, co);
  auto kern = down_wgrad_kernel<CK, N>;
  cudaError_t err = allow_smem(kern, g.smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(g.chunks, parts), Sp::kThreads, g.smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x),
      reinterpret_cast<const __nv_bfloat16*>(dz), partial, H, W, ci, co,
      g.Ho, g.Wo, g.tiles_x, g.tiles_y, g.ntiles, g.n_chunks);
  return cudaGetLastError();
}

// The shape's instantiation: CK = wgrad_chunk_k(ci), N = chunk_n(co).
struct WgradOps {
  cudaError_t (*parts)(int, int, int, int, int, int*);
  cudaError_t (*launch)(const void*, const void*, float*, int, int, int, int,
                        int, int, cudaStream_t);
};

template <int CK, int N>
constexpr WgradOps kWgradOps{wgrad_parts<CK, N>, wgrad_launch<CK, N>};

WgradOps wgrad_ops(int ci, int co) {
  const bool n96 = conv3x3_mma::chunk_n(co) == 96;
  if (wgrad_chunk_k(ci) == 32) return n96 ? kWgradOps<32, 96> : kWgradOps<32, 48>;
  return n96 ? kWgradOps<16, 96> : kWgradOps<16, 48>;
}

}  // namespace

extern "C" int down_train_fwd_launch(const void* x, const void* w, void* z,
                                     int B, int H, int W, int ci, int co,
                                     void* stream) {
  return (int)conv3x3_mma::launch<2, false, false>(
      x, nullptr, w, z, nullptr, B, H, W, ci, co, (cudaStream_t)stream);
}

// The rows of the weight gradient's partial for a shape (its `parts`), or
// minus a CUDA error.  Launches nothing.
extern "C" int down_train_wgrad_parts(int B, int H, int W, int ci, int co) {
  int parts = 0;
  const cudaError_t err = wgrad_ops(ci, co).parts(B, H, W, ci, co, &parts);
  return err != cudaSuccess ? -(int)err : parts;
}

// partial: parts * 9*ci*co floats of scratch, parts from
// down_train_wgrad_parts; dw: 9*ci*co floats.  Requires ci % 8 == 0,
// co % 8 == 0 and 16-byte aligned x and dz.
extern "C" int down_train_wgrad_launch(const void* x, const void* dz,
                                       float* partial, float* dw, int B, int H,
                                       int W, int ci, int co, int parts,
                                       void* stream) {
  auto st = (cudaStream_t)stream;
  cudaError_t err = wgrad_ops(ci, co).launch(x, dz, partial, B, H, W, ci, co,
                                             parts, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, dw, 9 * ci * co, parts, st);
}
