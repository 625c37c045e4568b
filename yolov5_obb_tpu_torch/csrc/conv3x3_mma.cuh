// A SAME Conv(3x3, pad 1) as a tensor-core implicit GEMM for Hopper, the
// body of every 3x3 conv kernel of the port: the inference downsample
// (down.cu: a BatchNorm scale/shift + SiLU epilogue), the train-mode
// downsample forward (down_train.cu: the raw conv), the fused train passes
// at stride 1 and 2 (train_fused_3x3.cu: a BatchNorm + SiLU prologue on the
// input, per-channel sums of the float32 accumulator) and layer 1 of the
// stem+L1 kernel (stem_l1.cu: its patch computed in the CTA, not copied).
// Its main loop (conv_mainloop) also runs the five convs of c3.cu.
//
// x (B, H, W, ci) bf16; taps w (9*ci, co) bf16, row (3*dy + dx)*ci + c.
// z (B, (H-1)/S + 1, (W-1)/S + 1, co) bf16: the float32 sums, through the
// epilogue, rounded once.  The prologue maps an in-image input value to
// bf16(silu(x*g + b)) (float32 arithmetic); positions outside the image,
// and channels past ci, are zero AFTER it (the conv pads its activated
// input).
//
// What bounds it on the H100 at yolov5m b16 1024²: layer 1 (512² x 48 → 256²
// x 96) moves 604 MB for 87 GFLOP, layer 3 (256² x 96 → 128² x 192) 302 MB
// for 87 GFLOP and a C3 bottleneck 3x3 (256² x 48 → 48, stride 1) 201 MB
// for 43.5 GFLOP: 0.18, 0.09 and 0.06 ms of bytes against 0.088, 0.088 and
// 0.044 ms of bf16 products, so bytes bound all three.  The design reads
// each input byte about once from device memory and keeps the products on
// the tensor cores.
//
// Design.  GEMM view: M = the output pixels of a kTileY x kTileX tile of one
// image (128), N = a chunk of N output channels (a grid axis, fastest, so a
// tile's chunks run together and its input is read from L2 the second
// time), K = 9 taps x ci.  N is 96 or 48, whichever pads co less (96 on a
// tie): 96 for co = 96, 192; 48 for the bottleneck's co = 48, which a
// 96-wide chunk would half fill with zero columns.  ci is padded to a
// multiple of 16 with zeros in both operands and walked in chunks of at
// most kMaxChunkK channels: the input patch of a chunk (17 x 33 pixels at
// stride 2, 10 x 18 at stride 1, bf16, pixel-major) is staged once per CTA,
// once the previous chunk is read.  (Double-buffering the chunks, to load
// the next while the current computes, measured slower on the H100: a
// smaller chunk per barrier and fewer CTAs per SM.)
// At stride 2 the patch's even and odd columns are stored apart, so the 8
// pixels one ldmatrix phase gathers (every other input column) sit in
// consecutive slots, as they do at stride 1 without the split; a slot is
// ck + 8 channels, an odd number of 16-byte units, so both the gather and
// the tap walk are free of bank conflicts.
// The taps stream through a ring of three (ck, N) shared tiles by
// cp.async, two taps ahead of the products, one barrier per tap: each
// weight byte is read from global memory once per CTA, never per pixel.
// Products: mma.sync m16n8k16 (bf16 in, float32 accumulation), A by
// ldmatrix.x4 from the patch (one row address per lane: the stride-2 gather
// costs nothing), B by ldmatrix.x4.trans from the tap tile.  4 warps, each
// 6 n8 tiles (48 channels) wide: at N = 96 2 along M x 2 along N, each 64
// pixels (4 output rows), 96 float32 accumulators per thread, 7 ldmatrix
// per 24 mma; at N = 48 4 x 1, each 32 pixels, 48 accumulators, 5 ldmatrix
// per 12 mma.  Staging: cp.async with zero fill where ci % 8 == 0, else
// through registers (4-byte loads), a template parameter chosen by ci (as
// a run-time branch in the staging loop it slowed the raw conv by ~10% on
// the H100); the prologue then activates each landed value in place, each
// thread its own copies (no extra barrier) with its channel group's g and
// b in registers (the zeros of the padding stay zeros).  Epilogue: a functor maps each float32 sum (raw, or the
// inference BatchNorm + SiLU with IEEE expf and division), then the bf16
// outputs go through shared memory to 16-byte coalesced stores.
// Statistics: each warp sums its columns over its valid rows (shuffles over
// lane bits 2-4), the M warps add in a fixed order through shared memory,
// and the CTA writes its tile's partial row of 2*co floats; a second pass
// (wgrad.cuh's sum_rows) adds the rows in order (the PTX helpers and this
// epilogue are mma.cuh's, shared with the 1x1 pass).  No float atomics:
// repeated runs agree bit for bit.  One tile per CTA (a persistent loop
// slowed an earlier shared conv body).  `mma.sync` rather than `wgmma`:
// its fragments map directly onto the stride-2 gather.  In practice neither
// bound holds: on the H100 the products run at about a fifth of the bf16
// tensor-core peak, and the prologue's two special-function operations per
// staged value (exp, reciprocal) add about as much again (PERF.md: the
// times and the variants measured).
#pragma once

#include "mma.cuh"

namespace conv3x3_mma {

constexpr int kTileY = 8;    // output rows per CTA tile
constexpr int kTileX = 16;   // output columns per CTA tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;           // tap tiles in flight
// input channels staged at once: 16 or 32, so a chunk is 2 or 4 groups of 8
// channels and a thread copies one group throughout (kThreads is a multiple)
constexpr int kMaxChunkK = 32;
static_assert(kMaxChunkK % 16 == 0 && kThreads % (kMaxChunkK / 8) == 0,
              "chunks are k16 steps; a thread copies one channel group");
static_assert(kTileX == 16, "an m16 tile is one output row");

// A chunk of N output channels and its warp split: every warp holds 6 n8
// tiles (48 channels) and kMTiles output rows.
template <int N> struct Split {
  static_assert(N == 48 || N == 96, "chunks of 48 or 96 channels");
  static constexpr int kWarpsN = N / 48;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kMTiles = kTileY / kWarpsM;  // m16 tiles per warp
  static constexpr int kNTiles = N / kWarpsN / 8;   // n8 tiles per warp
  // bf16 per tap-tile row and per output pixel staged for the stores: an
  // odd number of 16-byte units (13, 7)
  static constexpr int kWs = N + 8;
  static constexpr int kOs = N + 8;
  static_assert(kNTiles % 2 == 0, "B fragments load two n8 tiles at once");
};

// The chunk for co output channels: the one that pads co less, 96 on a tie.
inline int chunk_n(int co) {
  return (co + 47) / 48 * 48 < (co + 95) / 96 * 96 ? 48 : 96;
}

// the patch: rows, columns, and pixel slots per row (even columns, then odd
// columns, at stride 2)
template <int S> struct Patch {
  static constexpr int rows = S * (kTileY - 1) + 3;
  static constexpr int cols = S * (kTileX - 1) + 3;
  static constexpr int half = (cols + 1) / 2;
  static constexpr int row_slots = S == 2 ? 2 * half : cols;
  __host__ __device__ static constexpr int slot(int q) {
    return S == 2 ? (q & 1) * half + (q >> 1) : q;
  }
};

// ci padded to 16, split into equal chunks of at most kMaxChunkK channels
__host__ __device__ inline int chunk_k(int ci) {
  const int cp = (ci + 15) / 16 * 16;
  const int n = (cp + kMaxChunkK - 1) / kMaxChunkK;
  return ((cp + n - 1) / n + 15) / 16 * 16;
}

// bf16 of the patch's room (which the epilogue reuses for the outputs)
template <int S, int N>
__host__ __device__ inline int patch_elems(int ck) {
  const int patch = Patch<S>::rows * Patch<S>::row_slots * (ck + 8);
  const int out = kTileY * kTileX * Split<N>::kOs;
  return patch > out ? patch : out;
}

template <int S, int N, bool kStats>
__host__ __device__ inline size_t smem_bytes(int ck) {
  size_t b = (size_t)patch_elems<S, N>(ck) * 2;
  b += (size_t)kStages * ck * Split<N>::kWs * 2;
  if (kStats) b += Split<N>::kWarpsM * 2 * N * sizeof(float);
  return b;
}

// silu in float32 with the fast exponential and division (a few float32
// ulps from expf and IEEE division; the result is rounded to bf16)
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// An epilogue (as mma.cuh's Raw and BiasSilu): BatchNorm as a scale/shift
// after the conv, then SiLU (common.cuh's: IEEE expf and division, as the
// plain version's float32 sigmoid)
struct BnSilu {
  const float* ss;  // (2, co): scale row, then shift row
  int co;
  struct Pair {
    float s0, s1, t0, t1;
  };
  __device__ __forceinline__ Pair at(int n) const {
    return {ss[n], ss[n + 1], ss[co + n], ss[co + n + 1]};
  }
  __device__ __forceinline__ float2 operator()(const Pair& p, float2 v) const {
    return make_float2(silu(v.x * p.s0 + p.t0), silu(v.y * p.s1 + p.t1));
  }
};

// The main loop of every tensor-core conv of the port: acc (zeroed first
// when `zero`, else added to) += the products of a shared A operand with the
// weights w (taps * ci rows, row tap*ci + c; co columns) at output channels
// n0 .. n0 + kCols - 1, K = taps x ci (ci padded to 16) walked in chunks of
// ck_max (<= kMaxK) channels, one ring step per (chunk, tap).  Every lane
// gives its A row address in each of its kMT m16 tiles (shared-window bytes,
// its k half included: any pixel geometry) in arow; aoff(tap, k) is the
// byte offset of step (chunk k, tap)'s A.  Only the warp's first `live` m16
// tiles and first `pairs` n8 pairs of its kNT n8 tiles (columns wn*8*kNT ..)
// are computed.  load_a(k) stages chunk k's A: chunk 0's before the first
// weights are copied and, with `restage`, a later chunk's once the previous
// one is read; whatever cp.async copies it issues land before the chunk's
// first products.  activate(k) runs at the chunk's first tap, after those
// copies landed and before the barrier that publishes them.  The weights
// stream through a ring of kStages (ck_max, kCols) tiles at shared address
// ring by cp.async, two steps ahead of the products, one barrier per step.
// Users: conv_kernel and the stem+L1 kernel's layer 1 (through
// patch_mainloop) and the five convs of c3.cu.
template <int kMT, int kNT, int kCols, int kMaxK, int kThreads,
          typename AOff, typename LoadA, typename Activate>
__device__ __forceinline__ void conv_mainloop(
    float (&acc)[kMT][kNT][4], bool zero, const uint32_t (&arow)[kMT],
    int live, int pairs, int wn, uint32_t ring,
    const __nv_bfloat16* __restrict__ w, int taps, int ci, int co, int n0,
    int ck_max, bool restage, const AOff& aoff, const LoadA& load_a,
    const Activate& activate) {
  constexpr int kWs = kCols + 8;  // bf16 per ring row
  const int lane = threadIdx.x & 31;
  const int cp = (ci + 15) / 16 * 16;
  const int steps = taps * ((cp + ck_max - 1) / ck_max);

  // the weights of step s (chunk s / taps, tap s % taps) into ring slot
  // buf: rows c0 .. c0 + ck - 1, zero past ci and co
  auto load_w = [&](int s, int buf) {
    const int k = s / taps, tap = s - k * taps;
    const int c0 = k * ck_max, ck = min(ck_max, cp - c0);
    for (int i = threadIdx.x; i < ck * (kCols / 8); i += kThreads) {
      const int r = i / (kCols / 8), g = i - r * (kCols / 8);
      const int c = c0 + r, n = n0 + 8 * g;
      const bool full = c < ci && n < co;
      cp_async16(ring + 2 * ((buf * ck_max + r) * kWs + 8 * g),
                 full ? w + ((size_t)tap * ci + c) * co + n : w, full);
    }
  };
  // the lane's B row and column in ring slot 0
  const uint32_t bbase =
      ring + 2 * ((lane & 15) * kWs + wn * 8 * kNT + (lane >> 4) * 8);

  load_a(0);
  load_w(0, 0);
  cp_async_commit();
  if (steps > 1) load_w(1, 1);
  cp_async_commit();
  // zeroed after load_a: an A computed in the CTA needs the registers first
  if (zero) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  for (int s = 0; s < steps; ++s) {
    const int k = s / taps, tap = s - k * taps;
    const int ck = min(ck_max, cp - k * ck_max);
    if (restage && tap == 0 && k > 0) {
      __syncthreads();  // the previous chunk is read
      load_a(k);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();  // this step's weights (and chunk 0's A) landed
    }
    if (tap == 0) activate(k);
    __syncthreads();  // ... for all; step s - 1's ring slot is free
    if (s + 2 < steps) load_w(s + 2, (s + 2) % kStages);
    cp_async_commit();

    const uint32_t astep = aoff(tap, k);
    const uint32_t bstep = bbase + 2 * (s % kStages) * ck_max * kWs;
#pragma unroll
    for (int kk = 0; kk < kMaxK; kk += 16) {
      if (kk >= ck) break;
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        if (i < live) ldsm_x4(a[i], arow[i] + astep + 2 * kk);
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p) {
        if (p >= pairs) break;
        uint32_t bf[4];
        ldsm_x4_trans(bf, bstep + 2 * (kk * kWs + 16 * p));
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          if (i < live) {
            mma16816(acc[i][2 * p], a[i], bf[0], bf[1]);
            mma16816(acc[i][2 * p + 1], a[i], bf[2], bf[3]);
          }
      }
    }
  }
}

// conv_mainloop on a Patch<S> of an 8x16 output tile: acc (zeroed here) =
// the 3x3 conv of the patch with the taps w at output channels n0 .. n0 +
// N - 1, walked in chunks of ck_max (<= kMaxK) input channels.
// load_patch(k) stages chunk k's patch into `patch` (pitch ck_max + 8 bf16
// per slot); activate(k) as conv_mainloop's.  The taps stream through the
// kStages ring at wbuf.  Runs conv_kernel on a patch it copies from device
// memory and the stem+L1 kernel (stem_l1.cu) on one it computes itself.
template <int S, int N, int kMaxK, typename LoadPatch, typename Activate>
__device__ __forceinline__ void patch_mainloop(
    float (&acc)[Split<N>::kMTiles][Split<N>::kNTiles][4],
    const __nv_bfloat16* patch, __nv_bfloat16* wbuf,
    const __nv_bfloat16* __restrict__ w, int ci, int co, int n0, int ck_max,
    const LoadPatch& load_patch, const Activate& activate) {
  using P = Patch<S>;
  using Sp = Split<N>;
  constexpr int kMTiles = Sp::kMTiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Sp::kWarpsM, wn = warp / Sp::kWarpsM;
  const int ps = ck_max + 8;  // bf16 per patch slot
  // per lane: its A row (output pixel px = lane % 16 of output row
  // kMTiles*wm + i) at tap (0, 0), and its k half
  uint32_t arow[kMTiles];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
    arow[i] = smem_addr(patch) +
              2 * ((S * (kMTiles * wm + i) * P::row_slots +
                    P::slot(S * (lane & 15))) * ps + (lane >> 4) * 8);
  auto aoff = [&](int tap, int) -> uint32_t {
    const int dy = tap / 3, dx = tap - 3 * dy;
    return 2 * (dy * P::row_slots + P::slot(dx)) * ps;
  };
  conv_mainloop<kMTiles, Sp::kNTiles, N, kMaxK, kThreads>(
      acc, true, arow, kMTiles, Sp::kNTiles / 2, wn, smem_addr(wbuf), w, 9,
      ci, co, n0, ck_max, true, aoff, load_patch, activate);
}

// One CTA: output tile (ty, tx) of image b, output channels n0 .. n0+N-1.
// gb: (2, ci) float32 [g; b] of the prologue (kAct); partial: one row of
// 2*co floats per tile (kStats), sums of the raw accumulators.
template <int S, int N, bool kAct, bool kStats, bool kVec, typename Epi>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gb,
            const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ z,
            float* __restrict__ partial, Epi epi, int H, int W, int ci, int co,
            int Ho, int Wo, int tiles_x, int n_chunks, int ck_max) {
  using P = Patch<S>;
  using Sp = Split<N>;
  constexpr int kChunkN = N, kOs = Sp::kOs;
  constexpr int kWarpsM = Sp::kWarpsM, kMTiles = Sp::kMTiles;
  constexpr int kNTiles = Sp::kNTiles;
  extern __shared__ float4 smem4[];
  const int ps = ck_max + 8;                      // bf16 per patch slot
  auto* patch = reinterpret_cast<__nv_bfloat16*>(smem4);
  auto* wbuf = patch + patch_elems<S, N>(ck_max);
  float* red = reinterpret_cast<float*>(wbuf + (size_t)kStages * ck_max * Sp::kWs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int tile = blockIdx.x / n_chunks;
  const int n0 = (blockIdx.x - tile * n_chunks) * kChunkN;
  const int b = blockIdx.y;
  const int oy0 = (tile / tiles_x) * kTileY, ox0 = (tile % tiles_x) * kTileX;
  const int iy0 = S * oy0 - 1, ix0 = S * ox0 - 1;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * ci;
  const int cp = (ci + 15) / 16 * 16;

  // the patch of chunk k (channels k*ck_max ..), raw: zero outside the
  // image and past ci.  16-byte rows by cp.async with zero fill (kVec: ci %
  // 8 == 0); else through registers.  Thread tid takes items tid, tid +
  // kThreads, ... (all of one channel group).
  auto load_patch = [&](int k) {
    const int c0 = k * ck_max, groups = min(ck_max, cp - c0) / 8;
    for (int i = tid; i < P::rows * P::cols * groups; i += kThreads) {
      const int p = i / groups, g = i - p * groups;
      const int r = p / P::cols, q = p - r * P::cols;
      const int gy = iy0 + r, gx = ix0 + q, c = c0 + 8 * g;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      __nv_bfloat16* dst =
          patch + (r * P::row_slots + P::slot(q)) * ps + 8 * g;
      const __nv_bfloat16* src =
          in ? xb + ((size_t)gy * W + gx) * ci + c : x;
      if (kVec) {
        cp_async16(dst, src, in && c < ci);
        continue;
      }
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (in) {
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          if (c + e < ci) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(src + e));
            v[e] = f.x;
            v[e + 1] = f.y;
          }
      }
      store8_bf16(dst, v);
    }
  };

  // the prologue on this thread's own copies of chunk k's patch: each
  // in-image value becomes bf16(silu(v*g + b)) in place (the zeros stay
  // zeros).  A copy is complete for its issuer after the cp.async wait, so
  // no barrier comes between; the next one publishes the values.  The
  // thread's one channel group keeps its g and b in registers.
  auto activate_own = [&](int k) {
    if (!kAct) return;
    const int c0 = k * ck_max, groups = min(ck_max, cp - c0) / 8;
    const int g = tid % groups, c = c0 + 8 * g;
    if (c >= ci) return;
    float gg[8], bb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gg[e] = c + e < ci ? gb[c + e] : 0.f;
      bb[e] = c + e < ci ? gb[ci + c + e] : 0.f;
    }
    __nv_bfloat16* buf = patch + 8 * g;
    for (int p = tid / groups; p < P::rows * P::cols;
         p += kThreads / groups) {
      const int r = p / P::cols, q = p - r * P::cols;
      const int gy = iy0 + r, gx = ix0 + q;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      __nv_bfloat16* d = buf + (r * P::row_slots + P::slot(q)) * ps;
      float v[8];
      load8_bf16(d, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = c + e < ci ? silu_fast(v[e] * gg[e] + bb[e]) : 0.f;
      store8_bf16(d, v);
    }
  };

  float acc[kMTiles][kNTiles][4];
  patch_mainloop<S, N, kMaxChunkK>(acc, patch, wbuf, w, ci, co, n0, ck_max,
                                   load_patch, activate_own);

  // epilogue: the mapped bf16 outputs through shared memory (the patch's
  // room), then 16-byte stores; with kStats the per-channel sums of the
  // raw accumulators
  __syncthreads();
  __nv_bfloat16* ot = patch;
  auto valid = [&](int p) {
    return oy0 + p / kTileX < Ho && ox0 + p % kTileX < Wo;
  };
  stage_outputs<kMTiles, kNTiles, kChunkN, kOs, kStats>(
      acc, epi, valid, ot, red, wm, wn, lane, n0, co);
  __syncthreads();
  auto dst = [&](int p) -> __nv_bfloat16* {
    const int oy = oy0 + p / kTileX, ox = ox0 + p % kTileX;
    return oy < Ho && ox < Wo ? z + (((size_t)b * Ho + oy) * Wo + ox) * co
                              : nullptr;
  };
  store_outputs<kTileY * kTileX, kChunkN, kOs, kThreads>(ot, dst, tid, n0,
                                                         co);
  if (kStats) {
    const int per_image = gridDim.x / n_chunks;
    write_stats_row<kChunkN, kWarpsM, kThreads>(
        red, partial + ((size_t)b * per_image + tile) * 2 * co, tid, n0, co);
  }
}

// Output tiles (rows of a statistics partial) of an (H, W) input.
template <int S>
inline int tiles(int B, int H, int W) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  return B * ((Ho + kTileY - 1) / kTileY) * ((Wo + kTileX - 1) / kTileX);
}

template <int S, int N, bool kAct, bool kStats, bool kVec, typename Epi>
cudaError_t launch_n(const void* x, const float* gb, const void* w, void* z,
                     float* partial, const Epi& epi, int B, int H, int W,
                     int ci, int co, cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const int tiles_x = (Wo + kTileX - 1) / kTileX;
  const int tiles_y = (Ho + kTileY - 1) / kTileY;
  const int n_chunks = (co + N - 1) / N;
  const int ck = chunk_k(ci);
  const size_t smem = smem_bytes<S, N, kStats>(ck);
  auto kern = conv_kernel<S, N, kAct, kStats, kVec, Epi>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_x * tiles_y * n_chunks, B);
  kern<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), gb,
      reinterpret_cast<const __nv_bfloat16*>(w),
      reinterpret_cast<__nv_bfloat16*>(z), partial, epi, H, W, ci, co, Ho,
      Wo, tiles_x, n_chunks, ck);
  return cudaGetLastError();
}

template <int S, bool kAct, bool kStats, bool kVec, typename Epi>
cudaError_t launch_v(const void* x, const float* gb, const void* w, void* z,
                     float* partial, const Epi& epi, int B, int H, int W,
                     int ci, int co, cudaStream_t stream) {
  return chunk_n(co) == 48
             ? launch_n<S, 48, kAct, kStats, kVec>(x, gb, w, z, partial, epi,
                                                   B, H, W, ci, co, stream)
             : launch_n<S, 96, kAct, kStats, kVec>(x, gb, w, z, partial, epi,
                                                   B, H, W, ci, co, stream);
}

// kAct: gb (2, ci) float32; kStats: partial, tiles<S>(B, H, W) rows of 2*co
// floats, each tile's sums; epi: Raw or BnSilu.  Requires co % 8 == 0,
// ci % 2 == 0 and 16-byte aligned x and w.
template <int S, bool kAct, bool kStats, typename Epi = Raw>
cudaError_t launch(const void* x, const float* gb, const void* w, void* z,
                   float* partial, int B, int H, int W, int ci, int co,
                   cudaStream_t stream, const Epi& epi = Epi{}) {
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  return ci % 8 == 0
             ? launch_v<S, kAct, kStats, true>(x, gb, w, z, partial, epi, B,
                                               H, W, ci, co, stream)
             : launch_v<S, kAct, kStats, false>(x, gb, w, z, partial, epi, B,
                                                H, W, ci, co, stream);
}

}  // namespace conv3x3_mma
