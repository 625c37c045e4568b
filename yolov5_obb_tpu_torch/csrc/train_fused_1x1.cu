// The grouped 1x1 pass of the fused train region, forward and backward.
//
// Replaces: yolov5_obb_tpu/ops/pallas/train_fused.py:251 pass_1x1 (custom
//   VJP): forward body _k1x1 :108 (pallas_call :283), backward body
//   _k1x1_bwd :151 (pallas_call :326).
//
// A pass (the descriptor Pass1x1Desc; train_fused._Desc mirrors it) has up
// to 8 inputs z_i (N pixels x ci, bf16), each with (g_i, b_i) and a flag:
// activated inputs read silu(z·g + b), plain ones z.  Each input belongs to
// one of up to 2 groups; a group's value is the float32 sum of its
// members' values, rounded to bf16.  Each of up to 2 outputs is the sum of
// up to 2 products (group value) x (weight (ci, co), bf16), accumulated in
// float32 and stored as bf16; its statistics (2, co) are Σ and Σ² of the
// float32 accumulator.
//
// Backward, from the cotangents (dz_o, (ds1_o, ds2_o)):
//   e_o   = bf16(dz_o + ds1_o + 2·z_o·ds2_o)
//   dW_w  = Σ_pixels gval_gᵀ · e_o          over the pairs (g, w) of o
//   t_g   = Σ e_o · W_wᵀ                    over the pairs with group g
//   activated input: dα = t·silu'(α), dz = bf16(dα·g), (dg, db) += Σ (dα·z, dα)
//   plain input:     dz = bf16(t)
//
// Bounds on this card at yolov5m b16 1024² (1 M pixels, ci 48/96): the four
// passes of a step move 403 / 201 / 302 / 604 MB forward (cv1+cv2, b0.cv1,
// b1.cv1, cv3; 0.12 / 0.06 / 0.09 / 0.18 ms at 3.35 TB/s) and twice that
// backward, for at most 19 GFLOP of bf16 products each way: bytes bound
// them.  The backward uses scalar float32 FMAs, so in practice operations
// limit it.
//
// Forward design: the grouped pass on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulation), one kFwdTile-pixel tile at a
// time, every output of the pass per tile.  As many CTAs as fit on the card
// walk the tiles tile ≡ blockIdx.x (mod gridDim.x) and copy the next tile's
// inputs by cp.async while they multiply and store this one: the first
// nstage inputs, as many as the card's shared memory per block holds beside
// the rest (all of them on the main path; 4 of yolov5x's 6 at cv3), the
// others read from device memory where they are activated, so no number of
// inputs overflows it.  Each thread keeps one 16-byte group of 8 channels
// and walks the tile's pixels: it activates the members' values (silu_fast:
// __expf and __fdividef, as the 3x3 passes' prologue, and as the backward
// recomputes them; PERF.md has the IEEE A/B), sums them in float32 in
// input order and rounds once to bf16 into the group values (pixel-major
// rows of ci padded to 16 plus 8 channels: an odd number of 16-byte units),
// so each value is activated once, not once per output chunk.  All of the
// pass's weights ([ci][co padded to 16, + 8]) and every input's (g; b) are
// copied into shared memory once per CTA.  Products: one output at a time
// in chunks of N = 48 or 96 channels (conv3x3_mma::chunk_n of the widest
// output), the kFwdWarps warps along the pixels, each the whole chunk (N/8
// n8 tiles); A by ldmatrix.x4 from the group values, B by ldmatrix.x4.trans
// from the weight tile; a pair's products add into the same accumulators.
// Epilogue and statistics are mma.cuh's (those of the 3x3 convs): bf16
// through shared memory to 16-byte coalesced stores, Σ and Σ² of the
// float32 accumulator by warp shuffles, the warps added in a fixed order
// and the CTA's tiles in tile order into its one partial row (a row per
// tile cost a 30 µs sum_rows per pass on the H100), which wgrad.cuh's
// sum_rows adds in order.  No float atomics: repeated runs agree bit for
// bit.  On the H100 it moves its bytes at about half the card's rate: the
// per-value work (copies, activation, epilogue) and one tile of copies in
// flight per CTA bound it (PERF.md).
//
// Backward design: a fixed number of blocks (_build.partial_count) walk the
// kBwdTile-pixel tiles tile ≡ blockIdx.x (mod gridDim.x), since a dW partial
// per tile would be too large.  A block stages the group values and e_o as
// float32; thread blocks of 4x8 dW entries run over the tile's pixels and
// add into the block's own partial row in device memory (the entries belong
// to one thread); then a thread makes t for 8 channels of one pixel from e_o
// and Wᵀ, and the input gradients, with (dg, db) summed by warp shuffles
// (one lane adds them into the block's shared sums, one writer per slot).
// wgrad.cuh's sum_partials adds the blocks' partial rows in order.
#include "conv3x3_mma.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kMaxIn = 8, kMaxW = 4, kMaxOut = 2, kMaxPairs = 2;
constexpr int kFwdTile = 128;  // pixels per tile of the forward
constexpr int kFwdWarps = 8;   // warps of the forward (16 pixels each)
constexpr int kBwdTile = 64;   // pixels per tile of the backward
constexpr int kThreads = 256;  // threads of the backward

}  // namespace

struct Pass1x1Desc {
  const __nv_bfloat16* z[kMaxIn];       // inputs (N, ci)
  const float* gb[kMaxIn];              // (2, ci)
  const __nv_bfloat16* w[kMaxW];        // (ci, co_w)
  const __nv_bfloat16* wt[kMaxW];       // (co_w, ci): backward
  __nv_bfloat16* out[kMaxOut];          // (N, co_o): forward writes, backward reads
  const __nv_bfloat16* dz_out[kMaxOut];  // backward
  const float* dstat[kMaxOut];          // backward (2, co_o)
  __nv_bfloat16* dz_in[kMaxIn];         // backward (N, ci)
  int ns[kMaxIn];                       // 1: activated input
  int group[kMaxIn];                    // its group
  int npair[kMaxOut];
  int pair_g[kMaxOut * kMaxPairs];
  int pair_w[kMaxOut * kMaxPairs];
  int co[kMaxOut];
  int wco[kMaxW];
  int n_in, n_groups, n_out, n_w, ci;
};

namespace {

// channels 2*c2, 2*c2+1 of group g at pixel q: the float32 sum of its
// members' values, in input order, activated by the forward's silu_fast
// (rounded to bf16, the values the forward multiplied, bit for bit)
__device__ __forceinline__ float2 group_pair(const Pass1x1Desc& d, int g,
                                             size_t q, int c2) {
  float2 acc = make_float2(0.f, 0.f);
  for (int i = 0; i < d.n_in; ++i) {
    if (d.group[i] != g) continue;
    float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(d.z[i] + q * d.ci)[c2]);
    if (d.ns[i]) {
      const int c = 2 * c2;
      v.x = conv3x3_mma::silu_fast(v.x * __ldg(d.gb[i] + c) +
                                   __ldg(d.gb[i] + d.ci + c));
      v.y = conv3x3_mma::silu_fast(v.y * __ldg(d.gb[i] + c + 1) +
                                   __ldg(d.gb[i] + d.ci + c + 1));
    }
    acc.x += v.x;
    acc.y += v.y;
  }
  return acc;
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

// The forward's CTA: kFwdWarps warps along the pixels of the tile, each
// the whole chunk of N output channels.
template <int N> struct FwdSplit {
  static_assert(N == 48 || N == 96, "chunks of 48 or 96 channels");
  static_assert(kFwdTile % (16 * kFwdWarps) == 0, "whole m16 tiles per warp");
  static constexpr int kWarps = kFwdWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMTiles = kFwdTile / (16 * kWarps);  // per warp
  static constexpr int kNTiles = N / 8;  // n8 tiles per warp
  static constexpr int kOs = N + 8;      // bf16 per staged output pixel
};

// The forward's shared memory, in bf16 elements from its start: the raw
// tiles of the first nstage inputs [nstage][kFwdTile * ci] (as in device
// memory), the group values
// [n_groups][kFwdTile][ci padded to 16, + 8], every weight's [ci padded to
// 16][co_w padded to 16, + 8] tile, the output staging tile [kFwdTile][N +
// 8] (in the group values' room when the pass has one output chunk and it
// fits: they are dead by then), then in float32 the warps' statistics
// rows, the CTA's running statistics (S floats) and every input's (g; b)
// rows.
struct FwdSmem {
  int gval, wts, ot, red, cstat, gbs;  // offsets, all in bf16 units
  int nstage;                          // inputs staged by cp.async
  size_t bytes;
};

__host__ __device__ inline int fwd_in_pitch(int ci) {
  return (ci + 15) / 16 * 16 + 8;
}
__host__ __device__ inline int fwd_w_pitch(int co) {
  return (co + 15) / 16 * 16 + 8;
}

template <int N>
FwdSmem fwd_smem(const Pass1x1Desc& d, int S, int nstage) {
  using Sp = FwdSplit<N>;
  const int cp = (d.ci + 15) / 16 * 16;
  FwdSmem m;
  m.nstage = nstage;
  m.gval = nstage * kFwdTile * d.ci;
  m.wts = m.gval + d.n_groups * kFwdTile * fwd_in_pitch(d.ci);
  int end = m.wts;
  int chunks = 0;
  for (int w = 0; w < d.n_w; ++w) end += cp * fwd_w_pitch(d.wco[w]);
  for (int o = 0; o < d.n_out; ++o) chunks += (d.co[o] + N - 1) / N;
  const bool in_gval = chunks == 1 && kFwdTile * Sp::kOs <= m.wts - m.gval;
  m.ot = in_gval ? m.gval : end;
  if (!in_gval) end += kFwdTile * Sp::kOs;
  m.red = end;
  m.cstat = m.red + 2 * Sp::kWarps * 2 * N;
  m.gbs = m.cstat + 2 * ((S + 3) / 4 * 4);  // 16-byte aligned
  m.bytes = (size_t)(m.gbs + 2 * d.n_in * 2 * d.ci) * 2;
  return m;
}

// pixels p0 .. p0 + kFwdTile of the first nstage inputs into raw, 16 bytes
// a copy, as they lie in device memory; zero past the first `valid` pixels
template <int kThr>
__device__ __forceinline__ void copy_inputs(const Pass1x1Desc& d, int nstage,
                                            __nv_bfloat16* raw, size_t p0,
                                            int valid, int tid) {
  const int units = kFwdTile * d.ci / 8, full_units = valid * d.ci / 8;
  for (int i = 0; i < nstage; ++i) {
    const __nv_bfloat16* z = d.z[i] + p0 * d.ci;
    __nv_bfloat16* dst = raw + (size_t)i * kFwdTile * d.ci;
    for (int u = tid; u < units; u += kThr)
      cp_async16(dst + 8 * u, u < full_units ? z + 8 * u : d.z[i],
                 u < full_units);
  }
}

// As many CTAs as fit on the card walk the tiles tile ≡ blockIdx.x (mod
// gridDim.x): the next tile's inputs are copied by cp.async while this
// tile's group values are multiplied and stored.  A CTA adds its tiles'
// statistics in tile order and writes them as its partial row (the grid is
// fixed for a card and a shape, so the sums repeat bit for bit).
template <int N>
__global__ void __launch_bounds__(FwdSplit<N>::kThreads)
p1x1_fwd_kernel(const __grid_constant__ Pass1x1Desc d,
                float* __restrict__ partial, FwdSmem m, int npix, int S) {
  using Sp = FwdSplit<N>;
  constexpr int kThr = Sp::kThreads, kMTiles = Sp::kMTiles;
  constexpr int kNTiles = Sp::kNTiles, kOs = Sp::kOs;
  extern __shared__ float4 smem4[];
  auto* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int ci = d.ci, cp = (ci + 15) / 16 * 16, ps = fwd_in_pitch(ci);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* raw = sm;
  __nv_bfloat16* gval = sm + m.gval;
  __nv_bfloat16* wts = sm + m.wts;
  __nv_bfloat16* ot = sm + m.ot;
  float* red = reinterpret_cast<float*>(sm + m.red);
  float* cstat = reinterpret_cast<float*>(sm + m.cstat);
  float* gbs = reinterpret_cast<float*>(sm + m.gbs);
  const int ntiles = (npix + kFwdTile - 1) / kFwdTile;
  auto valid_in = [&](int t) {
    return min(kFwdTile, npix - t * kFwdTile);
  };

  // every weight (zero past ci and co_w) and every input's (g; b), once
  __nv_bfloat16* wdst = wts;
  for (int w = 0; w < d.n_w; ++w) {
    const int cow = d.wco[w], wp = fwd_w_pitch(cow), wu = (wp - 8) / 8;
    for (int u = tid; u < cp * wu; u += kThr) {
      const int k = u / wu, g = u - k * wu;
      const bool full = k < ci && 8 * g < cow;
      cp_async16(wdst + k * wp + 8 * g,
                 full ? d.w[w] + (size_t)k * cow + 8 * g : d.w[w], full);
    }
    wdst += cp * wp;
  }
  for (int u = tid; u < d.n_in * 2 * ci; u += kThr)
    gbs[u] = __ldg(d.gb[u / (2 * ci)] + u % (2 * ci));
  for (int u = tid; u < S; u += kThr) cstat[u] = 0.f;
  if ((int)blockIdx.x < ntiles)
    copy_inputs<kThr>(d, m.nstage, raw, (size_t)blockIdx.x * kFwdTile,
                      valid_in(blockIdx.x), tid);
  cp_async_commit();

  // each group's members and the activated inputs, as bit masks (bit i:
  // input i; members are taken in input order)
  unsigned members0 = 0u, members1 = 0u, act = 0u;
  for (int i = 0; i < d.n_in; ++i) {
    if (d.group[i]) members1 |= 1u << i;
    else members0 |= 1u << i;
    if (d.ns[i]) act |= 1u << i;
  }
  // the group values: this thread's 16-byte channel group c and first
  // pixel pr, every rows-th pixel after it (threads past rows * c8s idle)
  const int c8s = cp / 8, rows = kThr / c8s;
  const int c = 8 * (tid % c8s), pr = tid / c8s;
  // per lane: its A row (pixel lane % 16 of an m16 tile) and k half; its
  // B row and column
  const int aoff =
      (warp * 16 * kMTiles + (lane & 15)) * ps + (lane >> 4) * 8;
  const int brow = lane & 15, bcol = (lane >> 4) * 8;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const size_t p0 = (size_t)t * kFwdTile;
    const int valid = valid_in(t);
    cp_async_wait<0>();
    __syncthreads();  // this tile's inputs (and the weights) landed

    // the float32 sum of the members' values (silu(z·g + b) for activated
    // ones) in input order, rounded once to bf16; zero past ci and past
    // the last pixel
    for (int g = 0; g < d.n_groups; ++g) {
      const unsigned mem = g ? members1 : members0;
      for (int p = pr; p < kFwdTile && pr < rows; p += rows) {
        float acc[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
        if (c < ci && p < valid) {
          for (unsigned rest = mem; rest; rest &= rest - 1) {
            const int i = __ffs(rest) - 1;
            const __nv_bfloat16* src =
                i < m.nstage ? raw + (size_t)i * kFwdTile * ci
                             : d.z[i] + p0 * ci;
            float v[8];
            load8_bf16(src + (size_t)p * ci + c, v);
            if (act >> i & 1u) {
              const float4* gp =
                  reinterpret_cast<const float4*>(gbs + 2 * i * ci + c);
              const float4* bp = gp + ci / 4;
              const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
              const float gg[8] = {g0.x, g0.y, g0.z, g0.w,
                                   g1.x, g1.y, g1.z, g1.w};
              const float bb[8] = {b0.x, b0.y, b0.z, b0.w,
                                   b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int e = 0; e < 8; ++e)
                v[e] = conv3x3_mma::silu_fast(v[e] * gg[e] + bb[e]);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[e] += v[e];
          }
        }
        store8_bf16(gval + ((size_t)g * kFwdTile + p) * ps + c, acc);
      }
    }
    __syncthreads();  // the group values are published; raw is free
    if (t + (int)gridDim.x < ntiles)
      copy_inputs<kThr>(d, m.nstage, raw, p0 + (size_t)gridDim.x * kFwdTile,
                        valid_in(t + gridDim.x), tid);
    cp_async_commit();

    auto in_tile = [&](int p) { return p < valid; };
    int soff = 0;
    for (int o = 0; o < d.n_out; ++o) {
      const int co = d.co[o];
      for (int n0 = 0; n0 < co; n0 += N) {
        float acc[kMTiles][kNTiles][4];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i)
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
        for (int j = 0; j < d.npair[o]; ++j) {
          const int g = d.pair_g[o * kMaxPairs + j];
          const int w = d.pair_w[o * kMaxPairs + j];
          const __nv_bfloat16* A = gval + (size_t)g * kFwdTile * ps + aoff;
          const __nv_bfloat16* Bw = wts;
          for (int v = 0; v < w; ++v) Bw += cp * fwd_w_pitch(d.wco[v]);
          const int wp = fwd_w_pitch(d.wco[w]);
          Bw += brow * wp + n0 + bcol;
#pragma unroll 1
          for (int kk = 0; kk < cp; kk += 16) {
            uint32_t a[kMTiles][4];
#pragma unroll
            for (int i = 0; i < kMTiles; ++i)
              ldsm_x4(a[i], A + i * 16 * ps + kk);
#pragma unroll
            for (int q = 0; q < kNTiles / 2; ++q) {
              if (16 * q < co - n0) {
                uint32_t bf[4];
                ldsm_x4_trans(bf, Bw + kk * wp + 16 * q);
#pragma unroll
                for (int i = 0; i < kMTiles; ++i) {
                  mma16816(acc[i][2 * q], a[i], bf[0], bf[1]);
                  mma16816(acc[i][2 * q + 1], a[i], bf[2], bf[3]);
                }
              }
            }
          }
        }
        __syncthreads();  // the products have read the group values, and
                          // the last stores have read ot and red
        stage_outputs<kMTiles, kNTiles, N, kOs, true>(
            acc, conv3x3_mma::Raw{}, in_tile, ot, red, warp, 0, lane, n0,
            co);
        __syncthreads();
        __nv_bfloat16* out = d.out[o] + p0 * co;
        auto dst = [&](int p) -> __nv_bfloat16* {
          return p < valid ? out + p * co : nullptr;
        };
        store_outputs<kFwdTile, N, kOs, kThr>(ot, dst, tid, n0, co);
        write_stats_row<N, Sp::kWarps, kThr, true>(red, cstat + soff, tid,
                                                     n0, co);
      }
      soff += 2 * co;
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA
  __syncthreads();
  for (int u = tid; u < S; u += kThr)
    partial[(size_t)blockIdx.x * S + u] = cstat[u];
}

// --------------------------------------------------------------------------
// backward
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
p1x1_bwd_kernel(const __grid_constant__ Pass1x1Desc d,
                float* __restrict__ partial, int N, int ntiles, int R,
                int nwe) {
  extern __shared__ float4 smem4[];
  const int ci = d.ci, half = ci / 2, gs = ci + 4;
  // float rows padded by 4: 16-byte aligned, and 8 consecutive rows start
  // in 8 different 4-bank groups (row length ≡ 4 mod 8 words)
  float* gv = reinterpret_cast<float*>(smem4);  // [n_groups][kBwdTile][gs]
  float* dze[kMaxOut];
  float* cur = gv + d.n_groups * kBwdTile * gs;
  for (int o = 0; o < d.n_out; ++o) {
    dze[o] = cur;  // [kBwdTile][co_o + 4]
    cur += kBwdTile * (d.co[o] + 4);
  }
  const int G = d.n_in * 2 * ci;
  float* sdgb = cur;  // [2 halves][n_in][2][ci]
  for (int i = threadIdx.x; i < 2 * G; i += kThreads) sdgb[i] = 0.f;
  float* prow = partial + (size_t)blockIdx.x * R;  // [dW of each weight][dgb]

  // dW blocks: 4 input channels x 8 output channels of one weight
  int nblk = 0;
  for (int w = 0; w < d.n_w; ++w) nblk += (ci / 4) * (d.wco[w] / 8);

  bool first = true;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t p0 = (size_t)tile * kBwdTile;
    __syncthreads();  // the previous tile's reads are done
    // group values, rounded to bf16 as the forward rounds them
    for (int idx = threadIdx.x; idx < d.n_groups * kBwdTile * half; idx += kThreads) {
      const int g = idx / (kBwdTile * half), r = idx - g * kBwdTile * half;
      const int p = r / half, c2 = r - p * half;
      float2 v = make_float2(0.f, 0.f);
      if (p0 + p < (size_t)N) v = group_pair(d, g, p0 + p, c2);
      float* dst = gv + (g * kBwdTile + p) * gs + 2 * c2;
      dst[0] = bf16_round(v.x);
      dst[1] = bf16_round(v.y);
    }
    // e_o = bf16(dz + ds1 + 2·z·ds2), zero past the last pixel
    for (int o = 0; o < d.n_out; ++o) {
      const int co = d.co[o], h2 = co / 2;
      const float* ds = d.dstat[o];
      for (int idx = threadIdx.x; idx < kBwdTile * h2; idx += kThreads) {
        const int p = idx / h2, k2 = idx - p * h2, k = 2 * k2;
        float2 e = make_float2(0.f, 0.f);
        if (p0 + p < (size_t)N) {
          const size_t at = (p0 + p) * co;
          const float2 dz = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(d.dz_out[o] + at)[k2]);
          const float2 zo = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(d.out[o] + at)[k2]);
          e.x = bf16_round(dz.x + __ldg(ds + k) + 2.f * zo.x * __ldg(ds + co + k));
          e.y = bf16_round(dz.y + __ldg(ds + k + 1) +
                           2.f * zo.y * __ldg(ds + co + k + 1));
        }
        float* dst = dze[o] + p * (co + 4) + k;
        dst[0] = e.x;
        dst[1] = e.y;
      }
    }
    __syncthreads();

    // (a) dW += gvalᵀ · e over the tile, into this block's partial row
    for (int blk = threadIdx.x; blk < nblk; blk += kThreads) {
      int w = 0, rem = blk, woff = 0;
      while (rem >= (ci / 4) * (d.wco[w] / 8)) {
        rem -= (ci / 4) * (d.wco[w] / 8);
        woff += ci * d.wco[w];
        ++w;
      }
      const int cow = d.wco[w], nkb = cow / 8;
      const int cb = rem / nkb, kb = rem - cb * nkb;
      float* dst = prow + woff + (size_t)(cb * 4) * cow + kb * 8;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (first) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        } else {
          const float4 a = *reinterpret_cast<const float4*>(dst + i * cow);
          const float4 b = *reinterpret_cast<const float4*>(dst + i * cow + 4);
          acc[i][0] = a.x; acc[i][1] = a.y; acc[i][2] = a.z; acc[i][3] = a.w;
          acc[i][4] = b.x; acc[i][5] = b.y; acc[i][6] = b.z; acc[i][7] = b.w;
        }
      }
      for (int o = 0; o < d.n_out; ++o) {
        for (int j = 0; j < d.npair[o]; ++j) {
          if (d.pair_w[o * kMaxPairs + j] != w) continue;
          const float* gp = gv + d.pair_g[o * kMaxPairs + j] * kBwdTile * gs + cb * 4;
          const float* ep = dze[o] + kb * 8;
          const int es = d.co[o] + 4;
          for (int p = 0; p < kBwdTile; ++p) {
            const float4 x = *reinterpret_cast<const float4*>(gp + p * gs);
            const float4 e0 = *reinterpret_cast<const float4*>(ep + p * es);
            const float4 e1 = *reinterpret_cast<const float4*>(ep + p * es + 4);
            const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][0] = fmaf(xv[i], e0.x, acc[i][0]);
              acc[i][1] = fmaf(xv[i], e0.y, acc[i][1]);
              acc[i][2] = fmaf(xv[i], e0.z, acc[i][2]);
              acc[i][3] = fmaf(xv[i], e0.w, acc[i][3]);
              acc[i][4] = fmaf(xv[i], e1.x, acc[i][4]);
              acc[i][5] = fmaf(xv[i], e1.y, acc[i][5]);
              acc[i][6] = fmaf(xv[i], e1.z, acc[i][6]);
              acc[i][7] = fmaf(xv[i], e1.w, acc[i][7]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(dst + i * cow) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + i * cow + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }

    // (b) t_g = Σ e · Wᵀ, then each member's input gradient and (dg, db)
    for (int g = 0; g < d.n_groups; ++g) {
      for (int it = threadIdx.x; it < (ci / 8) * kBwdTile; it += kThreads) {
        const int c8 = it / kBwdTile, p = it - c8 * kBwdTile;
        const bool valid = p0 + p < (size_t)N;
        const size_t at = (p0 + p) * ci + c8 * 8;
        float t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = 0.f;
        for (int o = 0; o < d.n_out; ++o) {
          const int co = d.co[o];
          const float* e = dze[o] + p * (co + 4);
          for (int j = 0; j < d.npair[o]; ++j) {
            if (d.pair_g[o * kMaxPairs + j] != g) continue;
            const __nv_bfloat16* wt = d.wt[d.pair_w[o * kMaxPairs + j]] + c8 * 8;
            for (int k = 0; k < co; k += 4) {
              const float4 ev = *reinterpret_cast<const float4*>(e + k);
              const float es[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                float wr[8];
                ldg8_bf16(wt + (size_t)(k + u) * ci, wr);
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) t[jj] = fmaf(es[u], wr[jj], t[jj]);
              }
            }
          }
        }
        for (int i = 0; i < d.n_in; ++i) {
          if (d.group[i] != g) continue;
          float dz[8];
          if (!d.ns[i]) {
            if (valid) store8_bf16(d.dz_in[i] + at, t);
            continue;
          }
          float zf[8], dg[8], db[8];
          if (valid) {
            load8_bf16(d.z[i] + at, zf);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) zf[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c8 * 8 + j;
            const float gg = __ldg(d.gb[i] + c);
            const float a = zf[j] * gg + __ldg(d.gb[i] + ci + c);
            const float s = 1.f / (1.f + expf(-a));
            const float da = valid ? t[j] * (s * (1.f + a * (1.f - s))) : 0.f;
            dz[j] = da * gg;
            dg[j] = da * zf[j];
            db[j] = da;
          }
          if (valid) store8_bf16(d.dz_in[i] + at, dz);
          float* s = sdgb + (p >= 32 ? G : 0) + i * 2 * ci + c8 * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float s1 = warp_sum(dg[j]), s2 = warp_sum(db[j]);
            if ((threadIdx.x & 31) == 0) {
              s[j] += s1;
              s[ci + j] += s2;
            }
          }
        }
      }
    }
    first = false;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += kThreads)
    prow[nwe + i] = sdgb[i] + sdgb[G + i];
}

// grid: the CTAs launched, each writing one row of partial
template <int N>
cudaError_t fwd_launch(const Pass1x1Desc* d, float* partial, int npix, int S,
                       int* grid, cudaStream_t stream) {
  using Sp = FwdSplit<N>;
  auto kern = p1x1_fwd_kernel<N>;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return err;
  // stage as many inputs as the shared memory per block holds
  int nstage = d->n_in;
  FwdSmem m = fwd_smem<N>(*d, S, nstage);
  while (nstage > 0 && m.bytes > (size_t)optin)
    m = fwd_smem<N>(*d, S, --nstage);
  if ((err = allow_smem(kern, m.bytes)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, Sp::kThreads, m.bytes)) != cudaSuccess)
    return err;
  const int ntiles = (npix + kFwdTile - 1) / kFwdTile;
  *grid = per_sm * sms < ntiles ? per_sm * sms : ntiles;
  if (*grid == 0) return cudaErrorInvalidConfiguration;
  kern<<<*grid, Sp::kThreads, m.bytes, stream>>>(*d, partial, m, npix, S);
  return cudaGetLastError();
}

}  // namespace

// partial: one row of S floats per kFwdTile-pixel tile of scratch (at
// most one CTA per tile writes a row); stats: S = Σ_o 2*co_o floats, output
// o's (Σ; Σ²) rows at 2 * (co of earlier outputs).  Requires ci % 8 == 0,
// co % 8 == 0 and 16-byte aligned inputs and weights.
extern "C" int pass1x1_fwd_launch(const Pass1x1Desc* d, float* partial,
                                  float* stats, int N, void* stream) {
  int S = 0, co_max = 0, grid = 0;
  for (int o = 0; o < d->n_out; ++o) {
    S += 2 * d->co[o];
    if (d->co[o] > co_max) co_max = d->co[o];
  }
  auto st = (cudaStream_t)stream;
  cudaError_t err = conv3x3_mma::chunk_n(co_max) == 48
                        ? fwd_launch<48>(d, partial, N, S, &grid, st)
                        : fwd_launch<96>(d, partial, N, S, &grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, stats, S, grid, st);
}

// partial: parts * R floats of scratch, R = Σ_w ci*co_w + n_in*2*ci; sums:
// R floats — each weight's dW (ci, co_w) in order, then each input's
// (dg; db) rows (2, ci).
extern "C" int pass1x1_bwd_launch(const Pass1x1Desc* d, float* partial,
                                  float* sums, int N, int parts,
                                  void* stream) {
  int nwe = 0, sum_co = 0;
  for (int w = 0; w < d->n_w; ++w) nwe += d->ci * d->wco[w];
  for (int o = 0; o < d->n_out; ++o) sum_co += d->co[o] + 4;
  const int R = nwe + d->n_in * 2 * d->ci;
  const int ntiles = (N + kBwdTile - 1) / kBwdTile;
  const size_t smem =
      ((size_t)d->n_groups * kBwdTile * (d->ci + 4) + (size_t)kBwdTile * sum_co +
       2 * (size_t)d->n_in * 2 * d->ci) * sizeof(float);
  cudaError_t err = allow_smem(p1x1_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  p1x1_bwd_kernel<<<parts, kThreads, smem, (cudaStream_t)stream>>>(
      *d, partial, N, ntiles, R, nwe);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, sums, R, parts,
                                  (cudaStream_t)stream);
}
