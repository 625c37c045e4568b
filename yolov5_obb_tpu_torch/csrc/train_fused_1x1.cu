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
// them.
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
// Backward design, on the forward's lines: the products on the tensor cores
// (mma.sync m16n8k16), as many CTAs as fit on the card (the occupancy query
// of pass1x1_bwd_parts, which the wrapper sizes its partial by) walking the
// kBwdTile-pixel tiles tile ≡ blockIdx.x (mod gridDim.x).  Per tile, from
// its inputs, z_out and dz_out, staged by cp.async (the first nstage inputs,
// as many as the shared memory per block holds; the others read and their
// gradients written in device memory): e_o = bf16(dz + ds1 + 2·z·ds2) and
// the group values (the forward's group_values: silu_fast, one rounding),
// each once, into padded bf16 rows (an odd number of 16-byte units), zero
// past the last pixel and past ci / co.  Then the next tile's z_out and
// dz_out copies go out behind the products, its inputs once this tile's
// input gradients have left their tiles (one buffer: a second one cost
// cv3 its second CTA per SM, PERF.md):
//   dW, a split-K product over the pixels: A = gvalᵀ by ldmatrix.x4.trans
//     (as the downsample weight gradient reads patchᵀ), B = e_o by
//     ldmatrix.x4.trans; the dW block of every pair is cut into 16 x 16
//     units, unit u to warp u % 8, kU units a warp (in registers) for all
//     of the CTA's tiles; a pass with more units runs them in rounds along
//     gridDim.y (only round 0 computes the input gradients);
//   t_g = Σ e_o·W_wᵀ: A = e_o by ldmatrix.x4, B = the weight tile as it
//     lies ([ci][co]) by ldmatrix.x2, a warp one m16 tile of pixels x every
//     other n8 tile of channels, kBwdTN at a time; the activation backward
//     on the float32 accumulators (the sigmoid by __expf and __fdividef),
//     a member's tiles together: dz_in = bf16(dα·g) into the staged input
//     tile in place, then 16-byte stores; (dg, db) summed over the lanes by
//     shuffles and added, tile by tile, into the CTA's shared row of its
//     m16 tile (one writer per entry).
// The CTA writes its dW units and the four (dg, db) rows summed in order as
// its partial row; wgrad.cuh's sum_partials adds the rows in order.  No
// float atomics: repeated runs agree bit for bit.  At yolov5m's widths the
// kernel holds 118 registers a thread, so two 8-warp CTAs share an SM; on
// the H100 the activation backward's per-value work at those 16 warps, not
// the bytes, bounds it (PERF.md: the ablations).
#include "conv3x3_mma.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kMaxIn = 8, kMaxW = 4, kMaxOut = 2, kMaxPairs = 2;
constexpr int kFwdTile = 128;  // pixels per tile of the forward
constexpr int kFwdWarps = 8;   // warps of the forward (16 pixels each)
constexpr int kBwdTile = 64;   // pixels per tile of the backward
constexpr int kBwdWarps = 8;   // warps of the backward
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdTN = 2;      // n8 tiles of t a warp holds at a time

}  // namespace

struct Pass1x1Desc {
  const __nv_bfloat16* z[kMaxIn];       // inputs (N, ci)
  const float* gb[kMaxIn];              // (2, ci)
  const __nv_bfloat16* w[kMaxW];        // (ci, co_w)
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

__host__ __device__ inline int pad16(int c) { return (c + 15) / 16 * 16; }

// A tile's group values, as the forward multiplies them and the backward
// recomputes them: gval[g][p][c] (pitch gp) = the float32 sum of group g's
// members' values at pixel p, channel c, in input order (silu_fast(z·g + b)
// for activated ones: __expf and __fdividef, as the 3x3 passes' prologue),
// rounded once to bf16; zero past ci and at pixels >= valid.  Input i's
// tile is raw + i * rstride (pitch rp) for i < nstage, else device memory at
// d.z[i] + p0 * ci.  Each thread keeps one 16-byte group of 8 channels and
// walks the pixels (threads past rows * c8s idle).  members0/1: the groups'
// members, act: the activated inputs, as bit masks (bit i: input i).
template <int kTile, int kThr>
__device__ __forceinline__ void group_values(
    const Pass1x1Desc& d, const __nv_bfloat16* raw, int rstride, int rp,
    int nstage, const float* gbs, __nv_bfloat16* gval, int gp, size_t p0,
    int valid, unsigned members0, unsigned members1, unsigned act, int tid) {
  const int ci = d.ci, c8s = pad16(ci) / 8, rows = kThr / c8s;
  const int c = 8 * (tid % c8s), pr = tid / c8s;
  if (pr >= rows) return;
  for (int g = 0; g < d.n_groups; ++g) {
    const unsigned mem = g ? members1 : members0;
    for (int p = pr; p < kTile; p += rows) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      if (c < ci && p < valid) {
        for (unsigned rest = mem; rest; rest &= rest - 1) {
          const int i = __ffs(rest) - 1;
          const __nv_bfloat16* src =
              i < nstage ? raw + (size_t)i * rstride + (size_t)p * rp
                         : d.z[i] + (p0 + p) * ci;
          float v[8];
          load8_bf16(src + c, v);
          if (act >> i & 1u) {
            const float4* gp4 =
                reinterpret_cast<const float4*>(gbs + 2 * i * ci + c);
            const float4* bp = gp4 + ci / 4;
            const float4 g0 = gp4[0], g1 = gp4[1], b0 = bp[0], b1 = bp[1];
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
      store8_bf16(gval + ((size_t)g * kTile + p) * gp + c, acc);
    }
  }
}

// each group's members and the activated inputs, as bit masks
__device__ __forceinline__ void member_masks(const Pass1x1Desc& d,
                                             unsigned* members0,
                                             unsigned* members1,
                                             unsigned* act) {
  *members0 = *members1 = *act = 0u;
  for (int i = 0; i < d.n_in; ++i) {
    if (d.group[i]) *members1 |= 1u << i;
    else *members0 |= 1u << i;
    if (d.ns[i]) *act |= 1u << i;
  }
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

  unsigned members0, members1, act;
  member_masks(d, &members0, &members1, &act);
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

    group_values<kFwdTile, kThr>(d, raw, kFwdTile * ci, ci, m.nstage, gbs,
                                 gval, ps, p0, valid, members0, members1,
                                 act, tid);
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
            acc, Raw{}, in_tile, ot, red, warp, 0, lane, n0,
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

// --------------------------------------------------------------------------
// backward
// --------------------------------------------------------------------------

// The backward's shared memory, in bf16 elements from its start: every
// weight's [ci padded to 16][co_w padded to 16, + 8] tile (as the
// forward's), e_o [n_out][kBwdTile][ep] (ep: the widest output padded to 16,
// + 8), the group values [n_groups][kBwdTile][ci padded to 16, + 8], z_out
// then dz_out of each output [kBwdTile][co_o] (as in device memory), the
// first nstage inputs' tiles [nstage][kBwdTile][ci + 8]; then in
// float32 every input's (g; b) rows, every output's (ds1; ds2) rows and the
// (dg; db) rows of every input for each of the four m16 pixel tiles, and
// each thread's kU packed dW unit offsets (in shared memory, not registers:
// at two CTAs per SM the kernel has 128 registers a thread).  Every part is
// a multiple of 16 bytes.
struct BwdSmem {
  int e, gval, rawo, rawi, gbs, dss, sdgb, uoff;  // offsets, in bf16 units
  int ep, nstage, units, rounds;
  size_t bytes;
};

// the 16 x 16 dW units of all of a pass's pairs
inline int bwd_units(const Pass1x1Desc& d) {
  int u = 0;
  for (int o = 0; o < d.n_out; ++o)
    u += d.npair[o] * (pad16(d.ci) / 16) * (pad16(d.co[o]) / 16);
  return u;
}

inline BwdSmem bwd_smem(const Pass1x1Desc& d, int nstage, int kU) {
  const int cp = pad16(d.ci);
  int co_max = 0, sum_co = 0;
  for (int o = 0; o < d.n_out; ++o) {
    co_max = pad16(d.co[o]) > co_max ? pad16(d.co[o]) : co_max;
    sum_co += d.co[o];
  }
  BwdSmem m;
  m.ep = co_max + 8;
  m.nstage = nstage;
  int at = 0;
  for (int w = 0; w < d.n_w; ++w) at += cp * fwd_w_pitch(d.wco[w]);
  m.e = at;
  at += d.n_out * kBwdTile * m.ep;
  m.gval = at;
  at += d.n_groups * kBwdTile * fwd_in_pitch(d.ci);
  m.rawo = at;
  at += 2 * kBwdTile * sum_co;
  m.rawi = at;
  at += nstage * kBwdTile * (d.ci + 8);
  m.gbs = at;
  at += 2 * d.n_in * 2 * d.ci;
  m.dss = at;
  at += 2 * 2 * sum_co;
  m.sdgb = at;
  at += 2 * 4 * d.n_in * 2 * d.ci;
  m.uoff = at;
  at += 2 * kU * kBwdThreads;
  m.bytes = (size_t)at * 2;
  m.units = bwd_units(d);
  m.rounds = 1;
  return m;
}

// Unit u of a pass's dW (counted over its pairs in order): pair (o, q)'s
// m16 tile of input channels *mi and n16 block of output channels *ni;
// false past the last unit.
__host__ __device__ inline bool bwd_unit(const Pass1x1Desc& d, int u, int* o,
                                         int* q, int* mi, int* ni) {
  for (*o = 0; *o < d.n_out; ++*o)
    for (*q = 0; *q < d.npair[*o]; ++*q) {
      const int nb = pad16(d.co[*o]) / 16, cnt = pad16(d.ci) / 16 * nb;
      if (u < cnt) {
        *mi = u / nb;
        *ni = u - *mi * nb;
        return true;
      }
      u -= cnt;
    }
  return false;
}

template <int kU>
__global__ void __launch_bounds__(kBwdThreads, kU <= 5 ? 2 : 1)
p1x1_bwd_kernel(const __grid_constant__ Pass1x1Desc d,
                float* __restrict__ partial, BwdSmem m, int npix, int R,
                int nwe) {
  extern __shared__ float4 smem4[];
  auto* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int ci = d.ci, cp = pad16(ci), ip = ci + 8, gp = fwd_in_pitch(ci);
  const int ep = m.ep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* wts = sm;
  __nv_bfloat16* E = sm + m.e;
  __nv_bfloat16* G = sm + m.gval;
  __nv_bfloat16* rawo = sm + m.rawo;
  __nv_bfloat16* rawi = sm + m.rawi;
  float* gbs = reinterpret_cast<float*>(sm + m.gbs);
  float* dss = reinterpret_cast<float*>(sm + m.dss);
  float* sdgb = reinterpret_cast<float*>(sm + m.sdgb);
  unsigned* uoff = reinterpret_cast<unsigned*>(sm + m.uoff) + tid;
  const int ntiles = (npix + kBwdTile - 1) / kBwdTile;
  const bool round0 = blockIdx.y == 0;
  auto valid_in = [&](int t) {
    return min(kBwdTile, npix - t * kBwdTile);
  };

  // every weight (zero past ci and co_w), (g; b) and (ds1; ds2), once
  __nv_bfloat16* wdst = wts;
  for (int w = 0; w < d.n_w; ++w) {
    const int cow = d.wco[w], wp = fwd_w_pitch(cow), wu = (wp - 8) / 8;
    for (int u = tid; u < cp * wu; u += kBwdThreads) {
      const int k = u / wu, g = u - k * wu;
      const bool full = k < ci && 8 * g < cow;
      cp_async16(wdst + k * wp + 8 * g,
                 full ? d.w[w] + (size_t)k * cow + 8 * g : d.w[w], full);
    }
    wdst += cp * wp;
  }
  for (int u = tid; u < d.n_in * 2 * ci; u += kBwdThreads)
    gbs[u] = __ldg(d.gb[u / (2 * ci)] + u % (2 * ci));
  for (int o = 0, off = 0; o < d.n_out; off += 2 * d.co[o], ++o)
    for (int u = tid; u < 2 * d.co[o]; u += kBwdThreads)
      dss[off + u] = __ldg(d.dstat[o] + u);
  for (int u = tid; u < 4 * d.n_in * 2 * ci; u += kBwdThreads) sdgb[u] = 0.f;

  // tile t's z_out and dz_out, and its first nstage inputs, 16 bytes a
  // copy; zero past the last pixel
  auto copy_out = [&](int t) {
    const size_t p0 = (size_t)t * kBwdTile;
    const int valid = valid_in(t);
    __nv_bfloat16* dst = rawo;
    for (int o = 0; o < d.n_out; ++o) {
      const int co = d.co[o], units = kBwdTile * co / 8, full = valid * co / 8;
      for (int k = 0; k < 2; ++k) {
        const __nv_bfloat16* src = k ? d.dz_out[o] : d.out[o];
        for (int u = tid; u < units; u += kBwdThreads)
          cp_async16(dst + 8 * u, u < full ? src + p0 * co + 8 * u : src,
                     u < full);
        dst += kBwdTile * co;
      }
    }
  };
  auto copy_in = [&](int t) {
    const size_t p0 = (size_t)t * kBwdTile;
    const int valid = valid_in(t), c8 = ci / 8;
    for (int i = 0; i < m.nstage; ++i) {
      __nv_bfloat16* dst = rawi + (size_t)i * kBwdTile * ip;
      for (int u = tid; u < kBwdTile * c8; u += kBwdThreads) {
        const int p = u / c8, k = u - p * c8;
        cp_async16(dst + p * ip + 8 * k,
                   p < valid ? d.z[i] + (p0 + p) * ci + 8 * k : d.z[i],
                   p < valid);
      }
    }
  };

  // this warp's dW units of round blockIdx.y, ubase + kBwdWarps * j; per
  // lane its A address (pixel row of gvalᵀ's .trans load, channel half)
  // and its B address (pixel row of e_o's, column half)
  // (packed: A offset | B offset << 16; the plan keeps both below 2^16),
  // at uoff[j * kBwdThreads]
  const int ubase = blockIdx.y * kBwdWarps * kU + warp;
  float dw[kU][2][4];
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    int o = 0, q = 0, mi = 0, ni = 0;
    uoff[j * kBwdThreads] = 0u;
    if (bwd_unit(d, ubase + kBwdWarps * j, &o, &q, &mi, &ni)) {
      const int g = d.pair_g[o * kMaxPairs + q];
      const unsigned a = (g * kBwdTile + (lane & 7) + (lane >> 4) * 8) * gp +
                         16 * mi + ((lane >> 3) & 1) * 8;
      const unsigned b =
          (o * kBwdTile + (lane & 15)) * ep + 16 * ni + (lane >> 4) * 8;
      uoff[j * kBwdThreads] = a | b << 16;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[j][h][e] = 0.f;
  }
  if ((int)blockIdx.x < ntiles) {
    copy_in(blockIdx.x);
    copy_out(blockIdx.x);
  }
  cp_async_commit();
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const size_t p0 = (size_t)t * kBwdTile;
    const int valid = valid_in(t), tn = t + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this tile's copies (and the weights) landed

    // e_o = bf16(dz + ds1 + 2·z·ds2), zero past co and the last pixel
    const __nv_bfloat16* ro = rawo;
    const float* ds = dss;
    for (int o = 0; o < d.n_out; ++o) {
      const int co = d.co[o], g8 = pad16(co) / 8;
      for (int u = tid; u < kBwdTile * g8; u += kBwdThreads) {
        const int p = u / g8, n = 8 * (u - p * g8);
        float e[8];
        if (p < valid && n < co) {
          float zo[8], dz[8];
          load8_bf16(ro + p * co + n, zo);
          load8_bf16(ro + (kBwdTile + p) * co + n, dz);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = dz[j] + ds[n + j] + 2.f * zo[j] * ds[co + n + j];
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = 0.f;
        }
        store8_bf16(E + (o * kBwdTile + p) * ep + n, e);
      }
      ro += 2 * kBwdTile * co;
      ds += 2 * co;
    }
    // (the member masks, like every value not needed across the phases, are
    // made where they are used: the kernel runs at 128 registers)
    unsigned members0, members1, act;
    member_masks(d, &members0, &members1, &act);
    group_values<kBwdTile, kBwdThreads>(d, rawi, kBwdTile * ip, ip, m.nstage,
                                        gbs, G, gp, p0, valid, members0,
                                        members1, act, tid);
    __syncthreads();  // e_o and the group values published; rawo is free
    if (tn < ntiles) copy_out(tn);
    cp_async_commit();

    // dW += gvalᵀ · e_o, 16 pixels a step
#pragma unroll
    for (int ks = 0; ks < kBwdTile / 16; ++ks)
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        if (ubase + kBwdWarps * j >= m.units) continue;
        const unsigned u = uoff[j * kBwdThreads];
        uint32_t a[4], bf[4];
        ldsm_x4_trans(a, G + (u & 0xffffu) + ks * 16 * gp);
        ldsm_x4_trans(bf, E + (u >> 16) + ks * 16 * ep);
        mma16816(dw[j][0], a, bf[0], bf[1]);
        mma16816(dw[j][1], a, bf[2], bf[3]);
      }

    if (round0) {
      // t_g = Σ e_o · W_wᵀ over the pairs of group g, kBwdTN n8 tiles at a
      // time, then each member's input gradient and (dg, db); the warp's
      // m16 tile of pixels and its half of the n8 channel tiles
      const int mt = warp & 3, half = warp >> 2, nt = ci / 8;
      const int G1 = d.n_in * 2 * ci;  // floats of a pixel tile's (dg; db)
      member_masks(d, &members0, &members1, &act);
      for (int g = 0; g < d.n_groups; ++g) {
        const unsigned mem = g ? members1 : members0;
        for (int jc = 0; jc < nt; jc += 2 * kBwdTN) {
          float tacc[kBwdTN][4];
#pragma unroll
          for (int i = 0; i < kBwdTN; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) tacc[i][e] = 0.f;
          for (int o = 0; o < d.n_out; ++o)
            for (int q = 0; q < d.npair[o]; ++q) {
              if (d.pair_g[o * kMaxPairs + q] != g) continue;
              const int w = d.pair_w[o * kMaxPairs + q];
              const __nv_bfloat16* B = wts;
              for (int v = 0; v < w; ++v) B += cp * fwd_w_pitch(d.wco[v]);
              const int wp = fwd_w_pitch(d.wco[w]);
              B += (lane & 7) * wp + ((lane >> 3) & 1) * 8;
              const __nv_bfloat16* A =
                  E + (o * kBwdTile + 16 * mt + (lane & 15)) * ep +
                  (lane >> 4) * 8;
              const int kend = pad16(d.co[o]);
#pragma unroll 1
              for (int k0 = 0; k0 < kend; k0 += 16) {
                uint32_t a[4];
                ldsm_x4(a, A + k0);
#pragma unroll
                for (int i = 0; i < kBwdTN; ++i) {
                  const int j = jc + half + 2 * i;
                  if (j < nt) {
                    uint32_t bf[2];
                    ldsm_x2(bf, B + 8 * j * wp + k0);
                    mma16816(tacc[i], a, bf[0], bf[1]);
                  }
                }
              }
            }
          // each member's tiles together (independent chains interleave):
          // dα = t·silu'(z·g + b) (the sigmoid by __expf and __fdividef, as
          // the forward's silu_fast), dz_in = bf16(dα·g) (bf16(t) for a
          // plain input), (Σ dα·z, Σ dα) of channels c, c + 1
          for (unsigned rest = mem; rest; rest &= rest - 1) {
            const int ii = __ffs(rest) - 1;
            const bool on = act >> ii & 1u;
            float s[kBwdTN][4];
#pragma unroll
            for (int i = 0; i < kBwdTN; ++i) {
              const int j = jc + half + 2 * i;
              s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
              if (j >= nt) continue;
              const int c = 8 * j + 2 * (lane & 3);
              const float2 gg =
                  *reinterpret_cast<const float2*>(gbs + 2 * ii * ci + c);
              const float2 bb = *reinterpret_cast<const float2*>(
                  gbs + (2 * ii + 1) * ci + c);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = 16 * mt + (lane >> 2) + 8 * h;
                if (p >= valid) continue;
                // the staged tile, in place; else device memory
                __nv_bfloat16* st =
                    ii < m.nstage ? rawi + ((size_t)ii * kBwdTile + p) * ip + c
                                  : nullptr;
                const __nv_bfloat16* zs =
                    st ? st : d.z[ii] + (p0 + p) * ci + c;
                __nv_bfloat16* dzs = st ? st : d.dz_in[ii] + (p0 + p) * ci + c;
                float vx = tacc[i][2 * h], vy = tacc[i][2 * h + 1];
                if (on) {
                  const float2 z = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(zs));
                  const float ax = z.x * gg.x + bb.x, ay = z.y * gg.y + bb.y;
                  const float sx = __fdividef(1.f, 1.f + __expf(-ax));
                  const float sy = __fdividef(1.f, 1.f + __expf(-ay));
                  const float dax = vx * (sx * (1.f + ax * (1.f - sx)));
                  const float day = vy * (sy * (1.f + ay * (1.f - sy)));
                  s[i][0] += dax * z.x;
                  s[i][1] += day * z.y;
                  s[i][2] += dax;
                  s[i][3] += day;
                  vx = dax * gg.x;
                  vy = day * gg.y;
                }
                *reinterpret_cast<__nv_bfloat162*>(dzs) =
                    __floats2bfloat162_rn(vx, vy);
              }
            }
            if (!on) continue;
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
#pragma unroll
              for (int i = 0; i < kBwdTN; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  s[i][q] += __shfl_xor_sync(0xffffffffu, s[i][q], off);
            if (lane < 4) {  // the entries' one writer
#pragma unroll
              for (int i = 0; i < kBwdTN; ++i) {
                const int j = jc + half + 2 * i;
                if (j >= nt) continue;
                float* row = sdgb + (size_t)mt * G1 + 2 * ii * ci + 8 * j +
                             2 * lane;
                row[0] += s[i][0];
                row[1] += s[i][1];
                row[ci] += s[i][2];
                row[ci + 1] += s[i][3];
              }
            }
          }
        }
      }
      __syncthreads();  // the staged input gradients are whole
      const int c8 = ci / 8;
      for (int ii = 0; ii < m.nstage; ++ii)
        for (int u = tid; u < valid * c8; u += kBwdThreads) {
          const int p = u / c8, kk = u - p * c8;
          *reinterpret_cast<uint4*>(d.dz_in[ii] + (p0 + p) * ci + 8 * kk) =
              *reinterpret_cast<const uint4*>(
                  rawi + ((size_t)ii * kBwdTile + p) * ip + 8 * kk);
        }
    }
    __syncthreads();  // the input tiles are read
    if (tn < ntiles) copy_in(tn);
    cp_async_commit();
  }
  cp_async_wait<0>();  // no copy outlives the CTA
  __syncthreads();

  // the CTA's partial row: its dW units (rows: input channel lane/4 and
  // lane/4 + 8 of the m16 tile; columns 2*(lane%4), +1 of each n8 half),
  // then in round 0 each input's (dg; db), the four pixel tiles in order
  float* row = partial + (size_t)blockIdx.x * R;
#pragma unroll
  for (int j = 0; j < kU; ++j) {
    int o, q, mi, ni;
    if (!bwd_unit(d, ubase + kBwdWarps * j, &o, &q, &mi, &ni)) continue;
    const int w = d.pair_w[o * kMaxPairs + q], cow = d.wco[w];
    int woff = 0;
    for (int v = 0; v < w; ++v) woff += ci * d.wco[v];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * mi + (lane >> 2) + 8 * e;
        const int n = 16 * ni + 8 * h + 2 * (lane & 3);
        if (c < ci && n < cow)
          *reinterpret_cast<float2*>(row + woff + c * cow + n) =
              make_float2(dw[j][h][2 * e], dw[j][h][2 * e + 1]);
      }
  }
  const int G1 = d.n_in * 2 * ci;
  if (round0)
    for (int i = tid; i < G1; i += kBwdThreads) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) v += sdgb[r * G1 + i];
      row[nwe + i] = v;
    }
}

// As many CTAs as reside on the card at once (the occupancy query: shared
// memory and registers), over the rounds of dW units, at most one per
// tile; the inputs staged are as many as the shared memory per block holds.
// Fixed for a card and a pass, so repeated runs add the same partials in the
// same order.
template <int kU>
cudaError_t bwd_plan(const Pass1x1Desc& d, int npix, BwdSmem* m,
                     int* parts) {
  auto kern = p1x1_bwd_kernel<kU>;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return err;
  int nstage = d.n_in;
  *m = bwd_smem(d, nstage, kU);
  while (nstage > 0 && m->bytes > (size_t)optin)
    *m = bwd_smem(d, --nstage, kU);
  if (m->bytes > (size_t)optin || m->gval - m->e > 65536 ||
      m->rawo - m->gval > 65536)
    return cudaErrorInvalidValue;  // too wide for the packed unit offsets
  m->rounds = (m->units + kBwdWarps * kU - 1) / (kBwdWarps * kU);
  if ((err = allow_smem(kern, m->bytes)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kBwdThreads, m->bytes)) != cudaSuccess)
    return err;
  const int ntiles = (npix + kBwdTile - 1) / kBwdTile;
  const int fit = per_sm * sms / m->rounds;
  *parts = fit < ntiles ? fit : ntiles;
  if (*parts < 1) *parts = 1;
  return cudaSuccess;
}

template <int kU>
cudaError_t bwd_launch(const Pass1x1Desc* d, float* partial, int npix,
                       int parts, int R, int nwe, cudaStream_t stream) {
  BwdSmem m;
  int fit = 0;
  cudaError_t err = bwd_plan<kU>(*d, npix, &m, &fit);
  if (err != cudaSuccess) return err;
  p1x1_bwd_kernel<kU><<<dim3(parts, m.rounds), kBwdThreads, m.bytes,
                        stream>>>(*d, partial, m, npix, R, nwe);
  return cudaGetLastError();
}

// dW units a warp holds: 5 (yolov5n/s/m: at most 40 units a round), else 9
// (yolov5l/x; yolov5x's cv1+cv2 and cv3 in 2 rounds)
inline bool bwd_wide(const Pass1x1Desc& d) {
  return bwd_units(d) > kBwdWarps * 5;
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

// The rows of the backward's partial for a pass (its `parts`), or minus a
// CUDA error.  Launches nothing.
extern "C" int pass1x1_bwd_parts(const Pass1x1Desc* d, int N) {
  BwdSmem m;
  int parts = 0;
  const cudaError_t err = bwd_wide(*d) ? bwd_plan<9>(*d, N, &m, &parts)
                                       : bwd_plan<5>(*d, N, &m, &parts);
  return err != cudaSuccess ? -(int)err : parts;
}

// partial: parts * R floats of scratch, parts from pass1x1_bwd_parts, R =
// Σ_w ci*co_w + n_in*2*ci; sums: R floats — each weight's dW (ci, co_w) in
// order, then each input's (dg; db) rows (2, ci).  Requires ci % 8 == 0,
// co % 8 == 0, each weight in one pair, and 16-byte aligned inputs,
// weights, z_outs and dz_outs.
extern "C" int pass1x1_bwd_launch(const Pass1x1Desc* d, float* partial,
                                  float* sums, int N, int parts,
                                  void* stream) {
  int nwe = 0;
  for (int w = 0; w < d->n_w; ++w) nwe += d->ci * d->wco[w];
  const int R = nwe + d->n_in * 2 * d->ci;
  auto st = (cudaStream_t)stream;
  cudaError_t err = bwd_wide(*d)
                        ? bwd_launch<9>(d, partial, N, parts, R, nwe, st)
                        : bwd_launch<5>(d, partial, N, parts, R, nwe, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_partials(partial, sums, R, parts, st);
}
