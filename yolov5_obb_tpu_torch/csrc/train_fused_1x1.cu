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
// them.  This first version uses scalar float32 FMAs, so in practice
// operations limit it.
//
// Design.  Both kernels work on 64-pixel tiles and reduce in two stages
// with no float atomics, so repeated runs agree bit for bit.  Forward: one
// block per tile stages the tile's group values (bf16) in shared memory; a
// thread makes 8 channels of one pixel of one output, the weights read as
// warp-uniform broadcasts; each warp (32 pixels of one channel group) sums
// its accumulators and their squares by shuffles, one lane adds them into
// the block's shared sums (one writer per slot), and the block writes its
// tile's partial row, which wgrad.cuh's sum_rows adds in a fixed order.
// Backward: a fixed number of blocks (_build.partial_count) walk the tiles
// tile ≡ blockIdx.x (mod gridDim.x), since a dW partial per tile would be
// too large.  A block stages the group values and e_o as float32; thread
// blocks of 4x8 dW entries run over the tile's pixels and add into the
// block's own partial row in device memory (the entries belong to one
// thread); then a thread makes t for 8 channels of one pixel from e_o and
// Wᵀ, and the input gradients, with (dg, db) summed by warp shuffles as
// above.  wgrad.cuh's sum_partials adds the blocks' partial rows in order.
#include "common.cuh"
#include "wgrad.cuh"

namespace {

constexpr int kMaxIn = 8, kMaxW = 4, kMaxOut = 2, kMaxPairs = 2;
constexpr int P = 64;  // pixels per tile
constexpr int kThreads = 256;

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
// members' values, in input order
__device__ __forceinline__ float2 group_pair(const Pass1x1Desc& d, int g,
                                             size_t q, int c2) {
  float2 acc = make_float2(0.f, 0.f);
  for (int i = 0; i < d.n_in; ++i) {
    if (d.group[i] != g) continue;
    float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(d.z[i] + q * d.ci)[c2]);
    if (d.ns[i]) {
      const int c = 2 * c2;
      v.x = silu(v.x * __ldg(d.gb[i] + c) + __ldg(d.gb[i] + d.ci + c));
      v.y = silu(v.y * __ldg(d.gb[i] + c + 1) + __ldg(d.gb[i] + d.ci + c + 1));
    }
    acc.x += v.x;
    acc.y += v.y;
  }
  return acc;
}

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
p1x1_fwd_kernel(const __grid_constant__ Pass1x1Desc d,
                float* __restrict__ partial, int N, int S) {
  extern __shared__ float4 smem4[];
  const int ci = d.ci, half = ci / 2, st = smem_stride(ci);
  __nv_bfloat16* gval = reinterpret_cast<__nv_bfloat16*>(smem4);
  // [2 halves][S]: output o's Σ row then Σ² row at 2 * (co of earlier outputs)
  float* sst = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) +
      align16((size_t)d.n_groups * P * st * sizeof(__nv_bfloat16)));
  for (int i = threadIdx.x; i < 2 * S; i += kThreads) sst[i] = 0.f;

  const size_t p0 = (size_t)blockIdx.x * P;
  for (int idx = threadIdx.x; idx < d.n_groups * P * half; idx += kThreads) {
    const int g = idx / (P * half), r = idx - g * P * half;
    const int p = r / half, c2 = r - p * half;
    float2 v = make_float2(0.f, 0.f);
    if (p0 + p < (size_t)N) v = group_pair(d, g, p0 + p, c2);
    reinterpret_cast<__nv_bfloat162*>(gval + (g * P + p) * st)[c2] =
        __floats2bfloat162_rn(v.x, v.y);
  }
  __syncthreads();
  int soff = 0;
  for (int o = 0; o < d.n_out; ++o) {
    const int co = d.co[o];
    // items (channel group k8, pixel p), p fastest: a warp holds 32
    // pixels of one channel group
    for (int it = threadIdx.x; it < (co / 8) * P; it += kThreads) {
      const int k8 = it / P, p = it - k8 * P;
      const bool valid = p0 + p < (size_t)N;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      if (valid) {
        for (int j = 0; j < d.npair[o]; ++j) {
          const int g = d.pair_g[o * kMaxPairs + j];
          const int w = d.pair_w[o * kMaxPairs + j];
          fma_pixel(gval + (g * P + p) * st, ci, d.w[w] + k8 * 8, co, acc);
        }
        store8_bf16(d.out[o] + (p0 + p) * co + k8 * 8, acc);
      }
      float* s = sst + (p >= 32 ? S : 0) + soff + k8 * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s1 = warp_sum(acc[j]), s2 = warp_sum(acc[j] * acc[j]);
        if ((threadIdx.x & 31) == 0) {
          s[j] += s1;
          s[co + j] += s2;
        }
      }
    }
    soff += 2 * co;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += kThreads)
    partial[(size_t)blockIdx.x * S + i] = sst[i] + sst[S + i];
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
  float* gv = reinterpret_cast<float*>(smem4);  // [n_groups][P][gs]
  float* dze[kMaxOut];
  float* cur = gv + d.n_groups * P * gs;
  for (int o = 0; o < d.n_out; ++o) {
    dze[o] = cur;  // [P][co_o + 4]
    cur += P * (d.co[o] + 4);
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
    const size_t p0 = (size_t)tile * P;
    __syncthreads();  // the previous tile's reads are done
    // group values, rounded to bf16 as the forward rounds them
    for (int idx = threadIdx.x; idx < d.n_groups * P * half; idx += kThreads) {
      const int g = idx / (P * half), r = idx - g * P * half;
      const int p = r / half, c2 = r - p * half;
      float2 v = make_float2(0.f, 0.f);
      if (p0 + p < (size_t)N) v = group_pair(d, g, p0 + p, c2);
      float* dst = gv + (g * P + p) * gs + 2 * c2;
      dst[0] = bf16_round(v.x);
      dst[1] = bf16_round(v.y);
    }
    // e_o = bf16(dz + ds1 + 2·z·ds2), zero past the last pixel
    for (int o = 0; o < d.n_out; ++o) {
      const int co = d.co[o], h2 = co / 2;
      const float* ds = d.dstat[o];
      for (int idx = threadIdx.x; idx < P * h2; idx += kThreads) {
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
          const float* gp = gv + d.pair_g[o * kMaxPairs + j] * P * gs + cb * 4;
          const float* ep = dze[o] + kb * 8;
          const int es = d.co[o] + 4;
          for (int p = 0; p < P; ++p) {
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
      for (int it = threadIdx.x; it < (ci / 8) * P; it += kThreads) {
        const int c8 = it / P, p = it - c8 * P;
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

}  // namespace

// partial: one row of S floats per 64-pixel tile of scratch; stats: S =
// Σ_o 2*co_o floats, output o's (Σ; Σ²) rows at 2 * (co of earlier outputs).
extern "C" int pass1x1_fwd_launch(const Pass1x1Desc* d, float* partial,
                                  float* stats, int N, void* stream) {
  int S = 0;
  for (int o = 0; o < d->n_out; ++o) S += 2 * d->co[o];
  const int ntiles = (N + P - 1) / P;
  const size_t smem =
      align16((size_t)d->n_groups * P * smem_stride(d->ci) * sizeof(__nv_bfloat16)) +
      2 * (size_t)S * sizeof(float);
  cudaError_t err = allow_smem(p1x1_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  p1x1_fwd_kernel<<<ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      *d, partial, N, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, stats, S, ntiles, (cudaStream_t)stream);
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
  const int ntiles = (N + P - 1) / P;
  const size_t smem =
      ((size_t)d->n_groups * P * (d->ci + 4) + (size_t)P * sum_co +
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
