// The scalar float32 Conv(3x3, pad 1) body of the inference downsample
// (down.cu: BatchNorm scale/shift + SiLU epilogue) and the stride-1 fused
// train pass (train_fused_3x3.cu: a BatchNorm + SiLU prologue on the input,
// raw output, per-channel sums).  The train-mode downsample forward and the
// stride-2 pass run on the tensor-core body of conv3x3_mma.cuh; these two
// move onto it next, and this body goes when it has no user.
//
// x (B, H, W, ci) bf16; taps w (9*ci, co) bf16, row (3*dy + dx)*ci + c.
// Output (B, (H-1)/S + 1, (W-1)/S + 1, co) bf16, float32 accumulation.
//
// Design: a block makes one 8x8 output tile of one image at a time.  It
// stages the input patch under the tile in a padded bf16 shared tile,
// passing each in-image value through the prologue; positions outside the
// image are zero AFTER the prologue (the conv pads its activated input).
// Each thread then computes 8 output channels of one pixel; a warp covers
// 32 pixels of one channel group, so the weight reads are warp-uniform
// broadcasts.  With statistics each warp sums its 32 pixels' float32
// accumulators (and their squares) by shuffles, one lane adds them into the
// block's shared sums (a slot has one writer: no race, a fixed order), and
// the block writes its tile's partial (2, co).  (A version whose blocks
// each walked many tiles, to write fewer partials, made this same conv body
// 1.7x slower at 256² x 96 on the H100.)
#pragma once

#include "common.cuh"

namespace down_conv {

constexpr int T = 8;  // outputs per block side
constexpr int kThreads = 256;

// input pixels per block side at stride S
__host__ __device__ constexpr int patch(int S) { return S * (T - 1) + 3; }

template <int S>
__host__ __device__ inline size_t tile_bytes(int ci) {
  size_t b = (size_t)patch(S) * patch(S) * smem_stride(ci) * sizeof(__nv_bfloat16);
  return (b + 15) & ~(size_t)15;
}

// prologue: the staged input value as it is
struct Identity {
  __device__ __forceinline__ __nv_bfloat162 operator()(__nv_bfloat162 v, int) const {
    return v;
  }
};

// epilogue: the raw float32 sums
struct Raw {
  __device__ __forceinline__ void operator()(float*, int) const {}
};

// One 8x8 output tile at (b, oy0, ox0): stage the patch, then the conv.
// pro(v, c2) maps channels 2*c2, 2*c2+1 of an in-image input pixel;
// epi(acc, k0) maps the float32 sums of output channels k0 .. k0+7 in place.
// With kStats, each warp's sums of its 32 pixels' values (those the
// epilogue leaves) and of their squares go into sst [2 halves][2][co].
template <int S, bool kStats, typename Prologue, typename Epilogue>
__device__ __forceinline__ void tile_conv(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const Prologue& pro, const Epilogue& epi, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* tile, float* sst, int b, int oy0, int ox0, int H, int W,
    int ci, int co, int Ho, int Wo) {
  constexpr int IT = patch(S);
  const int st = smem_stride(ci);
  const int iy0 = S * oy0 - 1, ix0 = S * ox0 - 1;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * ci;

  // stage the patch two channels at a time
  const int half = ci / 2;
  for (int idx = threadIdx.x; idx < IT * IT * half; idx += kThreads) {
    int p = idx / half, c2 = idx - p * half;
    int r = p / IT, q = p - r * IT;
    int gy = iy0 + r, gx = ix0 + q;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = pro(reinterpret_cast<const __nv_bfloat162*>(
                  xb + ((size_t)gy * W + gx) * ci)[c2], c2);
    reinterpret_cast<__nv_bfloat162*>(tile + p * st)[c2] = v;
  }
  __syncthreads();

  const int groups = co / 8;
  for (int item = threadIdx.x; item < T * T * groups; item += kThreads) {
    int g = item / (T * T), p = item - g * (T * T);
    int py = p / T, px = p - py * T;
    int oy = oy0 + py, ox = ox0 + px;
    if (!kStats) {
      if (oy >= Ho || ox >= Wo) continue;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx)
          fma_pixel(tile + ((S * py + dy) * IT + S * px + dx) * st, ci,
                    w + (size_t)(dy * 3 + dx) * ci * co + g * 8, co, acc);
      epi(acc, g * 8);
      store8_bf16(out + (((size_t)b * Ho + oy) * Wo + ox) * co + g * 8, acc);
    } else {
      const bool valid = oy < Ho && ox < Wo;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      if (valid) {
        for (int dy = 0; dy < 3; ++dy)
          for (int dx = 0; dx < 3; ++dx)
            fma_pixel(tile + ((S * py + dy) * IT + S * px + dx) * st, ci,
                      w + (size_t)(dy * 3 + dx) * ci * co + g * 8, co, acc);
        epi(acc, g * 8);
        store8_bf16(out + (((size_t)b * Ho + oy) * Wo + ox) * co + g * 8, acc);
      }
      // a warp holds 32 pixels of one channel group (T*T = 64 items per
      // group); its half of the tile picks the shared slot
      float* s = sst + (p >= 32 ? 2 * co : 0) + g * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s1 = warp_sum(acc[j]), s2 = warp_sum(acc[j] * acc[j]);
        if ((threadIdx.x & 31) == 0) {
          s[j] += s1;
          s[co + j] += s2;
        }
      }
    }
  }
}

// One block per tile: grid (tiles along W, tiles along H, B).
template <int S, typename Prologue, typename Epilogue>
__global__ void __launch_bounds__(kThreads)
kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
       Prologue pro, Epilogue epi, __nv_bfloat16* __restrict__ out, int H,
       int W, int ci, int co, int Ho, int Wo) {
  extern __shared__ float4 smem4[];
  tile_conv<S, false>(x, w, pro, epi, out,
                      reinterpret_cast<__nv_bfloat16*>(smem4), nullptr,
                      blockIdx.z, blockIdx.y * T, blockIdx.x * T, H, W, ci,
                      co, Ho, Wo);
}

// With statistics: also one block per tile; block (x, y, b) writes its
// tile's partial (2, co) to stats row (b * gridDim.y + y) * gridDim.x + x.
template <int S, typename Prologue, typename Epilogue>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w, Prologue pro, Epilogue epi,
             __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int H,
             int W, int ci, int co, int Ho, int Wo) {
  extern __shared__ float4 smem4[];
  float* sst = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                        tile_bytes<S>(ci));
  for (int i = threadIdx.x; i < 4 * co; i += kThreads) sst[i] = 0.f;
  // (tile_conv's barrier after staging orders these stores before use)
  tile_conv<S, true>(x, w, pro, epi, out,
                     reinterpret_cast<__nv_bfloat16*>(smem4), sst, blockIdx.z,
                     blockIdx.y * T, blockIdx.x * T, H, W, ci, co, Ho, Wo);
  __syncthreads();
  const size_t row =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int i = threadIdx.x; i < 2 * co; i += kThreads)
    stats[row * 2 * co + i] = sst[i] + sst[2 * co + i];
}

// One block per tile, grid (tiles along W, tiles along H, B).  With stats
// (B * tiles rows of 2*co floats), each block writes its tile's partial.
template <int S, typename Prologue, typename Epilogue>
cudaError_t launch(const void* x, const void* w, Prologue pro, Epilogue epi,
                   void* out, float* stats, int B, int H, int W, int ci,
                   int co, cudaStream_t stream) {
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  if (B == 0 || H == 0 || W == 0) return cudaSuccess;
  const dim3 grid((Wo + T - 1) / T, (Ho + T - 1) / T, B);
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* wb = reinterpret_cast<const __nv_bfloat16*>(w);
  auto* ob = reinterpret_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (stats) {
    const size_t smem = tile_bytes<S>(ci) + 4 * (size_t)co * sizeof(float);
    err = allow_smem(stats_kernel<S, Prologue, Epilogue>, smem);
    if (err != cudaSuccess) return err;
    stats_kernel<S, Prologue, Epilogue><<<grid, kThreads, smem, stream>>>(
        xb, wb, pro, epi, ob, stats, H, W, ci, co, Ho, Wo);
  } else {
    const size_t smem = (size_t)patch(S) * patch(S) * smem_stride(ci) *
                        sizeof(__nv_bfloat16);
    err = allow_smem(kernel<S, Prologue, Epilogue>, smem);
    if (err != cudaSuccess) return err;
    kernel<S, Prologue, Epilogue><<<grid, kThreads, smem, stream>>>(
        xb, wb, pro, epi, ob, H, W, ci, co, Ho, Wo);
  }
  return cudaGetLastError();
}

}  // namespace down_conv
