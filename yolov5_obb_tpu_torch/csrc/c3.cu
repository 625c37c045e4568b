// Fused C3 block (CSP bottleneck with 3 convs), inference, every BN folded
// to a per-channel scale/shift, SiLU after each conv.
//
// Replaces: yolov5_obb_tpu/ops/pallas/c3_kernel.py:219 fused_c3
//   (Pallas body _kernel :112, pallas_call :259).
//
// Computes, for x (B, H, W, c1) bf16 and c_ hidden channels:
//   cur = cv1(x)                                   1x1, c1 → c_
//   n times: h = mask(b.cv1(cur))                  1x1, c_ → c_
//            cur = cur + b.cv2(h)  (or b.cv2(h))    3x3 SAME, c_ → c_
//   out = cv3([cur, cv2(x)])                       1x1 on the concat, 2c_ → c2
// with every conv output rounded to bf16 (the TPU kernel's rounding points)
// and float32 accumulation.  mask zeroes h outside the image, which is the
// SAME zero padding of the 3x3.  Weights: 1x1 as (ci, co) bf16; 3x3 taps as
// (9*c_, c_) bf16, row (3*dy + dx)*c_ + ci; the n bottlenecks stacked along
// a leading axis; scale/shift as (2, co) float32.
//
// Bound on this card at yolov5m b16 1024² layer 2 (256² x 96, c_=48, n=2):
// ~135 GFLOP against ~403 MB moved (input read once, output written once):
// 0.14 ms at the bf16 tensor-core peak, operations bound.  This first
// version uses scalar float32 FMAs.
//
// Design: one block per 8x8 output tile of one image.  The input patch
// carries an n-pixel halo ((8+2n)² pixels), staged once in shared memory;
// cv1, each bottleneck and cv2 run from shared tiles (each bottleneck's 3x3
// shrinks the valid region by one pixel per side), so the block's
// intermediates never touch device memory.  Each thread owns 8 output
// channels of one pixel per step; weight reads are warp-uniform broadcasts.
#include "common.cuh"

namespace {

constexpr int T = 8;  // outputs per block side
constexpr int kThreads = 256;

struct C3Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16 *w1, *wa, *wt, *w2, *w3a, *w3b;
  const float *s1, *sa, *st, *s2, *s3;
  __nv_bfloat16* out;
  int H, W, c1, c_, c2, n, shortcut;
};

// 1x1 conv over the pixels of region [lo, hi)² of an R x R shared tile:
// dst = bf16(silu(src·w * scale + shift)), zeroed outside the image when
// `mask` is set.
__device__ void conv1x1_region(int H, int W, const __nv_bfloat16* src,
                               int sst, int cin, const __nv_bfloat16* w,
                               const float* ss, int cout, __nv_bfloat16* dst,
                               int dst_st, int R, int lo, int hi, bool mask,
                               int gy0, int gx0) {
  const int side = hi - lo, npix = side * side, groups = cout / 8;
  for (int item = threadIdx.x; item < npix * groups; item += kThreads) {
    int g = item / npix, p = item - g * npix;
    int r = lo + p / side, q = lo + p % side;
    int pix = r * R + q;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    bool inside = true;
    if (mask) {
      int gy = gy0 + r, gx = gx0 + q;
      inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    }
    if (inside) {
      fma_pixel(src + pix * sst, cin, w + g * 8, cout, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = silu(acc[j] * ss[g * 8 + j] + ss[cout + g * 8 + j]);
    }
    store8_bf16_a4(dst + pix * dst_st + g * 8, acc);
  }
}

__global__ void __launch_bounds__(kThreads) c3_kernel(C3Args a) {
  extern __shared__ float4 smem4[];
  const int n = a.n, c1 = a.c1, c_ = a.c_, c2 = a.c2;
  const int R = T + 2 * n;  // staged tile side (n-pixel halo)
  const int xst = smem_stride(c1), hst = smem_stride(c_);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* cur = xs + R * R * xst;
  __nv_bfloat16* h = cur + R * R * hst;

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * T, ox0 = blockIdx.x * T;
  const int gy0 = oy0 - n, gx0 = ox0 - n;  // image coords of tile (0, 0)
  const __nv_bfloat16* xb = a.x + (size_t)b * a.H * a.W * c1;

  const int half = c1 / 2;
  for (int idx = threadIdx.x; idx < R * R * half; idx += kThreads) {
    int p = idx / half, cc = idx - p * half;
    int r = p / R, q = p - r * R;
    int gy = gy0 + r, gx = gx0 + q;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
      v = reinterpret_cast<const __nv_bfloat162*>(
          xb + ((size_t)gy * a.W + gx) * c1)[cc];
    reinterpret_cast<__nv_bfloat162*>(xs + p * xst)[cc] = v;
  }
  __syncthreads();

  // cv1 on the whole staged tile
  conv1x1_region(a.H, a.W, xs, xst, c1, a.w1, a.s1, c_, cur, hst, R, 0, R, false,
                 gy0, gx0);
  __syncthreads();

  for (int k = 1; k <= n; ++k) {
    const __nv_bfloat16* wa = a.wa + (size_t)(k - 1) * c_ * c_;
    const __nv_bfloat16* wt = a.wt + (size_t)(k - 1) * 9 * c_ * c_;
    const float* sa = a.sa + (k - 1) * 2 * c_;
    const float* st = a.st + (k - 1) * 2 * c_;
    // h on region [k-1, R-k+1), zero outside the image (SAME padding)
    conv1x1_region(a.H, a.W, cur, hst, c_, wa, sa, c_, h, hst, R, k - 1, R - k + 1,
                   true, gy0, gx0);
    __syncthreads();
    // 3x3 on region [k, R-k); the residual reads cur at the same pixel, which
    // only this thread writes, so cur updates in place
    const int side = R - 2 * k, npix = side * side, groups = c_ / 8;
    for (int item = threadIdx.x; item < npix * groups; item += kThreads) {
      int g = item / npix, p = item - g * npix;
      int r = k + p / side, q = k + p % side;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx)
          fma_pixel(h + ((r + dy - 1) * R + q + dx - 1) * hst, c_,
                    wt + (size_t)(dy * 3 + dx) * c_ * c_ + g * 8, c_, acc);
      __nv_bfloat16* cp = cur + (r * R + q) * hst + g * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y = bf16_round(silu(acc[j] * st[g * 8 + j] + st[c_ + g * 8 + j]));
        if (a.shortcut) y += __bfloat162float(cp[j]);
        acc[j] = y;
      }
      store8_bf16_a4(cp, acc);
    }
    __syncthreads();
  }

  // cv2 on the output region, into h (free now)
  conv1x1_region(a.H, a.W, xs, xst, c1, a.w2, a.s2, c_, h, hst, R, n, n + T, false,
                 gy0, gx0);
  __syncthreads();

  // cv3 on the concat [cur, cv2(x)] of the output region
  const int groups = c2 / 8;
  for (int item = threadIdx.x; item < T * T * groups; item += kThreads) {
    int g = item / (T * T), p = item - g * (T * T);
    int py = p / T, px = p - py * T;
    int oy = oy0 + py, ox = ox0 + px;
    if (oy >= a.H || ox >= a.W) continue;
    int pix = (n + py) * R + n + px;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    fma_pixel(cur + pix * hst, c_, a.w3a + g * 8, c2, acc);
    fma_pixel(h + pix * hst, c_, a.w3b + g * 8, c2, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = silu(acc[j] * a.s3[g * 8 + j] + a.s3[c2 + g * 8 + j]);
    store8_bf16(a.out + (((size_t)b * a.H + oy) * a.W + ox) * c2 + g * 8, acc);
  }
}

}  // namespace

extern "C" int c3_launch(const void* x, const void* w1, const float* s1,
                         const void* wa, const float* sa, const void* wt,
                         const float* st, const void* w2, const float* s2,
                         const void* w3a, const void* w3b, const float* s3,
                         void* out, int B, int H, int W, int c1, int c_,
                         int c2, int n, int shortcut, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  typedef const __nv_bfloat16* P;
  C3Args a{reinterpret_cast<P>(x), reinterpret_cast<P>(w1),
           reinterpret_cast<P>(wa), reinterpret_cast<P>(wt),
           reinterpret_cast<P>(w2), reinterpret_cast<P>(w3a),
           reinterpret_cast<P>(w3b), s1, sa, st, s2, s3,
           reinterpret_cast<__nv_bfloat16*>(out), H, W, c1, c_, c2, n,
           shortcut};
  const int R = T + 2 * n;
  size_t smem = (size_t)R * R * (smem_stride(c1) + 2 * smem_stride(c_)) *
                sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(c3_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  c3_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
