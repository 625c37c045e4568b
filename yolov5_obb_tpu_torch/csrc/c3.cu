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
// with every conv output rounded to bf16 (the TPU kernel's rounding points),
// the residual added as bf16 + bf16 rounded once, and float32
// accumulation.  mask zeroes h outside the image, which is the SAME zero
// padding of the 3x3.  Weights: 1x1 as (ci, co) bf16; 3x3 taps as (9*c_,
// c_) bf16, row (3*dy + dx)*c_ + ci; the n bottlenecks stacked along a
// leading axis; scale/shift as (2, co) float32.  Takes 1 <= n <= 4, even
// c1, c_ and c2 multiples of 8, shortcut on or off, c1 != c2.
//
// Bound on this card at yolov5m b16 1024² layer 2 (256² x 96, c_=48, n=2):
// 64,512 MACs per output pixel, ~135 GFLOP, 0.137 ms at the bf16
// tensor-core peak, against ~403 MB moved (0.12 ms): operations bound it.
// The SiLUs come close: one per conv output, ~384 per output pixel (~507
// with the halo recomputed below); IEEE expf and division make them the
// larger cost, so they run as one tanh.approx each (act).
//
// Design.  One CTA (8 warps) per kTileY x kTileX output tile of one image;
// the frame is that tile with an n-pixel halo ((8+2n) x (16+2n) pixels at
// the default tile).  Every conv is a GEMM on mma.sync m16n8k16 (bf16 in,
// float32 accumulation): M = the pixels of the region the conv fills
// (cv1: the frame; bottleneck k's 1x1: the frame inset by k-1, its 3x3: by
// k; cv2, cv3: the output tile), N = chunks of kNC output channels, K =
// taps x input channels in steps of kKC, on the main loop of every
// tensor-core conv of the port (conv3x3_mma.cuh's conv_mainloop).  An m16
// tile is 16 consecutive pixels of the region in row order, so its rows
// may span region rows: A comes by ldmatrix.x4 from per-lane row addresses
// (a 3x3 tap shifts them by (dy-1, dx-1) in the frame), B by
// ldmatrix.x4.trans from the weight step staged in the loop's ring of
// kStages shared tiles by cp.async, two steps ahead of the products, one
// barrier per step.  Warp w takes m16 tiles w, w + 8, ... of the region,
// each with all kNC columns.
// x is read from device memory by cp.async (zero fill outside the image
// and past c1) in chunks of kKC channels, staged for the region the conv
// fills (cv2: the tile, cv1: the frame), so no shape of x has to fit in
// shared memory.  The bf16 intermediates live in shared tiles and never
// touch device memory: cur (the frame), h (the frame; its room stages x's
// chunks while cv1 and cv2 run, and cv3's outputs at the end) and cv2's
// output (the tile).  cv2 runs first, so x's chunks share h's room.  cv3
// sums its two K halves (cur by w3a, cv2(x) by w3b) into one accumulator;
// its epilogue goes through mma.cuh's stage_outputs and store_outputs to
// 16-byte coalesced stores.  No atomics: repeated runs agree bit for bit.
// A warp holds kMT m16 tiles of accumulators: 2 up to n = 2 (the frame's
// 15 tiles at yolov5m; 82.3 KB of shared memory, 2 CTAs/SM, so 128
// registers a thread), 3 beyond (1 CTA/SM).  To stay within the 128
// without spills, the shared tiles are addressed by 32-bit shared-window
// addresses, the epilogues compute each row's address once, and the
// thread and block indices are read anew where they are used.  A shape
// whose shared tiles do not fit a block (c_ of 224 and more) runs at half
// the tile width.
#include "conv3x3_mma.cuh"

namespace {

constexpr int kTileY = 8, kTileX = 16;  // output tile (rows, columns)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNC = 48;           // output channels per N chunk
constexpr int kNT = kNC / 8;      // n8 tiles of a warp: the whole chunk
constexpr int kKC = 48;           // K rows per ring step: three k16 steps
using conv3x3_mma::kStages;       // ring steps in flight
// bf16 per ring row, per staged x pixel, per staged output pixel: an odd
// number of 16-byte units (7), so ldmatrix rows are free of bank conflicts
constexpr int kWs = kNC + 8;
constexpr int kXs = kKC + 8;
constexpr int kOs = kNC + 8;
// the SiLU after every conv: x/2 * (1 + tanh.approx(x/2)), one
// special-function operation; faster than IEEE expf and division (the plain
// version's float32 sigmoid) or __expf and __fdividef, and within the
// kernel's tolerance of the plain version (PERF.md)
__device__ __forceinline__ float act(float v) {
  float y;
  // (volatile, as measured spill-free: the activations stay in order)
  asm volatile(
      "{\n .reg .f32 h, t;\n mul.f32 h, %1, 0f3F000000;\n"
      " tanh.approx.f32 t, h;\n fma.rn.f32 %0, h, t, h;\n}\n"
      : "=f"(y) : "f"(v));
  return y;
}

struct C3Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16 *w1, *wa, *wt, *w2, *w3a, *w3b;
  const float *s1, *sa, *st, *s2, *s3;
  __nv_bfloat16* out;
  int H, W, c1, c_, c2, n, shortcut, tiles_x;
};

// 4 and 16 bytes to and from shared memory at a shared-window address
// (the "memory" clobber keeps the epilogue's loads after the stores before
// them, so few of them are in flight in registers)
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t a, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
}
// threadIdx.x and blockIdx.x, .y read anew at each use: the compiler
// cannot keep an earlier read live in their place (at 2 CTAs/SM a thread
// has 128 registers, and these would be live through every GEMM)
__device__ __forceinline__ int tidx() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int ctaid(int d) {
  int v;
  if (d == 0)
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  else
    asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// A pixel-major shared tile seen from a region: region pixel (r, q) sits
// in slot (y0 + r) * pitch + x0 + q, ps bf16 per slot, from the
// shared-window byte address s (32 bits: a generic pointer takes two
// registers, and the kernel keeps four tiles).
struct View {
  uint32_t s;
  int ps, y0, x0, pitch;
  __device__ __forceinline__ uint32_t addr(int r, int q) const {
    return s + 2 * ((y0 + r) * pitch + x0 + q) * ps;
  }
};

// The region of a conv: rh x rw pixels (rows of width rw), npix of them.
struct Region {
  int rh, rw;
  __device__ __forceinline__ int npix() const { return rh * rw; }
  __device__ __forceinline__ int ntiles() const { return (rh * rw + 15) / 16; }
};

// acc (zeroed when `zero`, else added to) += the conv of src over the
// region's pixels with w (taps * cin rows, row tap*cin + c; cout columns)
// at output channels n0 .. n0 + kNC - 1, on conv3x3_mma.cuh's conv_mainloop.
// taps is 1 or 9 (a SAME 3x3 whose region is inset by one pixel in src's
// frame).  With `streamed`, src is the staging tile of one K chunk that
// stage(k) fills (cp.async copies it issues land with the chunk's first
// weight step); else src holds every input channel.  The ring is at shared
// address ring.  Begins with a barrier: the previous conv is done with the
// ring, the staging room and the tile it wrote.
template <int kMT, typename Stage>
__device__ __forceinline__ void gemm(float (&acc)[kMT][kNT][4], bool zero,
                                     const View& src, const Region& rg,
                                     int taps, bool streamed,
                                     const __nv_bfloat16* __restrict__ w,
                                     int cin, int cout, int n0, uint32_t ring,
                                     const Stage& stage) {
  const int lane = tidx() & 31, warp = tidx() >> 5;
  const int npix = rg.npix();
  // per lane: its A row in each of its m16 tiles w, w + 8, .. (a row past
  // the region reads pixel 0 and is never stored) at its k half
  uint32_t arow[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    int m = 16 * (warp + kWarps * i) + (lane & 15);
    m = m < npix ? m : 0;
    const int r = (unsigned)m / (unsigned)rg.rw;
    arow[i] = src.addr(r, m - r * rg.rw) + 2 * (lane >> 4) * 8;
  }
  // step (chunk k, tap)'s A: the tap's pixel shift, and the chunk's
  // channels where src holds them all
  auto aoff = [&](int tap, int k) -> uint32_t {
    const int dy = tap / 3, dx = tap - 3 * dy;
    const int toff = taps == 9 ? (dy - 1) * src.pitch + dx - 1 : 0;
    return 2 * (toff * src.ps + (streamed ? 0 : k * kKC));
  };
  __syncthreads();
  conv3x3_mma::conv_mainloop<kMT, kNT, kNC, kKC, kThreads>(
      acc, zero, arow, (rg.ntiles() - warp + kWarps - 1) / kWarps,
      // n8 tile pairs holding output channels below cout (padded to 16)
      min(kNT / 2, (cout - n0 + 15) / 16), 0, ring, w, taps, cin, cout, n0,
      kKC, streamed, aoff, stage, [](int) {});
}

// The chunk's outputs of the region's pixels into dst, channels n0 ..
// (below cpad, cout rounded up to 16; zero from cout on, so a later conv
// reads zeros in the padding): bf16(act(v * scale + shift)).  kMask zeroes
// pixels outside the image (gy, gx: the image coordinates of region pixel
// (0, 0)); with kResidual the bf16 value already in dst is added, rounded
// once.
template <int kMT, bool kMask, bool kResidual>
__device__ __forceinline__ void store_tile(const float (&acc)[kMT][kNT][4],
                                           const View& dst, const Region& rg,
                                           const float* __restrict__ ss,
                                           int cout, int cpad, int n0, int gy,
                                           int gx, int H, int W) {
  const int lane = tidx() & 31, warp = tidx() >> 5;
  const int npix = rg.npix();
  const int n1 = n0 + 2 * (lane & 3);  // the thread's first column
  // the thread's rows (i, h): the address of column n1 of its slot (4-byte
  // aligned), ~0 where the row is past the region, with bit 0 set where
  // kMask puts it outside the image (no flag registers: 8 would not fit the
  // 7 predicates; unsigned divisions: a signed one costs more registers)
  uint32_t row[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * (warp + kWarps * i) + (lane >> 2) + 8 * h;
      const int r = (unsigned)m / (unsigned)rg.rw, q = m - r * rg.rw;
      const bool out = kMask && (gy + r < 0 || gy + r >= H || gx + q < 0 ||
                                 gx + q >= W);
      row[i][h] = m < npix ? (dst.addr(r, q) + 2 * n1) | out : ~0u;
    }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n1 + 8 * j;
    if (n >= cpad) break;
    const bool live = n < cout;
    const float g0 = live ? ss[n] : 0.f, g1 = live ? ss[n + 1] : 0.f;
    const float b0 = live ? ss[cout + n] : 0.f;
    const float b1 = live ? ss[cout + n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[i][h] == ~0u) continue;
        float y0 = 0.f, y1 = 0.f;
        if (live && !(row[i][h] & 1u)) {
          y0 = act(acc[i][j][2 * h] * g0 + b0);
          y1 = act(acc[i][j][2 * h + 1] * g1 + b1);
        }
        const uint32_t d = (row[i][h] & ~1u) + 16 * j;
        __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
        if (kResidual) {
          const float2 o = __bfloat1622float2(bits_bf2(lds32(d)));
          const float2 y = __bfloat1622float2(v);
          v = __floats2bfloat162_rn(o.x + y.x, o.y + y.y);
        }
        sts32(d, bf2_bits(v));
      }
  }
}

// cv3's epilogue: scale/shift and the SiLU of every conv (stage_outputs'
// functor)
struct Act {
  const float* ss;
  int co;
  struct Pair {
    float s0, s1, t0, t1;
  };
  __device__ __forceinline__ Pair at(int n) const {
    return {ss[n], ss[n + 1], ss[co + n], ss[co + n + 1]};
  }
  __device__ __forceinline__ float2 operator()(const Pair& p, float2 v) const {
    return make_float2(act(v.x * p.s0 + p.t0), act(v.y * p.s1 + p.t1));
  }
};

// shared memory of a tile: cur (the frame), h (the frame; also x's chunks
// and cv3's staged outputs), cv2's output (the tile), the ring (bf16)
__host__ __device__ inline size_t smem_elems(int ty, int tx, int n, int c_) {
  const int ps = (c_ + 15) / 16 * 16 + 8;
  const size_t frame = (size_t)(ty + 2 * n) * (tx + 2 * n);
  return frame * ps + frame * (ps > kXs ? ps : kXs) + (size_t)ty * tx * ps +
         (size_t)kStages * kKC * kWs;
}

// kHalf: the tile at half its width (where the full tile's shared tiles do
// not fit a block)
template <int kMT, bool kVec, bool kHalf>
__global__ void __launch_bounds__(kThreads, kMT == 2 ? 2 : 1)
c3_kernel(C3Args a) {
  extern __shared__ float4 smem4[];
  constexpr int TY = kTileY, TX = kHalf ? kTileX / 2 : kTileX;
  const int n = a.n, c1 = a.c1, c_ = a.c_, c2 = a.c2;
  const int RY = TY + 2 * n, RX = TX + 2 * n;
  const int cpad = (c_ + 15) / 16 * 16, ps = cpad + 8;
  // shared-window byte addresses of cur, h's room, cv2's output, the ring
  const uint32_t cur = smem_addr(smem4);
  const uint32_t hx = cur + 2 * RY * RX * ps;
  const uint32_t c2b = hx + 2 * RY * RX * (ps > kXs ? ps : kXs);
  const uint32_t ring = c2b + 2 * TY * TX * ps;

  // the tile's origin in image ctaid(1), read anew where it is used
  auto oy0 = [&]() { return ctaid(0) / a.tiles_x * TY; };
  auto ox0 = [&]() { return ctaid(0) % a.tiles_x * TX; };

  // x's chunk k (channels k*kKC ..) for the rh x rw pixels from image
  // (gy, gx) into h's room, pixel p of the region at slot p: zero outside
  // the image and past c1.  cp.async where c1 % 8 == 0 (kVec), else
  // through registers.
  auto stage_x = [&](int k, int gy, int gx, int rh, int rw) {
    const int c0 = k * kKC;
    const int groups = min(kKC, (c1 + 15) / 16 * 16 - c0) / 8;
    const __nv_bfloat16* xb = a.x + (size_t)ctaid(1) * a.H * a.W * c1;
#pragma unroll 1
    for (int i = tidx(); i < rh * rw * groups; i += kThreads) {
      const int p = (unsigned)i / (unsigned)groups, g = i - p * groups;
      const int r = (unsigned)p / (unsigned)rw, q = p - r * rw;
      const int iy = gy + r, ix = gx + q, c = c0 + 8 * g;
      const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      const uint32_t d = hx + 2 * (p * kXs + 8 * g);
      const __nv_bfloat16* s = in ? xb + ((size_t)iy * a.W + ix) * c1 + c : a.x;
      if (kVec) {
        cp_async16(d, s, in && c < c1);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (in) {
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            if (c + e < c1) v[e / 2] = *reinterpret_cast<const uint32_t*>(s + e);
        }
        sts128(d, v);
      }
    }
  };
  auto resident = [](int) {};

  float acc[kMT][kNT][4];
  const Region tile{TY, TX}, frame{RY, RX};

  // cv2 on the tile, from x → c2b
  for (int n0 = 0; n0 < c_; n0 += kNC) {
    gemm(acc, true, View{hx, kXs, 0, 0, TX}, tile, 1, true, a.w2, c1, c_, n0,
         ring, [&](int k) { stage_x(k, oy0(), ox0(), TY, TX); });
    store_tile<kMT, false, false>(acc, View{c2b, ps, 0, 0, TX}, tile, a.s2,
                                  c_, cpad, n0, 0, 0, 0, 0);
  }
  // cv1 on the frame, from x → cur
  for (int n0 = 0; n0 < c_; n0 += kNC) {
    gemm(acc, true, View{hx, kXs, 0, 0, RX}, frame, 1, true, a.w1, c1, c_,
         n0, ring, [&](int k) { stage_x(k, oy0() - n, ox0() - n, RY, RX); });
    store_tile<kMT, false, false>(acc, View{cur, ps, 0, 0, RX}, frame, a.s1,
                                  c_, cpad, n0, 0, 0, 0, 0);
  }
  for (int k = 1; k <= n; ++k) {
    // h on the frame inset by k - 1, zero outside the image (SAME padding)
    const int e = k - 1;
    const Region r1{RY - 2 * e, RX - 2 * e};
    for (int n0 = 0; n0 < c_; n0 += kNC) {
      gemm(acc, true, View{cur, ps, e, e, RX}, r1, 1, false,
           a.wa + (size_t)e * c_ * c_, c_, c_, n0, ring, resident);
      store_tile<kMT, true, false>(acc, View{hx, ps, e, e, RX}, r1,
                                   a.sa + e * 2 * c_, c_, cpad, n0,
                                   oy0() - n + e, ox0() - n + e, a.H, a.W);
    }
    // the 3x3 on the frame inset by k → cur, the residual read at the same
    // pixel and channels the thread writes (the products read h only)
    const Region r3{RY - 2 * k, RX - 2 * k};
    for (int n0 = 0; n0 < c_; n0 += kNC) {
      gemm(acc, true, View{hx, ps, k, k, RX}, r3, 9, false,
           a.wt + (size_t)e * 9 * c_ * c_, c_, c_, n0, ring, resident);
      const View dst{cur, ps, k, k, RX};
      const float* st = a.st + e * 2 * c_;
      if (a.shortcut)
        store_tile<kMT, false, true>(acc, dst, r3, st, c_, cpad, n0, 0, 0, 0,
                                     0);
      else
        store_tile<kMT, false, false>(acc, dst, r3, st, c_, cpad, n0, 0, 0,
                                      0, 0);
    }
  }
  // cv3 on the tile: cur by w3a plus cv2(x) by w3b, staged in h's room
  // (free now), then 16-byte stores
  for (int n0 = 0; n0 < c2; n0 += kNC) {
    gemm(acc, true, View{cur, ps, n, n, RX}, tile, 1, false, a.w3a, c_, c2,
         n0, ring, resident);
    gemm(acc, false, View{c2b, ps, 0, 0, TX}, tile, 1, false, a.w3b, c_, c2,
         n0, ring, resident);
    const int ty0 = oy0(), tx0 = ox0(), by = ctaid(1);
    const int tid = tidx(), lane = tid & 31, warp = tid >> 5;
    auto valid = [&](int p) {
      const int r = (unsigned)p / (unsigned)TX;
      return p < TY * TX && ty0 + r < a.H && tx0 + p - r * TX < a.W;
    };
    auto dst = [&](int p) -> __nv_bfloat16* {
      const int r = (unsigned)p / (unsigned)TX;
      const int oy = ty0 + r, ox = tx0 + p - r * TX;
      return p < TY * TX && oy < a.H && ox < a.W
                 ? a.out + (((size_t)by * a.H + oy) * a.W + ox) * c2
                 : nullptr;
    };
    auto* ot = reinterpret_cast<__nv_bfloat16*>(smem4) + RY * RX * ps;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int t = warp + kWarps * i;
      if (t >= tile.ntiles()) break;
      float one[1][kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) one[0][j][e] = acc[i][j][e];
      stage_outputs<1, kNT, kNC, kOs, false>(one, Act{a.s3, c2}, valid, ot,
                                             nullptr, t, 0, lane, n0, c2);
    }
    __syncthreads();
    store_outputs<kTileY * kTileX, kNC, kOs, kThreads>(ot, dst, tid, n0, c2);
  }
}

template <int kMT, bool kVec, bool kHalf>
cudaError_t launch_t(C3Args a, size_t smem, int B, cudaStream_t st) {
  auto kern = c3_kernel<kMT, kVec, kHalf>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int tx = kHalf ? kTileX / 2 : kTileX;
  a.tiles_x = (a.W + tx - 1) / tx;
  kern<<<dim3(a.tiles_x * ((a.H + kTileY - 1) / kTileY), B), kThreads, smem,
         st>>>(a);
  return cudaGetLastError();
}

// m16 tiles per warp that cover the frame (2 or 3), and c1 % 8 == 0
template <bool kHalf>
cudaError_t launch_h(const C3Args& a, size_t smem, int mt, bool vec, int B,
                     cudaStream_t s) {
  if (mt <= 2)
    return vec ? launch_t<2, true, kHalf>(a, smem, B, s)
               : launch_t<2, false, kHalf>(a, smem, B, s);
  if (mt == 3)
    return vec ? launch_t<3, true, kHalf>(a, smem, B, s)
               : launch_t<3, false, kHalf>(a, smem, B, s);
  return cudaErrorInvalidValue;  // (the 8x16 tile's frame needs at most 3)
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
           shortcut, 0};
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the tile, at half its width where its shared tiles do not fit a block
  int tx = kTileX;
  size_t smem = smem_elems(kTileY, tx, n, c_) * 2;
  if (smem > (size_t)optin) {
    tx = kTileX / 2;
    smem = smem_elems(kTileY, tx, n, c_) * 2;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  }
  const int mt = ((kTileY + 2 * n) * (tx + 2 * n) + 16 * kWarps - 1) /
                 (16 * kWarps);
  // 16-byte copies of x: c1 % 8 == 0 and x 16-byte aligned
  const bool vec = c1 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto s = (cudaStream_t)stream;
  err = tx == kTileX ? launch_h<false>(a, smem, mt, vec, B, s)
                     : launch_h<true>(a, smem, mt, vec, B, s);
  return (int)err;
}
