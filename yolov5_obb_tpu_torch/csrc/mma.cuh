// What the port's tensor-core bodies share: the PTX of their copies, shared
// matrix loads and products (cp.async, ldmatrix, mma.sync m16n8k16 with bf16
// operands and float32 accumulation), and the epilogue that takes a CTA's
// float32 accumulators to bf16 outputs with 16-byte coalesced stores and to
// per-channel statistics summed in a fixed order.
//
// Users: conv3x3_mma.cuh (every 3x3 conv kernel, the stem+L1 kernel's
// layer 1), stem_mma.cuh (the stem of stem_l1.cu, stem.cu and
// stem_train.cu's forward), c3.cu, the weight gradients of stem_train.cu
// and down_train.cu, train_fused_1x1.cu's forward and backward.
#pragma once

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared; zeros (and no read) when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  cp_async16(smem_addr(dst), src, full);
}
// 4 bytes global → shared (4-byte aligned both); zeros (and no read) when
// !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// the same from a shared-memory address (smem_addr's), so an address
// computed once stays one 32-bit register
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// two 8x8 matrices, from the row addresses of lanes 0-15
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulation
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The epilogue of a CTA tile whose M axis is output pixels (16 per m16 tile)
// and whose N axis is one chunk of kChunkN output channels starting at n0.
// Warp (wm, wn) holds acc[i][j], the m16 x n8 tile of pixels
// 16*(kMTiles*wm + i) .. and chunk columns wn*8*kNTiles + 8*j .. (the
// mma.sync C fragment: rows lane/4 and lane/4 + 8, columns 2*(lane%4), +1).
// ---------------------------------------------------------------------------

// Epilogues: map the float32 sums (v.x, v.y) of output channels n, n + 1
// of one pixel before the one bf16 rounding.  `at(n)` fetches what a
// channel pair needs, once for all of a thread's pixels (n < co).
struct Raw {
  struct Pair {};
  __device__ __forceinline__ Pair at(int) const { return {}; }
  __device__ __forceinline__ float2 operator()(const Pair&, float2 v) const {
    return v;
  }
};

// + bias, then SiLU (common.cuh's: IEEE expf and division, as the plain
// versions' float32 sigmoid)
struct BiasSilu {
  const float* b;
  struct Pair {
    float b0, b1;
  };
  __device__ __forceinline__ Pair at(int n) const { return {b[n], b[n + 1]}; }
  __device__ __forceinline__ float2 operator()(const Pair& p, float2 v) const {
    return make_float2(silu(v.x + p.b0), silu(v.y + p.b1));
  }
};

// Each float32 pair through the epilogue functor, rounded once to bf16, into
// the staging tile ot (pixel p at ot + p*kOs, chunk column c at + c); with
// kStats, the per-channel Σ and Σ² of the raw accumulators over the warp's
// valid pixels (shuffles over lane bits 2-4) into the warp's row of red
// (kWarpsM rows of 2*kChunkN floats).  valid(p): pixel p of the tile is an
// output.  Call after a barrier that frees ot and red.
template <int kMTiles, int kNTiles, int kChunkN, int kOs, bool kStats,
          typename Epi, typename Valid>
__device__ __forceinline__ void stage_outputs(
    const float (&acc)[kMTiles][kNTiles][4], const Epi& epi,
    const Valid& valid, __nv_bfloat16* ot, float* red, int wm, int wn,
    int lane, int n0, int co) {
  const int nw = n0 + wn * (8 * kNTiles) + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int n = nw + 8 * j;
    const typename Epi::Pair ep =
        n < co ? epi.at(n) : typename Epi::Pair{};
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (kMTiles * wm + i) * 16 + (lane >> 2) + 8 * h;
        if (valid(p) && n < co) {
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          const float2 e = epi(ep, make_float2(v0, v1));
          *reinterpret_cast<__nv_bfloat162*>(ot + p * kOs + n - n0) =
              __floats2bfloat162_rn(e.x, e.y);
          if (kStats) {
            s0 += v0;
            s1 += v1;
            q0 += v0 * v0;
            q1 += v1 * v1;
          }
        }
      }
    if (kStats) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        q0 += __shfl_xor_sync(0xffffffffu, q0, o);
        q1 += __shfl_xor_sync(0xffffffffu, q1, o);
      }
      if (lane < 4) {
        const int c = wn * (8 * kNTiles) + 8 * j + 2 * lane;
        float* rw = red + wm * 2 * kChunkN;
        rw[c] = s0;
        rw[c + 1] = s1;
        rw[kChunkN + c] = q0;
        rw[kChunkN + c + 1] = q1;
      }
    }
  }
}

// The staged tile of kPixels pixels to device memory in 16-byte stores:
// dst(p) is pixel p's output row (channel 0), or nullptr where p is not an
// output.  Call after a barrier that publishes ot.
template <int kPixels, int kChunkN, int kOs, int kThreads, typename Dst>
__device__ __forceinline__ void store_outputs(const __nv_bfloat16* ot,
                                              const Dst& dst, int tid, int n0,
                                              int co) {
  for (int i = tid; i < kPixels * (kChunkN / 8); i += kThreads) {
    const int p = i / (kChunkN / 8), g = i - p * (kChunkN / 8);
    const int n = n0 + 8 * g;
    __nv_bfloat16* d = dst(p);
    if (d != nullptr && n < co)
      *reinterpret_cast<uint4*>(d + n) =
          *reinterpret_cast<const uint4*>(ot + p * kOs + 8 * g);
  }
}

// The tile's statistics: Σ then Σ² of the chunk's channels into row (2*co
// floats: Σ at [n], Σ² at [co + n]), the kWarpsM warp rows of red added in
// order; with kAdd, added to what row holds (each entry by the same thread
// on every call).  Call after a barrier that publishes red.
template <int kChunkN, int kWarpsM, int kThreads, bool kAdd = false>
__device__ __forceinline__ void write_stats_row(const float* red, float* row,
                                                int tid, int n0, int co) {
  for (int i = tid; i < 2 * kChunkN; i += kThreads) {
    const int which = i / kChunkN, c = i - which * kChunkN;
    if (n0 + c >= co) continue;
    float v = 0.f;
#pragma unroll
    for (int m = 0; m < kWarpsM; ++m) v += red[m * 2 * kChunkN + i];
    row[which * co + n0 + c] = kAdd ? row[which * co + n0 + c] + v : v;
  }
}
