// Train-mode BatchNorm with the batch's statistics, then SiLU, of an NHWC
// tensor (rows = pixels, channels contiguous): the math of
// models/layers._bn_act_chain in float32, in four passes over the
// activations and a small finalize launch after each reduction.
//
//   1. bn_act_reduce_stats_kernel: each CTA's partial Σz and Σz² per channel.
//   F. bn_act_reduce_finalize_fwd_kernel: the partials summed in CTA order;
//      the mean, the biased variance E[z²] - E[z]² clamped at 0, rsqrt(var +
//      eps), and the running statistics moved as 0.97·old + 0.03·batch.
//   2. bn_act_elementwise_fwd_kernel: u = (z - mean)·(rstd·w) + b and
//      y = u·σ(u), written in the activation dtype.
//   3. bn_act_reduce_bwd_kernel: with g = dy·σ(u)·(1 + u·(1 - σ(u))) and
//      x̂ = (z - mean)·rstd, each CTA's partial Σg and Σg·x̂.
//   F. bn_act_reduce_finalize_bwd_kernel: db = Σg, dw = Σg·x̂, and the
//      coefficients Σg/N, Σg·x̂/N of the input gradient.
//   4. bn_act_elementwise_bwd_kernel: dz = rstd·w·(g - Σg/N - x̂·Σg·x̂/N).
//
// The backward keeps only z and the per-channel statistics.  No float
// atomics: partials are summed in a fixed order, so a repeat is bit for
// bit.  Between a reduction and its finalize a data-parallel step can
// all-reduce the sums (the finalize's modes).  u, σ(u) and y·σ(u) round
// operation by operation as PyTorch's separate float32 kernels do.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // the row passes' CTA
constexpr int kMaxVec = 8;     // channels a thread loads at once (16 bytes)
constexpr int kLanes = 8;      // the finalize CTA: 32 channels x 8 part lanes
constexpr float kEps = 1e-3f;  // models/layers.BN_EPS

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive channels as floats: one 16-byte access when V·sizeof(T) is
// 16, else one element (V == 1).
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float* f) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
  } else {
    static_assert(V == 1, "16-byte vectors or single elements");
    f[0] = to_f(*p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float* f) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = from_f<T>(f[0]);
  }
}

// A row pass's CTA: `cols` threads across a row's vectors of V channels
// (all of them, or kThreads at a time), `rows` rows at once.
struct Tile {
  int vecs, cols, rows, col, lane;
  __device__ Tile(int C, int V) {
    vecs = C / V;
    cols = min(vecs, kThreads);
    rows = kThreads / cols;
    col = threadIdx.x % cols;
    lane = threadIdx.x / cols;
  }
};

// The per-channel values a pass reads, for V channels from c0.
template <int V>
__device__ __forceinline__ void channel(const float* __restrict__ src, int c0,
                                        float* dst) {
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = src[c0 + i];
}

struct Norm {  // statistics rows: mean, rstd, rstd·w, 1 where var >= 0
  enum { kMean = 0, kRstd = 1, kScale = 2, kLive = 3 };
};

// u = (z - mean)·k + b, rounded operation by operation
__device__ __forceinline__ float affine(float x, float mean, float k,
                                        float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), k), b);
}

__device__ __forceinline__ float sigmoid(float u) {
  return 1.0f / (1.0f + expf(-u));
}

// g = ∂L/∂u from dy = ∂L/∂y
template <bool ACT>
__device__ __forceinline__ float grad_u(float dy, float u) {
  if constexpr (ACT) {
    const float s = sigmoid(u);
    return dy * s * (1.0f + u * (1.0f - s));
  } else {
    return dy;
  }
}

// Writes this CTA's per-channel sums of a and b (the per-thread sums of the
// channel chunk from v0) as part[blockIdx.x][0][c] and part[blockIdx.x][1][c]:
// through shared memory, lane by lane in order.
template <int V>
__device__ __forceinline__ void write_partials(const Tile& t, int v0, int C,
                                               bool on, const float* a,
                                               const float* b, float* sh,
                                               float* __restrict__ part) {
  const int w = t.cols * V;
  if (on)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sh[t.lane * w + t.col * V + i] = a[i];
      sh[kThreads * kMaxVec + t.lane * w + t.col * V + i] = b[i];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += kThreads) {
    const int ch = v0 * V + c;
    if (ch >= C) continue;
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < t.rows; ++l) {
      sa += sh[l * w + c];
      sb += sh[kThreads * kMaxVec + l * w + c];
    }
    part[(size_t)blockIdx.x * 2 * C + ch] = sa;
    part[(size_t)blockIdx.x * 2 * C + C + ch] = sb;
  }
  __syncthreads();
}

// Pass 1: partial Σz and Σz² of the rows blockIdx.x·rows + lane + k·step.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_act_reduce_stats_kernel(const T* __restrict__ z, float* __restrict__ part,
                           long long R, int C) {
  __shared__ float sh[2 * kThreads * kMaxVec];
  constexpr int U = 4;  // rows loaded before they are added
  const Tile t(C, V);
  const long long step = (long long)gridDim.x * t.rows;
  for (int v0 = 0; v0 < t.vecs; v0 += t.cols) {
    const int v = v0 + t.col;
    const bool on = t.lane < t.rows && v < t.vecs;
    float s1[V], s2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
    if (on) {
      const T* base = z + (size_t)v * V;
      long long r = (long long)blockIdx.x * t.rows + t.lane;
      for (; r + (U - 1) * step < R; r += U * step) {
        float x[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u) load<T, V>(base + (r + u * step) * C, x[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s1[i] += x[u][i];
            s2[i] += x[u][i] * x[u][i];
          }
      }
      for (; r < R; r += step) {
        float x[V];
        load<T, V>(base + r * C, x);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += x[i];
          s2[i] += x[i] * x[i];
        }
      }
    }
    write_partials<V>(t, v0, C, on, s1, s2, sh, part);
  }
}

// Pass 2: y = silu((z - mean)·rstd·w + b) (or without SiLU).
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kThreads)
bn_act_elementwise_fwd_kernel(const T* __restrict__ z,
                              const float* __restrict__ stats,
                              const float* __restrict__ bias,
                              T* __restrict__ y, long long R, int C) {
  constexpr int U = 4;
  const Tile t(C, V);
  if (t.lane >= t.rows) return;
  const long long step = (long long)gridDim.x * t.rows;
  for (int v = t.col; v < t.vecs; v += t.cols) {
    float mean[V], k[V], b[V];
    channel<V>(stats + Norm::kMean * C, v * V, mean);
    channel<V>(stats + Norm::kScale * C, v * V, k);
    channel<V>(bias, v * V, b);
    const T* zb = z + (size_t)v * V;
    T* yb = y + (size_t)v * V;
    long long r = (long long)blockIdx.x * t.rows + t.lane;
    for (; r < R; r += U * step) {
      float x[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * step < R) load<T, V>(zb + (r + u * step) * C, x[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step >= R) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float a = affine(x[u][i], mean[i], k[i], b[i]);
          x[u][i] = ACT ? __fmul_rn(a, sigmoid(a)) : a;
        }
        store<T, V>(yb + (r + u * step) * C, x[u]);
      }
    }
  }
}

// Pass 3: partial Σg and Σg·x̂.
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kThreads, 3)
bn_act_reduce_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ z,
                          const float* __restrict__ stats,
                          const float* __restrict__ bias,
                          float* __restrict__ part, long long R, int C) {
  __shared__ float sh[2 * kThreads * kMaxVec];
  constexpr int U = 1;  // a row at a time: 3 CTAs an SM (faster than 2 at 2)
  const Tile t(C, V);
  const long long step = (long long)gridDim.x * t.rows;
  for (int v0 = 0; v0 < t.vecs; v0 += t.cols) {
    const int v = v0 + t.col;
    const bool on = t.lane < t.rows && v < t.vecs;
    float sg[V], sgx[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.f;
    if (on) {
      float mean[V], rstd[V], k[V], b[V];
      channel<V>(stats + Norm::kMean * C, v * V, mean);
      channel<V>(stats + Norm::kRstd * C, v * V, rstd);
      channel<V>(stats + Norm::kScale * C, v * V, k);
      channel<V>(bias, v * V, b);
      const size_t off = (size_t)v * V;
      for (long long r = (long long)blockIdx.x * t.rows + t.lane; r < R;
           r += U * step) {
        float x[U][V], d[U][V];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (r + u * step < R) {
            load<T, V>(z + off + (r + u * step) * C, x[u]);
            load<T, V>(dy + off + (r + u * step) * C, d[u]);
          }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (r + u * step >= R) break;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float c = __fsub_rn(x[u][i], mean[i]);
            const float g = grad_u<ACT>(d[u][i], affine(x[u][i], mean[i],
                                                        k[i], b[i]));
            sg[i] += g;
            sgx[i] += g * (c * rstd[i]);
          }
        }
      }
    }
    write_partials<V>(t, v0, C, on, sg, sgx, sh, part);
  }
}

// Pass 4: dz = rstd·w·(g - Σg/N - x̂·Σg·x̂/N).
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(kThreads, 3)
bn_act_elementwise_bwd_kernel(const T* __restrict__ dy,
                              const T* __restrict__ z,
                              const float* __restrict__ stats,
                              const float* __restrict__ bias,
                              const float* __restrict__ coef,
                              T* __restrict__ dz, long long R, int C) {
  constexpr int U = 1;  // a row at a time: 3 CTAs an SM (faster than 2 at 2)
  const Tile t(C, V);
  if (t.lane >= t.rows) return;
  const long long step = (long long)gridDim.x * t.rows;
  for (int v = t.col; v < t.vecs; v += t.cols) {
    float mean[V], rstd[V], k[V], b[V], c1[V], c2[V];
    channel<V>(stats + Norm::kMean * C, v * V, mean);
    channel<V>(stats + Norm::kRstd * C, v * V, rstd);
    channel<V>(stats + Norm::kScale * C, v * V, k);
    channel<V>(bias, v * V, b);
    channel<V>(coef, v * V, c1);
    channel<V>(coef + C, v * V, c2);
    const size_t off = (size_t)v * V;
    for (long long r = (long long)blockIdx.x * t.rows + t.lane; r < R;
         r += U * step) {
      float x[U][V], d[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * step < R) {
          load<T, V>(z + off + (r + u * step) * C, x[u]);
          load<T, V>(dy + off + (r + u * step) * C, d[u]);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step >= R) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float c = __fsub_rn(x[u][i], mean[i]);
          const float g = grad_u<ACT>(d[u][i], affine(x[u][i], mean[i], k[i],
                                                      b[i]));
          x[u][i] = k[i] * (g - c1[i] - (c * rstd[i]) * c2[i]);
        }
        store<T, V>(dz + off + (r + u * step) * C, x[u]);
      }
    }
  }
}

// The finalizes' first stage: channel c's two partial sums over the parts,
// lane l adding parts l, l + kLanes, ... in order, then the lanes in order.
// Returns false on the threads that hold no channel's result.
__device__ __forceinline__ bool sum_parts(const float* __restrict__ part,
                                          int parts, int C, int c, float* a,
                                          float* b) {
  __shared__ float sh[2][kLanes][33];
  const int lane = threadIdx.y, x = threadIdx.x;
  float sa = 0.f, sb = 0.f;
  if (c < C)
    for (int p = lane; p < parts; p += kLanes) {
      sa += part[(size_t)p * 2 * C + c];
      sb += part[(size_t)p * 2 * C + C + c];
    }
  sh[0][lane][x] = sa;
  sh[1][lane][x] = sb;
  __syncthreads();
  if (lane != 0 || c >= C) return false;
  sa = sb = 0.f;
  for (int l = 0; l < kLanes; ++l) {
    sa += sh[0][l][x];
    sb += sh[1][l][x];
  }
  *a = sa;
  *b = sb;
  return true;
}

// mode 0: partials → sums → statistics; 1: partials → sums (S, 2 x C);
// 2: S (summed over the ranks in between) → statistics.
__global__ void bn_act_reduce_finalize_fwd_kernel(
    const float* __restrict__ part, int parts, float* __restrict__ S,
    const float* __restrict__ w, float* __restrict__ rm,
    float* __restrict__ rv, float* __restrict__ stats, int C, float inv_n,
    int mode) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s1, s2;
  if (mode == 2) {
    if (threadIdx.y != 0 || c >= C) return;
    s1 = S[c];
    s2 = S[C + c];
  } else {
    if (!sum_parts(part, parts, C, c, &s1, &s2)) return;
    if (mode == 1) {
      S[c] = s1;
      S[C + c] = s2;
      return;
    }
  }
  const float mean = __fmul_rn(s1, inv_n);
  const float raw = __fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  const float rstd = rsqrtf(__fadd_rn(var, kEps));
  stats[Norm::kMean * C + c] = mean;
  stats[Norm::kRstd * C + c] = rstd;
  stats[Norm::kScale * C + c] = __fmul_rn(rstd, w[c]);
  stats[Norm::kLive * C + c] = raw >= 0.f ? 1.f : 0.f;
  rm[c] = __fadd_rn(__fmul_rn(0.97f, rm[c]), __fmul_rn(0.03f, mean));
  rv[c] = __fadd_rn(__fmul_rn(0.97f, rv[c]), __fmul_rn(0.03f, var));
}

// mode 0: partials → sums (S = [db; dw]) and the coefficients; 1: partials →
// S only; 2: S (summed over the ranks) → the coefficients.  The variance's
// clamp passes no gradient where it clamped (torch.clamp's backward).
__global__ void bn_act_reduce_finalize_bwd_kernel(
    const float* __restrict__ part, int parts, float* __restrict__ S,
    const float* __restrict__ stats, float* __restrict__ coef, int C,
    float inv_n, int mode) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sg, sgx;
  if (mode == 2) {
    if (threadIdx.y != 0 || c >= C) return;
    sg = S[c];
    sgx = S[C + c];
  } else {
    if (!sum_parts(part, parts, C, c, &sg, &sgx)) return;
    S[c] = sg;
    S[C + c] = sgx;
    if (mode == 1) return;
  }
  coef[c] = sg * inv_n;
  coef[C + c] = stats[Norm::kLive * C + c] != 0.f ? sgx * inv_n : 0.f;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The vector width: 16 bytes where every row starts 16-byte aligned.
template <typename T>
int vec_width(int C, std::initializer_list<const void*> ptrs) {
  constexpr int W = 16 / sizeof(T);
  if (C % W) return 1;
  for (const void* p : ptrs)
    if (!aligned16(p)) return 1;
  return W;
}

// CTAs of an elementwise pass: each thread `unroll` rows an iteration.
int elementwise_grid(long long R, int C, int V, int unroll) {
  const int vecs = C / V, cols = vecs < kThreads ? vecs : kThreads;
  const long long rows = (long long)(kThreads / cols) * unroll;
  const long long need = (R + rows - 1) / rows;
  return (int)(need < 4096 ? (need > 0 ? need : 1) : 4096);
}

template <typename T>
cudaError_t stats_t(const void* z, float* part, long long R, int C,
                    int parts, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  if (vec_width<T>(C, {z}) > 1)
    bn_act_reduce_stats_kernel<T, 16 / sizeof(T)>
        <<<parts, kThreads, 0, st>>>(zt, part, R, C);
  else
    bn_act_reduce_stats_kernel<T, 1><<<parts, kThreads, 0, st>>>(zt, part, R,
                                                                   C);
  return cudaGetLastError();
}

template <typename T, bool ACT>
cudaError_t fwd_t(const void* z, const float* stats, const float* b, void* y,
                  long long R, int C, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  T* yt = static_cast<T*>(y);
  if (vec_width<T>(C, {z, y}) > 1) {
    constexpr int V = 16 / sizeof(T);
    bn_act_elementwise_fwd_kernel<T, V, ACT>
        <<<elementwise_grid(R, C, V, 4), kThreads, 0, st>>>(zt, stats, b, yt,
                                                            R, C);
  } else {
    bn_act_elementwise_fwd_kernel<T, 1, ACT>
        <<<elementwise_grid(R, C, 1, 4), kThreads, 0, st>>>(zt, stats, b, yt,
                                                            R, C);
  }
  return cudaGetLastError();
}

template <typename T, bool ACT>
cudaError_t bwd_t(const void* dy, const void* z, const float* stats,
                   const float* b, float* part, long long R, int C, int parts,
                   cudaStream_t st) {
  const T *d = static_cast<const T*>(dy), *zt = static_cast<const T*>(z);
  if (vec_width<T>(C, {dy, z}) > 1)
    bn_act_reduce_bwd_kernel<T, 16 / sizeof(T), ACT>
        <<<parts, kThreads, 0, st>>>(d, zt, stats, b, part, R, C);
  else
    bn_act_reduce_bwd_kernel<T, 1, ACT>
        <<<parts, kThreads, 0, st>>>(d, zt, stats, b, part, R, C);
  return cudaGetLastError();
}

template <typename T, bool ACT>
cudaError_t dz_t(const void* dy, const void* z, const float* stats,
                 const float* b, const float* coef, void* dz, long long R,
                 int C, cudaStream_t st) {
  const T *d = static_cast<const T*>(dy), *zt = static_cast<const T*>(z);
  T* out = static_cast<T*>(dz);
  if (vec_width<T>(C, {dy, z, dz}) > 1) {
    constexpr int V = 16 / sizeof(T);
    bn_act_elementwise_bwd_kernel<T, V, ACT>
        <<<elementwise_grid(R, C, V, 2), kThreads, 0, st>>>(d, zt, stats, b,
                                                            coef, out, R, C);
  } else {
    bn_act_elementwise_bwd_kernel<T, 1, ACT>
        <<<elementwise_grid(R, C, 1, 2), kThreads, 0, st>>>(d, zt, stats, b,
                                                            coef, out, R, C);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bfloat16, 1 float32.  z, y, dy, dz: R x C, C contiguous;
// statistics (4 x C), coefficients and sums (2 x C), partials
// (parts x 2 x C): float32.  Each returns cudaGetLastError() of its launch,
// or cudaErrorInvalidValue for a bad argument.

extern "C" int bn_act_stats_launch(const void* z, float* part, long long R,
                                   int C, int parts, int dtype, void* stream) {
  if (C < 1 || parts < 1 || R < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? stats_t<__nv_bfloat16>(z, part, R, C, parts, st)
                          : stats_t<float>(z, part, R, C, parts, st));
}

extern "C" int bn_act_fwd_finalize_launch(const float* part, int parts,
                                          float* S, const float* w, float* rm,
                                          float* rv, float* stats, int C,
                                          float inv_n, int mode,
                                          void* stream) {
  if (C < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  bn_act_reduce_finalize_fwd_kernel<<<(C + 31) / 32, dim3(32, kLanes), 0,
                                      (cudaStream_t)stream>>>(
      part, parts, S, w, rm, rv, stats, C, inv_n, mode);
  return (int)cudaGetLastError();
}

extern "C" int bn_act_fwd_launch(const void* z, const float* stats,
                                 const float* b, void* y, long long R, int C,
                                 int act, int dtype, void* stream) {
  if (C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(act ? fwd_t<__nv_bfloat16, true>(z, stats, b, y, R, C, st)
                     : fwd_t<__nv_bfloat16, false>(z, stats, b, y, R, C, st));
  return (int)(act ? fwd_t<float, true>(z, stats, b, y, R, C, st)
                   : fwd_t<float, false>(z, stats, b, y, R, C, st));
}

extern "C" int bn_act_bwd_launch(const void* dy, const void* z,
                                  const float* stats, const float* b,
                                  float* part, long long R, int C, int parts,
                                  int act, int dtype, void* stream) {
  if (C < 1 || parts < 1 || R < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(act ? bwd_t<__nv_bfloat16, true>(dy, z, stats, b, part, R,
                                                   C, parts, st)
                     : bwd_t<__nv_bfloat16, false>(dy, z, stats, b, part, R,
                                                    C, parts, st));
  return (int)(act ? bwd_t<float, true>(dy, z, stats, b, part, R, C, parts,
                                         st)
                   : bwd_t<float, false>(dy, z, stats, b, part, R, C, parts,
                                          st));
}

extern "C" int bn_act_bwd_finalize_launch(const float* part, int parts,
                                          float* S, const float* stats,
                                          float* coef, int C, float inv_n,
                                          int mode, void* stream) {
  if (C < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  bn_act_reduce_finalize_bwd_kernel<<<(C + 31) / 32, dim3(32, kLanes), 0,
                                      (cudaStream_t)stream>>>(
      part, parts, S, stats, coef, C, inv_n, mode);
  return (int)cudaGetLastError();
}

extern "C" int bn_act_dz_launch(const void* dy, const void* z,
                                const float* stats, const float* b,
                                const float* coef, void* dz, long long R,
                                int C, int act, int dtype, void* stream) {
  if (C < 1 || R < 1) return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(act ? dz_t<__nv_bfloat16, true>(dy, z, stats, b, coef, dz, R,
                                                 C, st)
                     : dz_t<__nv_bfloat16, false>(dy, z, stats, b, coef, dz,
                                                  R, C, st));
  return (int)(act ? dz_t<float, true>(dy, z, stats, b, coef, dz, R, C, st)
                   : dz_t<float, false>(dy, z, stats, b, coef, dz, R, C, st));
}
