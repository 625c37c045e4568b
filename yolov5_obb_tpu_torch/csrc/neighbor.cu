// Rotated-NMS neighbour selection + exact pair IoU, after the per-box
// records (riou_boxes.cu): two kernels of one launch call per batch.
//
// Replaces: yolov5_obb_tpu/ops/pallas/neighbor_kernel.py:199
//   fused_neighbor_iou (Pallas body _kernel :48, pallas_call :254), which
//   builds on iou_kernel._pairs_iou_math (here rotated_iou.cuh).
//
// What it computes, per image and per score-sorted row i:
//   * the edge test against every column j < i (strictly higher-scored):
//     same class, both valid, and the intersection of the two axis-aligned
//     covers > 0.98*thr*max(area_i, area_j) — a provable upper bound on the
//     rotated IoU, so no true suppressor is dropped;
//   * the first M admissible columns in score order (slots past the row's
//     count stay nbr_idx = 0, sup_in = false, as _first_m_neighbors gives);
//   * the exact rotated IoU of (i, j) on those slots, sup_in = iou > thr.
//
// Bound on this card: the work depends on the data.  Bytes are the boxes,
// classes and valid flags in (25 bytes a box) and the (B, n, M) indices and
// flags out (~11 MB at B=16, n=2048, M=64 → ~3.4 us at 3.35 TB/s);
// operations are each box's record, the edge tests each valid row makes
// until its M-th edge and the exact IoU of the selected pairs, all scalar
// float32 (chip_smoke.py counts what the function needs).
//
// Design.  neighbor_scan_kernel: kRowsPerWarp rows per warp, kRows per
// block.  The block stages tiles of kTile columns (cover; area, class,
// valid: two 16-byte loads of each column's record) in shared memory — the
// role of the 64-box tiles of the CUDA NMS this system was modelled on —
// and each lane tests its column against all of its warp's rows (one
// shared read for kRowsPerWarp tests): a ballot a row, and a popcount
// prefix gives each edge its slot, in column order, until M slots are
// full.  The block stops staging once none of its rows is valid and short
// of M edges (__syncthreads_or), so a block of padding rows writes zeros
// and leaves; the heaviest blocks of all images start first.  It writes nbr_idx, zeroes
// sup_in and appends its filled slots to a pair list (one atomicAdd a
// block).  neighbor_iou_kernel then computes the exact IoU of every listed
// slot (rotated_iou.cuh's register-only riou_pair) on a grid of resident
// blocks, so the few pairs of a row never hold a block: with the IoU inside
// the scan kernel, its registers cut the scan's occupancy and a block
// waited on its last pair (PERF.md §6).
// The TPU kernel's one-hot gathers, matmul cumsums and 4-way column split
// have no counterpart: a warp ballot is the compaction.
#include "common.cuh"
#include "rotated_iou.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of a block
constexpr int kTile = 256;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = kTile / 32;
constexpr int kPairThreads = 128;

__global__ void __launch_bounds__(kThreads)
neighbor_scan_kernel(const float4* __restrict__ rec,  // (B, n, 16)
                     int n, int M, float thr_edge,
                     int* __restrict__ nbr_idx,        // (B, n, M)
                     uint8_t* __restrict__ sup_in,     // (B, n, M)
                     int* __restrict__ pairs) {        // count, then slots
  __shared__ float4 s_cov[kTile];  // x1 y1 x2 y2
  __shared__ float4 s_acv[kTile];  // area, class bits, valid bits, -
  __shared__ int s_cnt[kRows];
  __shared__ int s_base;
  extern __shared__ int s_slots[];  // kRows * M

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  // blocks are numbered heaviest first: the last rows of every image (they
  // scan the most columns) start before any image's first rows
  const int nb = (n + kRows - 1) / kRows, B = gridDim.x / nb;
  const int img = blockIdx.x % B;
  const int row0 = (nb - 1 - (int)blockIdx.x / B) * kRows;
  const int w0 = row0 + warp * kRowsPerWarp;  // this warp's first row
  const float4* R = rec + (size_t)img * n * kRiouRecord;

  float4 rcov[kRowsPerWarp];
  float rarea[kRowsPerWarp];
  int rcls[kRowsPerWarp], count[kRowsPerWarp];  // count: warp-uniform
  bool ok[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = w0 + r;
    float4 acv = make_float4(0.f, 0.f, 0.f, 0.f);
    rcov[r] = acv;
    if (i < n) {
      rcov[r] = R[i * kRiouRecord + kRecCover];
      acv = R[i * kRiouRecord + kRecScan];
    }
    ok[r] = i < n && __float_as_int(acv.z) != 0;
    rcls[r] = __float_as_int(acv.y);
    rarea[r] = acv.x;
    count[r] = 0;
  }

  const int col_end = min(n, row0 + kRows - 1);  // columns j < last row
  for (int t0 = 0; t0 < col_end; t0 += kTile) {
    bool more = false;  // a row of this warp still scans this tile
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      more |= ok[r] && count[r] < M && w0 + r > t0;
    // also the barrier before the tile is overwritten
    if (!__syncthreads_or(more)) break;
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const int j = t0 + k;
      if (j < n) {
        s_cov[k] = R[j * kRiouRecord + kRecCover];
        s_acv[k] = R[j * kRiouRecord + kRecScan];
      }
    }
    __syncthreads();
    if (!more) continue;
    // each lane tests its column of a 32-column chunk against the warp's
    // rows, without a branch; one ballot a row gives each edge its slot in
    // column order, and an empty ballot costs nothing more
    const int lim = min(kTile, w0 + kRowsPerWarp - 1 - t0);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 32 >= lim) break;
      const int k = c * 32 + lane, j = t0 + k;
      const float4 q = s_cov[k], acv = s_acv[k];
      const bool col_ok = __float_as_int(acv.z) != 0;
      const int cls = __float_as_int(acv.y);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float iw =
            fmaxf(fminf(rcov[r].z, q.z) - fmaxf(rcov[r].x, q.x), 0.f);
        const float ih =
            fmaxf(fminf(rcov[r].w, q.w) - fmaxf(rcov[r].y, q.y), 0.f);
        const bool edge = (j < w0 + r) & ok[r] & col_ok & (cls == rcls[r]) &
                          (iw * ih > thr_edge * fmaxf(rarea[r], acv.x));
        const unsigned m = __ballot_sync(0xffffffffu, edge);
        if (m) {  // warp-uniform
          if (edge) {
            const int pos = count[r] + __popc(m & lanes_below);
            if (pos < M) s_slots[(warp * kRowsPerWarp + r) * M + pos] = j;
          }
          count[r] += __popc(m);
        }
      }
    }
  }
  if (lane < kRowsPerWarp) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      if (lane == r) s_cnt[warp * kRowsPerWarp + r] = min(count[r], M);
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // room for this block's pairs in the pair list
    int total = 0;
    for (int r = 0; r < kRows; ++r) total += s_cnt[r];
    s_base = total ? atomicAdd(pairs, total) : 0;
  }
  __syncthreads();

  // the rows' slots, written together (rows row0 .. row0 + kRows - 1 are
  // contiguous in the outputs); sup_in is 0 until the pair kernel sets it
  const int rows = min(kRows, n - row0);
  const int out0 = (img * n + row0) * M;
  int* list = pairs + 1 + s_base;
  for (int e = threadIdx.x; e < rows * M; e += kThreads) {
    const int w = e / M, s = e - w * M;
    const bool filled = s < s_cnt[w];
    nbr_idx[out0 + e] = filled ? s_slots[e] : 0;
    sup_in[out0 + e] = 0;
    if (filled) {
      int before = 0;  // the block's filled slots in the rows above
      for (int r = 0; r < w; ++r) before += s_cnt[r];
      list[before + s] = out0 + e;
    }
  }
}

// sup_in of every listed slot (the scan's filled ones, in any order): its
// pair's exact IoU > thr.  A grid of resident blocks walks the list.
__global__ void __launch_bounds__(kPairThreads)
neighbor_iou_kernel(const float4* __restrict__ rec,
                    const int* __restrict__ nbr_idx,
                    const int* __restrict__ pairs, int n, int M,
                    float iou_thr, uint8_t* __restrict__ sup_in) {
  const int total = pairs[0];
  for (int q = blockIdx.x * kPairThreads + threadIdx.x; q < total;
       q += gridDim.x * kPairThreads) {
    const int p = pairs[1 + q];
    const int a = p / M;                     // the row, b*n + i
    const int b = a - a % n + nbr_idx[p];    // its neighbour, b*n + j
    sup_in[p] = riou_records(rec + a * kRiouRecord, rec + b * kRiouRecord) >
                iou_thr;
  }
}

}  // namespace

// pairs: B*n*M + 1 ints of scratch.  B*n*16 and B*n*M + 1 below 2^31 (the
// wrapper checks them).
extern "C" int riou_neighbor_launch(const float* rec, int B, int n, int M,
                                    float thr_edge, float iou_thr,
                                    int* nbr_idx, uint8_t* sup_in, int* pairs,
                                    void* stream) {
  if (B == 0 || n == 0 || M == 0) return 0;
  const float4* r = reinterpret_cast<const float4*>(rec);
  cudaStream_t st = (cudaStream_t)stream;
  static int pair_grid = 0;  // resident blocks of the pair kernel
  cudaError_t err;
  if (pair_grid == 0) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, neighbor_iou_kernel, kPairThreads, 0)) != cudaSuccess)
      return (int)err;
    pair_grid = sms * per_sm;
  }
  const size_t smem = (size_t)kRows * M * sizeof(int);
  if ((err = allow_smem(neighbor_scan_kernel, smem)) != cudaSuccess ||
      (err = cudaMemsetAsync(pairs, 0, sizeof(int), st)) != cudaSuccess)
    return (int)err;
  neighbor_scan_kernel<<<(n + kRows - 1) / kRows * B, kThreads, smem, st>>>(
      r, n, M, thr_edge, nbr_idx, sup_in, pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  neighbor_iou_kernel<<<pair_grid, kPairThreads, 0, st>>>(
      r, nbr_idx, pairs, n, M, iou_thr, sup_in);
  return (int)cudaGetLastError();
}
