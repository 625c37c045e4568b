// Exact rotated IoU of box pairs from per-box records, one thread per pair.
//
// Replaces: yolov5_obb_tpu/ops/pallas/iou_kernel.py:199 pairs_rotated_iou
//   (Pallas body _kernel :190, pallas_call :219) and its wrapper
//   sparse_rotated_iou (:233).
//
// Two forms, one entry point, both on the records of riou_boxes.cu
// (rotated_iou.cuh's layout: the trig and the half vectors of a box are
// computed once, not once per pair):
//   * sparse: rec (B, K, 16) and nbr_idx (B, K, M) int32 indices into the
//     same image's K boxes → iou (B, K, M), the IoU of box (b, k) with box
//     (b, nbr_idx[b, k, m]);
//   * pairs (nbr_idx == NULL): rec (P, 16) and rec_b (P, 16) → iou (P,),
//     run as B = 1, K = P, M = 1 with each row's partner in rec_b.
// The TPU wrapper's jnp.repeat and boxes[nbr_idx] gathers through device
// memory, its 2048-pair padding and its (5, P) transpose have no
// counterpart.  The math is rotated_iou.cuh's riou_pair, the neighbour
// kernel's, built like it with -fmad=false so that the values, and so the
// suppression decisions iou > thr, match the plain PyTorch version
// (ops/rotated_iou.pairs_iou_records) operation for operation.
//
// Bound on this card at B=16, K=4096, M=64 (4.19 M pairs): operations —
// chip_smoke.py counts the scalar work the function needs (a ring of m
// points ordered by the fewest comparators known for m keys; IEEE divisions
// as their SASS fast path) at one float32 operation per lane per cycle —
// against ~35 MB moved (boxes 1.3 MB in, indices in and IoU out 16.8 MB
// each).  Design: a block holds R = 256 / M rows of one image (grid y) with
// the M <= 256 slots of a row on threadIdx.x, so a thread finds its row,
// image and pair in 32-bit arithmetic with no division; a row's own record
// is read once into shared memory for its M slots, its partner's fields
// through the index.  The candidate ring stays in registers
// (rotated_iou.cuh).
#include "common.cuh"
#include "rotated_iou.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
riou_pairs_kernel(const float4* __restrict__ rec,
                  const float4* __restrict__ rec_b,
                  const int* __restrict__ nbr_idx, float* __restrict__ out,
                  int K, int M) {
  // blockDim.y rows x the pair IoU's fields: the first two float4, the area
  extern __shared__ float4 s_row[];
  const int slot = threadIdx.x, r = threadIdx.y;  // blockDim.x == M
  const int row = blockIdx.x * blockDim.y + r;
  const float4* img = rec + blockIdx.y * K * kRiouRecord;
  if (row < K)
    for (int q = threadIdx.x; q < 3; q += blockDim.x)
      s_row[r * 3 + q] = img[row * kRiouRecord + (q < 2 ? kRecPair + q
                                                         : kRecScan)];
  __syncthreads();
  if (row >= K) return;
  const int p = (blockIdx.y * K + row) * M + slot;
  const float4* b = nbr_idx ? img + __ldg(nbr_idx + p) * kRiouRecord
                            : rec_b + row * kRiouRecord;
  const float4* a = s_row + r * 3;
  out[p] = riou_pair(a[0], a[1], a[2].x, b[kRecPair], b[kRecPair + 1],
                     b[kRecScan].x);
}

}  // namespace

// sparse: rec (B, K, 16), rec_b unused, nbr_idx (B, K, M).  pairs: rec and
// rec_b (P, 16), nbr_idx NULL, B = 1, K = P, M = 1.  B*K*M and B*K*16 below
// 2^31 and M <= 256 (the wrapper checks them).
extern "C" int riou_pairs_launch(const float* rec, const float* rec_b,
                                 const int* nbr_idx, float* out, int B, int K,
                                 int M, void* stream) {
  if (B == 0 || K == 0 || M == 0) return 0;
  if (M > kThreads) return (int)cudaErrorInvalidValue;
  const int rows = kThreads / M;
  const dim3 block(M, rows);
  const dim3 grid((K + rows - 1) / rows, B);
  riou_pairs_kernel<<<grid, block, rows * 3 * sizeof(float4),
                      (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(rec_b), nbr_idx, out, K, M);
  return (int)cudaGetLastError();
}
