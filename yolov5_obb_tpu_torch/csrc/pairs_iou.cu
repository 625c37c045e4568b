// Exact rotated IoU of box pairs, one thread per pair.
//
// Replaces: yolov5_obb_tpu/ops/pallas/iou_kernel.py:199 pairs_rotated_iou
//   (Pallas body _kernel :190, pallas_call :219) and its wrapper
//   sparse_rotated_iou (:233).
//
// Two forms, one entry point:
//   * pairs  (nbr_idx == NULL): a (P, 5), b (P, 5) → iou (P,);
//   * sparse (nbr_idx != NULL): boxes (B, K, 5) and nbr_idx (B, K, M) int32
//     indices into the same image's K boxes → iou (B, K, M), the IoU of box
//     (b, k) with box (b, nbr_idx[b, k, m]).  The thread reads the partner
//     box through the index itself: the TPU wrapper's jnp.repeat and
//     boxes[nbr_idx] gathers through device memory, its 2048-pair padding and
//     its (5, P) transpose have no counterpart.
// The math is rotated_pair_iou (rotated_iou.cuh), the neighbour kernel's,
// built like it with -fmad=false so that the values, and so the suppression
// decisions iou > thr, match the plain PyTorch version
// (ops/rotated_iou.pairs_iou_math) operation for operation.
//
// Bound on this card at B=16, K=4096, M=64 (4.19 M pairs): ~750 scalar
// float32 operations per pair, 3.1 GFLOP, 0.047 ms at 67 TFLOP/s, against
// ~35 MB moved (boxes 1.3 MB, indices and IoU 16.8 MB each), 0.010 ms:
// operations bound it.  Each thread's candidate points, their order and the
// ring stay in registers; a warp's 32 pairs of one row read the same box a.
#include "common.cuh"
#include "rotated_iou.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pairs_iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ nbr_idx, float* __restrict__ out,
                 long long P, int K, int M) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float* pa;
  const float* pb;
  if (nbr_idx == nullptr) {
    pa = a + p * 5;
    pb = b + p * 5;
  } else {
    const long long row = p / M;              // b*K + k
    const long long img = row / K;            // b
    pa = a + row * 5;
    pb = a + (img * K + __ldg(nbr_idx + p)) * 5;
  }
  out[p] = rotated_pair_iou(pa[0], pa[1], pa[2], pa[3], pa[4], pb[0], pb[1],
                            pb[2], pb[3], pb[4]);
}

}  // namespace

// pairs: a, b (P, 5), nbr_idx NULL, K = M = 1.  sparse: a the (B, K, 5)
// boxes, b unused, nbr_idx (B, K, M), P = B*K*M.
extern "C" int pairs_iou_launch(const float* a, const float* b,
                                const int* nbr_idx, float* out, long long P,
                                int K, int M, void* stream) {
  if (P == 0) return 0;
  const long long blocks = (P + kThreads - 1) / kThreads;
  pairs_iou_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, nbr_idx, out, P, K, M);
  return (int)cudaGetLastError();
}
