// Per-box records of the rotated IoU, one thread per box.
//
// Part of the port of yolov5_obb_tpu/ops/pallas/neighbor_kernel.py:199
//   fused_neighbor_iou (whose wrapper computes the boxes' covers and areas
//   before the Pallas call, pallas_call :254) and of
//   yolov5_obb_tpu/ops/pallas/iou_kernel.py:199 pairs_rotated_iou /
//   sparse_rotated_iou (:233): the work of a box that does not depend on its
//   partner — cos and sin of theta, the edge half vectors, the area and the
//   axis-aligned cover — done once per box instead of once per pair.
//
// boxes (N, 5) [cx cy l s theta] float32, cls (N,) int32 or NULL (class 0),
// valid (N,) bool or NULL (all valid) → rec (N, 16) float32, the layout of
// rotated_iou.cuh (riou_record).  Built with -fmad=false like the kernels
// that read the records, so the cover equals ops/geometry.hbb_cover's on the
// card and the half vectors the plain version's operation for operation.
//
// Bound on this card: bytes (25 in, 64 out per box: 2.9 MB at 16 x 2048
// boxes, ~0.9 us at 3.35 TB/s); a box's 76 scalar operations (chip_smoke.py
// counts them) are far below it.  One thread writes its record as four
// 16-byte stores.
#include "common.cuh"
#include "rotated_iou.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
riou_boxes_kernel(const float* __restrict__ boxes, const int* __restrict__ cls,
                  const uint8_t* __restrict__ valid, int N,
                  float4* __restrict__ rec) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= N) return;
  const float* q = boxes + p * 5;
  float4 r[kRiouRecord];
  riou_record(q[0], q[1], q[2], q[3], q[4], cls ? cls[p] : 0,
              valid ? (valid[p] ? 1 : 0) : 1, r);
#pragma unroll
  for (int k = 0; k < kRiouRecord; ++k) rec[p * kRiouRecord + k] = r[k];
}

}  // namespace

// N * 16 < 2^31 (the wrapper checks it).
extern "C" int riou_boxes_launch(const float* boxes, const int* cls,
                                 const uint8_t* valid, int N, float* rec,
                                 void* stream) {
  if (N == 0) return 0;
  riou_boxes_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(boxes, cls, valid, N,
                                              reinterpret_cast<float4*>(rec));
  return (int)cudaGetLastError();
}
