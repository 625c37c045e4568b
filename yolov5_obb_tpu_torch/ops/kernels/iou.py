"""Exact rotated IoU of box pairs (the iou-ordered NMS's pair IoU), and the
per-box records both rotated-IoU kernels read.

Counterparts of ``yolov5_obb_tpu/ops/pallas/iou_kernel.pairs_rotated_iou``
(iou_kernel.py:199) and its wrapper ``sparse_rotated_iou`` (:233).  On CUDA
tensors both first launch ``csrc/riou_boxes.cu`` (:func:`box_records`: each
box's trig, edge half vectors, area and cover, once per box), then
``csrc/pairs_iou.cu`` (one thread per pair; the sparse form reads each
partner's record through its index); on CPU tensors they run their plain
versions, built on
:func:`~yolov5_obb_tpu_torch.ops.rotated_iou.pairs_iou_records` — the plain
version of the ``__device__`` function ``riou_pair``
(``csrc/rotated_iou.cuh``) that both this kernel and the neighbour kernel
call.
"""

from __future__ import annotations

import torch

from ..rotated_iou import box_records_plain, pairs_iou_math, pairs_iou_records
from ._build import I, Kernel, P, check_cuda

KERNEL = Kernel(
    "pairs_iou", "riou_pairs_launch", [P, P, P, P, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/iou_kernel.py:199")
# the per-box prologue of both rotated-IoU kernels: the neighbour kernel's
# cover and area (the JAX wrapper computes them before its pallas_call) and
# the pair IoU's per-box trig
BOXES_KERNEL = Kernel(
    "riou_boxes", "riou_boxes_launch", [P, P, P, I, P],
    replaces="yolov5_obb_tpu/ops/pallas/neighbor_kernel.py:199")

__all__ = ["box_records", "box_records_plain", "pairs_iou_math",
           "pairs_rotated_iou", "pairs_rotated_iou_plain",
           "sparse_rotated_iou", "sparse_rotated_iou_plain"]

# the kernels index in 32 bits
_INT32 = 2**31
# the pair kernel's slots of a row (csrc/pairs_iou.cu: one thread each)
MAX_SLOTS = 256


def check_int32(what: str, n: int) -> None:
    if n >= _INT32:
        raise ValueError(f"{what}: {n} elements; the rotated-IoU kernels "
                         f"index in 32 bits (< 2^31)")


def box_records(boxes, class_ids=None, valid=None):
    """Per-box records of the rotated IoU: ``boxes (..., 5)`` float32
    ``[cx cy l s theta]``, optional int ``class_ids`` and bool ``valid`` of
    the leading shape → ``(..., 16)`` float32 (``rotated_iou.RECORD_FIELDS``:
    the edge half vectors and area the pair IoU reads, the area, cover,
    class and valid bits the neighbour scan reads).  CPU tensors take the
    plain version; CUDA tensors take ``csrc/riou_boxes.cu``."""
    if boxes.device.type == "cpu":
        return box_records_plain(boxes, class_ids, valid)
    check_cuda("boxes", boxes, torch.float32, boxes.dim())
    if boxes.shape[-1] != 5:
        raise ValueError(f"boxes: expected (..., 5), got {tuple(boxes.shape)}")
    lead = boxes.shape[:-1]
    if class_ids is not None:
        class_ids = class_ids.to(torch.int32).contiguous()
    if valid is not None:
        valid = valid.contiguous()
    for name, t, dtype in (("class_ids", class_ids, torch.int32),
                           ("valid", valid, torch.bool)):
        if t is not None:
            check_cuda(name, t, dtype, len(lead))
            if t.shape != lead:
                raise ValueError(f"{name}: expected {tuple(lead)}, got "
                                 f"{tuple(t.shape)}")
    N = boxes.numel() // 5
    check_int32("box records", N * 16)
    rec = torch.empty(*lead, 16, device=boxes.device)
    BOXES_KERNEL.launch(boxes, class_ids, valid, N, rec)
    return rec


def pairs_rotated_iou_plain(boxes_a, boxes_b):
    """Plain version of :func:`pairs_rotated_iou` (any device)."""
    return pairs_iou_math(boxes_a.float(), boxes_b.float())


def pairs_rotated_iou(boxes_a, boxes_b):
    """Exact rotated IoU of paired boxes: ``(P, 5)`` float32 ``[cx cy l s
    theta]`` each → ``(P,)`` float32.  CPU tensors take the plain version;
    CUDA tensors take the kernels (the records of each side, then the
    pairs)."""
    if boxes_a.device.type == "cpu":
        return pairs_rotated_iou_plain(boxes_a, boxes_b)
    check_cuda("boxes_a", boxes_a, torch.float32, 2)
    check_cuda("boxes_b", boxes_b, torch.float32, 2)
    if boxes_a.shape != boxes_b.shape or boxes_a.shape[-1] != 5:
        raise ValueError(f"pairs: expected two (P, 5), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    rec_a, rec_b = box_records(boxes_a), box_records(boxes_b)
    out = torch.empty(boxes_a.shape[0], device=boxes_a.device)
    KERNEL.launch(rec_a, rec_b, None, out, 1, boxes_a.shape[0], 1)
    return out


def sparse_rotated_iou_plain(boxes, nbr_idx):
    """Plain version of :func:`sparse_rotated_iou` (any device): each box's
    record once, gathered for its neighbours."""
    B, K, M = nbr_idx.shape
    rec = box_records_plain(boxes)
    pair = torch.gather(rec, 1, nbr_idx.reshape(B, K * M, 1).long()
                        .expand(-1, -1, rec.shape[-1])).reshape(B, K, M, -1)
    return pairs_iou_records(rec[:, :, None, :].expand_as(pair), pair)


def sparse_rotated_iou(boxes, nbr_idx):
    """IoU of each box with its listed neighbours: ``boxes (B, K, 5)``
    float32 and ``nbr_idx (B, K, M)`` int32 indices into the same image's K
    boxes → ``(B, K, M)`` float32, entry ``(b, k, m)`` the IoU of boxes
    ``k`` and ``nbr_idx[b, k, m]`` of image ``b`` (every index must lie in
    ``[0, K)``).  CPU tensors take the plain version; CUDA tensors take the
    kernels (the records, then the pairs)."""
    if boxes.device.type == "cpu":
        return sparse_rotated_iou_plain(boxes, nbr_idx)
    check_cuda("boxes", boxes, torch.float32, 3)
    check_cuda("nbr_idx", nbr_idx, torch.int32, 3)
    B, K, five = boxes.shape
    if five != 5 or nbr_idx.shape[:2] != (B, K):
        raise ValueError(f"sparse pairs: boxes {tuple(boxes.shape)}, nbr_idx "
                         f"{tuple(nbr_idx.shape)}; expected (B, K, 5), "
                         f"(B, K, M)")
    check_int32("sparse pairs", nbr_idx.numel())
    if nbr_idx.shape[2] > MAX_SLOTS:
        raise ValueError(f"sparse pairs: {nbr_idx.shape[2]} neighbours a "
                         f"box; the kernel takes at most {MAX_SLOTS}")
    rec = box_records(boxes)
    out = torch.empty(nbr_idx.shape, device=boxes.device)
    KERNEL.launch(rec, None, nbr_idx, out, B, K, nbr_idx.shape[2])
    return out
