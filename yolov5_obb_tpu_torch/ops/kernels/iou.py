"""Exact rotated IoU of box pairs (the iou-ordered NMS's pair IoU).

Counterparts of ``yolov5_obb_tpu/ops/pallas/iou_kernel.pairs_rotated_iou``
(iou_kernel.py:199) and its wrapper ``sparse_rotated_iou`` (:233).  On CUDA
tensors both launch ``csrc/pairs_iou.cu`` (one thread per pair; the sparse
form reads each partner box through its index); on CPU tensors they run
their plain versions, built on
:func:`~yolov5_obb_tpu_torch.ops.rotated_iou.pairs_iou_math` — the plain
version of the ``__device__`` function ``rotated_pair_iou``
(``csrc/rotated_iou.cuh``) that both this kernel and the neighbour kernel
call.
"""

from __future__ import annotations

import torch

from ..rotated_iou import pairs_iou_math
from ._build import I, Kernel, L, P, check_cuda

KERNEL = Kernel(
    "pairs_iou", "pairs_iou_launch", [P, P, P, P, L, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/iou_kernel.py:199")

__all__ = ["pairs_iou_math", "pairs_rotated_iou", "pairs_rotated_iou_plain",
           "sparse_rotated_iou", "sparse_rotated_iou_plain"]


def pairs_rotated_iou_plain(boxes_a, boxes_b):
    """Plain version of :func:`pairs_rotated_iou` (any device)."""
    return pairs_iou_math(boxes_a.float(), boxes_b.float())


def pairs_rotated_iou(boxes_a, boxes_b):
    """Exact rotated IoU of paired boxes: ``(P, 5)`` float32 ``[cx cy l s
    theta]`` each → ``(P,)`` float32.  CPU tensors take the plain version;
    CUDA tensors take the kernel."""
    if boxes_a.device.type == "cpu":
        return pairs_rotated_iou_plain(boxes_a, boxes_b)
    check_cuda("boxes_a", boxes_a, torch.float32, 2)
    check_cuda("boxes_b", boxes_b, torch.float32, 2)
    if boxes_a.shape != boxes_b.shape or boxes_a.shape[-1] != 5:
        raise ValueError(f"pairs: expected two (P, 5), got "
                         f"{tuple(boxes_a.shape)} and {tuple(boxes_b.shape)}")
    out = torch.empty(boxes_a.shape[0], device=boxes_a.device)
    KERNEL.launch(boxes_a, boxes_b, None, out, boxes_a.shape[0], 1, 1)
    return out


def sparse_rotated_iou_plain(boxes, nbr_idx):
    """Plain version of :func:`sparse_rotated_iou` (any device)."""
    B, K, M = nbr_idx.shape
    b = boxes.float()
    pair_b = torch.gather(b, 1, nbr_idx.reshape(B, K * M, 1).long()
                          .expand(-1, -1, 5)).reshape(B, K, M, 5)
    return pairs_iou_math(b[:, :, None, :].expand_as(pair_b), pair_b)


def sparse_rotated_iou(boxes, nbr_idx):
    """IoU of each box with its listed neighbours: ``boxes (B, K, 5)``
    float32 and ``nbr_idx (B, K, M)`` int32 indices into the same image's K
    boxes → ``(B, K, M)`` float32, entry ``(b, k, m)`` the IoU of boxes
    ``k`` and ``nbr_idx[b, k, m]`` of image ``b`` (every index must lie in
    ``[0, K)``).  CPU tensors take the plain version; CUDA tensors take the
    kernel."""
    if boxes.device.type == "cpu":
        return sparse_rotated_iou_plain(boxes, nbr_idx)
    check_cuda("boxes", boxes, torch.float32, 3)
    check_cuda("nbr_idx", nbr_idx, torch.int32, 3)
    B, K, five = boxes.shape
    if five != 5 or nbr_idx.shape[:2] != (B, K):
        raise ValueError(f"sparse pairs: boxes {tuple(boxes.shape)}, nbr_idx "
                         f"{tuple(nbr_idx.shape)}; expected (B, K, 5), "
                         f"(B, K, M)")
    out = torch.empty(nbr_idx.shape, device=boxes.device)
    KERNEL.launch(boxes, None, nbr_idx, out, nbr_idx.numel(), K,
                  nbr_idx.shape[2])
    return out
