"""Rotated-NMS neighbour selection + exact pair IoU (kernel 1 of the path).

Counterpart of ``yolov5_obb_tpu/ops/pallas/neighbor_kernel.fused_neighbor_iou``
(neighbor_kernel.py:199).  On CUDA tensors :func:`fused_neighbor_iou`
launches ``csrc/riou_boxes.cu`` (the per-box records: cover, area, class and
valid bits for the scan, the half vectors for the IoU) and ``csrc/neighbor.cu``,
once each for the whole batch; on CPU tensors it runs
:func:`fused_neighbor_iou_plain`, the same function in plain PyTorch
(the dense edge matrix, a first-M compaction and the pair IoU's plain
version, :func:`~yolov5_obb_tpu_torch.ops.kernels.iou.sparse_rotated_iou_plain`).
The records' cover and area are :func:`_edge_inputs`' bit for bit on the
card (both round every operation; ``chip_smoke.py`` holds them equal).
"""

from __future__ import annotations

import torch

from ..geometry import hbb_cover
from ._build import F, I, Kernel, P, check_cuda
from .iou import box_records, check_int32, sparse_rotated_iou_plain

KERNEL = Kernel(
    "neighbor", "riou_neighbor_launch", [P, I, I, I, F, F, P, P, P],
    replaces="yolov5_obb_tpu/ops/pallas/neighbor_kernel.py:199")

# the edge test's slack on the threshold: float rounding must never mask a
# borderline true suppression edge (neighbor_kernel.py:252)
EDGE_SLACK = 0.98


def _edge_inputs(boxes: torch.Tensor) -> torch.Tensor:
    """``(B, n, 5)`` = cover x1 y1 x2 y2 and exact area ``l*s`` — the plain
    version's, equal on the card to the records' (``rotated_iou.
    record_cover_area``)."""
    return torch.cat([hbb_cover(boxes), (boxes[..., 2] * boxes[..., 3])[..., None]],
                     -1).contiguous()


def first_m_neighbors(edge: torch.Tensor, M: int):
    """First ``M`` true columns of each row of ``edge`` ``(..., n, n)`` in
    column order → ``(nbr_idx (..., n, M) int32, nbr_valid (..., n, M))``;
    empty slots hold index 0 (JAX ``_first_m_neighbors``)."""
    pos = torch.cumsum(edge.to(torch.int32), -1)
    count = pos[..., -1].clamp(max=M)
    sel = edge & (pos <= M)
    idx = torch.sort((~sel).to(torch.uint8), dim=-1, stable=True).indices[..., :M]
    nbr_valid = torch.arange(M, device=edge.device) < count[..., None]
    return torch.where(nbr_valid, idx, 0).to(torch.int32), nbr_valid


def edge_matrix(boxes, class_ids, valid, iou_thr: float):
    """``(B, n, n)`` admissible suppression edges ``[row, col]``: col
    strictly higher-scored, same class, both valid, cover intersection >
    slack·thr·max(area)."""
    n = boxes.shape[1]
    cov = _edge_inputs(boxes)
    x1, y1, x2, y2, area = (cov[..., k] for k in range(5))
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0)
    cap = (iou_thr * EDGE_SLACK) * torch.maximum(area[:, :, None],
                                                 area[:, None, :])
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    edge = (iw * ih > cap) & tri & valid[:, :, None] & valid[:, None, :]
    if class_ids is not None:
        edge &= class_ids[:, :, None] == class_ids[:, None, :]
    return edge


def fused_neighbor_iou_plain(boxes, class_ids, valid, iou_thr: float,
                             max_neighbors: int = 64):
    """Plain version of :func:`fused_neighbor_iou` (any device)."""
    boxes = boxes.float()
    edge = edge_matrix(boxes, class_ids, valid, iou_thr)
    nbr_idx, nbr_valid = first_m_neighbors(edge, max_neighbors)
    return nbr_idx, nbr_valid & (sparse_rotated_iou_plain(boxes, nbr_idx)
                                 > iou_thr)


def fused_neighbor_iou(boxes, class_ids, valid, iou_thr: float,
                       max_neighbors: int = 64):
    """Edge test + first-M compaction + exact pair IoU over a batch.

    Args:
        boxes: ``(B, n, 5)`` float32 ``[cx cy l s theta]``, each image's rows
            in descending-score order.
        class_ids: ``(B, n)`` int class per box, or ``None`` (agnostic).
        valid: ``(B, n)`` bool.
        iou_thr: NMS threshold; max_neighbors: M.

    Returns:
        nbr_idx ``(B, n, M)`` int32 — the first M admissible higher-scored
        neighbours of each row (0 in empty slots); sup_in ``(B, n, M)`` bool —
        exact rotated IoU > ``iou_thr`` on that edge.
    """
    if boxes.device.type == "cpu":
        return fused_neighbor_iou_plain(boxes, class_ids, valid, iou_thr,
                                        max_neighbors)
    check_cuda("boxes", boxes, torch.float32, 3)
    B, n, five = boxes.shape
    if five != 5:
        raise ValueError(f"boxes: expected (B, n, 5), got {tuple(boxes.shape)}")
    M = max_neighbors
    check_int32("neighbour slots", B * n * M + 1)
    rec = box_records(boxes, class_ids, valid)
    nbr_idx = torch.empty(B, n, M, dtype=torch.int32, device=boxes.device)
    sup_in = torch.empty(B, n, M, dtype=torch.bool, device=boxes.device)
    # the scan's list of filled slots for the pair stage: a count, then slots
    pairs = torch.empty(B * n * M + 1, dtype=torch.int32, device=boxes.device)
    KERNEL.launch(rec, B, n, M, float(iou_thr * EDGE_SLACK), float(iou_thr),
                  nbr_idx, sup_in, pairs)
    return nbr_idx, sup_in
