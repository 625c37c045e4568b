"""Rotated NMS and the batched decode + rotated-NMS post-processing path.

Counterpart of ``yolov5_obb_tpu/ops/rotated_nms.py`` for the single-label
inference path.  The algorithm is the JAX package's sparse exact NMS:

1. an axis-aligned-cover upper bound on the rotated IoU prunes pairs that
   provably cannot suppress;
2. each box keeps its first ``max_neighbors`` admissible higher-scored
   neighbours (score order);
3. exact rotated IoU on those pairs only;
4. greedy resolution as a fixed-point sweep: any fixed point of
   ``alive[j] = valid[j] ∧ ¬∃ i→j : alive[i]`` in score order is the unique
   greedy-NMS result.

Steps 1-3 are the neighbour kernel (``ops/kernels/neighbor_kernel.py``).
Selection is an exact stable sort (ties keep the lower anchor index, as the
JAX ``compact_select`` + ``top_k`` pair does); the greedy sweep is an eager
loop with a convergence check, and the tier ladder is one host-side branch on
the batch's largest candidate count.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.neighbor_kernel import fused_neighbor_iou, fused_neighbor_iou_plain

PI = 3.141592653589793


def _resolve_greedy(sup_in, nbr_idx, valid):
    """Sparse suppression edges ``(B, n, M)`` → greedy keep mask ``(B, n)``.

    Each sweep: ``hit[j] = ∃m: sup_in[j, m] ∧ alive[nbr_idx[j, m]]``;
    iterate ``alive ← valid ∧ ¬hit`` until nothing changes (at most n
    sweeps).  Images that have converged stay at their fixed point, so one
    loop serves the batch."""
    B, n, M = nbr_idx.shape
    flat_idx = nbr_idx.reshape(B, n * M).long()
    alive, prev = valid, ~valid
    it = 0
    while it < n and bool((alive != prev).any()):
        prev = alive
        hit = (torch.gather(alive, 1, flat_idx).reshape(B, n, M) & sup_in).any(-1)
        alive = valid & ~hit
        it += 1
    return alive


def nms_rotated(rboxes, scores, iou_thr: float, class_ids=None,
                max_neighbors: int = 64, presorted: bool = False,
                plain: bool = False):
    """Greedy rotated NMS, sparse exact algorithm.

    Args:
        rboxes: ``(n, 5)`` or ``(B, n, 5)`` ``[cx cy l s theta]``.
        scores: ``(n,)`` or ``(B, n)``; padding / invalid boxes carry a
            score <= 0.
        iou_thr: suppression threshold.
        class_ids: optional int ids of the same leading shape; suppression
            only within a class.
        max_neighbors: the sparse graph's degree cap M (exact while no box
            has more than M threshold-capable higher-scored neighbours).
        presorted: scores are already descending along the last axis.
        plain: use the neighbour kernel's plain version on any device.

    Returns:
        keep ``(n,)`` / ``(B, n)`` bool, in input order.
    """
    single = scores.dim() == 1
    if single:
        rboxes, scores = rboxes[None], scores[None]
        class_ids = None if class_ids is None else class_ids[None]
    n = scores.shape[1]
    M = min(max_neighbors, n)
    if presorted:
        order = None
        b, s, c = rboxes, scores, class_ids
    else:
        order = torch.argsort(-scores, dim=1, stable=True)
        b = torch.gather(rboxes, 1, order[..., None].expand(-1, -1, 5))
        s = torch.gather(scores, 1, order)
        c = None if class_ids is None else torch.gather(class_ids, 1, order)
    valid = s > 0
    neighbors = fused_neighbor_iou_plain if plain else fused_neighbor_iou
    nbr_idx, sup_in = neighbors(b.float().contiguous(), c, valid, iou_thr, M)
    alive = _resolve_greedy(sup_in, nbr_idx, valid)
    if order is not None:
        alive = torch.empty_like(alive).scatter_(1, order, alive)
    return alive[0] if single else alive


def _compact_dets(rb, scores, cls_id, keep, max_det: int):
    """Kept rows, in input (score) order, front-compacted into
    ``(B, max_det, 7)`` ``[cx cy l s theta conf cls]`` with zero padding,
    plus the ``(B,)`` int32 count (JAX ``_compact_dets``)."""
    B, n = scores.shape
    det = torch.cat([rb, scores[..., None], cls_id.to(rb.dtype)[..., None]], -1)
    kept = keep & (scores > 0)
    m = min(max_det, n)
    order = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices[:, :m]
    rows = torch.gather(det, 1, order[..., None].expand(-1, -1, 7))
    rows = torch.where(torch.gather(kept, 1, order)[..., None], rows,
                       torch.zeros_like(rows))
    if max_det > n:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, max_det - n))
    num = kept.sum(1).clamp(max=m).to(torch.int32)
    return rows, num


def _tier(k: int, max_count: int) -> int:
    """Lattice size for the suppression: rows arrive score-sorted, so NMS
    over the first ``t`` rows is exact whenever every image has at most
    ``t`` positive candidates.  Ladder k → k/2 → k/4 (cost is ~quadratic
    in the size), as in the JAX ``_suppress_compact_batch``."""
    if k < 512:
        return k
    for t in (k // 4, k // 2):
        if t >= 256 and max_count <= t:
            return t
    return k


def _suppress_compact_batch(rb, scores, cls_id, iou_thres: float,
                            agnostic: bool, max_det: int, plain: bool = False):
    k = scores.shape[1]
    kk = _tier(k, int((scores > 0).sum(1).max()) if k else 0)
    rb, scores, cls_id = rb[:, :kk], scores[:, :kk], cls_id[:, :kk]
    keep = nms_rotated(rb, scores, iou_thres,
                       class_ids=None if agnostic else cls_id,
                       presorted=True, plain=plain)
    return _compact_dets(rb, scores, cls_id, keep, max_det)


def _apply_class_filter(cls_conf, classes, nc: int):
    """Zero the confidence of classes outside ``classes`` (reference
    ``--classes``), before candidate selection."""
    if classes is None:
        return cls_conf
    keep = torch.zeros(nc, dtype=cls_conf.dtype, device=cls_conf.device)
    keep[list(classes)] = 1.0
    return cls_conf * keep


def exact_select(gate, k: int):
    """Top-``k`` of a thresholded ``(B, N)`` score plane, exactly: a stable
    descending sort, so equal scores keep the lower anchor index (the JAX
    ``_batched_exact_select``).  Slots with score 0 carry index 0."""
    scores, idx = torch.sort(gate, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    return scores, torch.where(scores > 0, idx, torch.zeros_like(idx))


def decode_planes(maps, meta, classes=None):
    """Flat Detect maps → per-anchor f32 planes, concatenated over levels:
    x, y, w, h, obj, best class score, its id, theta-bin argmax.

    Each level ``(B, n, no)`` holds ``n = ny*nx*na`` anchors with the anchor
    index varying fastest; levels are square (ny == nx)."""
    nc, na = meta.nc, meta.na
    cols = {k: [] for k in ("x", "y", "w", "h", "obj", "best", "cid", "th")}
    for li, p in enumerate(maps):
        B, n, no = p.shape
        ny = nx = int(round((n // na) ** 0.5))
        if ny * nx * na != n:
            raise ValueError(f"flat Detect level {li}: n={n} is not a square "
                             f"grid of na={na} anchors")
        ii = np.arange(n)
        a, cell = ii % na, ii // na
        dev = p.device
        gx = torch.as_tensor((cell % nx).astype(np.float32), device=dev)
        gy = torch.as_tensor((cell // nx).astype(np.float32), device=dev)
        anchors = np.asarray(meta.anchors_px[li], np.float32)
        aw = torch.as_tensor(anchors[a, 0], device=dev)
        ah = torch.as_tensor(anchors[a, 1], device=dev)
        stride = float(meta.strides[li])

        f = lambda k: p[..., k].float()
        obj = torch.sigmoid(f(4))
        cols["x"].append((torch.sigmoid(f(0)) * 2 - 0.5 + gx) * stride)
        cols["y"].append((torch.sigmoid(f(1)) * 2 - 0.5 + gy) * stride)
        cols["w"].append((torch.sigmoid(f(2)) * 2) ** 2 * aw)
        cols["h"].append((torch.sigmoid(f(3)) * 2) ** 2 * ah)
        cols["obj"].append(obj)
        cls = torch.sigmoid(p[..., 5:5 + nc].float()) * obj[..., None]
        cls = _apply_class_filter(cls, classes, nc)
        best, cid = cls.max(-1)  # first maximum on ties
        cols["best"].append(best)
        cols["cid"].append(cid.to(torch.int32))
        cols["th"].append(torch.argmax(p[..., 5 + nc:], -1).to(torch.int32))
    return {k: torch.cat(v, 1) for k, v in cols.items()}


def non_max_suppression_from_maps(maps, meta, conf_thres: float = 0.25,
                                  iou_thres: float = 0.45,
                                  max_candidates: int = 4096,
                                  max_det: int = 1500, multi_label: bool = False,
                                  agnostic: bool = False, classes=None,
                                  plain: bool = False):
    """Decode + rotated NMS over flat Detect maps (single-label).

    Returns:
        dets ``(B, max_det, 7)`` ``[cx cy l s theta conf cls]`` (theta
        ``(bin - 90)°`` in radians), rows score-sorted, zero padding;
        num ``(B,)`` int32.
    """
    if multi_label:
        raise NotImplementedError(
            "multi-label selection (_batched_exact_pairs) is not ported yet")
    pl = decode_planes(maps, meta, classes)
    gate = torch.where((pl["best"] > conf_thres) & (pl["obj"] > conf_thres),
                       pl["best"], torch.zeros_like(pl["best"]))
    k = min(max_candidates, gate.shape[1])
    scores, box_idx = exact_select(gate, k)
    cls_id = torch.gather(pl["cid"], 1, box_idx)
    theta = (torch.gather(pl["th"], 1, box_idx).float() - 90.0) / 180.0 * PI
    rb = torch.stack([torch.gather(pl[c], 1, box_idx) for c in "xywh"]
                     + [theta], -1)
    return _suppress_compact_batch(rb, scores, cls_id, iou_thres, agnostic,
                                   max_det, plain=plain)
