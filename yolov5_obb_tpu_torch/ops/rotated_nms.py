"""Rotated NMS and the batched decode + rotated-NMS post-processing path.

Counterpart of ``yolov5_obb_tpu/ops/rotated_nms.py``.  The algorithm is
the JAX package's sparse exact NMS:

1. an axis-aligned-cover upper bound on the rotated IoU prunes pairs that
   provably cannot suppress;
2. each box keeps ``max_neighbors`` admissible higher-scored neighbours:
   the first in score order (``neighbor_order="score"``), or the highest
   upper bounds (``"iou"``);
3. exact rotated IoU on those pairs only;
4. greedy resolution as a fixed-point sweep: any fixed point of
   ``alive[j] = valid[j] ∧ ¬∃ i→j : alive[i]`` in score order is the unique
   greedy-NMS result.

In score order steps 1-3 are the neighbour kernel
(``ops/kernels/neighbor_kernel.py``); in iou order steps 1-2 are plain torch
on the ``(n, n)`` bound, as the JAX package leaves them to XLA, and step 3
is the pair-IoU kernel (``ops/kernels/iou.py``).  Candidate selection, of
the best class per box (single-label) or of every (box, class) pair
(multi-label), is an exact stable sort: ties keep the lower anchor (then
class) index, as the JAX ``compact_select`` + ``top_k`` pair does.  The
greedy sweep is an eager loop with a convergence check, and the tier ladder
is one host-side branch on the batch's largest candidate count.

Post-processing runs under the spans ``postproc.decode`` (decode, candidate
selection, gathers) and ``postproc.nms`` (tier, suppression, compaction) of
``utils/profiler.py``, and counts ``postproc.calls`` and
``postproc.host_syncs``: every point where the host waits for the device
(each grid or anchor copy to the device, the class filter's two copies,
the tier's read, each sweep's convergence read), counted on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiler import count, span
from .geometry import hbb_cover
from .kernels.iou import sparse_rotated_iou, sparse_rotated_iou_plain
from .kernels.neighbor_kernel import (
    EDGE_SLACK,
    fused_neighbor_iou,
    fused_neighbor_iou_plain,
)

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
    while it < n and _host_read(bool((alive != prev).any())):
        prev = alive
        hit = (torch.gather(alive, 1, flat_idx).reshape(B, n, M) & sup_in).any(-1)
        alive = valid & ~hit
        it += 1
    return alive


def _host_read(value):
    """``value``, a read the host waited on the device for, counted."""
    count("postproc.host_syncs")
    return value


def _to_device(array, dev):
    """A blocking host-to-device copy of ``array``, counted."""
    count("postproc.host_syncs")
    return torch.as_tensor(array, device=dev)


def riou_upper_bound(boxes):
    """``(B, n, n)`` provable upper bound on the pairwise rotated IoU:
    ``inter(cover_i, cover_j) / max(area_i, area_j)`` (JAX
    ``_riou_upper_bound``, rotated_nms.py:57)."""
    hbb = hbb_cover(boxes)
    a1 = torch.maximum(hbb[:, :, None, :2], hbb[:, None, :, :2])
    a2 = torch.minimum(hbb[:, :, None, 2:], hbb[:, None, :, 2:])
    inter = (a2 - a1).clamp(min=0).prod(-1)
    area = boxes[..., 2] * boxes[..., 3]
    return inter / torch.maximum(area[:, :, None], area[:, None, :]).clamp(
        min=1e-9)


def iou_order_neighbors(boxes, class_ids, valid, iou_thr: float, M: int):
    """The ``M`` admissible higher-scored neighbours of each row with the
    highest upper bounds → ``(nbr_idx (B, n, M) int32, nbr_valid)``.

    The bound is masked to the admissible edges (strictly higher-scored,
    both valid, same class, bound > 0.98·thr), cast to bf16 as the JAX
    package does (rotated_nms.py:202), and ranked by a stable descending
    sort, so equal values keep the lower column index as ``lax.top_k``
    does (``torch.topk`` promises no order among ties)."""
    n = boxes.shape[1]
    ub = riou_upper_bound(boxes)
    tri = torch.ones(n, n, dtype=torch.bool, device=boxes.device).tril(-1)
    edge = ((ub > iou_thr * EDGE_SLACK) & tri & valid[:, :, None]
            & valid[:, None, :])
    if class_ids is not None:
        edge &= class_ids[:, :, None] == class_ids[:, None, :]
    cand = torch.where(edge, ub, -1.0).to(torch.bfloat16)
    del ub, edge
    top, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
    top, idx = top[..., :M], idx[..., :M]
    return idx.to(torch.int32).contiguous(), top > 0


def nms_rotated(rboxes, scores, iou_thr: float, class_ids=None,
                max_neighbors: int = 64, presorted: bool = False,
                neighbor_order: str = "score", plain: bool = False):
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
        neighbor_order: which ``max_neighbors`` to keep when a box has
            more admissible ones: ``"score"`` the highest-scored (the
            neighbour kernel), ``"iou"`` the highest upper bounds (the
            pair-IoU kernel).  Identical results while no row overflows.
        plain: use the kernels' plain versions on any device.

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
    b = b.float().contiguous()
    if neighbor_order == "score":
        neighbors = fused_neighbor_iou_plain if plain else fused_neighbor_iou
        nbr_idx, sup_in = neighbors(b, c, valid, iou_thr, M)
    elif neighbor_order == "iou":
        nbr_idx, nbr_valid = iou_order_neighbors(b, c, valid, iou_thr, M)
        pair_iou = sparse_rotated_iou_plain if plain else sparse_rotated_iou
        sup_in = nbr_valid & (pair_iou(b, nbr_idx) > iou_thr)
    else:
        raise ValueError(f"neighbor_order must be 'score' or 'iou', got "
                         f"{neighbor_order!r}")
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
    with span("postproc.nms"):
        k = scores.shape[1]
        kk = _tier(k, _host_read(int((scores > 0).sum(1).max())) if k else 0)
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
    keep[_to_device(list(classes), cls_conf.device)] = 1.0
    count("postproc.host_syncs")  # the assignment's value, copied blocking
    return cls_conf * keep


def exact_select(gate, k: int):
    """Top-``k`` of a thresholded ``(B, N)`` score plane, exactly: a stable
    descending sort, so equal scores keep the lower anchor index (the JAX
    ``_batched_exact_select``).  Slots with score 0 carry index 0."""
    scores, idx = torch.sort(gate, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    return scores, torch.where(scores > 0, idx, torch.zeros_like(idx))


def exact_select_pairs(cls_conf, conf_thres: float, k: int):
    """Multi-label selection: the exact top-``k`` of the (box, class) pairs
    of ``cls_conf (B, N, nc)`` with ``conf > conf_thres`` (the obj gate is
    implied: ``conf = cls·obj ≤ obj``), as one stable descending sort over
    the flattened ``(B, N·nc)`` plane, so ties fall in (anchor, class) order
    (the JAX ``_batched_exact_pairs``, rotated_nms.py:399).  Returns
    ``(scores, box_idx, cls_id)``, each ``(B, min(k, N·nc))``; slots with
    score 0 carry box 0, class 0."""
    B, N, nc = cls_conf.shape
    flat = torch.where(cls_conf > conf_thres, cls_conf,
                       torch.zeros_like(cls_conf)).reshape(B, N * nc)
    scores, idx = exact_select(flat, min(k, N * nc))
    return scores, idx // nc, (idx % nc).to(torch.int32)


def obb_candidates(prediction, num_classes: int, conf_thres: float = 0.25,
                   max_candidates: int = 4096, multi_label: bool = False,
                   classes=None):
    """The candidate selection of :func:`non_max_suppression_obb`: ``(rb
    (B, k, 5) [cx cy l s θ], scores (B, k), cls_id (B, k))``, score-sorted,
    empty slots at score 0."""
    nc = num_classes
    pred = prediction.float()
    boxes, obj = pred[..., :4], pred[..., 4]
    cls_conf = pred[..., 5:5 + nc] * obj[..., None]
    cls_conf = _apply_class_filter(cls_conf, classes, nc)
    B, N = obj.shape
    k = min(max_candidates, N * nc if multi_label else N)
    if multi_label:
        scores, box_idx, cls_id = exact_select_pairs(cls_conf, conf_thres, k)
    else:
        best, cid = cls_conf.max(-1)  # first maximum on ties
        gate = torch.where((best > conf_thres) & (obj > conf_thres), best,
                           torch.zeros_like(best))
        scores, box_idx = exact_select(gate, k)
        cls_id = torch.gather(cid, 1, box_idx).to(torch.int32)
    rows = lambda t: torch.gather(
        t, 1, box_idx[..., None].expand(-1, -1, t.shape[-1]))
    theta_idx = torch.argmax(rows(pred[..., 5 + nc:]), -1)
    theta = (theta_idx.float() - 90.0) / 180.0 * PI
    return torch.cat([rows(boxes), theta[..., None]], -1), scores, cls_id


def non_max_suppression_obb(prediction, num_classes: int,
                            conf_thres: float = 0.25, iou_thres: float = 0.45,
                            max_candidates: int = 4096, max_det: int = 1500,
                            multi_label: bool = False, agnostic: bool = False,
                            classes=None, plain: bool = False):
    """Candidate selection + rotated NMS of decoded predictions (JAX
    ``non_max_suppression_obb``, rotated_nms.py:513): ``prediction`` is
    ``(B, N, 5+nc+180)`` ``[cx cy l s obj cls... theta_bins...]``, the
    sigmoid outputs of :func:`~..models.yolo.decode` in image pixels.

    ``conf = cls·obj``; the best class of each box (single-label) or every
    (box, class) pair (``multi_label``) above ``conf_thres`` competes for
    ``k = min(max_candidates, N·nc or N)`` slots; θ is ``(argmax_bin -
    90)°`` over the sigmoid bins (saturated bins tie in float32 and the
    first wins, as in the JAX package).  Same output as
    :func:`non_max_suppression_from_maps`."""
    count("postproc.calls")
    with span("postproc.decode"):
        rb, scores, cls_id = obb_candidates(prediction, num_classes,
                                            conf_thres, max_candidates,
                                            multi_label, classes)
    return _suppress_compact_batch(rb, scores, cls_id, iou_thres, agnostic,
                                   max_det, plain=plain)


def decode_planes(maps, meta, classes=None, multi_label: bool = False):
    """Flat Detect maps → per-anchor f32 planes, concatenated over levels:
    x, y, w, h, obj, theta-bin argmax ``th``, and either the best class
    score ``best`` and its id ``cid`` (single-label) or every class's
    ``conf = cls·obj`` as ``(B, N, nc)`` (``multi_label``).

    Each level ``(B, n, no)`` holds ``n = ny*nx*na`` anchors with the anchor
    index varying fastest; levels are square (ny == nx)."""
    nc, na = meta.nc, meta.na
    cols: dict = {}
    add = lambda key, v: cols.setdefault(key, []).append(v)
    for li, p in enumerate(maps):
        B, n, no = p.shape
        ny = nx = int(round((n // na) ** 0.5))
        if ny * nx * na != n:
            raise ValueError(f"flat Detect level {li}: n={n} is not a square "
                             f"grid of na={na} anchors")
        ii = np.arange(n)
        a, cell = ii % na, ii // na
        dev = p.device
        gx = _to_device((cell % nx).astype(np.float32), dev)
        gy = _to_device((cell // nx).astype(np.float32), dev)
        anchors = np.asarray(meta.anchors_px[li], np.float32)
        aw = _to_device(anchors[a, 0], dev)
        ah = _to_device(anchors[a, 1], dev)
        stride = float(meta.strides[li])

        f = lambda k: p[..., k].float()
        obj = torch.sigmoid(f(4))
        add("x", (torch.sigmoid(f(0)) * 2 - 0.5 + gx) * stride)
        add("y", (torch.sigmoid(f(1)) * 2 - 0.5 + gy) * stride)
        add("w", (torch.sigmoid(f(2)) * 2) ** 2 * aw)
        add("h", (torch.sigmoid(f(3)) * 2) ** 2 * ah)
        add("obj", obj)
        cls = torch.sigmoid(p[..., 5:5 + nc].float()) * obj[..., None]
        cls = _apply_class_filter(cls, classes, nc)
        if multi_label:
            add("conf", cls)
        else:
            best, cid = cls.max(-1)  # first maximum on ties
            add("best", best)
            add("cid", cid.to(torch.int32))
        add("th", torch.argmax(p[..., 5 + nc:], -1).to(torch.int32))
    return {k: torch.cat(v, 1) for k, v in cols.items()}


def _map_candidates(maps, meta, conf_thres, max_candidates, multi_label,
                    classes):
    """Decode and candidate selection of
    :func:`non_max_suppression_from_maps`, as :func:`obb_candidates`."""
    pl = decode_planes(maps, meta, classes, multi_label)
    if multi_label:
        scores, box_idx, cls_id = exact_select_pairs(
            pl["conf"], conf_thres, max_candidates)
    else:
        gate = torch.where((pl["best"] > conf_thres) & (pl["obj"] > conf_thres),
                           pl["best"], torch.zeros_like(pl["best"]))
        scores, box_idx = exact_select(gate, min(max_candidates, gate.shape[1]))
        cls_id = torch.gather(pl["cid"], 1, box_idx)
    theta = (torch.gather(pl["th"], 1, box_idx).float() - 90.0) / 180.0 * PI
    rb = torch.stack([torch.gather(pl[c], 1, box_idx) for c in "xywh"]
                     + [theta], -1)
    return rb, scores, cls_id


def non_max_suppression_from_maps(maps, meta, conf_thres: float = 0.25,
                                  iou_thres: float = 0.45,
                                  max_candidates: int = 4096,
                                  max_det: int = 1500, multi_label: bool = False,
                                  agnostic: bool = False, classes=None,
                                  plain: bool = False):
    """Decode + rotated NMS over flat Detect maps: the best class of each
    box (single-label) or every (box, class) pair (``multi_label``) above
    ``conf_thres`` competes for the ``max_candidates`` slots.

    Returns:
        dets ``(B, max_det, 7)`` ``[cx cy l s theta conf cls]`` (theta
        ``(bin - 90)°`` in radians), rows score-sorted, zero padding;
        num ``(B,)`` int32.
    """
    count("postproc.calls")
    with span("postproc.decode"):
        rb, scores, cls_id = _map_candidates(maps, meta, conf_thres,
                                             max_candidates, multi_label,
                                             classes)
    return _suppress_compact_batch(rb, scores, cls_id, iou_thres, agnostic,
                                   max_det, plain=plain)
