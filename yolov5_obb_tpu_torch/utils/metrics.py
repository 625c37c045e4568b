"""Detection metrics on the host (numpy): HBB TP matching, per-class AP.

Copies of ``yolov5_obb_tpu/utils/metrics.py`` (metrics.py:13-118), the
reference's in-train metric: HBB mAP over the rotated boxes' axis-aligned
covers at 10 IoU thresholds.  The confusion matrix and the plots (which need
matplotlib) are not ported (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import numpy as np

# numpy >= 2 names it trapezoid; older releases only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def fitness(p, r, map50, map_):
    """Weighted model fitness (reference metrics.py:15-19)."""
    return 0.1 * map50 + 0.9 * map_


def box_iou_np(box1, box2):
    """(n, 4) x (m, 4) xyxy IoU matrix."""
    a1 = np.maximum(box1[:, None, :2], box2[None, :, :2])
    a2 = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.clip(a2 - a1, 0, None).prod(-1)
    area1 = np.clip(box1[:, 2:] - box1[:, :2], 0, None).prod(-1)
    area2 = np.clip(box2[:, 2:] - box2[:, :2], 0, None).prod(-1)
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-9)


def compute_ap(recall, precision, method: str = "interp"):
    """AP from PR points (101-point interpolation, or 'continuous')."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    if method == "interp":
        x = np.linspace(0, 1, 101)
        ap = _trapezoid(np.interp(x, mrec, mpre), x)
    else:
        i = np.where(mrec[1:] != mrec[:-1])[0]
        ap = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16,
                 return_curves: bool = False):
    """Per-class AP across IoU thresholds.

    Args:
        tp: (n_pred, n_iou) bool TP matrix.
        conf, pred_cls: (n_pred,).
        target_cls: (n_gt,).
        return_curves: also return the curves a plot would draw.

    Returns:
        p, r, ap, f1, unique_classes — p/r/f1 at the max-F1 confidence, ap
        (n_cls, n_iou); with ``return_curves`` a 6th element: px (1000,),
        pr_py (nc, 1000) precision over the recall grid at IoU .5, and the
        p/r/f1-against-confidence curves (nc, 1000).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    pr_py = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l = nt[ci]
        n_p = int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[i], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                pr_py[ci] = np.interp(px, mrec, mpre)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = f1_curve.mean(0).argmax()
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    out = (p, r, ap, f1, unique_classes.astype(int))
    if return_curves:
        out += ({"px": px, "pr_py": pr_py, "p": p_curve, "r": r_curve,
                 "f1": f1_curve},)
    return out


def process_batch_hbb(det_xyxy, det_conf, det_cls, gt_xyxy, gt_cls, iouv):
    """TP matrix of one image at the IoU thresholds ``iouv``: one-to-one
    matching, best IoU first, same class (reference val.py:69-92).
    Returns (n_det, len(iouv)) bool."""
    correct = np.zeros((det_xyxy.shape[0], len(iouv)), bool)
    if len(gt_xyxy) == 0 or len(det_xyxy) == 0:
        return correct
    iou = box_iou_np(gt_xyxy, det_xyxy)  # (n_gt, n_det)
    cls_match = gt_cls[:, None] == det_cls[None, :]
    for j, thr in enumerate(iouv):
        gi, di = np.where((iou >= thr) & cls_match)
        if len(gi):
            order = np.argsort(-iou[gi, di])
            gi, di = gi[order], di[order]
            # one-to-one: first match per detection and per gt
            _, ud = np.unique(di, return_index=True)
            gi, di = gi[np.sort(ud)], di[np.sort(ud)]
            _, ug = np.unique(gi, return_index=True)
            gi, di = gi[np.sort(ug)], di[np.sort(ug)]
            correct[di, j] = True
    return correct
