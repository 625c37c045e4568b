"""COCO-style bbox evaluation without pycocotools.

Copy of the JAX package's ``devkit/coco_eval.py`` (the reference's
pycocotools branch, val.py:299-323): the ``--save-json`` predictions against
a COCO-format GT json (:func:`converters.dota_to_coco`), AP@[.5:.95], AP50
and AP75 with pycocotools' matching (per class, greedy best-IoU, 101-point
interpolated AP, the maxDets cap, area 'all'), in NumPy.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _xywh_tl_to_xyxy(b):
    b = np.asarray(b, np.float64)
    return np.stack([b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], 1)


def _cxcywh_to_xyxy(b):
    b = np.asarray(b, np.float64)
    return np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1)


def _iou_matrix(a, b):
    """(n,4) xyxy vs (m,4) xyxy → (n,m)."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _ap_101(tp_sorted, n_gt):
    """pycocotools-style 101-point interpolated AP from a score-sorted TP
    vector and the class GT count."""
    if n_gt == 0:
        return np.nan
    if not len(tp_sorted):
        return 0.0
    tp_c = np.cumsum(tp_sorted)
    fp_c = np.cumsum(~tp_sorted)
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    # monotone precision envelope, sampled at 101 recall points
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    rc_grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rc_grid, side="left")
    p_at = np.where(idx < len(prec_env), prec_env[np.minimum(idx, len(prec_env) - 1)], 0.0)
    return float(p_at.mean())


def coco_eval_bbox(gt_json, pred_json, max_dets: int = 100,
                   pred_bbox_format: str = "cxcywh",
                   pred_category_base: int = 0):
    """Evaluate predictions (val.py --save-json output) vs a COCO GT json.

    ``pred_json`` entries: {image_id: <file stem>, category_id, bbox, score}.
    Returns dict with map (AP@[.5:.95]), map50, map75, per_class.
    """
    gt = json.loads(Path(gt_json).read_text()) if not isinstance(gt_json, dict) else gt_json
    preds = (json.loads(Path(pred_json).read_text())
             if not isinstance(pred_json, list) else pred_json)

    stem_to_img = {Path(im["file_name"]).stem: im["id"] for im in gt["images"]}
    cat_ids = sorted(c["id"] for c in gt["categories"])
    cat_names = {c["id"]: c["name"] for c in gt["categories"]}

    # GT index: (img, cat) → xyxy array
    gt_by_key: dict = {}
    n_gt_per_cat = {c: 0 for c in cat_ids}
    for a in gt["annotations"]:
        if a.get("iscrowd"):
            continue
        k = (a["image_id"], a["category_id"])
        gt_by_key.setdefault(k, []).append(a["bbox"])
        n_gt_per_cat[a["category_id"]] = n_gt_per_cat.get(a["category_id"], 0) + 1

    # predictions: (img, cat) → (score, xyxy); cap maxDets per image
    by_img: dict = {}
    for p in preds:
        img = stem_to_img.get(str(p["image_id"]), p["image_id"])
        by_img.setdefault(img, []).append(p)
    pred_by_key: dict = {}
    for img, plist in by_img.items():
        plist.sort(key=lambda q: -q["score"])
        for p in plist[:max_dets]:
            # remap prediction category base (ours are 0-based) onto the GT
            # json's id space (dota_to_coco uses 1-based)
            cid = int(p["category_id"]) - pred_category_base + cat_ids[0]
            pred_by_key.setdefault((img, cid), []).append(
                (float(p["score"]), p["bbox"]))

    iou_thrs = np.arange(0.5, 1.0, 0.05)
    conv = _cxcywh_to_xyxy if pred_bbox_format == "cxcywh" else _xywh_tl_to_xyxy
    ap = np.full((len(cat_ids), len(iou_thrs)), np.nan)

    for ci, cid in enumerate(cat_ids):
        # gather all (score, tp@thr...) rows for this class across images
        scores, tps = [], []
        img_ids = {k[0] for k in list(gt_by_key) + list(pred_by_key) if k[1] == cid}
        for img in img_ids:
            g = np.asarray(gt_by_key.get((img, cid), []), np.float64).reshape(-1, 4)
            plist = pred_by_key.get((img, cid), [])
            if not plist:
                continue
            plist.sort(key=lambda q: -q[0])
            d_xyxy = conv(np.asarray([q[1] for q in plist]))
            g_xyxy = _xywh_tl_to_xyxy(g) if len(g) else g
            iou = _iou_matrix(d_xyxy, g_xyxy)
            tp_img = np.zeros((len(plist), len(iou_thrs)), bool)
            for ti, thr in enumerate(iou_thrs):
                used = np.zeros(len(g), bool)
                for di in range(len(plist)):  # score order (pycocotools)
                    if not len(g):
                        break
                    cand = np.where(~used & (iou[di] >= thr))[0]
                    if len(cand):
                        gi = cand[np.argmax(iou[di][cand])]
                        used[gi] = True
                        tp_img[di, ti] = True
            scores.extend(q[0] for q in plist)
            tps.append(tp_img)
        n_gt = n_gt_per_cat.get(cid, 0)
        if not scores:
            ap[ci] = np.nan if n_gt == 0 else 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        tp_all = np.concatenate(tps)[order]
        for ti in range(len(iou_thrs)):
            ap[ci, ti] = _ap_101(tp_all[:, ti], n_gt)

    with np.errstate(invalid="ignore"):
        per_class = {cat_names[c]: float(np.nanmean(ap[i]))
                     for i, c in enumerate(cat_ids) if not np.isnan(ap[i]).all()}
        map_all = float(np.nanmean(ap)) if not np.isnan(ap).all() else 0.0
        map50 = float(np.nanmean(ap[:, 0])) if not np.isnan(ap[:, 0]).all() else 0.0
        i75 = int(np.argmin(np.abs(iou_thrs - 0.75)))
        map75 = float(np.nanmean(ap[:, i75])) if not np.isnan(ap[:, i75]).all() else 0.0
    return {"map": map_all, "map50": map50, "map75": map75,
            "per_class": per_class}
