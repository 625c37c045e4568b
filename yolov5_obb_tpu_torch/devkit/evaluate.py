"""Exact OBB mAP over merged DOTA Task1 results, and mAOE.

Counterpart of the JAX package's ``devkit/evaluate.py`` (the reference
DOTA_devkit/dota_evaluation_task1.py and mAOE_evaluation.py):

* GT read from per-image DOTA label files, difficult-aware;
* detections matched greedily by descending confidence with an HBB
  prefilter and the exact polygon IoU (C++ ``native/`` where the library
  loads, else NumPy);
* VOC AP, the 11-point VOC07 metric by default;
* mAOE: the mean angle error of the matched detections above a confidence.

The class list is a parameter, so HRSC2016 (``ship``) and UCAS-AOD
(``car``, ``airplane``) run through the same functions.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..native import poly_overlaps_native
from ..ops.geometry import poly2rbox
from .poly_iou import poly_iou


def voc_ap(rec, prec, use_07_metric: bool = True):
    """VOC AP from recall and precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def parse_gt_dir(anno_dir, image_ids, classname):
    """GT polygons of one class → ``{image: {'poly', 'difficult', 'det'}}``."""
    recs = {}
    for img in image_ids:
        polys, difficult = [], []
        f = Path(anno_dir) / f"{img}.txt"
        if f.exists():
            for line in f.read_text().splitlines():
                parts = line.split()
                if len(parts) < 9 or parts[8] != classname:
                    continue
                try:
                    polys.append([float(v) for v in parts[:8]])
                except ValueError:
                    continue
                difficult.append(int(parts[9]) if len(parts) > 9 else 0)
        polys = np.array(polys, np.float64).reshape(-1, 8)
        recs[img] = {"poly": polys,
                     "difficult": np.array(difficult, bool),
                     "det": np.zeros(len(polys), bool)}
    return recs


def _poly_iou_max(det_poly, gt_polys):
    """The largest IoU of one detection against an image's GT, after the
    HBB prefilter: ``(max_iou, argmax)``, ``(0.0, -1)`` without a
    candidate."""
    if len(gt_polys) == 0:
        return 0.0, -1
    dx, dy = det_poly[0::2], det_poly[1::2]
    gx, gy = gt_polys[:, 0::2], gt_polys[:, 1::2]
    iw = np.minimum(gx.max(1), dx.max()) - np.maximum(gx.min(1), dx.min())
    ih = np.minimum(gy.max(1), dy.max()) - np.maximum(gy.min(1), dy.min())
    cand = np.where((iw > 0) & (ih > 0))[0]
    if len(cand) == 0:
        return 0.0, -1
    mat = poly_overlaps_native(det_poly[None], gt_polys[cand])
    if mat is not None:
        j = int(np.argmax(mat[0]))
        return float(mat[0, j]), int(cand[j])
    best, best_j = 0.0, -1
    for j in cand:
        v = poly_iou(det_poly, gt_polys[j])
        if v > best:
            best, best_j = v, int(j)
    return best, best_j


def voc_eval_obb(det_file, anno_dir, image_ids, classname,
                 ovthresh: float = 0.5, use_07_metric: bool = True):
    """One class; ``det_file`` rows ``image score x1 y1 ... y4``.  Returns
    ``(recall curve, precision curve, ap)``."""
    recs = parse_gt_dir(anno_dir, image_ids, classname)
    npos = sum(int((~r["difficult"]).sum()) for r in recs.values())

    img_names, scores, polys = [], [], []
    det_path = Path(det_file)
    if det_path.exists():
        for line in det_path.read_text().splitlines():
            parts = line.split()
            if len(parts) < 10:
                continue
            img_names.append(parts[0])
            scores.append(float(parts[1]))
            polys.append([float(v) for v in parts[2:10]])
    if not scores or npos == 0:
        return np.zeros(0), np.zeros(0), 0.0

    scores = np.array(scores)
    polys = np.array(polys)
    order = np.argsort(-scores)
    img_names = [img_names[i] for i in order]
    polys = polys[order]

    nd = len(img_names)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = recs.get(img_names[d])
        if rec is None:
            fp[d] = 1
            continue
        iou, j = _poly_iou_max(polys[d], rec["poly"])
        if iou > ovthresh:
            if not rec["difficult"][j]:
                if not rec["det"][j]:
                    tp[d] = 1
                    rec["det"][j] = True
                else:
                    fp[d] = 1
            # a difficult GT: neither a true nor a false positive
        else:
            fp[d] = 1

    fpc = np.cumsum(fp)
    tpc = np.cumsum(tp)
    recall = tpc / float(npos)
    precision = tpc / np.maximum(tpc + fpc, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def _image_ids(image_ids):
    if isinstance(image_ids, (str, Path)):
        return [l.strip() for l in Path(image_ids).read_text().splitlines()
                if l.strip()]
    return image_ids


def evaluate_task1(det_dir, anno_dir, image_ids, classnames,
                   ovthresh: float = 0.5, use_07_metric: bool = True,
                   det_prefix: str = "Task1_"):
    """Task1 OBB mAP over ``classnames``; ``image_ids`` a list or a file of
    ids.  Returns ``(map, {class: ap})``."""
    image_ids = _image_ids(image_ids)
    classaps = {}
    for cls in classnames:
        _, _, ap = voc_eval_obb(Path(det_dir) / f"{det_prefix}{cls}.txt",
                                anno_dir, image_ids, cls, ovthresh,
                                use_07_metric)
        classaps[cls] = float(ap)
    mean_ap = float(np.mean(list(classaps.values()))) if classaps else 0.0
    return mean_ap, classaps


def evaluate_maoe(det_dir, anno_dir, image_ids, classnames,
                  ovthresh: float = 0.5, conf_thresh: float = 0.3,
                  det_prefix: str = "Task1_"):
    """Mean angle-orientation error in degrees of the detections at
    ``conf_thresh`` or above that match a GT at IoU above ``ovthresh``.
    Returns ``(mAOE, {class: aoe})``."""
    image_ids = _image_ids(image_ids)
    out = {}
    for cls in classnames:
        recs = parse_gt_dir(anno_dir, image_ids, cls)
        errors = []
        f = Path(det_dir) / f"{det_prefix}{cls}.txt"
        if not f.exists():
            continue
        by_img = defaultdict(list)
        for line in f.read_text().splitlines():
            parts = line.split()
            if len(parts) < 10 or float(parts[1]) < conf_thresh:
                continue
            by_img[parts[0]].append([float(v) for v in parts[2:10]])
        for img, dets in by_img.items():
            rec = recs.get(img)
            if rec is None or len(rec["poly"]) == 0:
                continue
            gt_rb = poly2rbox(rec["poly"])
            for det in dets:
                det = np.asarray(det)
                iou, j = _poly_iou_max(det, rec["poly"])
                if iou > ovthresh:
                    d_rb = poly2rbox(det[None])[0]
                    dt = abs(d_rb[4] - gt_rb[j, 4]) * 180 / np.pi
                    errors.append(min(dt, 180 - dt))
        if errors:
            out[cls] = float(np.mean(errors))
    maoe = float(np.mean(list(out.values()))) if out else 0.0
    return maoe, out
