"""Merge per-tile detections back into whole-image results by polygon NMS.

Counterpart of the JAX package's ``devkit/result_merge.py`` (the reference
DOTA_devkit/ResultMerge_multi_process.py):

* per-class Task1 files hold rows ``{tile_name} {score} {x1 y1 ... y4}``,
  ``tile_name = stem__rate__left___up``;
* polygons shift back to source-image coordinates ``(x + left) / rate``;
* per source image, greedy polygon NMS at ``nms_thresh`` (0.2 for OBB) with
  an HBB-overlap prefilter before the exact polygon IoU, in C++
  (``native/``) where the library loads, else in NumPy.
"""

from __future__ import annotations

import multiprocessing
import re
import tempfile
from collections import defaultdict
from functools import partial
from pathlib import Path

import numpy as np

from ..native import poly_nms_native
from .poly_iou import poly_iou

_TILE_RE = re.compile(r"^(.*?)__([\d.]+)__(\d+)___(\d+)$")


def parse_tile_name(name: str):
    """``stem__rate__left___up`` → ``(stem, rate, left, up)``; a whole-image
    name passes through as ``(name, 1.0, 0, 0)``."""
    m = _TILE_RE.match(name)
    if not m:
        return name, 1.0, 0, 0
    return m.group(1), float(m.group(2)), int(m.group(3)), int(m.group(4))


def poly_nms_np(polys: np.ndarray, scores: np.ndarray, thresh: float,
                use_native: bool = True):
    """Greedy polygon NMS with the HBB prefilter; the kept indices in score
    order (``np.argsort(-scores)``).  ``use_native`` takes the C++ library
    when it loads."""
    n = len(scores)
    if n == 0:
        return []
    if use_native:
        keep = poly_nms_native(polys, scores, thresh)
        if keep is not None:
            return keep
    x = polys[:, 0::2]
    y = polys[:, 1::2]
    x1, x2 = x.min(1), x.max(1)
    y1, y2 = y.min(1), y.max(1)
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(n, bool)
    for _i, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(int(i))
        for j in order[_i + 1:]:
            if suppressed[j]:
                continue
            iw = min(x2[i], x2[j]) - max(x1[i], x1[j])
            ih = min(y2[i], y2[j]) - max(y1[i], y1[j])
            if iw <= 0 or ih <= 0:
                continue
            hbb_ovr = iw * ih / (areas[i] + areas[j] - iw * ih + 1e-12)
            if hbb_ovr <= 0:
                continue
            if poly_iou(polys[i], polys[j]) > thresh:
                suppressed[j] = True
    return keep


def read_task1_by_image(task1_file) -> dict:
    """A per-class Task1 file of tile rows → ``{stem: [(score, poly8 in
    source-image coordinates)]}``."""
    by_image = defaultdict(list)
    for line in Path(task1_file).read_text().splitlines():
        parts = line.split()
        if len(parts) < 10:
            continue
        stem, rate, left, up = parse_tile_name(parts[0])
        score = float(parts[1])
        poly = np.array([float(v) for v in parts[2:10]], np.float64)
        poly[0::2] = (poly[0::2] + left) / rate
        poly[1::2] = (poly[1::2] + up) / rate
        by_image[stem].append((score, poly))
    return by_image


def merge_single_class(task1_file, dst_file, nms_thresh: float = 0.2):
    """Merge one per-class Task1 file (reference mergesingle)."""
    by_image = read_task1_by_image(task1_file)
    with open(dst_file, "w") as f:
        for stem, dets in sorted(by_image.items()):
            scores = np.array([d[0] for d in dets])
            polys = np.stack([d[1] for d in dets])
            for i in poly_nms_np(polys, scores, nms_thresh):
                row = " ".join(f"{v:.2f}" for v in polys[i])
                f.write(f"{stem} {scores[i]:.5f} {row}\n")


def merge_by_poly_nms(src_dir, dst_dir, nms_thresh: float = 0.2,
                      num_workers: int = 8):
    """Merge every ``Task1_*.txt`` of ``src_dir`` into ``dst_dir``, one
    class a process (reference mergebypoly); returns the merged paths."""
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    jobs = [(f, dst / f.name) for f in sorted(src.glob("Task1_*.txt"))]
    if num_workers > 1 and len(jobs) > 1:
        with multiprocessing.Pool(num_workers) as pool:
            pool.starmap(partial(merge_single_class, nms_thresh=nms_thresh),
                         jobs)
    else:
        for a, b in jobs:
            merge_single_class(a, b, nms_thresh=nms_thresh)
    return [b for _, b in jobs]


def results_obb2hbb(src_dir, dst_dir):
    """Merged OBB Task1 files → HBB Task2 files (reference
    results_obb2hbb.py)."""
    src, dst = Path(src_dir), Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    for f in sorted(src.glob("Task1_*.txt")):
        out = dst / f.name.replace("Task1", "Task2")
        lines = []
        for line in f.read_text().splitlines():
            parts = line.split()
            if len(parts) < 10:
                continue
            poly = np.array([float(v) for v in parts[2:10]])
            x, y = poly[0::2], poly[1::2]
            lines.append(f"{parts[0]} {parts[1]} {x.min():.2f} {y.min():.2f} "
                         f"{x.max():.2f} {y.max():.2f}")
        out.write_text("\n".join(lines) + ("\n" if lines else ""))


def merge_ensemble(src_dirs, dst_dir, nms_thresh: float = 0.2,
                   num_workers: int = 8):
    """The union of several models' per-class files, then polygon NMS
    (reference results_ensemble.py)."""
    dst = Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    names = sorted({f.name for d in src_dirs
                    for f in Path(d).glob("Task1_*.txt")})
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            combined = [(Path(d) / name).read_text() for d in src_dirs
                        if (Path(d) / name).exists()]
            (Path(tmp) / name).write_text("".join(combined))
        return merge_by_poly_nms(tmp, dst, nms_thresh, num_workers)
