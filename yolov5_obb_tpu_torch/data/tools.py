"""Dataset tools (reference utils/datasets.py:885-1110): splits, statistics,
flattening, box crops, and the class and image weights of
``--image-weights``.

Counterpart of ``yolov5_obb_tpu/data/tools.py``: ``autosplit`` (:14),
``dataset_stats`` (:33), ``flatten_recursive`` (:63), ``extract_boxes``
(:73), ``labels_to_class_weights`` (:110) and ``labels_to_image_weights``
(:124), with the same files and results.  ``extract_boxes`` reads and
writes images through OpenCV, imported inside the call.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from .dota import IMG_EXTS, DotaDataset, img2label_path


def autosplit(path, weights=(0.9, 0.1, 0.0), annotated_only=False, seed=0):
    """The images under ``path`` drawn into ``autosplit_{train,val,test}.txt``
    beside it with probabilities ``weights`` (a seeded generator; with
    ``annotated_only`` only images with a label file) → the three paths
    (reference datasets.py:928-946)."""
    path = Path(path)
    files = sorted(f for f in path.rglob("*") if f.suffix.lower() in IMG_EXTS)
    rng = np.random.default_rng(seed)
    idx = rng.choice(3, size=len(files), p=list(weights))
    names = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for n in names:
        (path.parent / n).unlink(missing_ok=True)
    for f, i in zip(files, idx):
        if annotated_only and not Path(img2label_path(str(f))).exists():
            continue
        with open(path.parent / names[i], "a") as fh:
            fh.write(f"./{f.relative_to(path.parent)}\n")
    return [path.parent / n for n in names]


def dataset_stats(data_yaml, verbose=False):
    """Per-split statistics of a dataset yaml: image and instance counts,
    the per-class histogram, the mean instances an image; None for a split
    that is absent (reference datasets.py:1008-1110, without its downloads
    and uploads)."""
    from ..utils.general import load_dataset_config

    d = load_dataset_config(data_yaml)
    stats = {"nc": d["nc"], "names": d["names"]}
    for split in ("train", "val", "test"):
        if not d.get(split) or not Path(d[split]).exists():
            stats[split] = None
            continue
        ds = DotaDataset(d[split], d["names"], img_size=1024)
        counts = np.zeros(d["nc"], int)
        per_image = []
        for cls in ds.cls:
            for c in cls.astype(int):
                counts[c] += 1
            per_image.append(len(cls))
        stats[split] = {
            "image_count": len(ds),
            "instance_count": int(counts.sum()),
            "per_class": counts.tolist(),
            "instances_per_image_mean": (float(np.mean(per_image))
                                         if per_image else 0.0),
        }
    if verbose:
        print(json.dumps(stats, indent=2))
    return stats


def flatten_recursive(path, new_path=None):
    """Copy every file under ``path`` into one flat directory (default
    ``<path>_flat``) → its path (reference datasets.py:885-891)."""
    path = Path(path)
    new_path = Path(new_path or str(path) + "_flat")
    new_path.mkdir(parents=True, exist_ok=True)
    for f in path.rglob("*.*"):
        shutil.copy(f, new_path / f.name)
    return new_path


def extract_boxes(path, out_dir=None):
    """Crop each labelled object's axis-aligned cover (2 px margin, clipped
    to the image, at least 3 px a side) into ``<out_dir>/<class>/<image
    stem>_<n>.jpg``: a detection set as a classification set (reference
    datasets.py:893-926) → ``(out_dir, crops written)``."""
    import cv2

    path = Path(path)
    out = Path(out_dir or path.parent / "classifier")
    files = sorted(f for f in path.rglob("*") if f.suffix.lower() in IMG_EXTS)
    n = 0
    for f in files:
        lab = Path(img2label_path(str(f)))
        if not lab.exists():
            continue
        img = cv2.imread(str(f))
        if img is None:
            continue
        h, w = img.shape[:2]
        for line in lab.read_text().splitlines():
            parts = line.split()
            if len(parts) < 9:
                continue
            try:
                poly = np.array([float(v) for v in parts[:8]])
            except ValueError:
                continue
            cname = parts[8]
            x1 = int(np.clip(poly[0::2].min() - 2, 0, w))
            x2 = int(np.clip(poly[0::2].max() + 2, 0, w))
            y1 = int(np.clip(poly[1::2].min() - 2, 0, h))
            y2 = int(np.clip(poly[1::2].max() + 2, 0, h))
            if x2 - x1 < 3 or y2 - y1 < 3:
                continue
            dst = out / cname
            dst.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(dst / f"{f.stem}_{n}.jpg"), img[y1:y2, x1:x2])
            n += 1
    return out, n


def labels_to_class_weights(cls_lists, nc: int):
    """Inverse-frequency class weights, normalised to sum 1; a class with no
    object weighs 0 (reference general.py:506-519)."""
    counts = np.zeros(nc)
    for cls in cls_lists:
        for c in np.asarray(cls, int):
            if 0 <= c < nc:
                counts[c] += 1
    w = 1.0 / np.maximum(counts, 1)
    w[counts == 0] = 0
    return w / max(w.sum(), 1e-9)


def labels_to_image_weights(cls_lists, nc: int, class_weights=None):
    """Per-image sampling weights, the class weights summed over each
    image's objects, normalised (uniform when every image weighs 0;
    reference general.py:521-526)."""
    cw = (class_weights if class_weights is not None
          else labels_to_class_weights(cls_lists, nc))
    out = np.zeros(len(cls_lists))
    for i, cls in enumerate(cls_lists):
        h = np.bincount(np.asarray(cls, int), minlength=nc)[:nc]
        out[i] = float((h * cw).sum())
    s = out.sum()
    return (out / s if s > 0
            else np.full(len(cls_lists), 1.0 / max(len(cls_lists), 1)))
