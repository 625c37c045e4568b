"""DOTA-format dataset, the evaluation half: label parsing and the
letterboxed, un-augmented eval sample.

Counterpart of ``yolov5_obb_tpu/data/dota.py`` (``DotaDataset`` :103,
``get_eval_sample`` :380).  Labels are parsed at construction (no label or
image caches); training samples, mosaics and the caches wait for the train
data loader (ROADMAP.md queue 1 item 8).  ``cv2`` is imported inside the
call that decodes an image: the package imports without it.

Label format (DOTA): one object per line,
``x1 y1 x2 y2 x3 y3 x4 y4 classname difficult``; lines with difficult ==
'2' are dropped.  Target rows: ``[cls cx cy l s theta csl_0..csl_179]``,
pixel units of the letterboxed image.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.geometry import poly2rbox_csl
from .augment import letterbox

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}

DOTA_V1_NAMES = [
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
]

TARGET_COLS = 6 + 180
STRIDE = 32  # the rect-val canvas is a multiple of the largest Detect stride
CSL_RADIUS = 6.0  # the default hyp's csl_radius (target columns 6+)


def img2label_path(img_path: str) -> str:
    """images/xxx.png → labelTxt/xxx.txt (the last ``images`` folder)."""
    parts = list(Path(img_path).parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labelTxt"
            break
    return str(Path(*parts).with_suffix(".txt"))


def parse_dota_annotation(path, name_to_id: dict, drop_difficult2: bool = True):
    """One labelTxt file → (polys (n, 8) float32, cls (n,) float32);
    header lines, unknown class names and (by default) difficult-2 objects
    are skipped; a missing file gives no objects."""
    polys, cls = [], []
    p = Path(path)
    if p.exists():
        for line in p.read_text().splitlines():
            parts = line.split()
            if len(parts) < 9:
                continue  # imagesource/gsd headers
            try:
                coords = [float(v) for v in parts[:8]]
            except ValueError:
                continue
            name = parts[8]
            difficult = parts[9] if len(parts) > 9 else "0"
            if (drop_difficult2 and difficult == "2") or name not in name_to_id:
                continue
            polys.append(coords)
            cls.append(float(name_to_id[name]))
    return (np.array(polys, np.float32).reshape(-1, 8),
            np.array(cls, np.float32))


def _scan_images(path) -> list:
    """A folder (recursive), a txt list (relative to its folder) or one file
    → the sorted image paths."""
    p = Path(path)
    files: list = []
    if p.is_dir():
        files = [f for f in sorted(p.rglob("*")) if f.suffix.lower() in IMG_EXTS]
    elif p.suffix == ".txt" and p.exists():
        for line in p.read_text().splitlines():
            line = line.strip()
            if line:
                q = Path(line)
                files.append(q if q.is_absolute() else p.parent / q)
    elif p.exists():
        files = [p]
    else:
        raise FileNotFoundError(f"dataset path not found: {path}")
    if not files:
        raise FileNotFoundError(f"no images found under {path}")
    return [str(f) for f in files]


class DotaDataset:
    """Random-access DOTA dataset for evaluation: fixed-shape padded targets
    (``max_labels`` rows and a mask) beside each letterboxed image.

    ``eval_pad > 0`` gives the reference's rect-val canvas,
    ``ceil(img_size/32 + eval_pad)*32`` (1056 for 1024 at 0.5), with
    the content at ``img_size`` scale; 0 keeps the exact square."""

    def __init__(self, path, names, img_size: int = 1024,
                 max_labels: int = 500, single_cls: bool = False,
                 eval_pad: float = 0.0):
        self.img_files = _scan_images(path)
        self.label_files = [img2label_path(f) for f in self.img_files]
        self.names = list(names)
        self.name_to_id = {n: i for i, n in enumerate(self.names)}
        self.img_size = int(img_size)
        self.eval_pad = float(eval_pad)
        self.eval_canvas = (
            int(np.ceil(self.img_size / STRIDE + self.eval_pad)) * STRIDE
            if self.eval_pad > 0 else self.img_size)
        self.max_labels = int(max_labels)
        self.polys, self.cls = [], []
        for lf in self.label_files:
            p, c = parse_dota_annotation(lf, self.name_to_id)
            self.polys.append(p)
            self.cls.append(np.zeros_like(c) if single_cls else c)

    def __len__(self):
        return len(self.img_files)

    def load_image(self, i):
        """Read (BGR) and resize so max(h, w) == img_size, scaling the
        labels with it → (img, polys, cls, (h0, w0))."""
        import cv2

        img = cv2.imread(self.img_files[i])
        if img is None:
            raise FileNotFoundError(f"image not found: {self.img_files[i]}")
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        polys = self.polys[i]
        if r != 1:
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                             interpolation=cv2.INTER_LINEAR if r > 1
                             else cv2.INTER_AREA)
            polys = polys * r
        return img, polys.copy(), self.cls[i].copy(), (h0, w0)

    def _encode(self, polys, cls, img_shape):
        """polys/cls → padded (max_labels, 186) targets + mask; a box is
        kept when its centre lies in the image and (l > 5 or s > 5)."""
        M = self.max_labels
        out = np.zeros((M, TARGET_COLS), np.float32)
        mask = np.zeros((M,), bool)
        if len(polys):
            rb, csl = poly2rbox_csl(polys.astype(np.float64), radius=CSL_RADIUS)
            h, w = img_shape[:2]
            keep = ((rb[:, 0] >= 0) & (rb[:, 0] < w) & (rb[:, 1] >= 0)
                    & (rb[:, 1] < h) & ((rb[:, 2] > 5) | (rb[:, 3] > 5)))
            rb, csl, cls = rb[keep], csl[keep], cls[keep]
            n = min(len(rb), M)
            out[:n, 0] = cls[:n]
            out[:n, 1:6] = rb[:n]
            out[:n, 6:] = csl[:n]
            mask[:n] = True
        return out, mask

    def get_eval_sample(self, index: int):
        """Letterboxed, un-augmented sample (RGB HWC uint8) + its targets and
        the metadata that maps the canvas back to the original image."""
        img, polys, cls, (h0, w0) = self.load_image(index)
        lh = img.shape[0]
        img, ratio, pad = letterbox(img, self.eval_canvas, scaleup=False)
        if len(polys):
            polys = polys.copy()
            polys[:, 0::2] = polys[:, 0::2] * ratio[0] + pad[0]
            polys[:, 1::2] = polys[:, 1::2] * ratio[1] + pad[1]
        targets, mask = self._encode(polys, cls, img.shape)
        out = {
            "image": np.ascontiguousarray(img[:, :, ::-1]),
            "targets": targets,
            "target_mask": mask,
            "index": np.int32(index),
            "orig_hw": np.array([h0, w0], np.int32),
        }
        if self.eval_pad > 0:
            # on the padded canvas the canvas→original gain is the load
            # ratio times the letterbox ratio
            out["ratio_pad"] = np.array([lh / h0 * ratio[1], pad[0], pad[1]],
                                        np.float64)
        return out
