"""High-level Python API (the reference AutoShape/Detections and hubconf).

    import yolov5_obb_tpu_torch.api as api
    model = api.load("yolov5m.yaml", weights="runs/train/exp/best",
                     names=DOTA_V1_NAMES, dtype=torch.bfloat16)
    results = model(["img1.png", np_array, ...])   # any mix of inputs
    results.rows()          # per image, a list of dicts (no pandas needed)
    results.pandas()        # per image, a DataFrame
    results.save("out/")    # annotated images (needs OpenCV)

Counterpart of ``yolov5_obb_tpu/api.py``.  The model runs on the card unless
``device="cpu"``; in bfloat16 on the card it takes the packed uint8 image
and its kernels.  PNG files, URLs and bytes are read without OpenCV
(``utils/image_io.py``); other formats, drawing and crops need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .data.augment import letterbox
from .engine.evaluator import make_predict_fn, pack_images
from .models.yolo import create_model
from .ops.geometry import rbox2poly, scale_polys
from .utils import image_io
from .utils.checkpoint import load_model_weights
from .utils.device import resolve_device
from .utils.fuse import fuse_conv_bn
from .utils.plots import annotate_detections

COLUMNS = [f"{ax}{i + 1}" for i in range(4) for ax in "xy"] + [
    "confidence", "class", "name"]


def obb_crop(img, poly, rectify: bool = True):
    """Cut one detection from a BGR image given its 8-point polygon.

    ``rectify=True`` warps the oriented box upright (its first edge
    horizontal); ``False`` cuts the axis-aligned cover instead.  Needs
    OpenCV."""
    import cv2

    pts = np.asarray(poly, np.float32).reshape(4, 2)
    if rectify:
        w = int(round(float(np.linalg.norm(pts[1] - pts[0])))) or 1
        h = int(round(float(np.linalg.norm(pts[2] - pts[1])))) or 1
        dst = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                       np.float32)
        m = cv2.getPerspectiveTransform(pts, dst)
        return cv2.warpPerspective(img, m, (w, h))
    x0, y0 = np.maximum(pts.min(0).astype(int), 0)
    x1, y1 = pts.max(0).astype(int) + 1
    return img[y0:y1, x0:x1].copy()


def detection_rows(polys, confs, clses, names) -> list:
    """One image's detections as a list of dicts with the :data:`COLUMNS`
    keys (the rows of :meth:`Detections.pandas`, and the JSON the REST
    server answers)."""
    rows = []
    for p, c, k in zip(polys, confs, clses):
        row = {f"{ax}{i + 1}": float(p[2 * i + j]) for i in range(4)
               for j, ax in enumerate("xy")}
        row.update(confidence=float(c), **{"class": int(k)},
                   name=names[int(k)] if names else str(int(k)))
        rows.append({col: row[col] for col in COLUMNS})
    return rows


class Detections:
    """Per-image oriented detections (reference models/common.py:527-625)."""

    def __init__(self, imgs, polys, confs, clses, names, paths):
        self.imgs = imgs  # BGR arrays
        self.polys = polys  # list of (n, 8)
        self.confs = confs
        self.clses = clses
        self.names = names
        self.paths = paths

    def __len__(self):
        return len(self.imgs)

    def rows(self) -> list:
        """Per image, :func:`detection_rows`."""
        return [detection_rows(p, c, k, self.names)
                for p, c, k in zip(self.polys, self.confs, self.clses)]

    def pandas(self):
        import pandas as pd

        return [pd.DataFrame(r, columns=COLUMNS) for r in self.rows()]

    def render(self):
        for img, polys, confs, clses in zip(self.imgs, self.polys,
                                            self.confs, self.clses):
            annotate_detections(img, polys, confs, clses, self.names)
        return self.imgs

    def crop(self, save_dir=None, rectify=True):
        """Per-detection crops (reference ``Detections.crop``): a list (per
        image) of lists of BGR crops, saved under ``save_dir`` if given;
        ``rectify`` as :func:`obb_crop`."""
        import cv2

        out = []
        for idx, (img, polys, clses) in enumerate(
                zip(self.imgs, self.polys, self.clses)):
            crops = [obb_crop(img, p, rectify) for p in polys]
            out.append(crops)
            if save_dir is not None:
                d = Path(save_dir)
                d.mkdir(parents=True, exist_ok=True)
                stem = (Path(self.paths[idx]).stem if self.paths[idx]
                        else f"image{idx}")
                for j, (crop, k) in enumerate(zip(crops, clses)):
                    label = self.names[int(k)] if self.names else str(int(k))
                    cv2.imwrite(str(d / f"{stem}_{label}_{j}.png"), crop)
        return out

    def save(self, save_dir="runs/hub"):
        import cv2

        d = Path(save_dir)
        d.mkdir(parents=True, exist_ok=True)
        self.render()
        for i, img in enumerate(self.imgs):
            name = (Path(self.paths[i]).name if self.paths[i]
                    else f"image{i}.jpg")
            cv2.imwrite(str(d / name), img)
        return d

    def print(self):
        for i, polys in enumerate(self.polys):
            print(f"image {i}: {len(polys)} detections")


class OBBModel:
    """Callable wrapper: image inputs of any form → :class:`Detections`
    (single-label NMS, as the JAX package's API)."""

    def __init__(self, cfg="yolov5m.yaml", weights: str | None = None,
                 names=None, imgsz: int = 1024, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 1000, dtype=None,
                 device=None):
        self.imgsz = imgsz
        self.device = resolve_device(device)
        dtype = dtype or torch.float32
        # the stem kernels compute bf16: the packed path only for a bf16
        # model on the card, so a float32 model keeps its numerics
        packed = self.device.type == "cuda" and dtype == torch.bfloat16
        self.model, self.meta = create_model(
            cfg, nc=len(names) if names else None, dtype=dtype,
            device=self.device, packed_stem=packed)
        if weights:
            wmeta = load_model_weights(self.model, self.meta, weights)
            names = names or wmeta.get("names")
        fuse_conv_bn(self.model)
        self.names = (list(names) if names
                      else [str(i) for i in range(self.meta.nc)])
        self.predict = make_predict_fn(self.model, self.meta, conf_thres,
                                       iou_thres, max_det, multi_label=False)

    @staticmethod
    def _to_bgr(im):
        """Any reference-AutoShape input form → ``(BGR uint8 HWC, path or
        None)``: a file name or Path, an http(s) URL, a PIL image, a torch
        tensor (CHW or HWC, uint8 or float) or an array (BGR, the cv2
        convention) — reference models/common.py:439-475."""
        if isinstance(im, str) and im.startswith(("http://", "https://")):
            from urllib.request import urlopen

            img = image_io.imdecode(urlopen(im).read())
            if img is None:
                raise ValueError(f"undecodable image data from {im}")
            return img, im.split("?")[0]
        if isinstance(im, (str, Path)):
            img = image_io.imread(im)
            if img is None:
                raise FileNotFoundError(im)
            return img, str(im)
        if im.__class__.__module__.split(".")[0] == "PIL":
            # PIL images are RGB; flip to the BGR convention
            arr = np.asarray(im.convert("RGB"))[..., ::-1]
            return np.ascontiguousarray(arr), getattr(im, "filename", None)
        if isinstance(im, torch.Tensor):
            im = im.detach().cpu().numpy()
        arr = np.asarray(im)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        elif arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] > 3:
            arr = arr.transpose(1, 2, 0)  # CHW (torch convention) → HWC
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, -1)
        if arr.dtype != np.uint8:
            scale = 255.0 if float(arr.max(initial=0.0)) <= 1.0 else 1.0
            arr = np.clip(np.rint(arr * scale), 0, 255).astype(np.uint8)
        return arr[..., :3].astype(np.uint8), None

    def __call__(self, inputs):
        """One batch of all the inputs: no image's detections depend on
        the batch it rides in, so a request is not padded to a power of two
        (the JAX package pads only to bound its XLA compiles)."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        imgs, paths = zip(*(self._to_bgr(im) for im in inputs))
        batch = np.stack([
            np.ascontiguousarray(letterbox(im, self.imgsz, auto=False,
                                           scaleup=False)[0][:, :, ::-1])
            for im in imgs])
        if self.predict.packed_stem:
            batch = pack_images(batch)
        dets, num = self.predict(torch.from_numpy(batch).to(self.device))
        dets, num = dets.cpu().numpy(), num.cpu().numpy()
        polys_l, confs_l, clses_l = [], [], []
        for i, im in enumerate(imgs):
            d = dets[i, :int(num[i])]
            polys = rbox2poly(d[:, :5]) if len(d) else np.zeros((0, 8))
            if len(d):
                polys = scale_polys((self.imgsz, self.imgsz), polys,
                                    im.shape[:2])
            polys_l.append(polys)
            confs_l.append(d[:, 5])
            clses_l.append(d[:, 6])
        return Detections(list(imgs), polys_l, confs_l, clses_l, self.names,
                          list(paths))


def load(cfg="yolov5m.yaml", weights=None, **kw) -> OBBModel:
    """hubconf-style one-liner (reference hubconf.py:14-66)."""
    return OBBModel(cfg=cfg, weights=weights, **kw)
