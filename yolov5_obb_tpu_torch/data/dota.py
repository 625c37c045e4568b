"""DOTA-format dataset: label parsing, the label and image caches, the
augmented train sample and the letterboxed eval sample.

Counterpart of ``yolov5_obb_tpu/data/dota.py`` (``DotaDataset`` :103): every
sample returns fixed-shape padded arrays (``max_labels`` target rows and a
mask).  ``get_train_sample`` (:309) draws its augmentations from the
``np.random.Generator`` it is given, in the JAX package's order and through
the same OpenCV calls (``augment.py``), so a seeded sample is the JAX
package's bit for bit.  ``cv2`` (and PIL, for ``verify``) are imported
inside the calls that decode or resize an image: the package imports
without them, and a dataset whose samples come from elsewhere (the shard
cache, ``shards.py``) needs neither.

Label format (DOTA): one object per line,
``x1 y1 x2 y2 x3 y3 x4 y4 classname difficult``; lines with difficult ==
'2' are dropped.  Target rows: ``[cls cx cy l s theta csl_0..csl_179]``,
pixel units of the sample's image.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from ..ops.geometry import poly2rbox_csl
from . import augment as A

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}

DOTA_V1_NAMES = [
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
]

TARGET_COLS = 6 + 180


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
    """Random-access DOTA dataset with fixed-shape padded outputs.

    ``hyp`` holds the augmentation settings (and ``csl_radius``);
    ``augment`` turns them on in ``get_train_sample``.  ``cache_dir`` keeps
    the parsed labels (``labels_<key>.npz``) and, with ``cache_images =
    "disk"``, the resized images; ``"ram"`` keeps them in memory.  Both
    image caches fill on first access.  ``verify`` drops unreadable images
    first.  ``eval_pad > 0`` gives the reference's rect-val canvas,
    ``ceil(img_size/stride + eval_pad)*stride`` (1056 for 1024 at 0.5),
    with the content at ``img_size`` scale; 0 keeps the exact square."""

    def __init__(self, path, names, img_size: int = 1024,
                 hyp: dict | None = None, augment: bool = False,
                 max_labels: int = 500, cache_dir: str | None = None,
                 stride: int = 32, verify: bool = False,
                 single_cls: bool = False, cache_images: str | None = None,
                 eval_pad: float = 0.0):
        self.img_files = _scan_images(path)
        if verify:
            self.img_files = self._verify_images(self.img_files)
        self.label_files = [img2label_path(f) for f in self.img_files]
        self.names = list(names)
        self.name_to_id = {n: i for i, n in enumerate(self.names)}
        self.img_size = int(img_size)
        self.eval_pad = float(eval_pad)
        self.eval_canvas = (
            int(np.ceil(self.img_size / stride + self.eval_pad)) * stride
            if self.eval_pad > 0 else self.img_size)
        self.hyp = dict(hyp or {})
        self.augment = augment
        self.max_labels = int(max_labels)
        self.stride = stride
        self._load_labels(cache_dir)
        if single_cls:
            self.cls = [np.zeros_like(c) for c in self.cls]
        if cache_images not in (None, "", "ram", "disk"):
            raise ValueError(
                f"cache_images must be ram|disk, got {cache_images!r}")
        if cache_images == "disk" and not cache_dir:
            raise ValueError("cache_images='disk' requires cache_dir")
        self.cache_images = cache_images or None
        self._ram_cache: dict = {}
        # keyed by the dataset's identity: train and val share cache_dir
        self._disk_cache_dir = (
            Path(cache_dir) / f"imgs_{self.img_size}_{self._cache_key()}"
            if cache_images == "disk" else None)
        if self._disk_cache_dir is not None:
            self._disk_cache_dir.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _verify_images(files):
        """Drop unreadable or corrupt images (reference verify_image_label,
        datasets.py:949-995): PIL's header check, a 10-pixel minimum and the
        JPEG end marker."""
        from PIL import Image

        good = []
        for f in files:
            try:
                with Image.open(f) as im:
                    im.verify()
                    w, h = im.size
                if w < 10 or h < 10:
                    raise ValueError(f"image too small ({w}x{h})")
                if Path(f).suffix.lower() in (".jpg", ".jpeg"):
                    with open(f, "rb") as fh:
                        fh.seek(-2, 2)
                        if fh.read() != b"\xff\xd9":
                            raise ValueError("truncated JPEG")
                good.append(f)
            except Exception as e:
                print(f"dataset: quarantined {f}: {e}")
        if not good:
            raise FileNotFoundError("all images failed verification")
        return good

    def _cache_key(self):
        h = hashlib.md5()
        for f in self.img_files:
            h.update(f.encode())
        h.update(str(len(self.img_files)).encode())
        h.update(",".join(self.names).encode())
        return h.hexdigest()[:16]

    def _load_labels(self, cache_dir):
        """Parse every label file, or read them from ``cache_dir``'s
        ``labels_<key>.npz`` (the JAX package's file: object arrays of the
        per-image polys and classes)."""
        cache_path = None
        if cache_dir:
            cache_path = Path(cache_dir) / f"labels_{self._cache_key()}.npz"
            if cache_path.exists():
                z = np.load(cache_path, allow_pickle=True)
                self.polys = [np.asarray(p, np.float32).reshape(-1, 8)
                              for p in z["polys"]]
                self.cls = [np.asarray(c, np.float32).reshape(-1)
                            for c in z["cls"]]
                return
        self.polys, self.cls = [], []
        for lf in self.label_files:
            p, c = parse_dota_annotation(lf, self.name_to_id)
            self.polys.append(p)
            self.cls.append(c)
        if cache_path is not None:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache_path, polys=np.array(self.polys, dtype=object),
                     cls=np.array(self.cls, dtype=object))

    def __len__(self):
        return len(self.img_files)

    def load_image(self, i):
        """Read (BGR) and resize so max(h, w) == img_size, scaling the
        labels with it → (img, polys, cls, (h0, w0)); bilinear when
        augmenting or enlarging, area otherwise.  With ``cache_images`` the
        resized image is cached and a copy returned (the augmentations
        write in place)."""
        cached = self._cached_image(i)
        if cached is not None:
            img, r, (h0, w0) = cached
            polys = self.polys[i] * r if r != 1 else self.polys[i]
            return img, polys.copy(), self.cls[i].copy(), (h0, w0)
        import cv2

        img = cv2.imread(self.img_files[i])
        if img is None:
            raise FileNotFoundError(f"image not found: {self.img_files[i]}")
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        polys = self.polys[i]
        if r != 1:
            img = cv2.resize(img, (int(w0 * r), int(h0 * r)),
                             interpolation=cv2.INTER_LINEAR
                             if (self.augment or r > 1) else cv2.INTER_AREA)
            polys = polys * r
        self._store_image(i, img, r, (h0, w0))
        return img, polys.copy(), self.cls[i].copy(), (h0, w0)

    def _cached_image(self, i):
        """(resized image copy, scale, (h0, w0)) on a cache hit, else None."""
        if self.cache_images == "ram":
            hit = self._ram_cache.get(i)
            if hit is not None:
                img, r, hw0 = hit
                return img.copy(), r, hw0
        elif self.cache_images == "disk":
            p = self._disk_cache_dir / f"{i}.npz"
            if p.exists():
                z = np.load(p)
                return (z["img"], float(z["r"]),
                        tuple(int(v) for v in z["hw0"]))
        return None

    def _store_image(self, i, img, r, hw0):
        if self.cache_images == "ram":
            self._ram_cache[i] = (img.copy(), r, hw0)
        elif self.cache_images == "disk":
            p = self._disk_cache_dir / f"{i}.npz"
            if not p.exists():
                np.savez(p, img=img, r=np.float64(r),
                         hw0=np.asarray(hw0, np.int64))

    def _encode(self, polys, cls, img_shape):
        """polys/cls → padded (max_labels, 186) targets + mask; a box is
        kept when its centre lies in the image and (l > 5 or s > 5); the CSL
        window is hyp ``csl_radius`` (6)."""
        M = self.max_labels
        out = np.zeros((M, TARGET_COLS), np.float32)
        mask = np.zeros((M,), bool)
        if len(polys):
            radius = float(self.hyp.get("csl_radius", 6.0))
            rb, csl = poly2rbox_csl(polys.astype(np.float64), radius=radius)
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

    def get_train_sample(self, index: int, rng: np.random.Generator):
        """The augmented sample (RGB HWC uint8 image, targets, mask, index):
        a 4- or 9-image mosaic (then copy-paste and mixup) or the
        letterboxed image under ``random_perspective``; then the extras,
        HSV and the flips, each as ``hyp`` asks and ``rng`` draws."""
        hyp = self.hyp
        if self.augment and rng.random() < hyp.get("mosaic", 0.0):
            use9 = rng.random() < hyp.get("mosaic9", 0.0)
            k = 8 if use9 else 3
            idxs = [index] + list(rng.integers(0, len(self), k))
            rng.shuffle(idxs)

            def load(i):
                img, polys, cls, _ = self.load_image(i)
                return img, polys, cls

            mosaic_fn = A.mosaic9 if use9 else A.mosaic4
            img, polys, cls = mosaic_fn(load, idxs, self.img_size, rng, hyp)
            if hyp.get("copy_paste", 0.0) > 0:
                img, polys, cls = A.copy_paste(img, polys, cls, rng,
                                               p=hyp["copy_paste"])
            if rng.random() < hyp.get("mixup", 0.0):
                j = int(rng.integers(0, len(self)))
                jdxs = [j] + list(rng.integers(0, len(self), 3))
                img2, polys2, cls2 = A.mosaic4(load, jdxs, self.img_size,
                                               rng, hyp)
                img, polys, cls = A.mixup(img, polys, cls, img2, polys2,
                                          cls2, rng)
        else:
            img, polys, cls, _ = self.load_image(index)
            img, ratio, pad = A.letterbox(img, self.img_size, auto=False,
                                          scaleup=self.augment)
            if len(polys):
                polys = polys.copy()
                polys[:, 0::2] = polys[:, 0::2] * ratio[0] + pad[0]
                polys[:, 1::2] = polys[:, 1::2] * ratio[1] + pad[1]
            if self.augment:
                img, polys, cls = A.random_perspective(
                    img, polys, cls, rng, **A.perspective_args(hyp))

        if self.augment:
            if hyp.get("extra_aug", 0.0) > 0:
                img = np.ascontiguousarray(img)
                A.extra_augment(img, rng, p=hyp["extra_aug"])
            A.hsv_augment(img, rng, hyp.get("hsv_h", 0.015),
                          hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4))
            if rng.random() < hyp.get("flipud", 0.0):
                img = np.flipud(img)
                if len(polys):
                    polys = A.flip_polys_ud(polys, img.shape[0])
            if rng.random() < hyp.get("fliplr", 0.0):
                img = np.fliplr(img)
                if len(polys):
                    polys = A.flip_polys_lr(polys, img.shape[1])

        targets, mask = self._encode(polys, cls, img.shape)
        return {
            "image": np.ascontiguousarray(img[:, :, ::-1]),  # BGR → RGB
            "targets": targets,
            "target_mask": mask,
            "index": np.int32(index),
        }

    def get_eval_sample(self, index: int):
        """Letterboxed, un-augmented sample (RGB HWC uint8) + its targets and
        the metadata that maps the canvas back to the original image."""
        img, polys, cls, (h0, w0) = self.load_image(index)
        lh = img.shape[0]
        img, ratio, pad = A.letterbox(img, self.eval_canvas, scaleup=False)
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
