"""COCO-like access to a DOTA dataset directory (``images/`` +
``labelTxt/``) and the label parsers.

Copy of the JAX package's ``devkit/dota_api.py`` (the reference
DOTA_devkit/DOTA.py and dota_utils).  ``cv2`` reads and draws images,
imported inside the two methods that do.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..data.dota import IMG_EXTS

# the JAX package's utils/plots.py class colours (BGR)
_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def parse_dota_poly(label_file):
    """One labelTxt file → list of dicts {name, poly (4,2), difficult}
    (reference dota_utils.parse_dota_poly:47-90)."""
    objects = []
    p = Path(label_file)
    if not p.exists():
        return objects
    for line in p.read_text().splitlines():
        parts = line.split()
        if len(parts) < 9:
            continue
        try:
            coords = np.array([float(v) for v in parts[:8]]).reshape(4, 2)
        except ValueError:
            continue
        objects.append(
            {
                "name": parts[8],
                "poly": coords,
                "difficult": int(parts[9]) if len(parts) > 9 and parts[9].isdigit() else 0,
                "area": _shoelace(coords),
            }
        )
    return objects


def parse_dota_rec(label_file):
    """Like parse_dota_poly but with axis-aligned xyxy bounds
    (reference dota_utils.parse_dota_rec:110-133)."""
    out = []
    for o in parse_dota_poly(label_file):
        p = o["poly"]
        o = dict(o)
        o["bndbox"] = [p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
        out.append(o)
    return out


def _shoelace(pts):
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


class DOTA:
    """Index over images/ + labelTxt/ with COCO-style queries."""

    def __init__(self, basepath):
        self.basepath = Path(basepath)
        self.image_dir = self.basepath / "images"
        self.label_dir = self.basepath / "labelTxt"
        self.img_paths = {
            f.stem: f
            for f in sorted(self.image_dir.rglob("*"))
            if f.suffix.lower() in IMG_EXTS
        }
        self.anns = {
            stem: parse_dota_poly(self.label_dir / f"{stem}.txt")
            for stem in self.img_paths
        }
        self.cat_to_imgs = defaultdict(set)
        for stem, objs in self.anns.items():
            for o in objs:
                self.cat_to_imgs[o["name"]].add(stem)

    def get_img_ids(self, cat_names=()):
        """Image ids containing ALL the given categories (reference DOTA.py:35-55)."""
        if not cat_names:
            return sorted(self.img_paths)
        sets = [self.cat_to_imgs.get(c, set()) for c in cat_names]
        return sorted(set.intersection(*sets)) if sets else []

    def load_anns(self, cat_names=(), img_id=None, difficult=None):
        ids = [img_id] if img_id else self.get_img_ids(cat_names)
        out = []
        for i in ids:
            for o in self.anns.get(i, []):
                if cat_names and o["name"] not in cat_names:
                    continue
                if difficult is not None and o["difficult"] != difficult:
                    continue
                out.append({**o, "image_id": i})
        return out

    def load_imgs(self, img_ids):
        import cv2

        if isinstance(img_ids, str):
            img_ids = [img_ids]
        return [cv2.imread(str(self.img_paths[i])) for i in img_ids]

    def show_anns(self, img_id, save_path=None):
        """Draw annotations on the image (reference DOTA.py:57-91)."""
        import cv2

        img = self.load_imgs(img_id)[0]
        cats = sorted({o["name"] for o in self.anns.get(img_id, [])})
        for o in self.anns.get(img_id, []):
            color = _PALETTE[cats.index(o["name"]) % len(_PALETTE)]
            pts = o["poly"].reshape(4, 2).astype(np.int32)
            cv2.drawContours(img, [pts], 0, color, 2)
            x, y = pts[:, 0].min(), pts[:, 1].min() - 4
            cv2.putText(img, o["name"], (int(x), max(int(y), 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                        cv2.LINE_AA)
        if save_path:
            cv2.imwrite(str(save_path), img)
        return img
