"""DOTA image tiling: split large aerial images into overlapping tiles.

Counterpart of the JAX package's ``devkit/img_split.py`` (the reference
DOTA_devkit/ImgSplit_multi_process.py):

* a sliding ``subsize`` x ``subsize`` window with ``gap`` overlap (stride
  ``subsize - gap``);
* a GT polygon lying whole in a tile is kept as it is; a polygon the window
  cuts is clipped to it and marked difficult ``2`` when its
  intersection-over-area is ``thresh`` (0.7) or less;
* a 5-point clip becomes 4 points by merging its shortest edge, a clip of
  3 or more than 5 points becomes its minimum-area rectangle
  (:func:`_min_area_rect`: the corners the JAX package's
  ``cv2.minAreaRect`` call gives, without OpenCV);
* tile names are ``{stem}__{rate}__{left}___{up}``.

The tiling itself is :func:`split_image_array` (arrays in, tiles and label
lines out) and needs no OpenCV; :func:`split_single_image` and
:func:`split_dataset` read, resize and write files around it with ``cv2``,
imported inside them.
"""

from __future__ import annotations

import multiprocessing
from functools import partial
from pathlib import Path

import numpy as np

from ..data.dota import IMG_EXTS
from .min_area_rect import min_area_rect
from .poly_iou import clip_polygon, poly_area


def _best_point_order(poly: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Rotate ``poly`` (4, 2) cyclically to the least L2 distance to ``ref``
    (reference choose_best_pointorder_fit_another)."""
    best, best_d = poly, np.inf
    for k in range(4):
        cand = np.roll(poly, -k, axis=0)
        d = np.sum((cand - ref) ** 2)
        if d < best_d:
            best, best_d = cand, d
    return best


def _poly5to4(poly: np.ndarray) -> np.ndarray:
    """Merge the shortest edge of a 5-gon into its midpoint (reference
    GetPoly4FromPoly5)."""
    n = len(poly)
    dists = [np.linalg.norm(poly[i] - poly[(i + 1) % n]) for i in range(n)]
    i = int(np.argmin(dists))
    mid = (poly[i] + poly[(i + 1) % n]) / 2
    out = [mid if k == i else poly[k] for k in range(n) if k != (i + 1) % n]
    return np.asarray(out)


def _min_area_rect(pts: np.ndarray) -> np.ndarray:
    """Minimum-area rectangle of a point ring ``(m, 2)`` → its four corners
    ``(4, 2)`` float64, those of ``cv2.boxPoints(cv2.minAreaRect(pts))`` bit
    for bit on the float32 points (:mod:`.min_area_rect`: OpenCV 5.0's
    steps in C++ where ``g++`` builds them, else in NumPy)."""
    return min_area_rect(pts)[1].astype(np.float64)


def clip_poly_to_tile(poly8: np.ndarray, left: float, up: float, size: int,
                      thresh: float = 0.7):
    """Clip one GT polygon against a tile window.

    Returns ``(poly8 in tile coordinates | None, difficult_suffix)``, the
    suffix ``''`` (keep the object's flag) or ``'2'`` (force difficult)."""
    quad = poly8.reshape(4, 2)
    window = np.array([[left, up], [left + size, up],
                       [left + size, up + size], [left, up + size]],
                      np.float64)
    inter = clip_polygon(quad.astype(np.float64), window)
    if len(inter) < 3:
        return None, ""
    a_poly = poly_area(quad.astype(np.float64))
    if a_poly <= 0:
        return None, ""
    ioa = poly_area(inter) / a_poly
    if ioa >= 1 - 1e-6:
        out = quad.astype(np.float64)
        flag = ""
    else:
        if len(inter) == 4:
            out = inter
        elif len(inter) == 5:
            out = _poly5to4(inter)
        else:
            out = _min_area_rect(inter).reshape(4, 2)
        out = _best_point_order(out, quad)
        flag = "" if ioa > thresh else "2"
    out = out - np.array([left, up])
    out = np.clip(out, 0, size)
    return out.reshape(-1), flag


def _tile_origins(length: int, subsize: int, slide: int):
    """Window origins covering ``[0, length)`` (reference :252-273)."""
    out = [0]
    while out[-1] + subsize < length:
        nxt = min(out[-1] + slide, max(length - subsize, 0))
        if nxt == out[-1]:
            break
        out.append(nxt)
    return out


def read_split_objects(label_path, rate: float = 1.0) -> list:
    """A DOTA label file → ``[(poly8 * rate, class name, difficult)]``; an
    absent file gives no objects."""
    objs = []
    if label_path is None or not Path(label_path).exists():
        return objs
    for line in Path(label_path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 9:
            continue
        try:
            coords = np.array([float(v) for v in parts[:8]], np.float64) * rate
        except ValueError:
            continue
        objs.append((coords, parts[8], parts[9] if len(parts) > 9 else "0"))
    return objs


def split_image_array(img: np.ndarray, objs, stem: str, rate: float = 1.0,
                      subsize: int = 1024, gap: int = 200,
                      thresh: float = 0.7, padding: bool = True):
    """Tile one image array (already scaled by ``rate``) and its objects
    (:func:`read_split_objects`): yields ``(tile name, tile, label lines)``
    row by row, as the JAX ``split_single_image`` (:108-170) writes them."""
    h, w = img.shape[:2]
    slide = subsize - gap
    for up in _tile_origins(h, subsize, slide):
        for left in _tile_origins(w, subsize, slide):
            tile = img[up: up + subsize, left: left + subsize]
            if padding and (tile.shape[0] < subsize
                            or tile.shape[1] < subsize):
                pad = np.zeros((subsize, subsize, 3), img.dtype)
                pad[: tile.shape[0], : tile.shape[1]] = tile
                tile = pad
            lines = []
            for coords, cls_name, diff in objs:
                clipped, force_diff = clip_poly_to_tile(
                    coords, left, up, subsize, thresh)
                if clipped is None:
                    continue
                d = force_diff or diff
                lines.append(" ".join(f"{v:.1f}" for v in clipped)
                             + f" {cls_name} {d}")
            yield f"{stem}__{rate}__{left}___{up}", tile, lines


def write_tile_labels(path, lines) -> None:
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def split_single_image(img_path, label_path, out_img_dir, out_label_dir,
                       rate: float = 1.0, subsize: int = 1024, gap: int = 200,
                       thresh: float = 0.7, ext: str = ".png",
                       padding: bool = True):
    """Tile one image file (and its DOTA labels); returns the tiles
    written."""
    import cv2

    img = cv2.imread(str(img_path))
    if img is None:
        return 0
    if rate != 1.0:
        img = cv2.resize(img, None, fx=rate, fy=rate,
                         interpolation=cv2.INTER_CUBIC)
    objs = read_split_objects(label_path, rate)
    out_img_dir = Path(out_img_dir)
    out_label_dir = Path(out_label_dir)
    out_img_dir.mkdir(parents=True, exist_ok=True)
    out_label_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for name, tile, lines in split_image_array(
            img, objs, Path(img_path).stem, rate, subsize, gap, thresh,
            padding):
        cv2.imwrite(str(out_img_dir / f"{name}{ext}"), tile)
        write_tile_labels(out_label_dir / f"{name}.txt", lines)
        n += 1
    return n


def split_dataset(src_dir, dst_dir, rate: float = 1.0, subsize: int = 1024,
                  gap: int = 200, thresh: float = 0.7, num_workers: int = 8,
                  ext: str = ".png", with_labels: bool = True):
    """Tile a DOTA split directory (``images/`` [+ ``labelTxt/``]) into
    ``dst_dir`` with ``num_workers`` processes; returns the tiles written
    (reference splitbase.splitdata)."""
    src = Path(src_dir)
    imgs = sorted(f for f in (src / "images").rglob("*")
                  if f.suffix.lower() in IMG_EXTS)
    work = partial(
        _split_one, src=src, out_img=Path(dst_dir) / "images",
        out_lab=Path(dst_dir) / "labelTxt", rate=rate, subsize=subsize,
        gap=gap, thresh=thresh, ext=ext, with_labels=with_labels)
    if num_workers > 1 and len(imgs) > 1:
        with multiprocessing.Pool(num_workers) as pool:
            counts = pool.map(work, imgs)
    else:
        counts = [work(f) for f in imgs]
    return int(sum(counts))


def _split_one(img_path, *, src, out_img, out_lab, rate, subsize, gap,
               thresh, ext, with_labels):
    label = (src / "labelTxt" / (Path(img_path).stem + ".txt")
             if with_labels else None)
    return split_single_image(img_path, label, out_img, out_lab, rate=rate,
                              subsize=subsize, gap=gap, thresh=thresh,
                              ext=ext)
