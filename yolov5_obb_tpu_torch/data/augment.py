"""Host-side image and polygon augmentations (numpy; OpenCV inside the
calls that resize, warp, blur, convert or fill).

Counterpart of ``yolov5_obb_tpu/data/augment.py``: ``letterbox`` (:25),
``hsv_augment`` (:56), ``random_perspective`` (:71), ``flip_polys_ud`` /
``flip_polys_lr`` (:122-133), ``extra_augment`` (:134), ``mixup`` (:160),
``mosaic4`` (:167), ``mosaic9`` (:224), ``copy_paste`` (:287) and ``cutout``
(:324).  Every geometric transform moves all four polygon corners; a box is
kept while its HBB centre stays inside the image (no corner clipping).

All randomness comes from the ``np.random.Generator`` passed in, drawn in
the JAX package's order, and the pixel transforms are the same OpenCV calls:
a seeded sample is the JAX package's bit for bit.  ``cv2`` is imported
inside the calls that need it, so the package imports without it.
"""

from __future__ import annotations

import math

import numpy as np

from ..ops.geometry import poly2hbb, poly_filter, xywh2xyxy

PAD_COLOR = (114, 114, 114)


def letterbox(img, new_shape, color=PAD_COLOR, auto=False, scale_fill=False,
              scaleup=True, stride=32):
    """Aspect-preserving resize + constant pad to ``new_shape`` (reference
    augmentations.py:92-128): ``auto`` pads only to the next multiple of
    ``stride``, ``scale_fill`` stretches with no pad.  Returns ``(img, (rw,
    rh), (dw, dh))`` with ``dw``/``dh`` the one-side paddings.  The border
    is filled in numpy, as ``cv2.copyMakeBorder`` fills it."""
    h, w = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = int(round(w * r)), int(round(h * r))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / w, new_shape[0] / h)
    dw /= 2
    dh /= 2
    if (w, h) != new_unpad:
        import cv2

        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    h, w, c = img.shape
    out = np.empty((h + top + bottom, w + left + right, c), img.dtype)
    out[...] = color
    out[top:top + h, left:left + w] = img
    return out, ratio, (dw, dh)


def hsv_augment(img, rng: np.random.Generator, hgain=0.5, sgain=0.5,
                vgain=0.5):
    """In-place LUT HSV jitter of a BGR image (reference
    augmentations.py:48-61)."""
    if not (hgain or sgain or vgain):
        return img
    import cv2

    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    im_hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                        cv2.LUT(val, lut_v)))
    cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def random_perspective(img, polys, cls, rng: np.random.Generator,
                       degrees=10.0, translate=0.1, scale=0.1, shear=10.0,
                       perspective=0.0, border=(0, 0)):
    """Random affine (or perspective) warp of the image and every polygon
    corner (reference augmentations.py:131-222): ``M = T@S@R@P@C``, then
    the centre-inside keep mask.  Returns ``(img, polys, cls)``."""
    import cv2

    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height),
                                      borderValue=PAD_COLOR)
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                                 borderValue=PAD_COLOR)

    n = len(polys)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = polys.reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective
              else xy[:, :2]).reshape(n, 8)
        keep = poly_filter(xy, h=height, w=width)
        polys, cls = xy[keep], cls[keep]
    return img, polys, cls


def flip_polys_ud(polys, img_h):
    out = polys.copy()
    out[:, 1::2] = img_h - polys[:, 1::2] - 1
    return out


def flip_polys_lr(polys, img_w):
    out = polys.copy()
    out[:, 0::2] = img_w - polys[:, 0::2] - 1
    return out


def extra_augment(img, rng: np.random.Generator, p: float = 0.01):
    """Photometric extras, in place, each with probability ``p``: box blur,
    median blur, greyscale, CLAHE on luma (reference
    augmentations.py:17-45's Albumentations block; hyp ``extra_aug``).
    Pixels only: the polygons do not move."""
    import cv2

    if rng.random() < p:  # box blur
        k = int(rng.integers(3, 8)) | 1
        img[:] = cv2.blur(img, (k, k))
    if rng.random() < p:  # median blur
        k = int(rng.integers(3, 8)) | 1
        img[:] = cv2.medianBlur(img, k)
    if rng.random() < p:  # greyscale
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img[:] = g[..., None]
    if rng.random() < p:  # CLAHE on luma
        yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV)
        clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        yuv[..., 0] = clahe.apply(yuv[..., 0])
        img[:] = cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)
    return img


def mixup(img1, polys1, cls1, img2, polys2, cls2, rng: np.random.Generator):
    """Beta(32, 32) blend of two images, the union of their labels
    (reference augmentations.py:276-281)."""
    r = rng.beta(32.0, 32.0)
    img = (img1 * r + img2 * (1 - r)).astype(np.uint8)
    return (img, np.concatenate([polys1, polys2], 0),
            np.concatenate([cls1, cls2], 0))


def perspective_args(hyp: dict) -> dict:
    """``random_perspective``'s keyword arguments from a hyp dict."""
    return dict(degrees=hyp.get("degrees", 0.0),
                translate=hyp.get("translate", 0.1),
                scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                perspective=hyp.get("perspective", 0.0))


def mosaic4(load_fn, indices, img_size: int, rng: np.random.Generator,
            hyp: dict):
    """4-image mosaic around a random centre of a ``2s x 2s`` canvas, then
    ``random_perspective`` cropping the mosaic border (reference
    datasets.py:725-785).  ``load_fn(i)`` → ``(img BGR resized to long side
    img_size, polys (n, 8) pixels, cls (n,))``."""
    s = img_size
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    polys4, cls4 = [], []
    img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    for i, index in enumerate(indices):
        img, polys, cls = load_fn(index)
        h, w = img.shape[:2]
        if i == 0:
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        if len(polys):
            p = polys.copy()
            p[:, 0::2] += x1a - x1b
            p[:, 1::2] += y1a - y1b
            polys4.append(p)
            cls4.append(cls)

    if polys4:
        polys4 = np.concatenate(polys4, 0)
        cls4 = np.concatenate(cls4, 0)
        keep = poly_filter(polys4, h=2 * s, w=2 * s)
        polys4, cls4 = polys4[keep], cls4[keep]
    else:
        polys4 = np.zeros((0, 8), np.float32)
        cls4 = np.zeros((0,), np.float32)
    return random_perspective(img4, polys4, cls4, rng, border=border,
                              **perspective_args(hyp))


def mosaic9(load_fn, indices, img_size: int, rng: np.random.Generator,
            hyp: dict):
    """9-image mosaic on a ``3s x 3s`` canvas, a random ``2s x 2s`` crop,
    then ``random_perspective`` (reference datasets.py:788-874)."""
    s = img_size
    tiles = [load_fn(i) for i in indices]
    img9 = np.full((s * 3, s * 3, 3), 114, dtype=np.uint8)
    polys9, cls9 = [], []
    hp = wp = 0
    h0 = w0 = 0
    for i, (img, polys, cls) in enumerate(tiles):
        h, w = img.shape[:2]
        if i == 0:  # centre
            h0, w0 = h, w
            c = s, s, s + w, s + h
        elif i == 1:  # top
            c = s, s - h, s + w, s
        elif i == 2:  # top right
            c = s + wp, s - h, s + wp + w, s
        elif i == 3:  # right
            c = s + w0, s, s + w0 + w, s + h
        elif i == 4:  # bottom right
            c = s + w0, s + hp, s + w0 + w, s + hp + h
        elif i == 5:  # bottom
            c = s + w0 - w, s + h0, s + w0, s + h0 + h
        elif i == 6:  # bottom left
            c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
        elif i == 7:  # left
            c = s - w, s + h0 - h, s, s + h0
        else:  # top left
            c = s - w, s + h0 - hp - h, s, s + h0 - hp
        padw, padh = c[0], c[1]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        img9[y1:y2, x1:x2] = img[y1 - padh:, x1 - padw:][:y2 - y1, :x2 - x1]
        hp, wp = h, w
        if len(polys):
            p = polys.copy()
            p[:, 0::2] += padw
            p[:, 1::2] += padh
            polys9.append(p)
            cls9.append(cls)

    # crop the centre 2s x 2s at a random offset (reference :858-866)
    yc = int(rng.uniform(0, s))
    xc = int(rng.uniform(0, s))
    img9 = img9[yc:yc + 2 * s, xc:xc + 2 * s]
    if polys9:
        polys9 = np.concatenate(polys9, 0)
        cls9 = np.concatenate(cls9, 0)
        polys9[:, 0::2] -= xc
        polys9[:, 1::2] -= yc
        keep = poly_filter(polys9, h=2 * s, w=2 * s)
        polys9, cls9 = polys9[keep], cls9[keep]
    else:
        polys9 = np.zeros((0, 8), np.float32)
        cls9 = np.zeros((0,), np.float32)
    return random_perspective(img9, polys9, cls9, rng,
                              border=(-s // 2, -s // 2),
                              **perspective_args(hyp))


def copy_paste(img, polys, cls, rng: np.random.Generator, p: float = 0.0):
    """Copy-paste for OBBs: mirror object patches left-right and paste them
    where their cover does not collide with an existing box's (reference
    augmentations.py:225-246, segments replaced by polygon masks)."""
    if p <= 0 or not len(polys):
        return img, polys, cls
    import cv2

    h, w = img.shape[:2]
    n = max(1, int(len(polys) * p))
    hbb = poly2hbb(polys)
    new_polys, new_cls = [polys], [cls]
    for j in rng.permutation(len(polys))[:n]:
        flipped = polys[j].copy()
        flipped[0::2] = w - flipped[0::2]
        fx, fy = flipped[0::2], flipped[1::2]
        # skip if the mirrored location overlaps an existing box's cover
        bx1, bx2 = fx.min(), fx.max()
        by1, by2 = fy.min(), fy.max()
        ox1 = np.maximum(hbb[:, 0] - hbb[:, 2] / 2, bx1)
        ox2 = np.minimum(hbb[:, 0] + hbb[:, 2] / 2, bx2)
        oy1 = np.maximum(hbb[:, 1] - hbb[:, 3] / 2, by1)
        oy2 = np.minimum(hbb[:, 1] + hbb[:, 3] / 2, by2)
        inter = np.clip(ox2 - ox1, 0, None) * np.clip(oy2 - oy1, 0, None)
        if (inter > 0.3 * (bx2 - bx1) * (by2 - by1)).any():
            continue
        src = polys[j].reshape(4, 2).astype(np.int32)
        mask = np.zeros((h, w), np.uint8)
        cv2.fillPoly(mask, [src], 1)
        patch = cv2.flip(img, 1)
        mflip = cv2.flip(mask, 1).astype(bool)
        img[mflip] = patch[mflip]
        new_polys.append(flipped[None])
        new_cls.append(cls[j:j + 1])
    return img, np.concatenate(new_polys, 0), np.concatenate(new_cls, 0)


def cutout(img, polys, cls, rng: np.random.Generator, p: float = 0.5):
    """Random grey squares; boxes whose cover becomes 60% hidden are
    dropped (reference augmentations.py:249-273).  Numpy only."""
    if rng.random() >= p:
        return img, polys, cls
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
    for s in scales:
        mh, mw = int(rng.uniform(0.02, s) * h), int(rng.uniform(0.02, s) * w)
        xmin = max(0, int(rng.uniform(0, w)) - mw // 2)
        ymin = max(0, int(rng.uniform(0, h)) - mh // 2)
        xmax = min(w, xmin + mw)
        ymax = min(h, ymin + mh)
        img[ymin:ymax, xmin:xmax] = rng.integers(64, 191, 3, dtype=np.uint8)
        if len(polys):
            box = np.array([xmin, ymin, xmax, ymax], np.float64)
            bb = xywh2xyxy(poly2hbb(polys))
            ix1 = np.maximum(bb[:, 0], box[0])
            iy1 = np.maximum(bb[:, 1], box[1])
            ix2 = np.minimum(bb[:, 2], box[2])
            iy2 = np.minimum(bb[:, 3], box[3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            area = np.clip(bb[:, 2] - bb[:, 0], 1e-9, None) * np.clip(
                bb[:, 3] - bb[:, 1], 1e-9, None)
            keep = inter / area < 0.6
            polys, cls = polys[keep], cls[keep]
    return img, polys, cls
