"""Exact polygon IoU in float64 NumPy (Sutherland–Hodgman convex clip and
shoelace areas).

Copy of the JAX package's ``devkit/poly_iou.py``: the same operations in the
same order, so the same bits.  This is the host eval/merge path; the card's
rotated IoU is ``ops/rotated_iou.py`` and its kernels.
"""

from __future__ import annotations

import numpy as np


def poly_area(pts: np.ndarray) -> float:
    """Shoelace area of an ``(n, 2)`` point ring."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1))
                           - np.dot(y, np.roll(x, -1))))


def _ensure_ccw(pts: np.ndarray) -> np.ndarray:
    x, y = pts[:, 0], pts[:, 1]
    signed = float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return pts if signed >= 0 else pts[::-1]


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Clip ``subject`` by the convex ``clip``; returns ``(m, 2)``."""
    clip = _ensure_ccw(np.asarray(clip, dtype=np.float64))
    out = [tuple(p) for p in np.asarray(subject, dtype=np.float64)]
    for i in range(len(clip)):
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        inp, out = out, []
        if not inp:
            break
        edge = (b[0] - a[0], b[1] - a[1])

        def side(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0])

        s = inp[-1]
        s_side = side(s)
        for e in inp:
            e_side = side(e)
            if e_side >= 0:
                if s_side < 0:
                    t = s_side / (s_side - e_side)
                    out.append((s[0] + t * (e[0] - s[0]),
                                s[1] + t * (e[1] - s[1])))
                out.append(e)
            elif s_side >= 0:
                t = s_side / (s_side - e_side)
                out.append((s[0] + t * (e[0] - s[0]),
                            s[1] + t * (e[1] - s[1])))
            s, s_side = e, e_side
    return np.array(out, dtype=np.float64).reshape(-1, 2)


def poly_intersection_area(p1, p2) -> float:
    """Exact intersection area of two convex polygons ``(n, 2)``/``(m, 2)``."""
    inter = clip_polygon(np.asarray(p1, np.float64).reshape(-1, 2),
                         np.asarray(p2, np.float64).reshape(-1, 2))
    if len(inter) < 3:
        return 0.0
    return poly_area(inter)


def poly_iou(p1, p2) -> float:
    """Exact IoU of two polygons, flat ``[x1 y1 ... x4 y4]`` or ``(n, 2)``
    (the reference's ``polyiou.iou_poly``)."""
    p1 = np.asarray(p1, np.float64).reshape(-1, 2)
    p2 = np.asarray(p2, np.float64).reshape(-1, 2)
    inter = poly_intersection_area(p1, p2)
    union = poly_area(p1) + poly_area(p2) - inter
    if union <= 0:
        return 0.0
    return float(inter / union)
