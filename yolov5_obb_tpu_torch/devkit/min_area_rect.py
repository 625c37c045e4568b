"""Minimum-area rectangle as OpenCV 5.0 computes it, in NumPy float32.

``cv2.boxPoints(cv2.minAreaRect(points))``, operation for operation: the
convex hull ``cv2.convexHull(points, clockwise=False)`` returns (Sklansky's
scan over the points sorted by x, then y, with its cyclic shift into one
ascending or descending run of input indices), the rotating calipers over
that hull (the caliper to turn chosen by cross products of the edges turned
into one frame; areas compared with ``<=``, so the last minimum wins), the
``RotatedRect`` built from the winning caliper (angle in degrees from
``atan2``, in float64) and its four float32 corners.

The same steps as ``native/min_area_rect.cpp``, which :func:`min_area_rect`
calls where ``g++`` is present; this module is the path without a compiler,
held bit for bit to the library and to cv2 by the tests.  Each float32
operation here rounds on its own, as the library's do (``-ffp-contract=off``).
"""

from __future__ import annotations

import math

import numpy as np

from .. import native

F = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(ptr, start: int, end: int, nsign: int, sign2: int) -> list:
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or ptr[start] == ptr[end]:
        return [start]
    stack = [pprev, pcur, pnext] + [0] * abs(end - start)
    size = 3
    end += incr
    while pnext != end:
        cury, nexty = ptr[pcur][1], ptr[pnext][1]
        by = F(nexty - cury)
        if _sign(by) != nsign:
            ax = F(ptr[pcur][0] - ptr[pprev][0])
            bx = F(ptr[pnext][0] - ptr[pcur][0])
            ay = F(cury - ptr[pprev][1])
            convexity = F(F(ay * bx) - F(ax * by))
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[size - 2] = pnext
                pcur = pprev
                pprev = stack[size - 4]
                size -= 1
        else:
            pnext += incr
            stack[size - 1] = pnext
    return stack[:size - 1]


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(pts, clockwise=False)`` of float32 ``(m, 2)``."""
    m = len(pts)
    order = sorted(range(m), key=lambda i: (pts[i, 0], pts[i, 1], i))
    ptr = [(pts[i, 0], pts[i, 1]) for i in order]
    miny = maxy = 0
    for i in range(1, m):
        if ptr[miny][1] > ptr[i][1]:
            miny = i
        if ptr[maxy][1] < ptr[i][1]:
            maxy = i
    if ptr[0] == ptr[m - 1]:
        return pts[[0]]
    # upper half, counter-clockwise (the left and right chains swapped)
    tr = _sklansky(ptr, 0, maxy, -1, 1)
    tl = _sklansky(ptr, m - 1, maxy, -1, -1)
    hull = [order[i] for i in tl[:-1]] + [order[i] for i in tr[:0:-1]]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(ptr, 0, miny, 1, -1)
    br = _sklansky(ptr, m - 1, miny, 1, 1)
    if stop >= 0:
        check = (bl[1] if len(bl) > 2 else br[2 - len(bl)]
                 if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0 and ptr[check] == ptr[stop]):
            bl, br = bl[:2], br[:2]  # all the points on one line
    hull += [order[i] for i in bl[:-1]] + [order[i] for i in br[:0:-1]]
    n = len(hull)
    if n >= 3:  # one ascending or descending run of indices, where there is
        up = sum(hull[i] < hull[(i + 1) % n] for i in range(n))
        i0 = (hull.index(min(hull)) if up == n - 1
              else hull.index(max(hull)) if up == 1 else 0)
        hull = hull[i0:] + hull[:i0]
    return pts[hull]


def _calipers(p):
    """The winning caliper's corner and side vectors (float32)."""
    n = len(p)
    vect, inv = [], []
    left = bottom = right = top = 0
    x0, y0 = p[0]
    left_x = right_x = x0
    top_y = bottom_y = y0
    for i in range(n):
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        x1, y1 = p[(i + 1) % n]
        dx, dy = F(x1 - x0), F(y1 - y0)
        vect.append((dx, dy))
        inv.append(F(1.0 / math.sqrt(float(dx) ** 2 + float(dy) ** 2)))
        x0, y0 = x1, y1
    seq = [bottom, right, top, left]
    minarea = F(np.finfo(np.float32).max)
    best = (F(0), F(0), F(0), F(0), 0, 0)
    for _ in range(n):
        v0, v1, v2, v3 = (vect[s] for s in seq)
        turned = (v0, (v1[1], -v1[0]), (-v2[0], -v2[1]))
        main = 1 if 0 > F(F(-v1[0] * v0[0]) - F(v1[1] * v0[1])) else 0
        r = turned[main]
        if 0 > F(F(-v2[1] * r[0]) + F(v2[0] * r[1])):
            main, r = 2, turned[2]
        if 0 > F(F(r[0] * v3[0]) + F(r[1] * v3[1])):
            main = 3
        k = seq[main]
        lx, ly = F(vect[k][0] * inv[k]), F(vect[k][1] * inv[k])
        a, b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = 0 if k + 1 == n else k + 1
        dx = F(p[seq[1], 0] - p[seq[3], 0])
        dy = F(p[seq[1], 1] - p[seq[3], 1])
        width = F(F(dx * a) + F(dy * b))
        dx = F(p[seq[2], 0] - p[seq[0], 0])
        dy = F(p[seq[2], 1] - p[seq[0], 1])
        height = F(F(dy * a) - F(dx * b))
        area = F(width * height)
        if not minarea < area:
            minarea = area
            best = (a, b, width, height, seq[3], seq[0])
    a1, b1, w, h, il, ib = best
    a2, b2 = -b1, a1
    c1 = F(F(a1 * p[il, 0]) + F(p[il, 1] * b1))
    c2 = F(F(a2 * p[ib, 0]) + F(p[ib, 1] * b2))
    idet = F(F(1) / F(F(a1 * b2) - F(a2 * b1)))
    px = F(F(F(c1 * b2) - F(c2 * b1)) * idet)
    py = F(F(F(a1 * c2) - F(a2 * c1)) * idet)
    return (px, py), (F(a1 * w), F(b1 * w)), (F(a2 * h), F(b2 * h))


def _length(x, y) -> np.float32:
    return F(math.sqrt(float(x) ** 2 + float(y) ** 2))


def min_area_rect_np(pts):
    """``(box (5,) [cx cy w h angle°], corners (4, 2))`` float32, as
    ``cv2.minAreaRect`` and ``cv2.boxPoints`` give them."""
    hull = convex_hull(np.ascontiguousarray(pts, np.float32).reshape(-1, 2))
    cx = cy = w = h = F(0)
    angle = F(-90)
    if len(hull) > 2:
        (px, py), (ax, ay), (bx, by) = _calipers(hull)
        cx = F(px + F(F(ax + bx) * F(0.5)))
        cy = F(py + F(F(ay + by) * F(0.5)))
        w, h = _length(bx, by), _length(ax, ay)
        if ax == 0 and ay > 0:  # side 1 points straight up
            w, h = h, w
        else:
            angle = F(math.atan2(float(ax), float(ay)) * -180.0 / math.pi)
    elif len(hull) == 2:
        (x0, y0), (x1, y1) = hull
        cx, cy = F(F(x0 + x1) * F(0.5)), F(F(y0 + y1) * F(0.5))
        dx, dy = F(x0 - x1), F(y0 - y1)
        h = _length(dx, dy)
        if dx == 0:
            w, h = h, F(0)
        elif 0 > dy:
            w, h = h, F(0)
            angle = F(math.atan2(float(dy), float(dx)) * 180.0 / math.pi)
        elif dy > 0:
            angle = F(math.atan2(float(dx), float(dy)) * -180.0 / math.pi)
    elif len(hull) == 1:
        cx, cy = hull[0]
    rad = float(angle) * math.pi / 180.0
    b, a = F(F(math.cos(rad)) * F(0.5)), F(F(math.sin(rad)) * F(0.5))
    ah, bh, aw, bw = F(a * h), F(b * h), F(a * w), F(b * w)
    corners = np.array([[F(cx - ah) - bw, F(cy + bh) - aw],
                        [F(cx + ah) - bw, F(cy - bh) - aw],
                        [F(cx + ah) + bw, F(cy - bh) + aw],
                        [F(cx - ah) + bw, F(cy + bh) + aw]], np.float32)
    return np.array([cx, cy, w, h, angle], np.float32), corners


def min_area_rect(pts, use_native: bool = True):
    """:func:`min_area_rect_np`, through ``native/min_area_rect.cpp`` where
    it builds."""
    if use_native:
        out = native.min_area_rect_native(pts)
        if out is not None:
            return out
    return min_area_rect_np(pts)
