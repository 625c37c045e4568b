"""Rotated-box geometry and CSL angle labels.

Boxes follow the JAX package's convention ``[cx cy l s theta]`` (long side,
short side, angle in radians, ``theta ∈ [-pi/2, pi/2)``); polygons are
``(..., 8)`` corners ``[x1 y1 .. x4 y4]`` and HBBs ``(..., 4) [cx cy w h]``
(JAX ``ops/geometry.py``).  The host half — the angle helpers, the poly /
rbox / hbb conversions, clipping and rescaling that the dataset and the
evaluator use — is numpy; :func:`hbb_cover` is torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def regular_theta(theta, start=-math.pi / 2, cycle=math.pi):
    """Wrap angles into ``[start, start + cycle)`` (JAX geometry.py:36)."""
    return (theta - start) % cycle + start


def csl_gaussian_labels(theta_deg, num_bins: int = 180, radius: float = 6.0):
    """Circular Smooth Labels: a gaussian window wrapped on the angle circle
    (JAX geometry.py:41).

    ``theta_deg (n,)`` angle-class values in ``[0, num_bins)`` (``theta*180/pi
    + 90``); ``radius`` the window's sigma (hyp ``csl_radius``).  Returns
    ``(n, num_bins)`` float32 with peak 1.0 at bin ``num_bins/2 -
    trunc(num_bins/2 - theta_deg)``: a float label snaps by truncation, as in
    the reference ``gaussian_label_cpu``."""
    half = num_bins // 2
    theta_deg = np.asarray(theta_deg)
    idx = np.trunc(half - theta_deg)
    j = np.arange(num_bins, dtype=theta_deg.dtype
                  if theta_deg.dtype.kind == "f" else None)
    d = (j[None, :] + idx[..., None]) % num_bins - half
    return np.exp(-(d.astype(np.float32) ** 2) / (2.0 * float(radius) ** 2))


def hbb_cover(rboxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned cover ``(..., 4)`` = x1 y1 x2 y2 of ``(..., 5)`` rboxes,
    in closed form from |cos θ| and |sin θ| (JAX rotated_nms._hbb_cover)."""
    cx, cy, l, s, t = rboxes.unbind(-1)
    ct, st = torch.cos(t).abs(), torch.sin(t).abs()
    w = l * ct + s * st
    h = l * st + s * ct
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


# ---------------------------------------------------------------------------
# host (numpy) conversions, copies of JAX geometry.py:69-218
# ---------------------------------------------------------------------------


def rbox2poly(rboxes):
    """``(n, 5) [cx cy l s theta]`` → ``(n, 8)`` corners ``c+a+b, c+a-b,
    c-a-b, c-a+b`` with ``a = l/2·(cos t, -sin t)``, ``b = s/2·(-sin t,
    -cos t)`` (reference rbox2poly)."""
    rboxes = np.asarray(rboxes)
    c = rboxes[..., 0:2]
    l, s, t = rboxes[..., 2:3], rboxes[..., 3:4], rboxes[..., 4:5]
    cos, sin = np.cos(t), np.sin(t)
    a = np.concatenate([l / 2 * cos, -l / 2 * sin], axis=-1)
    b = np.concatenate([-s / 2 * sin, -s / 2 * cos], axis=-1)
    pts = np.concatenate([c + a + b, c + a - b, c - a - b, c - a + b], -1)
    return pts.reshape(rboxes.shape[:-1] + (8,))


def poly2rbox(polys, return_angle_deg: bool = False):
    """Batched min-area rect: ``(n, 8)`` polys → ``(n, 5)`` long-edge rboxes
    (the 6 directions spanned by the quad's point pairs contain its hull's
    edges, so the min-area candidate is exact), plus the angle classes
    ``theta_deg + 90`` when ``return_angle_deg``."""
    polys = np.asarray(polys)
    pts = polys.reshape(polys.shape[:-1] + (4, 2))
    ii, jj = np.triu_indices(4, 1)
    d = pts[..., jj, :] - pts[..., ii, :]
    theta = np.arctan2(-d[..., 1], d[..., 0])
    cos, sin = np.cos(theta), np.sin(theta)
    p1 = (pts[..., None, :, 0] * cos[..., None]
          - pts[..., None, :, 1] * sin[..., None])
    p2 = (pts[..., None, :, 0] * sin[..., None]
          + pts[..., None, :, 1] * cos[..., None])
    w = p1.max(axis=-1) - p1.min(axis=-1)
    h = p2.max(axis=-1) - p2.min(axis=-1)
    k = np.argmin(w * h, axis=-1)

    take = lambda a: np.take_along_axis(a, k[..., None], axis=-1)[..., 0]
    w, h, theta, cos, sin = take(w), take(h), take(theta), take(cos), take(sin)
    m1 = (take(p1.max(axis=-1)) + take(p1.min(axis=-1))) / 2
    m2 = (take(p2.max(axis=-1)) + take(p2.min(axis=-1))) / 2
    cx = m1 * cos + m2 * sin
    cy = -m1 * sin + m2 * cos
    swap = h > w
    l = np.where(swap, h, w)
    s = np.where(swap, w, h)
    theta = regular_theta(np.where(swap, theta + math.pi / 2, theta))
    rb = np.stack([cx, cy, l, s, theta], axis=-1)
    if return_angle_deg:
        return rb, theta * (180.0 / math.pi) + 90.0
    return rb


def poly2rbox_csl(polys, num_bins: int = 180, radius: float = 6.0):
    """polys → (rboxes ``(n, 5)``, CSL labels ``(n, num_bins)``)."""
    rb, ang = poly2rbox(polys, return_angle_deg=True)
    return rb, csl_gaussian_labels(ang, num_bins=num_bins, radius=radius)


def poly2hbb(polys):
    """``(n, 8)`` polys → ``(n, 4) [cx cy w h]`` axis-aligned cover."""
    polys = np.asarray(polys)
    x, y = polys[..., 0::2], polys[..., 1::2]
    x_min, x_max = x.min(axis=-1), x.max(axis=-1)
    y_min, y_max = y.min(axis=-1), y.max(axis=-1)
    return np.stack([(x_min + x_max) / 2, (y_min + y_max) / 2,
                     x_max - x_min, y_max - y_min], axis=-1)


def poly_filter(polys, h, w):
    """Keep-mask of the polys whose HBB centre lies strictly inside
    ``(0, w) x (0, h)`` (JAX geometry.py:162)."""
    x, y = polys[..., 0::2], polys[..., 1::2]
    xc = (x.min(axis=-1) + x.max(axis=-1)) / 2
    yc = (y.min(axis=-1) + y.max(axis=-1)) / 2
    return (xc > 0) & (xc < w) & (yc > 0) & (yc < h)


def xywh2xyxy(x):
    x = np.asarray(x)
    half = x[..., 2:4] / 2
    return np.concatenate([x[..., 0:2] - half, x[..., 0:2] + half], axis=-1)


def xyxy2xywh(x):
    x = np.asarray(x)
    return np.concatenate([(x[..., 0:2] + x[..., 2:4]) / 2,
                           x[..., 2:4] - x[..., 0:2]], axis=-1)


def clip_polys(polys, h, w):
    """Clamp poly coordinates into the image."""
    x = np.clip(polys[..., 0::2], 0, w)
    y = np.clip(polys[..., 1::2], 0, h)
    return np.stack([x, y], axis=-1).reshape(polys.shape)


def scale_polys(img1_shape, polys, img0_shape, ratio_pad=None):
    """Rescale polys from the letterboxed ``img1_shape`` (h, w) back to
    ``img0_shape``: the gain from the resize ratio, the pad removed from
    both coordinates (float64 result)."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    polys = np.asarray(polys).astype(np.float64)
    x = (polys[..., 0::2] - pad[0]) / gain
    y = (polys[..., 1::2] - pad[1]) / gain
    return np.stack([x, y], axis=-1).reshape(polys.shape)
