"""Rotated-box geometry and CSL angle labels.

Boxes follow the JAX package's convention ``[cx cy l s theta]`` (long side,
short side, angle in radians).  The angle helpers ``regular_theta`` and
``csl_gaussian_labels`` build targets on the host (numpy).
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
