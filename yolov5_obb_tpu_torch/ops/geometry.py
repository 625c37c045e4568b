"""Rotated-box geometry used on the inference path.

Boxes follow the JAX package's convention ``[cx cy l s theta]`` (long side,
short side, angle in radians).
"""

from __future__ import annotations

import torch


def hbb_cover(rboxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned cover ``(..., 4)`` = x1 y1 x2 y2 of ``(..., 5)`` rboxes,
    in closed form from |cos θ| and |sin θ| (JAX rotated_nms._hbb_cover)."""
    cx, cy, l, s, t = rboxes.unbind(-1)
    ct, st = torch.cos(t).abs(), torch.sin(t).abs()
    w = l * ct + s * st
    h = l * st + s * ct
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
