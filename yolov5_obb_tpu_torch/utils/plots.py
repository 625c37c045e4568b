"""Drawing helpers: oriented-box annotation and feature-map grids.

Counterpart of the drawing part of ``yolov5_obb_tpu/utils/plots.py``
(:10-46, :251-274; the reference utils/plots.py:113-186).  ``cv2`` and
``matplotlib`` are imported inside the calls: the card's machine has
neither, and nothing on the detect path draws unless asked to.  The curves
and the confusion matrix are not ported (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def class_color(i: int):
    return _PALETTE[int(i) % len(_PALETTE)]


def draw_poly(img, poly, label: str | None = None, color=None,
              line_width: int = 2):
    """Draw one oriented box polygon (and its label) on a BGR image in
    place."""
    import cv2

    pts = np.asarray(poly, np.float64).reshape(4, 2).astype(np.int32)
    color = color or (0, 255, 0)
    cv2.drawContours(img, [pts], 0, color, line_width)
    if label:
        x, y = pts[:, 0].min(), pts[:, 1].min() - 4
        cv2.putText(img, label, (int(x), max(int(y), 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return img


def annotate_detections(img, polys, confs, clses, names, line_width=2,
                        hide_conf=False, hide_labels=False):
    """Draw all detections; ``img`` is BGR uint8 (modified in place)."""
    for poly, conf, c in zip(polys, confs, clses):
        name = names[int(c)] if names and int(c) < len(names) else str(int(c))
        label = (None if hide_labels else name if hide_conf
                 else f"{name} {conf:.2f}")
        draw_poly(img, poly, label, class_color(int(c)), line_width)
    return img


def feature_visualization(x, module_name, save_dir, n_max=32):
    """Save a grid of a layer's feature-map channels (reference
    plots.py:162-186).  ``x``: a ``(B, H, W, C)`` activation (NHWC, as the
    port's layers hand them on; a tensor or an array).  Returns the file,
    or None for an activation that is not a map."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, np.float32)
    if x.ndim != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        return None
    ch = min(x.shape[-1], n_max)
    cols = 8
    rows = int(np.ceil(ch / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.4, rows * 1.4))
    for i, ax in enumerate(np.ravel(axes)):
        ax.axis("off")
        if i < ch:
            ax.imshow(x[0, :, :, i], cmap="gray")
    out = Path(save_dir) / f"{module_name}_features.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out
