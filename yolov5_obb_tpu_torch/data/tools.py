"""Dataset tools: the class and image weights of ``--image-weights``.

Counterpart of ``yolov5_obb_tpu/data/tools.py``'s
``labels_to_class_weights`` (:110) and ``labels_to_image_weights`` (:124);
its other tools (``autosplit``, ``dataset_stats``, ``flatten_recursive``,
``extract_boxes``) are not ported yet (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import numpy as np


def labels_to_class_weights(cls_lists, nc: int):
    """Inverse-frequency class weights, normalised to sum 1; a class with no
    object weighs 0 (reference general.py:506-519)."""
    counts = np.zeros(nc)
    for cls in cls_lists:
        for c in np.asarray(cls, int):
            if 0 <= c < nc:
                counts[c] += 1
    w = 1.0 / np.maximum(counts, 1)
    w[counts == 0] = 0
    return w / max(w.sum(), 1e-9)


def labels_to_image_weights(cls_lists, nc: int, class_weights=None):
    """Per-image sampling weights, the class weights summed over each
    image's objects, normalised (uniform when every image weighs 0;
    reference general.py:521-526)."""
    cw = (class_weights if class_weights is not None
          else labels_to_class_weights(cls_lists, nc))
    out = np.zeros(len(cls_lists))
    for i, cls in enumerate(cls_lists):
        h = np.bincount(np.asarray(cls, int), minlength=nc)[:nc]
        out[i] = float((h * cw).sum())
    s = out.sum()
    return (out / s if s > 0
            else np.full(len(cls_lists), 1.0 / max(len(cls_lists), 1)))
