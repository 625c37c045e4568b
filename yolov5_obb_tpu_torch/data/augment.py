"""Host-side image transforms (numpy; OpenCV only to resize).

Counterpart of ``yolov5_obb_tpu/data/augment.py``'s ``letterbox``
(augment.py:25), the one transform evaluation uses.  The train-time
augmentations wait for the train data loader (ROADMAP.md queue 1 item 8).
``cv2`` is imported inside the call that resizes: the package imports
without it.
"""

from __future__ import annotations

import numpy as np

PAD_COLOR = (114, 114, 114)


def letterbox(img, new_shape, scaleup=True):
    """Aspect-preserving resize + grey pad to ``new_shape`` (reference
    augmentations.py:92-128, its evaluation form: no stride rounding, no
    stretch).  Returns ``(img, (rw, rh), (dw, dh))`` with ``dw``/``dh`` the
    one-side paddings."""
    h, w = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = int(round(w * r)), int(round(h * r))
    dw = (new_shape[1] - new_unpad[0]) / 2
    dh = (new_shape[0] - new_unpad[1]) / 2
    if (w, h) != new_unpad:
        import cv2

        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    # the constant border of cv2.copyMakeBorder, in numpy
    h, w, c = img.shape
    out = np.empty((h + top + bottom, w + left + right, c), img.dtype)
    out[...] = PAD_COLOR
    out[top:top + h, left:left + w] = img
    return out, (r, r), (dw, dh)
