"""Inference entry point: image batch → rotated detections.

Counterpart of ``yolov5_obb_tpu/engine/evaluator.make_predict_fn``
(evaluator.py:27) and ``pack_images`` (:166) for single-label inference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rotated_nms import non_max_suppression_from_maps


def make_predict_fn(model, meta, conf_thres, iou_thres, max_det,
                    multi_label=True, max_candidates=4096,
                    agnostic: bool = False, classes=None,
                    plain: bool = False):
    """Image → detections function, shared by the command-line tools.

    If ``model.packed_stem`` is set, the returned function expects the image
    batch as the packed ``(B, H, W*3)`` uint8 view (see :func:`pack_images`)
    on the model's device — the /255 normalize is folded into the stem
    weights; otherwise an NHWC uint8 batch.  ``plain=True`` runs every
    kernel-bearing step as its plain PyTorch version (on any device), the
    reference the kernels are checked against.

    The returned ``predict(images) -> (dets (B, max_det, 7), num (B,))``
    runs under ``torch.inference_mode``.

    ``multi_label`` defaults to True, as in the JAX package; only
    single-label selection is ported, so pass ``multi_label=False``."""
    if multi_label:
        raise NotImplementedError(
            "multi-label inference (_batched_exact_pairs) is not ported yet")
    classes = tuple(int(c) for c in classes) if classes is not None else None
    packed = bool(model.packed_stem)

    @torch.inference_mode()
    def predict(image_u8):
        x = image_u8 if packed else image_u8.float() / 255.0
        maps = model(x, plain=plain)
        return non_max_suppression_from_maps(
            maps, meta, conf_thres=conf_thres, iou_thres=iou_thres,
            max_candidates=max_candidates, max_det=max_det,
            agnostic=agnostic, classes=classes, plain=plain)

    predict.packed_stem = packed
    return predict


def pack_images(batch_u8):
    """NHWC uint8 batch (numpy or tensor) → the packed ``(B, H, W*3)`` view
    a packed-stem predict function expects; no copy for contiguous input."""
    if isinstance(batch_u8, torch.Tensor):
        b = batch_u8.contiguous()
    else:
        b = np.ascontiguousarray(batch_u8)
    return b.reshape(b.shape[0], b.shape[1], -1)
