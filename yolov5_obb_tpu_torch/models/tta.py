"""Test-time augmentation: multi-scale + flip inference.

Counterpart of ``yolov5_obb_tpu/models/tta.py`` (the reference
``Model._forward_augment``, models/yolo.py:149-222): scales [1.0, 0.83,
0.67], flips [none, lr, none], each pass decoded, de-scaled and merged, with
the cross-scale tail clipping of ``_clip_augmented``.  A left-right flip
negates the box angle, so the 180 CSL bin scores are re-indexed ``b → (180 -
b) % 180``.

The downscale is ``F.interpolate(..., "bilinear", antialias=True)``: the JAX
package's ``jax.image.resize(..., "bilinear")`` antialiases when it shrinks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .yolo import ModelMeta, decode

THETA_BINS = 180


def _scale_shape(imgsz: int, ratio: float, gs: int = 32) -> int:
    return int((imgsz * ratio) // gs * gs) if ratio != 1.0 else imgsz


def _flip_theta_lr(pred, nc: int):
    """Remap the theta-bin scores of a horizontally flipped image: bin ``b``
    encodes ``b - 90`` degrees, and the mirror takes θ to -θ."""
    th = pred[..., 5 + nc:]
    return torch.cat([pred[..., :5 + nc], torch.roll(th.flip(-1), 1, -1)], -1)


def predict_tta(model, meta: ModelMeta, image, nc: int | None = None,
                scales=(1.0, 0.83, 0.67), flips=(None, "lr", None),
                plain: bool = False):
    """Augmented inference → ``(B, total_anchors, no)`` decoded predictions.

    ``image``: ``(B, H, W, 3)`` float in [0, 1] on the model's device;
    ``plain`` runs the model's kernels as their plain versions."""
    nc = nc if nc is not None else meta.nc
    B, H, W, _ = image.shape
    preds = []
    for si, fi in zip(scales, flips):
        h, w = _scale_shape(H, si), _scale_shape(W, si)
        xi = image
        if fi == "lr":
            xi = xi.flip(2)
        elif fi == "ud":
            xi = xi.flip(1)
        if (h, w) != (H, W):
            xi = F.interpolate(xi.permute(0, 3, 1, 2), size=(h, w),
                               mode="bilinear", align_corners=False,
                               antialias=True).permute(0, 2, 3, 1)
        y = decode(model(xi.contiguous(), plain=plain), meta, (h, w))
        # de-scale (reference _descale_pred, yolo.py:183-199)
        scale_back = torch.tensor([W / w, H / h, W / w, H / h],
                                  dtype=torch.float32, device=y.device)
        xywh = y[..., :4] * scale_back
        if fi == "lr":
            xywh = torch.cat([W - xywh[..., :1], xywh[..., 1:]], -1)
        elif fi == "ud":
            xywh = torch.cat([xywh[..., :1], H - xywh[..., 1:2],
                              xywh[..., 2:]], -1)
        y = torch.cat([xywh, y[..., 4:]], -1)
        if fi == "lr":
            y = _flip_theta_lr(y, nc)
        preds.append(y)

    # _clip_augmented (yolo.py:200-210): drop large-object rows from the
    # finest output and small-object rows from the coarsest
    nl = meta.nl
    g = sum(4 ** x for x in range(nl))
    e = 1
    i = preds[0].shape[1] // g * sum(4 ** x for x in range(e))
    preds[0] = preds[0][:, :preds[0].shape[1] - i]
    i = preds[-1].shape[1] // g * sum(4 ** (nl - 1 - x) for x in range(e))
    preds[-1] = preds[-1][:, i:]
    return torch.cat(preds, 1)
