"""Inference from weights or from an exported model (reference
``DetectMultiBackend``, models/common.py:277-437).

Counterpart of ``yolov5_obb_tpu/models/backend.py`` (:21-139).  Two kinds:

* ``pt2``: a ``torch.export`` program written by
  ``python -m yolov5_obb_tpu_torch.export`` (``model_<imgsz>.pt2``, with
  ``model_<imgsz>.json`` beside it: imgsz, nc, names, cfg, strides);
* ``weights``: a checkpoint directory of the port or a state-dict ``.pt``
  (the CLIs' ``--weights``), built from ``cfg``, BatchNorm folded.

Both return ``fn(image_f32 (B, H, W, 3) in [0, 1]) → (B, n_anchors, no)``
decoded float32 predictions.  The JAX package's artifacts (``.stablehlo``,
``.tflite``, a SavedModel directory) are recognised by name and refused.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

from ..utils.checkpoint import load_model_weights
from ..utils.device import resolve_device
from ..utils.fuse import fuse_for_inference
from .yolo import create_model, decode

_JAX_SUFFIXES = (".stablehlo", ".tflite")


class DecodedForward(nn.Module):
    """``model`` and :func:`~.yolo.decode`: ``(B, H, W, 3)`` float32 in
    [0, 1] → ``(B, n_anchors, 5 + nc + 180)`` decoded (JAX export.py:50-53).
    The forward that ``export`` traces and the ``weights`` backend runs."""

    def __init__(self, model, meta):
        super().__init__()
        self.model, self.meta = model, meta

    def forward(self, image_f32):
        maps = self.model(image_f32)
        return decode(maps, self.meta, tuple(image_f32.shape[1:3]))


def _is_jax_artifact(path) -> bool:
    """True for the JAX package's exported formats."""
    p = Path(path)
    return p.suffix in _JAX_SUFFIXES or (p / "saved_model.pb").exists()


def is_artifact(path) -> bool:
    """True if ``path`` is an exported model rather than weights: a
    ``.pt2``, or one of the JAX package's formats (which the port
    refuses)."""
    return Path(path).suffix == ".pt2" or _is_jax_artifact(path)


def refuse_jax_artifact(path) -> None:
    """Raise for an artifact of the JAX package, naming it."""
    if _is_jax_artifact(path):
        raise ValueError(
            f"{path} is an artifact of the JAX package (yolov5_obb_tpu's "
            "export.py); the port runs a .pt2 from python -m "
            "yolov5_obb_tpu_torch.export, or weights")


def _artifact_meta(path) -> dict:
    """The ``.json`` written beside a ``.pt2`` (empty if there is none)."""
    side = Path(path).with_suffix(".json")
    return json.loads(side.read_text()) if side.exists() else {}


class MultiBackend:
    """``path`` → a callable of the decoded predictions on ``device`` (the
    card unless ``"cpu"``).  A ``.pt2`` is moved to ``device`` if it was
    traced elsewhere; ``imgsz`` must be the size it was exported at.
    ``weights`` need ``cfg`` and ``nc``.  ``names``: the weights' or the
    export's, else None."""

    def __init__(self, path, cfg: str | None = None, nc: int | None = None,
                 imgsz: int = 1024, device=None):
        p = Path(path)
        refuse_jax_artifact(p)
        self.device = resolve_device(device)
        if p.suffix == ".pt2":
            self.kind = "pt2"
            side = _artifact_meta(p)
            if side.get("imgsz", imgsz) != imgsz:
                raise ValueError(f"{p} was exported at {side['imgsz']}², "
                                 f"not {imgsz}²: its H and W are fixed")
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(torch.export.load(str(p)),
                                          self.device)
            self._fn = program.module()
            self.names = side.get("names")
        else:
            self.kind = "weights"
            model, meta = create_model(cfg or "yolov5m.yaml", nc=nc,
                                       device=self.device)
            self.names = load_model_weights(model, meta, p).get("names")
            self._fn = DecodedForward(fuse_for_inference(model), meta)

    def __call__(self, image_f32):
        with torch.no_grad():
            return self._fn(image_f32)

    def warmup(self, shape=(1, 1024, 1024, 3)):
        self(torch.zeros(shape, device=self.device))
        return self


def make_backend_predict_fn(weights, cfg, nc, imgsz, conf_thres, iou_thres,
                            max_det, tta: bool = False, device=None):
    """The exported-model path of the val and detect CLIs →
    ``(predict(image_u8) -> (dets (B, max_det, 7), num (B,)), names)``:
    the backend's decoded rows through ``non_max_suppression_obb``
    (multi-label; the rotated-IoU kernels on the card) on the backend's
    device.  ``predict.device`` and ``predict.packed_stem`` (False) as
    ``engine/evaluator.make_predict_fn``'s.  Test-time augmentation needs
    the raw maps, which an exported model does not give."""
    if tta:
        raise ValueError("--augment (TTA) is not supported with exported "
                         "models: use weights")
    from ..ops.rotated_nms import non_max_suppression_obb

    backend = MultiBackend(weights, cfg=cfg, nc=nc, imgsz=imgsz,
                           device=device)

    @torch.inference_mode()
    def predict(image_u8):
        return non_max_suppression_obb(
            backend(image_u8.float() / 255.0), num_classes=nc,
            conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det,
            multi_label=True)

    predict.device = backend.device
    predict.packed_stem = False
    return predict, backend.names
