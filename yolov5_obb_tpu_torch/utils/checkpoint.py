"""Checkpoints: a directory of plain tensors and a JSON sidecar.

Counterpart of ``yolov5_obb_tpu/utils/checkpoint.py`` (:30-122) in a
torch-native format.  A checkpoint is a directory holding

* ``state.pt``: ``torch.save`` of a dict of tensors, dicts, lists, ints and
  strings only (it loads with ``weights_only=True``), on the CPU so that it
  restores on any device.  ``kind`` is ``"checkpoint"`` — the model's
  ``state_dict`` (parameters and BatchNorm buffers) and the train state's
  tensors (:meth:`~..engine.trainer.TrainState.state_dict`: the EMA by
  name, the optimizer's moments, accumulation buffer and counters, ``step``,
  ``ema_updates``), what ``--resume`` needs — or ``"weights"``: a
  ``state_dict`` alone, for deployment the EMA parameters with the
  BatchNorm buffers (JAX ``save_weights``: ``ema_params`` + ``batch_stats``);
* ``meta.json``: the train CLI's metadata (epoch, best_fitness, names, cfg,
  imgsz and the anchors, which autoanchor may have evolved).  ``state.pt``
  holds the same dict under ``meta``, and the loaders read that one: each
  file is swapped in whole (written aside, then ``os.replace``), and
  ``state.pt`` last, so a save cut short leaves the previous state with
  its own metadata.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from .loggers import resolve_wandb_artifact

STATE = "state.pt"
META = "meta.json"


def _cpu(obj):
    """Tensors (in dicts and lists) → detached CPU copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_cpu(v) for v in obj]
    return obj


def _replace(dst: Path, write) -> None:
    """``write(tmp)`` a file beside ``dst``, then swap it in whole."""
    tmp = dst.with_name(dst.name + ".tmp")
    write(tmp)
    os.replace(tmp, dst)


def _save(path, obj: dict, metadata: dict | None) -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    # plain JSON values, so that state.pt loads with weights_only=True
    meta = (json.loads(json.dumps(metadata, default=str))
            if metadata is not None else None)
    if meta is not None:
        _replace(path / META, lambda t: t.write_text(json.dumps(meta)))
    _replace(path / STATE, lambda t: torch.save(_cpu({**obj, "meta": meta}),
                                                t))
    return path


def _load(path) -> tuple:
    # a wandb-artifact:// reference is downloaded first (JAX
    # checkpoint.py:92-97)
    path = Path(resolve_wandb_artifact(path))
    obj = torch.load(path / STATE, map_location="cpu", weights_only=True)
    meta = obj.pop("meta", None)
    mp = path / META
    if meta is None and mp.exists():
        meta = json.loads(mp.read_text())
    return obj, meta or {}


def save_checkpoint(path, model, state, metadata: dict | None = None):
    """The full train state, for ``--resume``: ``model``'s ``state_dict``
    and ``state``'s tensors."""
    return _save(path, {"kind": "checkpoint", "model": model.state_dict(),
                        **state.state_dict()}, metadata)


def restore_checkpoint(path, model, state):
    """Load a full checkpoint into ``model`` and ``state`` in place (the
    shapes must match: same config, same optimizer) → ``(state, meta)``."""
    obj, meta = _load(path)
    if obj.get("kind") != "checkpoint":
        raise ValueError(f"{path} holds weights only, not a train state to "
                         "resume")
    model.load_state_dict(obj["model"])
    state.load_state_dict(obj)
    return state, meta


def save_weights(path, state_dict: dict, metadata: dict | None = None):
    """Deployment weights: one ``state_dict`` (the EMA parameters with the
    BatchNorm buffers, as the train CLI's ``best``)."""
    return _save(path, {"kind": "weights", "model": dict(state_dict)},
                 metadata)


def load_weights(path):
    """A checkpoint directory → ``(state_dict, meta)``: the stored weights,
    or a full checkpoint's model (its raw parameters, as the JAX package's
    ``load_weights`` gives a full checkpoint's ``params``)."""
    obj, meta = _load(path)
    return obj["model"], meta


def restore_model_meta(meta, ckpt_meta: dict):
    """Apply a checkpoint's ``meta.json`` to a live ``ModelMeta``: its
    anchors, which autoanchor may have evolved, replace ``meta.anchors_px``
    (without them an evolved model would decode with the config's anchors);
    anchors of another shape than the model's raise."""
    anchors = ckpt_meta.get("anchors") if ckpt_meta else None
    if anchors is not None and meta is not None:
        arr = np.asarray(anchors, dtype=np.float32)
        if arr.shape != tuple(np.shape(meta.anchors_px)):
            raise ValueError(
                f"the checkpoint's anchors have shape {arr.shape}, the "
                f"model's {tuple(np.shape(meta.anchors_px))}: wrong --cfg "
                "for these weights?")
        meta.anchors_px = arr
    return meta


def load_state_dict(model, path, meta) -> None:
    """A torch-saved state dict (or module) in the reference model's names
    → ``model``; keys outside the port model are ignored, a missing one
    raises.  The Detect ``anchors`` buffer (the reference keeps it divided
    by the stride, so autoanchor's evolved anchors travel with the weights)
    replaces ``meta.anchors_px`` (unless ``meta`` is None) where its shape
    matches, as the JAX package's checkpoint restore does; without one the
    config's anchors stay."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    sd = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        sd[k if k.startswith("model.") else f"model.{k}"] = v
    own = model.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{len(missing)} keys absent from {path}, e.g. "
                       f"{missing[:5]}: wrong --cfg for these weights?")
    model.load_state_dict({k: sd[k] if k in sd else own[k] for k in own})
    det = next(i for i, s in enumerate(model.specs) if s.name == "Detect")
    grid = sd.get(f"model.{det}.anchors")
    if grid is not None and meta is not None:
        stride = np.asarray(meta.strides, np.float32)[:, None, None]
        px = grid.float().numpy() * stride
        if px.shape == np.shape(meta.anchors_px):
            meta.anchors_px = px


def load_model_weights(model, meta, path) -> dict:
    """``--weights`` of the CLIs: a checkpoint directory (through
    :func:`load_weights` and :func:`restore_model_meta`) or a state-dict
    ``.pt`` in the reference model's names (:func:`load_state_dict`) →
    ``model`` and ``meta`` (``meta`` None: the weights alone, the config's
    anchors stay); returns the checkpoint's ``meta.json`` (empty for a
    ``.pt``).  A ``wandb-artifact://`` reference is downloaded first."""
    path = Path(resolve_wandb_artifact(path))
    if path.suffix == ".pt" and path.is_file():
        load_state_dict(model, path, meta)
        return {}
    sd, ckpt_meta = load_weights(path)
    model.load_state_dict(sd)
    restore_model_meta(meta, ckpt_meta)
    return ckpt_meta
