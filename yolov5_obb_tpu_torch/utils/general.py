"""Hyperparameter helpers.

Counterparts of ``yolov5_obb_tpu/utils/general.py`` ``load_hyp`` (:18) and
``scale_hyp_gains`` (:76).  The default hyp file is the port's own copy of
the DOTA finetune set (``data/configs/hyp_finetune_dota.yaml``).
"""

from __future__ import annotations

from pathlib import Path

import yaml

DEFAULT_HYP_NAME = "hyp_finetune_dota.yaml"


def load_hyp(path=None) -> dict:
    """Load a hyperparameter yaml; the bundled DOTA finetune set (reference
    data/hyps/obb/hyp.finetune_dota.yaml) when ``path`` is None."""
    if path is None:
        path = Path(__file__).parent.parent / "data" / "configs" / DEFAULT_HYP_NAME
    with open(path) as f:
        return yaml.safe_load(f)


def scale_hyp_gains(hyp: dict, nl: int, nc: int, imgsz: int) -> dict:
    """Per-model loss-gain scaling (reference train.py:249-252)."""
    h = dict(hyp)
    h["box"] = h.get("box", 0.05) * 3.0 / nl
    h["cls"] = h.get("cls", 0.5) * nc / 80.0 * 3.0 / nl
    h["obj"] = h.get("obj", 1.0) * (imgsz / 640.0) ** 2 * 3.0 / nl
    h["theta"] = h.get("theta", 0.5) * 3.0 / nl
    return h
