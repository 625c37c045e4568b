"""Config, hyperparameter and path helpers.

Counterparts of ``yolov5_obb_tpu/utils/general.py`` ``load_yaml`` (:13),
``load_hyp`` (:18), ``load_dataset_config`` (:26), ``increment_path`` (:43),
``init_seeds`` (:57), ``colorstr`` (:64) and ``scale_hyp_gains`` (:76).  The default hyp file is the port's own copy
of the DOTA finetune set (``data/configs/hyp_finetune_dota.yaml``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import yaml

DEFAULT_HYP_NAME = "hyp_finetune_dota.yaml"


def load_yaml(path) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


CONFIG_DIR = Path(__file__).parent.parent / "data" / "configs"


def load_hyp(path=None) -> dict:
    """Load a hyperparameter yaml; the bundled DOTA finetune set (reference
    data/hyps/obb/hyp.finetune_dota.yaml) when ``path`` is None.  A name
    that is not a file is looked up among the bundled sets
    (``data/configs``: ``hyp_paper.yaml``, ``hyp_finetune_dota_closeaug.yaml``
    ...), as a model config's name is among ``models/configs``."""
    if path is None:
        path = CONFIG_DIR / DEFAULT_HYP_NAME
    elif not Path(path).exists() and (CONFIG_DIR / Path(path).name).exists():
        path = CONFIG_DIR / Path(path).name
    return load_yaml(path)


def load_dataset_config(path) -> dict:
    """Dataset yaml: path/train/val/test/nc/names (reference
    general.py:371-421).  Relative train/val/test entries resolve against
    ``path`` (itself relative to the yaml's folder); a names dict becomes a
    list."""
    d = load_yaml(path)
    root = Path(d.get("path", "."))
    if not root.is_absolute():
        root = Path(path).parent / root
    for k in ("train", "val", "test"):
        if d.get(k):
            p = Path(d[k])
            d[k] = str(p if p.is_absolute() else root / p)
    if isinstance(d.get("names"), dict):
        d["names"] = [d["names"][i] for i in sorted(d["names"])]
    return d


def increment_path(path, exist_ok=False, mkdir=True) -> Path:
    """runs/exp → runs/exp2, exp3, ... unless ``exist_ok``."""
    path = Path(path)
    if path.exists() and not exist_ok:
        for n in range(2, 9999):
            p = Path(f"{path}{n}")
            if not p.exists():
                path = p
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def init_seeds(seed: int = 0) -> None:
    """Seed Python's ``random``, numpy's global generator and torch's (the
    JAX package seeds the first two; its weights take an explicit key)."""
    import random

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def colorstr(*args) -> str:
    """ANSI colour helper (reference general.py:481-504): ``colorstr("red",
    "bold", "text")``; one argument is blue and bold."""
    *prefix, string = args if len(args) > 1 else ("blue", "bold", args[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m", "bold": "\033[1m",
        "end": "\033[0m",
    }
    return "".join(colors[p] for p in prefix) + str(string) + colors["end"]


def scale_hyp_gains(hyp: dict, nl: int, nc: int, imgsz: int) -> dict:
    """Per-model loss-gain scaling (reference train.py:249-252)."""
    h = dict(hyp)
    h["box"] = h.get("box", 0.05) * 3.0 / nl
    h["cls"] = h.get("cls", 0.5) * nc / 80.0 * 3.0 / nl
    h["obj"] = h.get("obj", 1.0) * (imgsz / 640.0) ** 2 * 3.0 / nl
    h["theta"] = h.get("theta", 0.5) * 3.0 / nl
    return h
