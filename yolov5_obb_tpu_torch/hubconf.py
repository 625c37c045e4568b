"""torch.hub entry points of the port (reference hubconf.py:14-66).

    import torch
    model = torch.hub.load("path/to/repo/yolov5_obb_tpu_torch", "yolov5m_obb",
                           source="local", weights="runs/train/exp/best",
                           names=[...])           # device="cpu" off the card
    results = model(["image.png"])

Counterpart of the repo root's ``hubconf.py``, which serves the JAX
package.  Each entry is ``api.load`` of a bundled config, on the card
unless ``device="cpu"``; keyword arguments go to
:class:`~yolov5_obb_tpu_torch.api.OBBModel`.
"""

import sys
from pathlib import Path

# torch.hub imports this file on its own: make its package importable
_ROOT = str(Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from yolov5_obb_tpu_torch.api import load  # noqa: E402

dependencies = ["torch", "numpy", "yaml"]


def _create(size, **kw):
    return load(cfg=f"yolov5{size}.yaml", **kw)


def yolov5n_obb(**kw):
    return _create("n", **kw)


def yolov5s_obb(**kw):
    return _create("s", **kw)


def yolov5m_obb(**kw):
    return _create("m", **kw)


def yolov5l_obb(**kw):
    return _create("l", **kw)


def yolov5x_obb(**kw):
    return _create("x", **kw)


def custom(cfg, weights=None, **kw):
    return load(cfg=cfg, weights=weights, **kw)
