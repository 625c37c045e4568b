"""Export CLI: a ``torch.export`` program (``.pt2``) of the decoded forward.

    python -m yolov5_obb_tpu_torch.export --weights runs/train/exp/best \\
        --cfg yolov5m.yaml --imgsz 1024 [--device cpu]

Counterpart of the JAX package's root ``export.py`` (:21-122), whose
native format is StableHLO.  The exported graph is the stock float32 model,
unpacked, BatchNorm folded, with ``decode`` appended: ``(B, imgsz, imgsz,
3)`` float32 in [0, 1] → ``(B, n_anchors, 5 + nc + 180)``, the batch
symbolic (as the JAX export's ``symbolic_shape("b")``).  The hand-written
kernels are ``ctypes`` calls, which ``torch.export`` does not trace: the
graph holds none of them (the JAX package's export builds leave its
kernels off too).  The graph keeps its constants on the device it was
traced on (``--device``, the card by default); ``models/backend.py``
moves it where it runs.

Writes ``model_<imgsz>.pt2`` (``torch.export.save``) and
``model_<imgsz>.json`` beside it (imgsz, nc, names, cfg, strides), which
the val and detect CLIs read as ``--weights``.  ``stablehlo``,
``saved_model`` and ``tflite`` are the JAX package's formats; ONNX and
TensorRT are not offered.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from .models.backend import DecodedForward
from .models.yolo import create_model
from .utils.checkpoint import load_model_weights
from .utils.fuse import fuse_for_inference

JAX_FORMATS = ("stablehlo", "saved_model", "tflite")


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.export")
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint directory or state-dict .pt; empty: "
                        "random weights")
    p.add_argument("--cfg", type=str, default="yolov5n.yaml")
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--nc", type=int, default=15)
    p.add_argument("--include", nargs="+", default=["pt2"],
                   choices=["pt2", *JAX_FORMATS])
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu: where the graph's "
                        "constants live")
    p.add_argument("--out", type=str, default="runs/export")
    return p.parse_args(argv)


def build_forward(opt):
    """The float32 model, unpacked, from ``--cfg``/``--nc``/``--weights``,
    BatchNorm folded → ``(fwd, model, meta)``; ``fwd`` is the
    :class:`~.models.backend.DecodedForward` (JAX export.py:36-55)."""
    model, meta = create_model(opt.cfg, nc=opt.nc, device=opt.device)
    if opt.weights:
        names = load_model_weights(model, meta, opt.weights).get("names")
        meta.names = names or meta.names
    fuse_for_inference(model)  # reference attempt_load(fuse=True)
    return DecodedForward(model, meta).eval(), model, meta


def export_pt2(fwd, opt, out_dir: Path) -> Path:
    """``torch.export`` of ``fwd`` with a symbolic batch, traced on a seeded
    example batch of 2 (a batch of 1 would be specialised) on ``fwd``'s
    device, saved as ``model_<imgsz>.pt2`` with its ``.json``."""
    t0 = time.time()
    dev = next(fwd.parameters()).device
    example = torch.rand(2, opt.imgsz, opt.imgsz, 3, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad():
        program = torch.export.export(fwd, (example,),
                                      dynamic_shapes=({0: batch},))
    path = out_dir / f"model_{opt.imgsz}.pt2"
    torch.export.save(program, str(path))
    meta = fwd.meta
    path.with_suffix(".json").write_text(json.dumps({
        "imgsz": opt.imgsz, "nc": meta.nc, "names": meta.names,
        "cfg": opt.cfg, "strides": [float(s) for s in meta.strides]}))
    print(f"pt2 → {path} ({time.time() - t0:.1f}s)")
    return path


def run(opt) -> dict:
    jax_only = [f for f in opt.include if f in JAX_FORMATS]
    if jax_only:
        raise ValueError(f"--include {' '.join(jax_only)}: the JAX package's "
                         "formats (yolov5_obb_tpu's export.py); the port "
                         "exports pt2")
    out_dir = Path(opt.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    fwd, _, _ = build_forward(opt)
    return {"pt2": export_pt2(fwd, opt, out_dir)}


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
