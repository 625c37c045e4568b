#!/usr/bin/env python
"""Convert a JAX package checkpoint (orbax) into a checkpoint directory of
the PyTorch port.

    python tools/jax_ckpt_to_torch.py releases/golden_yolov5n_192 out/golden

SRC is an orbax directory written by the JAX package: a weights checkpoint
(``save_weights``: ``params`` + ``batch_stats``, e.g. ``best/`` or
``releases/golden_yolov5n_192``) or a full one (``save_checkpoint``, e.g.
``last/``: its ``params``, as the JAX ``load_weights`` reads it).  DST becomes
the port's weights checkpoint (``yolov5_obb_tpu_torch/utils/checkpoint.py``:
``state.pt`` + ``meta.json``), which the port's val and train CLIs take as
``--weights``.  SRC's ``meta.json`` (which the JAX package writes beside
every checkpoint) is copied, anchors included; its ``cfg`` and ``names``
give the config and class count.  A full checkpoint's optimizer state is
not carried over: resume a JAX run with the JAX package.

Runs on the CPU and needs both packages (orbax to read, the port to write):
it is the one place outside the tests where they meet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def convert(src, dst) -> Path:
    import orbax.checkpoint as ocp

    from yolov5_obb_tpu_torch.models.yolo import build_model
    from yolov5_obb_tpu_torch.utils.checkpoint import save_weights
    from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

    src = Path(src).absolute()
    meta = json.loads((src / "meta.json").read_text())
    cfg, nc = meta["cfg"], len(meta["names"])
    tree = ocp.PyTreeCheckpointer().restore(src)
    variables = {k: _numpy(tree.get(k, {})) for k in ("params", "batch_stats")}
    model, _, _ = build_model(cfg, nc=nc)
    sd = from_jax_variables(variables, model.specs)
    model.load_state_dict(sd, assign=True)  # every key, the right shapes
    return save_weights(dst, sd, meta)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="orbax checkpoint directory (JAX package)")
    p.add_argument("dst", help="the port's checkpoint directory to write")
    a = p.parse_args(argv)
    out = convert(a.src, a.dst)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
