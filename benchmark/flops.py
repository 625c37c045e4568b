"""The work of a predict call and of a train step, counted by
``torch.utils.flop_counter`` on the benchmark's plain reference model with
meta tensors: the same count whatever kernels the program runs it on, so
no change to the program can move it."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.model import ReferenceYolo


def _model(model_json: str, nc: int):
    with torch.device("meta"):
        return ReferenceYolo(json.loads(model_json), nc)


@functools.lru_cache(maxsize=8)
def _count(model_json: str, nc: int, batch: int, imgsz: int,
           train: bool) -> int:
    model = _model(model_json, nc).train(train)
    x = torch.empty(batch, imgsz, imgsz, 3, dtype=torch.uint8,
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        maps = model(x)
        if train:
            total = sum(m.sum() for m in maps)
            torch.autograd.grad(total, list(model.parameters()))
    return counter.get_total_flops()


def forward_flops(model_dict: dict, nc: int, batch: int, imgsz: int) -> int:
    """FLOPs of one forward of ``batch`` images (eval mode)."""
    return _count(json.dumps(model_dict, sort_keys=True), nc, batch, imgsz,
                  False)


def train_flops(model_dict: dict, nc: int, batch: int, imgsz: int) -> int:
    """FLOPs of one forward and backward (train mode, no recompute)."""
    return _count(json.dumps(model_dict, sort_keys=True), nc, batch, imgsz,
                  True)
