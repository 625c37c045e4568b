"""Deploy-time Conv+BN folding and model info (reference
``fuse_conv_and_bn``, ``model_info``).

Counterpart of ``yolov5_obb_tpu/utils/fuse.py``: ``fuse_conv_bn`` (:25),
``fuse_for_inference`` (:66) and ``model_info`` (:86).  ``fuse_conv_bn``: each
conv kernel absorbs its BatchNorm's scale; the BN keeps only a per-channel
shift, stored in its running-mean slot (the convs are bias-free), with
scale 1, bias 0 and ``var = 1 - eps`` so ``rsqrt(var + eps)`` is 1.  The
module structure and state_dict keys stay the same.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BN_EPS, ConvBnAct


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, eps: float = BN_EPS) -> nn.Module:
    """Fold every ConvBnAct's BatchNorm into its conv, in place (the folded
    weights replace the originals; nothing is copied).  Returns ``model``."""
    for m in model.modules():
        if not isinstance(m, ConvBnAct):
            continue
        bn = m.bn
        gamma, beta = bn.weight.clone(), bn.bias.clone()
        mean, var = bn.running_mean.clone(), bn.running_var.clone()
        std = torch.sqrt(var + eps)
        m.conv.weight.mul_((gamma / std)[:, None, None, None])
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(gamma * mean / std - beta)
        bn.running_var.copy_(torch.ones_like(var) - eps)
    return model


def fuse_for_inference(model: nn.Module, enable: bool = True) -> nn.Module:
    """Load-time Conv+BN folding for every inference entry point (reference
    ``attempt_load(fuse=True)``): :func:`fuse_conv_bn` in place, or
    ``model`` unchanged when disabled.  Returns ``model``."""
    return fuse_conv_bn(model) if enable else model


def model_info(model: nn.Module, imgsz: int = 640, example=None) -> dict:
    """Parameter count and, given ``example`` (the forward's arguments, a
    tuple), its GFLOPs as ``torch.utils.flop_counter`` counts them (the
    JAX package reads XLA's cost analysis; reference ``model_info``).
    ``imgsz`` is the JAX signature's; the FLOPs are those of ``example``.
    A hand-written kernel's work is not counted: measure an unpacked
    model."""
    from .profiler import flops_of

    n = sum(p.numel() for p in model.parameters())
    info = {"params": n, "params_M": round(n / 1e6, 2)}
    if example is not None:
        flops = flops_of(model, *example)
        if flops is not None:
            info["gflops"] = round(flops / 1e9, 1)
    return info
