"""Deploy-time Conv+BN folding (reference ``fuse_conv_and_bn``).

Counterpart of ``yolov5_obb_tpu/utils/fuse.fuse_conv_bn`` (fuse.py:25): each
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
