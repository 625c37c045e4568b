"""Activation zoo (reference utils/activations.py:12-101): the plain
functions and the parameterised activations as modules on NHWC tensors.

Counterpart of ``yolov5_obb_tpu/models/activations.py``.  The modules
compute as flax promotes their operands: a bfloat16 input against float32
parameters computes, and returns, float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _bn_module, _conv, _norm, batch_norm_train


def silu(x):
    return x * torch.sigmoid(x)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x):
    """``x · tanh(softplus(x))`` with softplus ``log(1 + eˣ)`` unclipped
    (``jax.nn.softplus``; torch's ``F.softplus`` turns linear past 20)."""
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


class Hardswish(nn.Module):
    def forward(self, x):
        return hardswish(x)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class FReLU(nn.Module):
    """Funnel activation ``max(x, BN(depthwise k x k conv(x)))`` (reference
    :37-46), the conv padded 'SAME'; BatchNorm with the batch statistics
    in train mode, but never in bfloat16 (flax's ``BatchNorm`` there has no
    dtype)."""

    def __init__(self, c1, k=3):
        super().__init__()
        self.k = k
        self.conv = nn.Conv2d(c1, c1, k, 1, 0, groups=c1, bias=False)
        self.bn = _bn_module(c1)

    def forward(self, x):
        lo = (self.k - 1) // 2
        xf = x.float()
        y = _conv(self.conv, F.pad(xf, (0, 0, lo, self.k - 1 - lo,
                                        lo, self.k - 1 - lo)))
        y = batch_norm_train(self.bn, y) if self.training else _norm(self.bn,
                                                                      y)
        return torch.maximum(xf, y)


class AconC(nn.Module):
    """ACON-C ``(p1 - p2)·x·σ(β(p1 - p2)x) + p2·x`` (reference :49-70);
    ``p1``, ``p2`` drawn from N(0, 1), ``beta`` ones."""

    def __init__(self, c1):
        super().__init__()
        self.p1 = nn.Parameter(torch.randn(1, 1, 1, c1))
        self.p2 = nn.Parameter(torch.randn(1, 1, 1, c1))
        self.beta = nn.Parameter(torch.ones(1, 1, 1, c1))

    def forward(self, x):
        dpx = (self.p1 - self.p2) * x
        return dpx * torch.sigmoid(self.beta * dpx) + self.p2 * x


class MetaAconC(nn.Module):
    """ACON-C with ``beta`` from a small network over the global average
    (reference :73-101): two k x k convs with bias, ``c1 → max(r, c1 // r)
    → c1`` ('SAME' padding for odd k), then σ."""

    def __init__(self, c1, k=1, s=1, r=16):
        super().__init__()
        c2 = max(r, c1 // r)
        self.p1 = nn.Parameter(torch.randn(1, 1, 1, c1))
        self.p2 = nn.Parameter(torch.randn(1, 1, 1, c1))
        self.fc1 = nn.Conv2d(c1, c2, k, s, k // 2, bias=True)
        self.fc2 = nn.Conv2d(c2, c1, k, s, k // 2, bias=True)

    def forward(self, x):
        # the mean in x's dtype, the convs in float32 (flax promotes)
        y = x.float().mean((1, 2), keepdim=True).to(x.dtype).float()
        beta = torch.sigmoid(_conv(self.fc2, _conv(self.fc1, y)))
        dpx = (self.p1 - self.p2) * x
        return dpx * torch.sigmoid(beta * dpx) + self.p2 * x
