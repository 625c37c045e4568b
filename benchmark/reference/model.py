"""Plain float32 YOLOv5-OBB, built from a model dict (a YAML model file as
JSON): the layers the two benchmark configurations use (Conv, C3,
Bottleneck, SPPF, nn.Upsample, Concat, Detect) in NCHW with
``torch.nn.functional`` only.

Parameter and buffer names are those of the Ultralytics model
(``model.<i>.conv.weight``, ``model.<i>.bn.running_mean``, ``cv1``/``cv2``/
``cv3``, ``m``), so one state dict loads into this model and into the
program.  BatchNorm: eps 1e-3; in train mode the batch mean and the biased
variance, and the running statistics move as ``0.97·old + 0.03·batch`` with
that biased variance (flax's update, which the program follows) when
:meth:`ReferenceYolo.commit_running_stats` is called, once a step, so that a
recompute under ``torch.utils.checkpoint`` cannot move them twice.

``lowp`` (a :class:`~benchmark.reference.lowp.Rounding` or None) rounds
every conv's input and weight to a lower precision: the control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-3
THETA_BINS = 180


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


class Conv(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, p=None, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act
        self.batch = None

    def forward(self, x, lowp=None):
        w = self.conv.weight
        if lowp is not None:
            x, w = lowp(x), lowp(w)
        z = F.conv2d(x, w, None, self.conv.stride, self.conv.padding)
        bn = self.bn
        if self.training:
            mean = z.mean((0, 2, 3))
            var = (z * z).mean((0, 2, 3)) - mean * mean
            var = var.clamp(min=0.0)
            self.batch = (mean.detach(), var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        y = ((z - mean[:, None, None]) * (torch.rsqrt(var + BN_EPS)
                                          * bn.weight)[:, None, None]
             + bn.bias[:, None, None])
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x, lowp=None):
        y = self.cv2(self.cv1(x, lowp), lowp)
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut)
                                 for _ in range(n)))

    def forward(self, x, lowp=None):
        y = self.cv1(x, lowp)
        for b in self.m:
            y = b(y, lowp)
        return self.cv3(torch.cat([y, self.cv2(x, lowp)], 1), lowp)


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def forward(self, x, lowp=None):
        x = self.cv1(x, lowp)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1), lowp)


class Upsample(nn.Module):
    def __init__(self, scale=2):
        super().__init__()
        self.scale = scale

    def forward(self, x, lowp=None):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs, lowp=None):
        return torch.cat(xs, 1)


class Detect(nn.Module):
    """Per level a 1x1 conv with bias → ``(B, ny*nx*na, no)``, the anchor
    index varying fastest, channels ``[x y w h obj cls*nc theta*180]``."""

    def __init__(self, nc, na, ch):
        super().__init__()
        self.nc, self.na = nc, na
        self.no = nc + 5 + THETA_BINS
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in ch)

    def forward(self, xs, lowp=None):
        out = []
        for conv, x in zip(self.m, xs):
            w = conv.weight
            if lowp is not None:
                x, w = lowp(x), lowp(w)
            y = F.conv2d(x, w, conv.bias)
            B, _, ny, nx = y.shape
            out.append(y.permute(0, 2, 3, 1).reshape(B, ny * nx * self.na,
                                                     self.no))
        return out


def parse(model_dict: dict, nc: int):
    """``(layers, froms, anchors_px, strides)`` of a YOLOv5 model dict:
    the Ultralytics ``parse_model`` channel arithmetic for the modules
    above.  ``anchors_px`` is ``(nl, na, 2)`` in input pixels; levels are
    listed P3 first, stride 8 doubling a level."""
    gd, gw = model_dict["depth_multiple"], model_dict["width_multiple"]
    anchors = model_dict["anchors"]
    na = len(anchors[0]) // 2
    ch, layers, froms = [3], [], []
    for i, (f, n, name, args) in enumerate(model_dict["backbone"]
                                           + model_dict["head"]):
        n = max(round(n * gd), 1) if n > 1 else n
        if name in ("Conv", "C3", "SPPF"):
            c1, c2 = ch[f], make_divisible(args[0] * gw, 8)
            if name == "Conv":
                m = Conv(c1, c2, *args[1:])
            elif name == "C3":
                m = C3(c1, c2, n, *args[1:])
            else:
                m = SPPF(c1, c2, *args[1:])
        elif name == "nn.Upsample":
            m, c2 = Upsample(int(args[1])), ch[f]
        elif name == "Concat":
            m, c2 = Concat(), sum(ch[x] for x in f)
        elif name == "Detect":
            m, c2 = Detect(nc, na, tuple(ch[x] for x in f)), None
        else:
            raise ValueError(f"module {name!r} is not in the reference")
        layers.append(m)
        froms.append(f)
        if i == 0:
            ch = []
        ch.append(c2)
    anchors_px = torch.tensor(anchors, dtype=torch.float32,
                              device="cpu").reshape(len(anchors), na, 2)
    strides = tuple(8.0 * 2 ** i for i in range(len(anchors)))
    return layers, froms, anchors_px, strides


class ReferenceYolo(nn.Module):
    """The model: ``forward(image_u8 NHWC) -> list of flat Detect maps``,
    float32.  ``remat``: in train mode each layer runs under a
    non-reentrant checkpoint, so the backward keeps only the layers'
    outputs (the reference at the training cells' sizes fits that way)."""

    def __init__(self, model_dict: dict, nc: int):
        super().__init__()
        layers, self.froms, self.anchors_px, self.strides = parse(
            model_dict, nc)
        self.model = nn.ModuleList(layers)
        self.nc, self.na = nc, self.anchors_px.shape[1]
        self.nl = self.anchors_px.shape[0]
        self.no = nc + 5 + THETA_BINS
        self.lowp = None
        self.remat = False

    def forward(self, image_u8):
        x = image_u8.permute(0, 3, 1, 2).float() / 255.0
        y = []
        for f, m in zip(self.froms, self.model):
            h = (y[-1] if y else x) if f == -1 else (
                y[f] if isinstance(f, int) else [y[j] for j in f])
            if self.remat and self.training and not isinstance(
                    m, (Concat, Upsample)):
                h = checkpoint(m, h, self.lowp, use_reentrant=False)
            else:
                h = m(h, self.lowp)
            y.append(h)
        return y[-1]

    def convs(self):
        return [m for m in self.modules() if isinstance(m, Conv)]

    @torch.no_grad()
    def commit_running_stats(self):
        """Move every BatchNorm's running statistics by the batch
        statistics of the last train-mode forward."""
        for c in self.convs():
            mean, var = c.batch
            c.bn.running_mean.mul_(0.97).add_(0.03 * mean)
            c.bn.running_var.mul_(0.97).add_(0.03 * var)
            c.batch = None
