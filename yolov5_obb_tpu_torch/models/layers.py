"""Layers of the YOLOv5-OBB graph, NHWC, inference and training.

Counterparts of ``yolov5_obb_tpu/models/layers.py``: every module of the
JAX zoo but its TPU-only parameter twins, so every bundled config builds.
Module and parameter names follow the reference PyTorch model
(``conv``/``bn``, ``cv1``/``cv2``/``cv3``, ``m``), so a reference state_dict
maps onto them key for key (the attention keeps flax's separate
``query``/``key``/``value``/``out`` projections).

Activations are NHWC tensors; a convolution views them as channels-last
NCHW for ``F.conv2d`` (no copy).  Convs compute in the activation dtype,
BatchNorm and SiLU in float32, BN eps 1e-3.  In eval mode BatchNorm uses its
running statistics; in train mode (``module.train()``) it normalises with
the batch statistics and updates the running ones as flax does (see
:func:`batch_norm_train`).  ``YOLO_BN_HALF=1`` (the train CLI's
``--bn-half``) casts the train-mode normalised values to bfloat16 and runs
SiLU in bfloat16 (:func:`bn_dtype`).  On the card, train-mode float32
BatchNorm + SiLU of a conv block runs on hand-written kernels
(ops/kernels/bn_act_train.py) with the same math; the chain of PyTorch ops
below is their plain version.

Every module takes ``(x, plain=False)``; ``plain`` sends a kernel-bearing
layer to its kernel's plain PyTorch version on any device.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import bn_act_train as bn_act_kernel
from ..ops.kernels.c3_kernel import fold_c3_params, fused_c3, fused_c3_plain
from ..ops.kernels.down_kernel import (
    down_conv_train,
    fold_down_params,
    fused_down,
    fused_down_plain,
)
from ..ops.kernels.stem_kernel import (
    fold_stem_params,
    fused_stem,
    fused_stem_plain,
    stem_conv_train,
)
from ..utils.profiler import count
from . import step_context

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # flax momentum 0.97

# Which layers run a hand-written kernel: the same choice as the JAX package
# at 1024².  At inference the layer-2 C3 and the layer-3 downsample (both at
# 256² input); in training the layer-1 and layer-3 downsamples (512² and 256²
# input; the C3 kernel is inference-only).  These gates were measured on a
# TPU; an A/B on the H100 is an open question (PERF.md).  The environment
# overrides them when the module is imported, as in the JAX package.
FUSED_C3_MIN_SPATIAL = int(os.environ.get("FUSED_C3_MIN_SPATIAL", 256 * 256))
FUSED_DOWN_MIN_SPATIAL = int(
    os.environ.get("FUSED_DOWN_MIN_SPATIAL", 256 * 256))


def autopad(k, p=None):
    """'same'-style padding for odd kernels."""
    if p is None:
        p = k // 2 if isinstance(k, int) else [v // 2 for v in k]
    return p


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def batch_stats(zf):
    """``(E[z], E[z²])`` per channel of a float32 NHWC tensor over the
    batch.  Under a data-parallel step (``step_context.mesh``) over the
    global batch, as the JAX step's mean over a batch-sharded array: each
    rank's moments, weighted by its share ``1/world`` of the global pixel
    count (the ranks hold equal slices), are summed over the ranks —
    ``Σz`` and ``Σz²`` over the global count; with one rank every value is
    the one-process value bit for bit."""
    m1, m2 = zf.mean((0, 1, 2)), (zf * zf).mean((0, 1, 2))
    mesh = step_context.mesh()
    if mesh is not None:
        m1, m2 = mesh.sum(torch.stack([m1, m2]) / mesh.world).unbind(0)
    return m1, m2


def batch_norm_train(bn: nn.BatchNorm2d, z):
    """Train-mode BatchNorm of an NHWC conv output, flax semantics: the
    batch mean and the biased variance ``E[z²] - E[z]²`` (clamped at 0)
    in float32 (:func:`batch_stats`), normalise in float32, and the running
    statistics updated as ``0.97·old + 0.03·batch`` with that biased
    variance (``F.batch_norm`` would store the unbiased one).  Returns the
    float32 normalised ``z``."""
    zf = z.float()
    mean, sq = batch_stats(zf)
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(0.97 * bn.running_mean + 0.03 * mean)
        bn.running_var.copy_(0.97 * bn.running_var + 0.03 * var)
    return (zf - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias


def bn_dtype() -> torch.dtype:
    """The dtype of the train-mode BatchNorm output and its SiLU: bfloat16
    under ``YOLO_BN_HALF=1`` (the train CLI's ``--bn-half``), else float32
    (JAX ``layers._bn_dtype``; eval mode stays float32).  As flax's
    ``BatchNorm(dtype=bfloat16)`` does, the statistics, the normalisation,
    scale and shift stay float32 and only their result is cast; the running
    statistics stay float32."""
    if os.environ.get("YOLO_BN_HALF") == "1":
        return torch.bfloat16
    return torch.float32


def silu(y):
    """SiLU in ``y``'s dtype.  In bfloat16 it is the JAX graph's op
    sequence ``y · (1 / (1 + exp(-y)))``, each op rounded to bfloat16 (a
    fused sigmoid rounds once and differs in ~28% of the elements by one
    ulp, which compounds over the layers)."""
    if y.dtype == torch.bfloat16:
        return y * (1 / (1 + torch.exp(-y)))
    return y * torch.sigmoid(y)


def _norm(bn, z):
    """BatchNorm of an NHWC tensor: the batch statistics in train mode,
    its result cast to :func:`bn_dtype`; the running statistics in eval
    mode, in float32."""
    if bn.training:
        return batch_norm_train(bn, z).to(bn_dtype())
    mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
    return (z.float() - bn.running_mean) * mul + bn.bias


def _bn_act_chain(m, z, dtype):
    y = _norm(m.bn, z)
    y = silu(y) if m.act else y
    return y.to(dtype)


def _bn_act(m, z, dtype, plain: bool = False):
    """BatchNorm (batch statistics in train mode, running ones in eval) +
    SiLU in :func:`bn_dtype` → ``dtype``.

    Train mode counts ``bn_act.calls``.  On the card with float32
    BatchNorm (and not ``plain``) it is the hand-written kernels
    (ops/kernels/bn_act_train.py, which raise on a tensor they do not
    take), counted in ``bn_act.fused``; they keep ``z`` alone for the
    backward, as selective remat's checkpoint does.  Otherwise the chain of
    PyTorch ops, under selective remat (``step_context.remat``) as a
    checkpoint that saves ``z`` alone."""
    if not m.bn.training:
        return _bn_act_chain(m, z, dtype)
    count("bn_act.calls")
    if z.is_cuda and not plain and bn_dtype() == torch.float32:
        count("bn_act.fused")
        return bn_act_kernel.bn_act_train(m.bn, z, m.act)
    if step_context.remat() == "selective":
        return checkpoint(_bn_act_chain, m, z, dtype, use_reentrant=False)
    return _bn_act_chain(m, z, dtype)


def _conv(conv: nn.Conv2d, x):
    """``conv`` on an NHWC tensor in ``x``'s dtype (its bias too, if any)."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(x.dtype), b, conv.stride,
                          conv.padding, conv.dilation, conv.groups))


def _bn_module(c):
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + SiLU (reference ``Conv``).

    ``fused=True``: an eligible stride-2 3x3 downsample at a large enough
    input runs on the downsample kernels (ops/kernels/down_kernel.py): at
    inference the conv + BN + SiLU kernel, in training the raw conv kernel
    (with its weight-gradient kernel) and live BatchNorm."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True,
                 fused: bool = False):
        super().__init__()
        self.k, self.s, self.p, self.g, self.act = k, s, p, g, act
        self.fused = fused
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = _bn_module(c2)

    def _down_shape(self, x) -> bool:
        ci, co = self.conv.in_channels, self.conv.out_channels
        return (self.fused and self.k == 3 and self.s == 2 and self.g == 1
                and self.act and self.p in (None, 1)
                and ci % 2 == 0 and co % 8 == 0
                and x.shape[1] * x.shape[2] >= FUSED_DOWN_MIN_SPATIAL)

    def down_eligible(self, x) -> bool:
        """Inference: the conv + BN + SiLU kernel (BN folded, so eval only)."""
        return not self.training and self._down_shape(x)

    def down_train_eligible(self, x) -> bool:
        """Training: the raw conv kernel, then live BatchNorm."""
        return (self.training and self._down_shape(x)
                and self.conv.in_channels % 8 == 0)

    def forward(self, x, plain: bool = False):
        if self.down_eligible(x):
            w, ss = fold_down_params(self.conv, self.bn, x.dtype)
            return (fused_down_plain if plain else fused_down)(x, w, ss)
        if self.down_train_eligible(x):
            ci, co = self.conv.in_channels, self.conv.out_channels
            w = self.conv.weight.permute(2, 3, 1, 0).reshape(9 * ci, co)
            z = down_conv_train(x, w, plain=plain)
        else:
            z = _conv(self.conv, x)
        return _bn_act(self, z, x.dtype, plain)


class PackedStem(ConvBnAct):
    """The stem Conv(c2, 6, 2, 2) + BatchNorm + SiLU reading the packed
    ``(B, H, 3W)`` uint8 image (a free view of the NHWC batch); the /255
    normalize folds into the conv weights.  Parameters and names are those
    of ``ConvBnAct(3, c2, 6, 2, 2)`` (JAX ``PackedStem``, layers.py:213).

    Eval mode: BatchNorm folds too, and the layer is the stem kernel
    (``fused_stem``, ops/kernels/stem_kernel.py) — unless the model runs
    layers 0-1 as the stem+L1 kernel and never calls this layer.  Train
    mode: the raw stem conv kernel (with its weight-gradient kernel) and
    live BatchNorm (JAX ``PackedStem``'s train branch, layers.py:246-259)."""

    def __init__(self, c1, c2, k=6, s=2, p=2, dtype=torch.bfloat16):
        super().__init__(c1, c2, k, s, p)
        if (c1, k, s, p) != (3, 6, 2, 2):
            raise ValueError(f"PackedStem is the Conv(c2, 6, 2, 2) stem of a "
                             f"3-channel image, got c1={c1} k={k} s={s} p={p}")
        self.dtype = dtype

    def forward(self, x, plain: bool = False):
        if x.dtype != torch.uint8 or x.dim() != 3:
            raise ValueError(f"PackedStem takes the packed (B, H, 3W) uint8 "
                             f"image, got {x.dtype} {tuple(x.shape)}")
        if not self.training:
            w0, b0 = fold_stem_params(self.conv.weight, self.bn)
            return (fused_stem_plain if plain else fused_stem)(x, w0, b0,
                                                               self.dtype)
        z = stem_conv_train(x, self.conv.weight / 255.0, self.dtype,
                            plain=plain)
        return _bn_act(self, z, self.dtype, plain)


class Bottleneck(nn.Module):
    """Residual bottleneck (reference models/common.py:94-104)."""

    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x, plain: bool = False):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference models/common.py:126-138).

    ``fused=True``: an eligible block (n <= 4, shortcut, c1 == c2, g == 1,
    e == 0.5, large enough input) runs as the C3 kernel
    (ops/kernels/c3_kernel.py)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5,
                 fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.n, self.shortcut, self.g, self.e = n, shortcut, g, e
        self.fused = fused
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def eligible(self, x) -> bool:
        """The C3 kernel folds BN: inference only."""
        c1, c2 = self.cv1.conv.in_channels, self.cv3.conv.out_channels
        c_ = self.cv1.conv.out_channels
        return (not self.training and self.fused and 1 <= self.n <= 4 and self.shortcut
                and c1 == c2 and self.g == 1 and self.e == 0.5
                and c1 % 2 == 0 and c_ % 8 == 0 and c2 % 8 == 0
                and x.shape[1] * x.shape[2] >= FUSED_C3_MIN_SPATIAL)

    def forward(self, x, plain: bool = False):
        if self.eligible(x):
            p = fold_c3_params(self, x.dtype)
            return (fused_c3_plain if plain else fused_c3)(x, p, self.shortcut)
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], -1))


class SPPF(nn.Module):
    """Fast SPP: 3 chained k-pools (reference models/common.py:181-196)."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, 1)

    def forward(self, x, plain: bool = False):
        x = self.cv1(x)
        pool = lambda t: _nhwc(F.max_pool2d(_nchw(t), self.k, 1, self.k // 2))
        y1 = pool(x)
        y2 = pool(y1)
        y3 = pool(y2)
        return self.cv2(torch.cat([x, y1, y2, y3], -1))


class Concat(nn.Module):
    """Concatenate along channels."""

    def forward(self, xs, plain: bool = False):
        return torch.cat(xs, -1)


class Upsample(nn.Module):
    """Nearest-neighbour upsample by an integer scale."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x, plain: bool = False):
        B, H, W, C = x.shape
        s = self.scale
        return (x[:, :, None, :, None, :].expand(B, H, s, W, s, C)
                .reshape(B, H * s, W * s, C))


# ---------------------------------------------------------------------------
# the Ghost family (JAX layers.py:265-281, :657-714; reference names)
# ---------------------------------------------------------------------------


def _run(mods, x, plain: bool):
    """Apply a sequence of this module family (``nn.Identity`` included)."""
    for m in mods:
        x = x if isinstance(m, nn.Identity) else m(x, plain)
    return x


class DWConv(ConvBnAct):
    """Depthwise-separable conv: a ConvBnAct with ``gcd(c1, c2)`` groups
    (reference models/common.py:52-55); its depthwise conv stays
    ``F.conv2d`` with ``groups``, as the JAX package leaves it to XLA."""

    def __init__(self, c1, c2, k=1, s=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class GhostConv(nn.Module):
    """Ghost convolution (reference models/common.py:211-221): a conv to
    half the channels, then a depthwise 5x5 of that half, concatenated."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, None, g, act)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, None, c_, act)

    def forward(self, x, plain: bool = False):
        y = self.cv1(x, plain)
        return torch.cat([y, self.cv2(y, plain)], -1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck (reference models/common.py:224-236)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = nn.Sequential(
            DWConv(c1, c1, k, s, act=False),
            ConvBnAct(c1, c2, 1, 1, act=False)) if s == 2 else nn.Identity()

    def forward(self, x, plain: bool = False):
        sc = x if isinstance(self.shortcut, nn.Identity) else _run(
            self.shortcut, x, plain)
        return _run(self.conv, x, plain) + sc


class C3Ghost(C3):
    """C3 with GhostBottleneck stages (reference models/common.py:157-162);
    built unfused, so never the C3 kernel."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


# ---------------------------------------------------------------------------
# the rest of the zoo (JAX layers.py:301-328, :520-609, :634-654, :717-880)
# ---------------------------------------------------------------------------


class BottleneckCSP(nn.Module):
    """CSP bottleneck, the original formulation (reference
    models/common.py:107-123): a standalone BatchNorm + SiLU over the
    concatenation of two raw 1x1 convs (``cv3`` after the bottlenecks,
    ``cv2`` on the input), then ``cv4``."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1)
        self.bn = _bn_module(2 * c_)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x, plain: bool = False):
        y1 = self.cv1(x, plain)
        for b in self.m:
            y1 = b(y1, plain)
        y = torch.cat([_conv(self.cv3, y1), _conv(self.cv2, x)], -1)
        return self.cv4(silu(_norm(self.bn, y)).to(x.dtype), plain)


def _linear(lin: nn.Linear, x):
    """``lin`` in ``x``'s dtype; the bias added after the product, as flax's
    ``Dense`` adds it."""
    y = x @ lin.weight.to(x.dtype).t()
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` without masks or dropout:
    separate ``query``/``key``/``value`` projections with bias, the query
    scaled by ``1/sqrt(head_dim)``, a softmax over the keys (the ops of
    ``jax.nn.softmax``), the ``out`` projection with bias.  Written as
    explicit products (no fused attention backend, whose rounding
    differs)."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.h = num_heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.out = nn.Linear(c, c)

    def forward(self, q, k, v):
        B, N, C = q.shape
        d = C // self.h
        heads = lambda lin, t: _linear(lin, t).reshape(B, -1, self.h, d)
        qh = heads(self.query, q) / torch.tensor(math.sqrt(d), dtype=q.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, heads(self.key, k))
        # jax.nn.softmax's ops, each rounded to the dtype (a fused softmax
        # rounds once and differs by an ulp in ~half the bf16 weights)
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", w, heads(self.value, v))
        return _linear(self.out, o.reshape(B, N, C))


class TransformerLayer(nn.Module):
    """LayerNorm-free transformer layer (reference models/common.py:58-72):
    ``q``/``k``/``v`` and ``fc1``/``fc2`` without bias."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = MultiHeadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma(_linear(self.q, x), _linear(self.k, x),
                    _linear(self.v, x)) + x
        return _linear(self.fc2, _linear(self.fc1, x)) + x


class TransformerBlock(nn.Module):
    """ViT-style block over the flattened ``h*w`` tokens (reference
    models/common.py:75-91): a learned position ``linear`` (with bias)
    added to the tokens, then ``num_layers`` transformer layers."""

    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.conv = ConvBnAct(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(
            *(TransformerLayer(c2, num_heads) for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x, plain: bool = False):
        if self.conv is not None:
            x = self.conv(x, plain)
        B, H, W, C = x.shape
        p = x.reshape(B, H * W, C)
        p = p + _linear(self.linear, p)
        for layer in self.tr:
            p = layer(p)
        return p.reshape(B, H, W, self.c2)


class C3TR(C3):
    """C3 with a TransformerBlock inner stage (reference
    models/common.py:141-146).  Never the C3 kernel: the kernel computes
    bottlenecks, not attention."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n)

    def eligible(self, x) -> bool:
        return False

    def forward(self, x, plain: bool = False):
        y1 = self.m(self.cv1(x, plain), plain)
        return self.cv3(torch.cat([y1, self.cv2(x, plain)], -1), plain)


def _max_pool(x, k, s, p=0):
    return _nhwc(F.max_pool2d(_nchw(x), k, s, p))


class SPP(nn.Module):
    """Spatial pyramid pooling (reference models/common.py:165-178)."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x, plain: bool = False):
        x = self.cv1(x, plain)
        pools = [_max_pool(x, k, 1, k // 2) for k in self.k]
        return self.cv2(torch.cat([x, *pools], -1), plain)


class C3SPP(C3):
    """C3 with an SPP inner stage (reference models/common.py:149-154);
    the JAX package's argument order, ``k`` last."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5,
                 k=(5, 9, 13)):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = SPP(c_, c_, k)

    def eligible(self, x) -> bool:
        return False

    def forward(self, x, plain: bool = False):
        y1 = self.m(self.cv1(x, plain), plain)
        return self.cv3(torch.cat([y1, self.cv2(x, plain)], -1), plain)


class Focus(nn.Module):
    """Space-to-depth stem (reference models/common.py:199-208): the four
    pixel phases ``[::2, ::2]``, ``[1::2, ::2]``, ``[::2, 1::2]``,
    ``[1::2, 1::2]`` (rows, columns) stacked on the channels, then a
    ConvBnAct."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, s, p, g, act)

    def forward(self, x, plain: bool = False):
        x = torch.cat([x[:, ::2, ::2], x[:, 1::2, ::2], x[:, ::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.conv(x, plain)


class CrossConv(nn.Module):
    """Cross convolution (reference models/experimental.py:15-26): a
    ``(1, k)`` ConvBnAct of stride ``(1, s)``, then a ``(k, 1)`` one of
    stride ``(s, 1)`` with ``g`` groups."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnAct(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x, plain: bool = False):
        y = self.cv2(self.cv1(x, plain), plain)
        return x + y if self.add else y


class Contract(nn.Module):
    """Space-to-depth ``(b, h, w, c) → (b, h/g, w/g, g·g·c)``, NHWC order
    ``(g, g, c)`` on the channels (JAX layers.py:755)."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x, plain: bool = False):
        g = self.gain
        B, H, W, C = x.shape
        x = x.reshape(B, H // g, g, W // g, g, C).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, H // g, W // g, C * g * g)


class Expand(nn.Module):
    """Depth-to-space ``(b, h, w, c) → (b, h·g, w·g, c/g²)``, the inverse
    of :class:`Contract` (JAX layers.py:768)."""

    def __init__(self, gain=2):
        super().__init__()
        self.gain = gain

    def forward(self, x, plain: bool = False):
        g = self.gain
        B, H, W, C = x.shape
        x = x.reshape(B, H, W, g, g, C // (g * g)).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, H * g, W * g, C // (g * g))


class Classify(nn.Module):
    """Classification head (reference models/common.py:628-638): global
    average pool, a 1x1 conv with bias, flattened."""

    def __init__(self, c1, c2):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, 1)

    def forward(self, x, plain: bool = False):
        x = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        return _conv(self.conv, x).reshape(x.shape[0], -1)


class Sum(nn.Module):
    """Sum of ``n`` inputs, optionally weighted (reference
    models/experimental.py:29-47): ``y = x0 + Σ 2σ(wᵢ)·xᵢ₊₁`` with ``w``
    learned, initialised to ``-arange(1, n) / 2``."""

    def __init__(self, n, weight=False):
        super().__init__()
        self.n = n
        self.w = (nn.Parameter(-torch.arange(1.0, n) / 2) if weight
                  else None)

    def forward(self, xs, plain: bool = False):
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i].to(y.dtype))
        return y


class MixConv2d(nn.Module):
    """Mixed kernel sizes (reference models/experimental.py:50-71): the
    output channels split over the kernels as ``floor(linspace(0, n -
    1e-6, c2))`` does, each conv with ``gcd(c1, c_)`` groups,
    concatenated, then BatchNorm + SiLU."""

    def __init__(self, c1, c2, k=(1, 3), s=1):
        super().__init__()
        k = tuple(k)
        idx = np.floor(np.linspace(0, len(k) - 1e-6, c2)).astype(int)
        split = [int((idx == g).sum()) for g in range(len(k))]
        self.m = nn.ModuleList(
            nn.Conv2d(c1, c_, ki, s, ki // 2, groups=math.gcd(c1, c_),
                      bias=False) for ki, c_ in zip(k, split))
        self.bn = _bn_module(c2)

    def forward(self, x, plain: bool = False):
        y = torch.cat([_conv(m, x) for m in self.m], -1)
        return silu(_norm(self.bn, y)).to(x.dtype)


class MaxPool(nn.Module):
    """Max-pool of ``k`` with stride ``s`` (default ``k``), no padding (the
    reference yolov3-tiny's ``nn.MaxPool2d`` rows; flax ``max_pool``
    VALID)."""

    def __init__(self, k=2, s=None):
        super().__init__()
        self.k, self.s = k, s or k

    def forward(self, x, plain: bool = False):
        return _max_pool(x, self.k, self.s)
