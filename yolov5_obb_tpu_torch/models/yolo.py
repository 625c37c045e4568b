"""YOLOv5-OBB model: YAML graph spec → PyTorch module graph, Detect head.

Counterpart of ``yolov5_obb_tpu/models/yolo.py``.  The YAML spec is the
single source of truth for the 21 bundled configs (``models/configs``: the
P5 n/s/m/l/x, the P6 n6-x6, P2, P7, BiFPN, FPN, PANet, YOLOv3, the ghost
and transformer variants; ``anchors.yaml`` holds anchor sets).
``packed_stem`` builds the fast path: ``forward`` then takes the raw
``(B, H, 3W)`` uint8 view.  In eval mode layers 0-1 run
as the fused stem+L1 kernel where layer 1 can join the stem
(:func:`packed_l1_eligible`, and ``PACKED_L1`` is not ``0``), else layer 0
as the stem kernel; the eligible C3 blocks and stride-2 downsamples run as
their kernels.  In train mode layer 0 runs on the stem train kernels and
the eligible downsamples on the downsample train kernels (models/layers.py
gates).
``fused_train`` (with ``packed_stem``) runs layers 0-3 in train mode as the
stat-carrying pass chain of ``ops/kernels/train_fused.py``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import train_fused as TF
from ..ops.kernels.stem_kernel import (
    fold_stem_l1_params,
    fused_stem_l1,
    fused_stem_l1_plain,
    stem_conv_train,
)
from ..utils.device import resolve_device
from . import layers as L
from . import step_context

THETA_BINS = 180


# ---------------------------------------------------------------------------
# config parsing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    frm: Any  # int or tuple of ints
    repeats: int
    name: str
    args: tuple


@dataclasses.dataclass
class ModelMeta:
    """Static model metadata needed by decode/NMS."""

    nc: int
    nl: int
    na: int
    strides: tuple  # per level, input pixels
    anchors_px: np.ndarray  # (nl, na, 2) in input pixels
    names: list | None = None

    @property
    def anchors_grid(self) -> np.ndarray:
        """Anchors in feature-map units per level (reference yolo.py:124)."""
        return self.anchors_px / np.asarray(self.strides)[:, None, None]

    @property
    def no(self) -> int:
        return self.nc + 5 + THETA_BINS


def load_config(cfg) -> dict:
    if isinstance(cfg, dict):
        return dict(cfg)
    p = Path(cfg)
    if not p.exists():
        p = Path(__file__).parent / "configs" / p.name
    with open(p) as f:
        return yaml.safe_load(f)


# modules whose first arg is an output-channel count subject to width scaling
_CH_MODULES = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF",
    "DWConv", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "C3SPP",
    "C3Ghost", "MixConv2d",
}
# modules that additionally take the repeat count as a constructor arg
_REPEAT_MODULES = {"BottleneckCSP", "C3", "C3TR", "C3Ghost"}
_NAMES = {"nn.Upsample": "Upsample", "nn.MaxPool": "MaxPool",
          "nn.MaxPool2d": "MaxPool"}


def parse_model_config(d: dict, ch_in: int = 3):
    """YAML dict → (specs, nc, na, anchors_px, detect_from); the reference
    ``parse_model`` channel arithmetic (JAX yolo.py:83-156).  ``anchors: N``
    (an integer) gives N placeholder priors a level: squares of 1.25, 2.5,
    5, ... times the level's stride, for a P3-first ladder (fit them to a
    dataset with ``utils/autoanchor``)."""
    anchors, nc = d["anchors"], d["nc"]
    gd, gw = d["depth_multiple"], d["width_multiple"]
    na = len(anchors[0]) // 2 if isinstance(anchors, list) else anchors

    specs: list[LayerSpec] = []
    ch = [ch_in]
    detect_from = None
    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        name = _NAMES.get(name, name)
        args = list(args)
        n_eff = max(round(n * gd), 1) if n > 1 else n
        if name in _CH_MODULES:
            c1 = ch[f]
            c2 = L.make_divisible(args[0] * gw, 8)
            args = [c1, c2, *args[1:]]
            if name in _REPEAT_MODULES:
                args.insert(2, n_eff)
                n_eff = 1
        elif name == "Concat":
            c2 = sum(ch[x] for x in f)
        elif name == "Sum":
            args = [len(f), *args[1:]] if args else [len(f)]
            c2 = ch[f[0]]
        elif name == "Detect":
            detect_from = tuple(f)
            args = [tuple(ch[x] for x in f)]
            c2 = None
        elif name == "Contract":
            c2 = ch[f] * args[0] ** 2
        elif name == "Expand":
            c2 = ch[f] // args[0] ** 2
        else:
            c2 = ch[f] if isinstance(f, int) else ch[f[0]]
        specs.append(LayerSpec(
            i, tuple(f) if isinstance(f, list) else f, n_eff, name,
            tuple(tuple(v) if isinstance(v, list) else v for v in args)))
        if i == 0:
            ch = []
        ch.append(c2)
    if isinstance(anchors, int):
        sizes = np.array([[1.25 * 2.0 ** a] * 2 for a in range(anchors)],
                         dtype=np.float32)
        anchors_px = np.stack([sizes * 2.0 ** (li + 3)
                               for li in range(len(detect_from))]
                              ).astype(np.float32)
    else:
        anchors_px = np.asarray(anchors, dtype=np.float32).reshape(
            len(anchors), -1, 2)
    return specs, nc, na, anchors_px, detect_from


# ---------------------------------------------------------------------------
# Detect head
# ---------------------------------------------------------------------------


class Detect(nn.Module):
    """OBB head: per level a 1x1 conv → flat ``(B, ny*nx*na, no)`` map,
    channel layout per anchor ``[x y w h obj cls*nc theta*180]``; in the
    compute dtype at inference (bf16 on the card), float32 in train mode
    for the loss (JAX yolo.py:196)."""

    def __init__(self, nc: int, na: int, ch: tuple):
        super().__init__()
        self.nc, self.na = nc, na
        self.no = nc + 5 + THETA_BINS
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in ch)

    def forward(self, xs, plain: bool = False):
        outs = []
        for conv, x in zip(self.m, xs):
            y = torch.nn.functional.conv2d(
                L._nchw(x), conv.weight.to(x.dtype), conv.bias.to(x.dtype))
            B, _, ny, nx = y.shape
            flat = L._nhwc(y).reshape(B, ny * nx * self.na, self.no)
            outs.append(flat.float() if self.training else flat)
        return outs


def decode(maps, meta: ModelMeta, image_hw):
    """Flat Detect maps → ``(B, sum(ny*nx*na), no)`` float32 decoded
    predictions (JAX ``decode``, yolo.py:202): xy = (2σ - 0.5 + grid) ·
    stride, wh = (2σ)² · anchor_px, everything else σ.

    Each level ``(B, ny*nx*na, no)`` has the anchor index varying fastest;
    ``ny``, ``nx`` are the input's ``image_hw`` over the level's stride, so
    levels need not be square."""
    H, W = image_hw
    zs = []
    for li, p in enumerate(maps):
        B, n, no = p.shape
        stride = meta.strides[li]
        ny, nx = int(round(H / stride)), int(round(W / stride))
        if ny * nx * meta.na != n:
            raise ValueError(f"Detect level {li}: n={n} is not {ny}x{nx} "
                             f"cells of {meta.na} anchors at stride {stride}")
        y = torch.sigmoid(p.float().reshape(B, ny, nx, meta.na, no))
        gy, gx = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=p.device),
            torch.arange(nx, dtype=torch.float32, device=p.device),
            indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :]  # (ny, nx, 1, 2)
        anchor = torch.as_tensor(np.asarray(meta.anchors_px[li], np.float32),
                                 device=p.device)  # (na, 2)
        xy = (y[..., 0:2] * 2 - 0.5 + grid) * stride
        wh = (y[..., 2:4] * 2) ** 2 * anchor
        zs.append(torch.cat([xy, wh, y[..., 4:]], -1).reshape(B, n, no))
    return torch.cat(zs, 1)


# ---------------------------------------------------------------------------
# full model graph
# ---------------------------------------------------------------------------


_PLAIN_MODULES = {
    "Bottleneck": L.Bottleneck, "BottleneckCSP": L.BottleneckCSP,
    "C3TR": L.C3TR, "C3SPP": L.C3SPP, "C3Ghost": L.C3Ghost, "SPP": L.SPP,
    "SPPF": L.SPPF, "Focus": L.Focus, "DWConv": L.DWConv,
    "GhostConv": L.GhostConv, "GhostBottleneck": L.GhostBottleneck,
    "CrossConv": L.CrossConv, "Contract": L.Contract, "Expand": L.Expand,
    "Sum": L.Sum, "MixConv2d": L.MixConv2d, "Classify": L.Classify}


def _build_module(spec: LayerSpec, packed_stem: bool, dtype):
    """Every kind of JAX ``_build_module`` (yolo.py:234-266).  Only ``Conv``
    and ``C3`` take the kernels' gates (``fused``); C3TR, C3SPP and C3Ghost
    are built without them, as in the JAX package."""
    kind, a = spec.name, spec.args
    if packed_stem and spec.index == 0:
        return L.PackedStem(*a, dtype=dtype)
    if kind == "Conv":
        return L.ConvBnAct(*a, fused=packed_stem)
    if kind == "C3":
        return L.C3(*a, fused=packed_stem)
    if kind in _PLAIN_MODULES:
        return _PLAIN_MODULES[kind](*a)
    if kind == "Concat":
        return L.Concat()
    if kind == "Upsample":
        return L.Upsample(int(a[1]) if len(a) > 1 else 2)
    if kind == "MaxPool":
        return L.MaxPool(*(int(v) for v in a))
    raise ValueError(f"unknown module {kind!r} in model config")


def _fused_train_specs_ok(specs) -> bool:
    """True iff layers 0-3 form the standard high-resolution prefix stem
    Conv(6,2) → Conv(3,2) → C3(c,c,n shortcut) → Conv(3,2) and no later
    layer references layers 0-2 (whose activations the fused train region
    never forms).  A copy of the JAX package's structural gate
    (yolo.py:269-296); its Mosaic shape terms have no counterpart."""
    if len(specs) < 5:
        return False
    s0, s1, s2, s3 = specs[:4]
    if not (s0.name == "Conv" and list(s0.args[2:4]) == [6, 2]):
        return False
    if not (s1.name == "Conv" and list(s1.args[2:4]) == [3, 2]
            and s1.frm == -1 and s1.repeats == 1):
        return False
    if not (s2.name == "C3" and s2.frm == -1 and s2.repeats == 1):
        return False
    a2 = list(s2.args)
    if a2[0] != a2[1] or a2[1] % 2 or (len(a2) > 3 and not a2[3]):
        return False
    if len(a2) > 4 and a2[4] != 1:  # groups
        return False
    if not (s3.name == "Conv" and list(s3.args[2:4]) == [3, 2]
            and s3.frm == -1 and s3.repeats == 1):
        return False
    for sp in specs[4:]:
        refs = (sp.frm,) if isinstance(sp.frm, int) else tuple(sp.frm)
        if any(j in (0, 1, 2) for j in refs):
            return False
    return True


def _bn_update(bn, mean, var) -> None:
    """flax's running-statistic update, ``0.97·old + 0.03·batch``."""
    bn.running_mean.copy_(0.97 * bn.running_mean + 0.03 * mean)
    bn.running_var.copy_(0.97 * bn.running_var + 0.03 * var)


class YoloModel(nn.Module):
    """Backbone + PAN + Detect, built from parsed specs.

    ``packed_stem``: ``forward`` takes the packed ``(B, H, 3W)`` uint8 image
    (/255 folded into the stem weights) and the eligible layers run on
    kernels.  In eval mode layers 0-1 run as the stem+L1 kernel (layer 0's
    activation is never formed; ``packed_l1``) or layer 0 as the stem
    kernel, and the eligible C3 blocks and downsamples as theirs.  In train
    mode layer 0 is a :class:`~.layers.PackedStem` on
    the stem train kernels, layer 1 a ``ConvBnAct`` (JAX yolo.py:481-485:
    the stem+L1 fold is inference-only) and the eligible downsamples run on
    the downsample train kernels.  Otherwise ``forward`` takes a float NHWC
    image in [0, 1] and runs the stock layers.  ``dtype`` is the compute
    dtype; parameters and BN statistics stay float32.

    ``packed_l1`` (set only with ``packed_stem``): in eval mode layers 0-1
    run as the stem+L1 kernel; without it layer 0 runs as the stem kernel
    and layer 1 as its stock self.

    ``fused_train`` (set only with ``packed_stem``): in train mode, when
    :func:`_fused_train_specs_ok` holds, layers 0-3 run as the
    stat-carrying pass chain (:meth:`_fused_train_region`).  The modules
    and parameter names are those of the stock graph."""

    def __init__(self, specs, nc: int, na: int, dtype=torch.float32,
                 packed_stem: bool = False, packed_l1: bool = False,
                 fused_train: bool = False):
        super().__init__()
        self.specs = tuple(specs)
        self.nc, self.na, self.dtype = nc, na, dtype
        self.packed_stem = packed_stem
        self.packed_l1 = packed_l1 and packed_stem
        self.fused_train = fused_train
        layers = []
        for spec in self.specs:
            if spec.name == "Detect":
                layers.append(Detect(nc, na, spec.args[0]))
            elif spec.repeats == 1:
                layers.append(_build_module(spec, packed_stem, dtype))
            else:
                layers.append(nn.Sequential(*(
                    _build_module(spec, packed_stem, dtype)
                    for _ in range(spec.repeats))))
        self.model = nn.ModuleList(layers)

    def _stem_l1(self, x, plain: bool):
        m0, m1 = self.model[0], self.model[1]
        ops = fold_stem_l1_params(m0.conv.weight, m0.bn, m1.conv.weight,
                                  m1.bn, dtype=self.dtype)
        fn = fused_stem_l1_plain if plain else fused_stem_l1
        return fn(x, *ops, dtype=self.dtype)

    def _fused_train_region(self, x, plain: bool):
        """Layers 0-3 as the stat-carrying pass chain (train mode only;
        JAX ``YoloModel._fused_train_region``, yolo.py:348-436).  Returns
        layer 3's activation in the model dtype and updates the running
        statistics of layers 0-3 and of every C3 sub-conv."""
        m0, m1, c3, m3 = self.model[:4]
        c_ = c3.cv1.conv.out_channels
        updates = []
        mesh = step_context.mesh()

        def fin(st, conv_bn, n):
            if mesh is not None:
                # a data-parallel step: (Σz, Σz²) and the pixel count of
                # the global batch (ranks hold equal slices)
                st, n = mesh.sum(st), n * mesh.world
            g, b, mean, var = TF.finalize_gb(st[0], st[1], conv_bn.bn.weight,
                                             conv_bn.bn.bias, n)
            updates.append((conv_bn.bn, mean, var))
            return torch.stack([g, b])

        def taps(m):
            w = m.conv.weight
            return w.permute(2, 3, 1, 0).reshape(9 * w.shape[1], w.shape[0])

        def w1x1(m):
            return m.conv.weight[:, :, 0, 0].t()  # (ci, co)

        def npix(z):
            return z.shape[0] * z.shape[1] * z.shape[2]

        # the stem conv (kernel; its stat cotangents reach the weight
        # gradient kernel through the torch sums)
        z0 = stem_conv_train(x, m0.conv.weight / 255.0, torch.bfloat16,
                             plain=plain)
        z0f = z0.float()
        st0 = torch.stack([z0f.sum((0, 1, 2)), (z0f * z0f).sum((0, 1, 2))])
        gb0 = fin(st0, m0, npix(z0))
        # down1: the stem's BN+SiLU fused with the stride-2 conv
        z1, st1 = TF.pass_3x3s2(z0, gb0, taps(m1), plain)
        n1 = npix(z1)
        gb1 = fin(st1, m1, n1)
        # C3 cv1 + cv2: one read of z1, two outputs
        (zc1, zc2), (sta, stb) = TF.pass_1x1(
            (True,), ((0,),), (((0, 0),), ((0, 1),)), (z1,), (gb1,),
            (w1x1(c3.cv1), w1x1(c3.cv2)), plain)
        gba = fin(sta, c3.cv1, n1)
        gbb = fin(stb, c3.cv2, n1)
        # bottlenecks: the residual sums stay in z-space — bottleneck k's
        # input is the sum of the activations of cv1's output and of every
        # earlier bottleneck's 3x3 output
        chain, gbs = [zc1], [gba]
        for b in c3.m:
            m = len(chain)
            (zd,), (std,) = TF.pass_1x1(
                (True,) * m, (tuple(range(m)),), (((0, 0),),), tuple(chain),
                tuple(gbs), (w1x1(b.cv1),), plain)
            gbd = fin(std, b.cv1, n1)
            ze, ste = TF.pass_3x3s1(zd, gbd, taps(b.cv2), plain)
            chain.append(ze)
            gbs.append(fin(ste, b.cv2, n1))
        # cv3 on concat(chain, cv2): its weight split at c_ into two groups
        m = len(chain)
        wc3 = w1x1(c3.cv3)
        (z3,), (st3,) = TF.pass_1x1(
            (True,) * (m + 1), (tuple(range(m)), (m,)), (((0, 0), (1, 1)),),
            (*chain, zc2), (*gbs, gbb), (wc3[:c_], wc3[c_:]), plain)
        gb3 = fin(st3, c3.cv3, n1)
        # down2
        zd2, std2 = TF.pass_3x3s2(z3, gb3, taps(m3), plain)
        gbo = fin(std2, m3, npix(zd2))
        # hand-off to layer 4: BN+SiLU in float32 (bfloat16 under
        # YOLO_BN_HALF=1, its operands cast first, JAX yolo.py:427-429),
        # cast to the model dtype
        bd = L.bn_dtype()
        h = zd2.to(bd) * gbo[0].to(bd) + gbo[1].to(bd)
        with torch.no_grad():
            for bn, mean, var in updates:
                _bn_update(bn, mean, var)
        return L.silu(h).to(self.dtype)

    def forward(self, x, plain: bool = False):
        """Image batch → list of flat Detect maps ``(B, n_l, no)``.  In
        train mode under full remat (``step_context.remat``, the train
        step's ``remat``) each layer runs under a non-reentrant
        checkpoint: the backward recomputes one layer at a time from the
        layers' inputs."""
        remat = self.training and step_context.remat() == "full"

        def call(m, h):
            if remat:
                return checkpoint(m, h, plain, use_reentrant=False)
            return m(h, plain)

        y: list = []
        skip = 0
        if (self.training and self.fused_train and x.dim() == 3
                and _fused_train_specs_ok(self.specs)):
            y = [None, None, None, call(self._fused_train_region, x)]
            skip = 4
        elif self.packed_l1 and not self.training:
            y = [None, self._stem_l1(x, plain)]
            skip = 2
        elif not self.packed_stem:
            x = x.to(self.dtype)

        def fetch(j):
            return (y[-1] if y else x) if j == -1 else y[j]

        out = None
        for spec, m in zip(self.specs[skip:], self.model[skip:]):
            f = spec.frm
            h = fetch(f) if isinstance(f, int) else [fetch(j) for j in f]
            if isinstance(m, nn.Sequential):
                for r in m:
                    h = call(r, h)
            else:
                h = call(m, h)
            if spec.name == "Detect":
                out = h
                h = None
            y.append(h)
        # a graph without a Detect head yields its last layer's output
        return out if out is not None else y[-1]


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------


def packed_stem_eligible(specs) -> bool:
    """The first layer is the Conv(c2, 6, 2) stem the packed path reads."""
    s0 = specs[0]
    return s0.name == "Conv" and list(s0.args[2:4]) == [6, 2]


def packed_l1_eligible(specs) -> bool:
    """Layers 0-1 can run as the stem+L1 kernel: a Conv(c2, 6, 2) stem, a
    Conv(c3, 3, 2) layer 1 reading it, and no later layer reading layer 0
    (its activation is never formed)."""
    if len(specs) < 2:
        return False
    s1 = specs[1]
    refs0 = any((sp.frm == 0 if isinstance(sp.frm, int) else 0 in sp.frm)
                for sp in specs[2:])
    return (packed_stem_eligible(specs)
            and s1.name == "Conv" and list(s1.args[2:4]) == [3, 2]
            and s1.frm == -1 and s1.repeats == 1 and not refs0)


def build_model(cfg, nc: int | None = None, dtype=torch.float32,
                packed_stem: bool = False, fused_train: bool = False):
    """Load config → (YoloModel on the meta device, ModelMeta without
    strides, raw dict).  As in the JAX package (yolo.py:518-542):
    ``packed_stem`` takes effect only for a Conv(c2, 6, 2) stem; layer 1
    joins the stem in the stem+L1 kernel where it can
    (:func:`packed_l1_eligible`) unless the environment sets
    ``PACKED_L1=0``; ``fused_train`` takes effect only with
    ``packed_stem``."""
    d = load_config(cfg)
    if nc is not None and nc != d.get("nc"):
        d["nc"] = nc
    specs, nc_, na, anchors_px, _ = parse_model_config(d)
    packed_stem = packed_stem and packed_stem_eligible(specs)
    packed_l1 = (packed_stem and packed_l1_eligible(specs)
                 and int(os.environ.get("PACKED_L1", "1")) != 0)
    with torch.device("meta"):
        model = YoloModel(specs, nc_, na, dtype=dtype,
                          packed_stem=packed_stem, packed_l1=packed_l1,
                          fused_train=fused_train and packed_stem)
    meta = ModelMeta(nc=nc_, nl=anchors_px.shape[0], na=na, strides=(),
                     anchors_px=anchors_px)
    return model, meta, d


def _dummy_input(model: YoloModel, imgsz: int, device):
    if model.packed_stem:
        return torch.zeros(1, imgsz, imgsz * 3, dtype=torch.uint8,
                           device=device)
    return torch.zeros(1, imgsz, imgsz, 3, device=device)


def probe_strides(model: YoloModel, meta: ModelMeta,
                  imgsz: int = 256) -> ModelMeta:
    """Per-level strides from a forward on the meta device (shapes only, no
    arithmetic) — the counterpart of the JAX ``jax.eval_shape`` probe."""
    training = model.training
    with torch.no_grad():
        outs = model.to("meta").eval()(_dummy_input(model, imgsz, "meta"),
                                       plain=True)
    model.train(training)
    strides = tuple(float(imgsz // round((o.shape[1] // meta.na) ** 0.5))
                    for o in outs)
    meta = dataclasses.replace(meta, strides=strides)
    # anchor order must match stride order: the levels' anchors flip when
    # their mean areas run against the strides (reference
    # utils/autoanchor.py check_anchor_order; the JAX package's reorder by
    # the strides' rank leaves levels listed largest-first as they are)
    areas = meta.anchors_px.prod(-1).mean(-1)
    da, ds = areas[-1] - areas[0], strides[-1] - strides[0]
    if da and np.sign(da) != np.sign(ds):
        meta = dataclasses.replace(meta, anchors_px=meta.anchors_px[::-1])
    return meta


def init_model(model: YoloModel, meta: ModelMeta,
               generator: torch.Generator) -> None:
    """Initialise in place, on the CPU, from ``generator``: conv and linear
    kernels LeCun-normal (truncated at 2σ, flax's default), biases zero, BN
    identity, a weighted ``Sum``'s ``w`` at ``-arange(1, n) / 2``, Detect
    biases zero plus the focal-style priors (reference yolo.py:224-232)."""
    for mod in model.modules():
        if isinstance(mod, L.Sum) and mod.w is not None:
            with torch.no_grad():
                mod.w.copy_(-torch.arange(1.0, mod.n) / 2)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    det = model.model[-1]
    with torch.no_grad():
        for li, s in enumerate(meta.strides):
            b = det.m[li].bias.view(meta.na, meta.no)
            b[:, 4] += math.log(8 / (640 / s) ** 2)  # obj prior
            b[:, 5:] += math.log(0.6 / (meta.nc - 0.999999))  # cls (+theta)


def create_model(cfg, nc: int | None = None, dtype=torch.float32,
                 device=None, seed: int = 0, packed_stem: bool = False,
                 fused_train: bool = False):
    """One-call constructor: ``(model, meta)``, weights random from ``seed``
    (an explicit ``torch.Generator`` on the CPU), in eval mode on
    ``device`` — the card unless ``device="cpu"`` is passed.  ``model.train()``
    switches it to the train path (:mod:`..engine.trainer`); with
    ``packed_stem`` and ``fused_train`` that path runs layers 0-3 as the
    fused pass chain."""
    dev = resolve_device(device)
    model, meta, d = build_model(cfg, nc=nc, dtype=dtype,
                                 packed_stem=packed_stem,
                                 fused_train=fused_train)
    meta = probe_strides(model, meta)
    meta.names = d.get("names")
    model = model.to_empty(device="cpu")
    init_model(model, meta, torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), meta
