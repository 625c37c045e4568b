"""The stem kernels, all reading the packed ``(B, H, 3W)`` uint8 image — a
free view of the NHWC batch — so the /255 normalize folds into the stem
weights.  The kernels read the 6x6 stem taps directly; the TPU tap remap
(``remap_w6``) and its 128-row weight pad have no counterpart.

- Inference: image ingest + stem Conv(6,2,2) + layer-1 Conv(3,2), BN and
  SiLU folded into both (``fused_stem_l1``; counterpart of
  ``yolov5_obb_tpu/ops/pallas/stem_kernel.fused_stem_l1``, stem_kernel.py:599,
  and ``fold_stem_l1_params``, :481).
- Inference, the stem alone, when layer 1 cannot join it (``fused_stem``;
  counterpart of ``fused_stem``, :153, and ``fold_stem_params``, :453).
- Training: the raw pre-BN stem conv and its weight gradient
  (``stem_conv_train``; counterpart of ``stem_conv_train``, :428).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import I, Kernel, P, check_aligned, check_cuda, query

KERNEL = Kernel(
    "stem_l1", "stem_l1_launch", [P, P, P, P, P, P, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/stem_kernel.py:599")
STEM_KERNEL = Kernel(
    "stem", "stem_launch", [P, P, P, P, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/stem_kernel.py:153")
TRAIN_FWD_KERNEL = Kernel(
    "stem_train", "stem_train_fwd_launch", [P, P, P, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/stem_kernel.py:267")
TRAIN_WGRAD_KERNEL = Kernel(
    "stem_train", "stem_train_wgrad_launch", [P, P, P, P, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/stem_kernel.py:291")


def _bn_fold(bn, eps: float):
    g = bn.weight / torch.sqrt(bn.running_var + eps)
    return g, bn.bias - bn.running_mean * g


@torch.no_grad()
def fold_stem_params(k0, bn0, eps: float = 1e-3):
    """Stem Conv+BN → operands of :func:`fused_stem`.

    ``k0`` ``(c2, 3, 6, 6)`` OIHW conv weights; ``bn0`` a BatchNorm module
    (inference statistics).  Returns ``w0 (108, c2)`` float32, row
    ``(6*dy + dx)*3 + c`` (the 6x6 taps as they are: the TPU's ``remap_w6``
    has no counterpart), with the BN scale and the /255 folded in, and
    ``b0 (c2,)`` float32."""
    g0, b0 = _bn_fold(bn0, eps)
    w0 = (k0 * g0[:, None, None, None] / 255.0).permute(2, 3, 1, 0)
    return (w0.reshape(108, w0.shape[-1]).float().contiguous(),
            b0.float().contiguous())


def _stem_out_hw(H: int, W: int) -> tuple[int, int]:
    return (H - 2) // 2 + 1, (W - 2) // 2 + 1


def fused_stem_plain(x_packed, w0, b0, dtype=torch.bfloat16):
    """Plain version: the float32 conv of the uint8 values with bias, SiLU in
    float32, one rounding to ``dtype``.  Returns ``(B, Hs, Ws, c2)``."""
    c2 = b0.shape[0]
    k0 = w0.float().reshape(6, 6, 3, c2).permute(3, 2, 0, 1)
    s = F.conv2d(_image_nchw(x_packed).float(), k0, b0.float(), stride=2,
                 padding=2)
    return (s * torch.sigmoid(s)).to(dtype).permute(0, 2, 3, 1).contiguous()


def fused_stem(x_packed, w0, b0, dtype=torch.bfloat16):
    """Fused ingest + stem Conv + BN + SiLU on the packed ``(B, H, 3W)``
    uint8 image; operands from :func:`fold_stem_params`.  Returns ``(B, Hs,
    Ws, c2)``, ``Hs = (H - 2)//2 + 1``.  CPU tensors take the plain version;
    CUDA tensors take the kernel, which computes bf16 outputs only."""
    if x_packed.device.type == "cpu":
        return fused_stem_plain(x_packed, w0, b0, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the stem kernel computes bf16, not {dtype}")
    check_cuda("x_packed", x_packed, torch.uint8, 3)
    check_cuda("w0", w0, torch.float32, 2)
    check_cuda("b0", b0, torch.float32, 1)
    B, H, W3 = x_packed.shape
    W, c2 = W3 // 3, b0.shape[0]
    if W3 % 3 or H < 2 or W < 2 or w0.shape != (108, c2) or c2 % 8:
        raise ValueError(f"stem kernel: bad shapes x {tuple(x_packed.shape)}, "
                         f"w0 {tuple(w0.shape)} (c2 % 8 == 0)")
    out = torch.empty(B, *_stem_out_hw(H, W), c2, dtype=torch.bfloat16,
                      device=x_packed.device)
    STEM_KERNEL.launch(x_packed, w0, b0, out, B, H, W, c2)
    return out


@torch.no_grad()
def fold_stem_l1_params(k0, bn0, k1, bn1, dtype=torch.bfloat16,
                        eps: float = 1e-3):
    """Stem + layer-1 Conv+BN → operands of :func:`fused_stem_l1`.

    ``k0`` ``(c2, 3, 6, 6)`` and ``k1`` ``(c3, c2, 3, 3)`` are OIHW conv
    weights; ``bn0``/``bn1`` BatchNorm modules (inference statistics).
    Returns ``w0 (108, c2)`` float32, row ``(6*dy + dx)*3 + c``, with the BN
    scale and the /255 folded in; ``b0 (c2,)``; ``w1 (9*c2, c3)`` in
    ``dtype``, row ``(3*dy + dx)*c2 + ci``, BN scale folded; ``b1 (c3,)``.
    """
    w0, b0 = fold_stem_params(k0, bn0, eps)
    g1, b1 = _bn_fold(bn1, eps)
    w1 = (k1 * g1[:, None, None, None]).permute(2, 3, 1, 0)
    c2, c3 = w0.shape[-1], w1.shape[-1]
    return (w0, b0, w1.reshape(9 * c2, c3).to(dtype).contiguous(),
            b1.float().contiguous())


def _image_nchw(x_packed):
    """The packed ``(B, H, 3W)`` image as an NCHW view (no copy)."""
    B, H, W3 = x_packed.shape
    return x_packed.reshape(B, H, W3 // 3, 3).permute(0, 3, 1, 2)


def fused_stem_l1_plain(x_packed, w0, b0, w1, b1, dtype=torch.bfloat16):
    """Plain version: the stem as :func:`fused_stem_plain` (rounded to
    ``dtype`` before layer 1, as the kernel does), layer 1 in float32 on the
    ``dtype`` values.  Returns ``(B, H/4, W/4, c3)`` in ``dtype``."""
    c2, c3 = b0.shape[0], b1.shape[0]
    s = fused_stem_plain(x_packed, w0, b0, dtype).permute(0, 3, 1, 2).float()
    k1 = w1.float().reshape(3, 3, c2, c3).permute(3, 2, 0, 1)
    y = F.conv2d(s, k1, b1.float(), stride=2, padding=1)
    return (y * torch.sigmoid(y)).to(dtype).permute(0, 2, 3, 1).contiguous()


def fused_stem_l1(x_packed, w0, b0, w1, b1, dtype=torch.bfloat16):
    """Fused ingest + stem + layer 1 on the packed ``(B, H, 3W)`` uint8
    image; operands from :func:`fold_stem_l1_params`.  Returns
    ``(B, Ho, Wo, c3)``.  CPU tensors take the plain version; CUDA tensors
    take the kernel, which computes bf16 outputs only, for c2 <= 80 (the
    widths of yolov5n to yolov5x: its shared memory holds the stem tile)."""
    if x_packed.device.type == "cpu":
        return fused_stem_l1_plain(x_packed, w0, b0, w1, b1, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the stem+L1 kernel computes bf16, not {dtype}")
    check_cuda("x_packed", x_packed, torch.uint8, 3)
    check_cuda("w0", w0, torch.float32, 2)
    check_cuda("b0", b0, torch.float32, 1)
    check_cuda("w1", w1, torch.bfloat16, 2)
    check_cuda("b1", b1, torch.float32, 1)
    B, H, W3 = x_packed.shape
    W = W3 // 3
    c2, c3 = b0.shape[0], b1.shape[0]
    if (W3 % 3 or H < 2 or W < 2 or w0.shape != (108, c2)
            or w1.shape != (9 * c2, c3) or c2 % 8 or c3 % 8 or c2 > 80):
        raise ValueError(
            f"stem+L1 kernel: bad shapes x {tuple(x_packed.shape)}, w0 "
            f"{tuple(w0.shape)}, w1 {tuple(w1.shape)} (channels % 8 == 0, "
            f"c2 <= 80)")
    check_aligned(w1=w1)
    hs, ws = (H - 2) // 2 + 1, (W - 2) // 2 + 1
    out = torch.empty(B, (hs + 1) // 2, (ws + 1) // 2, c3,
                      dtype=torch.bfloat16, device=x_packed.device)
    KERNEL.launch(x_packed, w0, b0, w1, b1, out, B, H, W, c2, c3)
    return out


# ---------------------------------------------------------------------------
# training: the raw stem conv and its weight gradient
# ---------------------------------------------------------------------------


def stem_train_fwd_plain(x_packed, w, dtype=torch.bfloat16):
    """Plain version of the forward: the float32 conv (stride 2, pad 2) of
    the uint8 values with the float32 taps ``w (c2, 3, 6, 6)``, rounded to
    ``dtype``.  Returns ``(B, Hs, Ws, c2)``."""
    z = F.conv2d(_image_nchw(x_packed).float(), w.float(), stride=2,
                 padding=2)
    return z.to(dtype).permute(0, 2, 3, 1).contiguous()


def stem_train_fwd(x_packed, w, dtype=torch.bfloat16):
    """Raw stem conv: ``(B, H, 3W)`` uint8 and the ``(c2, 3, 6, 6)`` float32
    taps (the /255 folded in) → ``(B, Hs, Ws, c2)``.  CPU tensors take the
    plain version; CUDA tensors take the kernel, which computes bf16 only."""
    if x_packed.device.type == "cpu":
        return stem_train_fwd_plain(x_packed, w, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the stem train kernel computes bf16, not {dtype}")
    check_cuda("x_packed", x_packed, torch.uint8, 3)
    check_cuda("w", w, torch.float32, 4)
    B, H, W3 = x_packed.shape
    W, c2 = W3 // 3, w.shape[0]
    if W3 % 3 or H < 2 or W < 2 or w.shape[1:] != (3, 6, 6) or c2 % 8:
        raise ValueError(f"stem train kernel: bad shapes x "
                         f"{tuple(x_packed.shape)}, w {tuple(w.shape)} "
                         f"(c2 % 8 == 0)")
    w108 = w.permute(2, 3, 1, 0).reshape(108, c2).contiguous()
    z = torch.empty(B, *_stem_out_hw(H, W), c2, dtype=torch.bfloat16,
                    device=x_packed.device)
    TRAIN_FWD_KERNEL.launch(x_packed, w108, z, B, H, W, c2)
    return z


def stem_train_wgrad_plain(x_packed, dz):
    """Plain version of the weight gradient: the float32 conv weight
    gradient of the image values and ``dz (B, Hs, Ws, c2)`` →
    ``(c2, 3, 6, 6)`` float32."""
    return torch.nn.grad.conv2d_weight(
        _image_nchw(x_packed).float(), (dz.shape[-1], 3, 6, 6),
        dz.permute(0, 3, 1, 2).float(), stride=2, padding=2)


def wgrad_parts(B: int, H: int, W: int, c2: int) -> int:
    """Rows of the weight-gradient kernel's partial dW (its CTAs along the
    pixel axis), as ``csrc/stem_train.cu`` plans them for this card."""
    return query("stem_train", "stem_train_wgrad_parts", B, H, W, c2)


def stem_train_wgrad(x_packed, dz):
    """Weight gradient of :func:`stem_train_fwd`: ``dz (B, Hs, Ws, c2)`` →
    ``(c2, 3, 6, 6)`` float32.  CPU tensors take the plain version; CUDA
    tensors take the kernel (bf16 ``dz``, 16-byte aligned)."""
    if x_packed.device.type == "cpu":
        return stem_train_wgrad_plain(x_packed, dz)
    check_cuda("x_packed", x_packed, torch.uint8, 3)
    check_cuda("dz", dz, torch.bfloat16, 4)
    B, H, W3 = x_packed.shape
    W, c2 = W3 // 3, dz.shape[-1]
    Hs, Ws = _stem_out_hw(H, W)
    if W3 % 3 or dz.shape != (B, Hs, Ws, c2) or c2 % 8 or c2 > 200:
        raise ValueError(f"stem wgrad kernel: bad shapes x "
                         f"{tuple(x_packed.shape)}, dz {tuple(dz.shape)} "
                         f"(c2 % 8 == 0, c2 <= 200)")
    check_aligned(dz=dz)
    parts = wgrad_parts(B, H, W, c2)
    partial = torch.empty(parts, 108, c2, device=x_packed.device)
    dw = torch.empty(108, c2, device=x_packed.device)
    TRAIN_WGRAD_KERNEL.launch(x_packed, dz, partial, dw, B, H, W, c2, parts)
    return dw.view(6, 6, 3, c2).permute(3, 2, 0, 1)


class _StemConvTrain(torch.autograd.Function):
    """Raw stem conv whose backward is the weight-gradient kernel (or, with
    ``plain``, both plain versions); the uint8 image takes no gradient."""

    @staticmethod
    def forward(ctx, x_packed, w, dtype, plain):
        ctx.save_for_backward(x_packed)
        ctx.plain = plain
        return (stem_train_fwd_plain if plain else stem_train_fwd)(
            x_packed, w, dtype)

    @staticmethod
    def backward(ctx, dz):
        (x_packed,) = ctx.saved_tensors
        wgrad = stem_train_wgrad_plain if ctx.plain else stem_train_wgrad
        return None, wgrad(x_packed, dz.contiguous()), None, None


def stem_conv_train(x_packed, w, dtype=torch.bfloat16, plain: bool = False):
    """Train-mode raw (pre-BatchNorm) stem conv, differentiable in ``w``.

    ``x_packed (B, H, 3W)`` uint8; ``w (c2, 3, 6, 6)`` float32 with the /255
    normalize folded in.  Returns ``(B, H/2, W/2, c2)`` in ``dtype``: on the
    card the forward and weight-gradient kernels (bf16); on the CPU, or with
    ``plain``, their plain versions (``dtype`` float32 gives the float32
    model's conv)."""
    return _StemConvTrain.apply(x_packed, w, dtype, plain)
