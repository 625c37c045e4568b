"""The stride-2 downsample Conv(3x3, s2, p1) kernels.

- Inference: the conv + BN (scale/shift) + SiLU (``fused_down``; counterpart
  of ``yolov5_obb_tpu/ops/pallas/down_kernel.fused_down``, down_kernel.py:326).
  The BN scale is applied after the conv, not folded into the weights, as in
  the TPU kernel.
- Training: the raw pre-BN conv and its weight gradient
  (``down_conv_train``; counterpart of ``fused_down_train``, :295).  The
  input gradient is the transposed conv, outside any kernel, as on the TPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import I, Kernel, P, check_aligned, check_cuda, query

KERNEL = Kernel(
    "down", "down_launch", [P, P, P, P, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/down_kernel.py:326")
TRAIN_FWD_KERNEL = Kernel(
    "down_train", "down_train_fwd_launch", [P, P, P, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/down_kernel.py:147")
TRAIN_WGRAD_KERNEL = Kernel(
    "down_train", "down_train_wgrad_launch", [P, P, P, P, I, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/down_kernel.py:169")


@torch.no_grad()
def fold_down_params(conv, bn, dtype=torch.bfloat16, eps: float = 1e-3):
    """Conv(3x3) + BN modules → ``(w_taps (9*ci, co) dtype, ss (2, co)
    float32)``; tap ``(dy, dx)`` at rows ``[(3*dy + dx)*ci : +ci]``."""
    g = bn.weight * torch.rsqrt(bn.running_var + eps)
    ss = torch.stack([g, bn.bias - bn.running_mean * g]).float().contiguous()
    co, ci = conv.weight.shape[:2]
    w = conv.weight.permute(2, 3, 1, 0).reshape(9 * ci, co)
    return w.to(dtype).contiguous(), ss


def fused_down_plain(x, w_taps, ss):
    """Plain version: float32 conv of the ``x.dtype`` values, then
    scale/shift and SiLU, rounded to ``x.dtype``.  NHWC in and out."""
    ci, co = x.shape[-1], w_taps.shape[1]
    k = w_taps.float().reshape(3, 3, ci, co).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), k, stride=2, padding=1)
    y = y * ss[0].float()[:, None, None] + ss[1].float()[:, None, None]
    return (y * torch.sigmoid(y)).to(x.dtype).permute(0, 2, 3, 1).contiguous()


def fused_down(x, w_taps, ss):
    """``(B, H, W, ci)`` → ``(B, ceil(H/2), ceil(W/2), co)``.  CPU tensors
    take the plain version; CUDA tensors take the kernel (bf16 only)."""
    if x.device.type == "cpu":
        return fused_down_plain(x, w_taps, ss)
    check_cuda("x", x, torch.bfloat16, 4)
    check_cuda("w_taps", w_taps, torch.bfloat16, 2)
    check_cuda("ss", ss, torch.float32, 2)
    B, H, W, ci = x.shape
    co = w_taps.shape[1]
    if w_taps.shape[0] != 9 * ci or ss.shape != (2, co) or ci % 2 or co % 8:
        raise ValueError(
            f"down kernel: bad shapes x {tuple(x.shape)}, w_taps "
            f"{tuple(w_taps.shape)}, ss {tuple(ss.shape)} "
            f"(ci % 2 == 0, co % 8 == 0)")
    check_aligned(x=x, w_taps=w_taps)
    out = torch.empty(B, (H + 1) // 2, (W + 1) // 2, co, dtype=torch.bfloat16,
                      device=x.device)
    KERNEL.launch(x, w_taps, ss, out, B, H, W, ci, co)
    return out


# ---------------------------------------------------------------------------
# training: the raw conv and its weight gradient
# ---------------------------------------------------------------------------

def wgrad_parts(B: int, H: int, W: int, ci: int, co: int) -> int:
    """Rows of the weight-gradient kernel's partial dW (its CTAs along the
    pixel axis), as ``csrc/down_train.cu`` plans them for this card."""
    return query("down_train", "down_train_wgrad_parts", B, H, W, ci, co)


def _taps_oihw(w_taps, ci):
    return w_taps.reshape(3, 3, ci, w_taps.shape[1]).permute(3, 2, 0, 1)


def _check_train(x, w_or_dz, what):
    check_cuda("x", x, torch.bfloat16, 4)
    if x.shape[-1] % 8 or w_or_dz.shape[-1] % 8:
        raise ValueError(f"down train kernel: bad shapes x {tuple(x.shape)}, "
                         f"{what} {tuple(w_or_dz.shape)} (channels % 8 == 0)")


def down_train_fwd_plain(x, w_taps):
    """Plain version of the forward: the float32 conv of the ``x.dtype``
    values with ``w_taps (9*ci, co)``, rounded to ``x.dtype``.  NHWC in and
    out."""
    k = _taps_oihw(w_taps.float(), x.shape[-1])
    z = F.conv2d(x.permute(0, 3, 1, 2).float(), k, stride=2, padding=1)
    return z.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def down_train_fwd(x, w_taps):
    """Raw conv ``(B, H, W, ci)`` → ``(B, ceil(H/2), ceil(W/2), co)``.  CPU
    tensors take the plain version; CUDA tensors take the kernel (bf16)."""
    if x.device.type == "cpu":
        return down_train_fwd_plain(x, w_taps)
    _check_train(x, w_taps, "w_taps")
    check_cuda("w_taps", w_taps, torch.bfloat16, 2)
    B, H, W, ci = x.shape
    co = w_taps.shape[1]
    if w_taps.shape[0] != 9 * ci:
        raise ValueError(f"down train kernel: w_taps {tuple(w_taps.shape)} "
                         f"for {ci} input channels")
    check_aligned(x=x, w_taps=w_taps)
    z = torch.empty(B, (H + 1) // 2, (W + 1) // 2, co, dtype=torch.bfloat16,
                    device=x.device)
    TRAIN_FWD_KERNEL.launch(x, w_taps, z, B, H, W, ci, co)
    return z


def down_train_wgrad_plain(x, dz):
    """Plain version of the weight gradient: the float32 conv weight
    gradient of ``x`` and ``dz (B, Ho, Wo, co)`` → ``(9*ci, co)`` float32,
    row ``(3*dy + dx)*ci + c``."""
    ci, co = x.shape[-1], dz.shape[-1]
    dw = torch.nn.grad.conv2d_weight(
        x.permute(0, 3, 1, 2).float(), (co, ci, 3, 3),
        dz.permute(0, 3, 1, 2).float(), stride=2, padding=1)
    return dw.permute(2, 3, 1, 0).reshape(9 * ci, co)


def down_train_wgrad(x, dz):
    """Weight gradient of :func:`down_train_fwd` → ``(9*ci, co)`` float32.
    CPU tensors take the plain version; CUDA tensors take the kernel."""
    if x.device.type == "cpu":
        return down_train_wgrad_plain(x, dz)
    _check_train(x, dz, "dz")
    check_cuda("dz", dz, torch.bfloat16, 4)
    B, H, W, ci = x.shape
    co = dz.shape[-1]
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    if dz.shape != (B, Ho, Wo, co):
        raise ValueError(f"down wgrad kernel: dz {tuple(dz.shape)} for x "
                         f"{tuple(x.shape)}")
    check_aligned(x=x, dz=dz)
    parts = wgrad_parts(B, H, W, ci, co)
    partial = torch.empty(parts, 9 * ci, co, device=x.device)
    dw = torch.empty(9 * ci, co, device=x.device)
    TRAIN_WGRAD_KERNEL.launch(x, dz, partial, dw, B, H, W, ci, co, parts)
    return dw


def down_train_igrad(w_taps, dz, x_shape, dtype):
    """Input gradient: the float32 transposed conv of ``dz`` with the
    float32 taps, rounded to ``dtype`` (the JAX package's XLA conv
    transpose).  cuDNN runs it without TF32."""
    B, H, W, ci = x_shape
    k = _taps_oihw(w_taps.float(), ci)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dx = torch.nn.grad.conv2d_input((B, ci, H, W), k,
                                        dz.permute(0, 3, 1, 2).float(),
                                        stride=2, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    return dx.to(dtype).permute(0, 2, 3, 1).contiguous()


class _DownConvTrain(torch.autograd.Function):
    """Raw downsample conv whose backward is the weight-gradient kernel (or,
    with ``plain``, the plain versions) and the transposed conv."""

    @staticmethod
    def forward(ctx, x, w_taps, plain):
        ctx.save_for_backward(x, w_taps)
        ctx.plain = plain
        wq = w_taps.to(x.dtype).contiguous()
        return (down_train_fwd_plain if plain else down_train_fwd)(x, wq)

    @staticmethod
    def backward(ctx, dz):
        x, w_taps = ctx.saved_tensors
        dz = dz.contiguous()
        wgrad = down_train_wgrad_plain if ctx.plain else down_train_wgrad
        dw = wgrad(x, dz) if ctx.needs_input_grad[1] else None
        dx = (down_train_igrad(w_taps, dz, x.shape, x.dtype)
              if ctx.needs_input_grad[0] else None)
        return dx, dw, None


def down_conv_train(x, w_taps, plain: bool = False):
    """Train-mode raw (pre-BatchNorm) downsample conv, differentiable in
    ``x`` and ``w_taps``.

    ``x (B, H, W, ci)``; ``w_taps (9*ci, co)`` float32, row
    ``(3*dy + dx)*ci + c`` (rounded to ``x.dtype`` for the forward, as the
    TPU kernel takes bf16 taps).  Returns ``(B, ceil(H/2), ceil(W/2), co)``
    in ``x.dtype``: on the card the forward and weight-gradient kernels
    (bf16); on the CPU, or with ``plain``, their plain versions.  The input
    gradient uses the float32 taps."""
    return _DownConvTrain.apply(x, w_taps, plain)
