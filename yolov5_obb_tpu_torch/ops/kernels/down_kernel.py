"""Fused downsample Conv(3x3, s2, p1) + BN (scale/shift) + SiLU (kernel 3 of
the path).

Counterpart of ``yolov5_obb_tpu/ops/pallas/down_kernel.fused_down``
(down_kernel.py:326).  The BN scale is applied after the conv, not folded
into the weights, as in the TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import I, Kernel, P, check_cuda

KERNEL = Kernel(
    "down", "down_launch", [P, P, P, P, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/down_kernel.py:326")


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
    out = torch.empty(B, (H + 1) // 2, (W + 1) // 2, co, dtype=torch.bfloat16,
                      device=x.device)
    KERNEL.launch(x, w_taps, ss, out, B, H, W, ci, co)
    return out
