"""Fused C3 block, inference (kernel 4 of the path).

Counterpart of ``yolov5_obb_tpu/ops/pallas/c3_kernel.fused_c3``
(c3_kernel.py:219): cv1 1x1, ``n`` bottlenecks (1x1 → SAME 3x3, residual),
cv2 1x1 and cv3 1x1 on the concat ``[bottlenecks, cv2]``, every BN folded to
a per-channel scale/shift, SiLU after each conv, one read of the input and
one write of the output.  Every conv output is rounded to the activation
dtype where the TPU kernel rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import I, Kernel, P, check_aligned, check_cuda

KERNEL = Kernel(
    "c3", "c3_launch",
    [P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I],
    replaces="yolov5_obb_tpu/ops/pallas/c3_kernel.py:219")


def _fold(cba, dtype, eps: float = 1e-3):
    """ConvBnAct → (HWIO weight in ``dtype``, (2, co) float32 scale/shift)."""
    bn = cba.bn
    g = bn.weight * torch.rsqrt(bn.running_var + eps)
    ss = torch.stack([g, bn.bias - bn.running_mean * g]).float().contiguous()
    return cba.conv.weight.permute(2, 3, 1, 0).to(dtype), ss


@torch.no_grad()
def fold_c3_params(c3, dtype=torch.bfloat16) -> dict:
    """A port ``C3`` module → the operands of :func:`fused_c3`.

    1x1 weights are ``(ci, co)``; the 3x3 taps ``(9*c_, c_)`` with tap
    ``(dy, dx)`` at rows ``[(3*dy + dx)*c_ : +c_]``; the n bottlenecks are
    stacked on a leading axis."""
    w1, s1 = _fold(c3.cv1, dtype)
    w2, s2 = _fold(c3.cv2, dtype)
    w3, s3 = _fold(c3.cv3, dtype)
    c_ = w1.shape[-1]
    wa, sa, wt, st = [], [], [], []
    for bot in c3.m:
        w, s = _fold(bot.cv1, dtype)
        wa.append(w[0, 0])
        sa.append(s)
        w, s = _fold(bot.cv2, dtype)
        wt.append(w.reshape(9 * c_, c_))
        st.append(s)
    w3 = w3[0, 0]
    return {
        "w1": w1[0, 0].contiguous(), "s1": s1,
        "wa": torch.stack(wa).contiguous(), "sa": torch.stack(sa).contiguous(),
        "wt": torch.stack(wt).contiguous(), "st": torch.stack(st).contiguous(),
        "w2": w2[0, 0].contiguous(), "s2": s2,
        "w3a": w3[:c_].contiguous(), "w3b": w3[c_:].contiguous(), "s3": s3,
    }


def _act(y, ss, dtype):
    y = y * ss[0] + ss[1]
    return (y * torch.sigmoid(y)).to(dtype)


def fused_c3_plain(x, p: dict, shortcut: bool = True):
    """Plain version, NHWC: float32 convs on ``x.dtype`` values, each conv
    output rounded to ``x.dtype``, the residual added in ``x.dtype``."""
    dt = x.dtype
    c_ = p["w1"].shape[1]
    f = lambda t: t.float()
    cur = _act(f(x) @ f(p["w1"]), p["s1"], dt)
    for k in range(p["wa"].shape[0]):
        h = _act(f(cur) @ f(p["wa"][k]), p["sa"][k], dt)
        taps = f(p["wt"][k]).reshape(3, 3, c_, c_).permute(3, 2, 0, 1)
        y3 = F.conv2d(f(h).permute(0, 3, 1, 2), taps, padding=1)
        y3 = _act(y3.permute(0, 2, 3, 1), p["st"][k], dt)
        cur = cur + y3 if shortcut else y3
    c2c = _act(f(x) @ f(p["w2"]), p["s2"], dt)
    return _act(f(cur) @ f(p["w3a"]) + f(c2c) @ f(p["w3b"]), p["s3"], dt)


def fused_c3(x, p: dict, shortcut: bool = True):
    """Fused C3(c1, c2, n, shortcut, e=0.5, g=1) on ``(B, H, W, c1)``;
    operands from :func:`fold_c3_params`.  CPU tensors take the plain
    version; CUDA tensors take the kernel (bf16, 1 <= n <= 4, even c1, c_
    and c2 multiples of 8, 16-byte aligned weights)."""
    if x.device.type == "cpu":
        return fused_c3_plain(x, p, shortcut)
    check_cuda("x", x, torch.bfloat16, 4)
    for k in ("w1", "w2", "w3a", "w3b"):
        check_cuda(k, p[k], torch.bfloat16, 2)
    for k in ("wa", "wt"):
        check_cuda(k, p[k], torch.bfloat16, 3)
    for k in ("s1", "s2", "s3"):
        check_cuda(k, p[k], torch.float32, 2)
    for k in ("sa", "st"):
        check_cuda(k, p[k], torch.float32, 3)
    B, H, W, c1 = x.shape
    n, c_ = p["wa"].shape[0], p["w1"].shape[1]
    c2 = p["w3a"].shape[1]
    want = {"w1": (c1, c_), "s1": (2, c_), "wa": (n, c_, c_),
            "sa": (n, 2, c_), "wt": (n, 9 * c_, c_), "st": (n, 2, c_),
            "w2": (c1, c_), "s2": (2, c_), "w3a": (c_, c2), "w3b": (c_, c2),
            "s3": (2, c2)}
    bad = {k: tuple(p[k].shape) for k, s in want.items() if p[k].shape != s}
    if bad or not 1 <= n <= 4 or c1 % 2 or c_ % 8 or c2 % 8:
        raise ValueError(f"c3 kernel: unsupported shapes x {tuple(x.shape)}, "
                         f"n={n}, c_={c_}, c2={c2}, mismatched {bad}")
    # the kernel copies the weights 16 bytes at a time
    check_aligned(**{k: p[k] for k in ("w1", "wa", "wt", "w2", "w3a", "w3b")})
    out = torch.empty(B, H, W, c2, dtype=torch.bfloat16, device=x.device)
    KERNEL.launch(x, p["w1"], p["s1"], p["wa"], p["sa"], p["wt"], p["st"],
                  p["w2"], p["s2"], p["w3a"], p["w3b"], p["s3"], out,
                  B, H, W, c1, c_, c2, n, int(shortcut))
    return out
