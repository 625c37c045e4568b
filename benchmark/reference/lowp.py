"""The control's rounding: the reference put in the program's place and
computed one precision below the configuration's.  For a bfloat16
configuration that is fp8 (e4m3): every conv's input and weight are
rounded to it, the products and sums stay float32.  Gradients pass
straight through, rounded to fp8 (e5m2) on the way back."""

from __future__ import annotations

import torch

FORWARD = {"float8_e4m3fn": torch.float8_e4m3fn}
BACKWARD = {"float8_e5m2": torch.float8_e5m2}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _cast(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _cast(g, ctx.bwd), None, None


def _cast(x, dtype):
    """Round to ``dtype`` and back, saturating at its largest finite value
    (a plain cast turns out-of-range values into NaN)."""
    big = torch.finfo(dtype).max
    return x.clamp(-big, big).to(dtype).to(x.dtype)


class Rounding:
    """``lowp(x)``: ``x`` rounded to the forward precision, its gradient to
    the backward one."""

    def __init__(self, forward: str = "float8_e4m3fn",
                 backward: str = "float8_e5m2"):
        self.fwd, self.bwd = FORWARD[forward], BACKWARD[backward]

    def __call__(self, x):
        return _Round.apply(x, self.fwd, self.bwd)
