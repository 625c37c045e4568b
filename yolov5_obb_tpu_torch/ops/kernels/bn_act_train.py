"""Train-mode BatchNorm (the batch's statistics) + SiLU as one autograd
Function over hand-written kernels (``csrc/bn_act_train.cu``).

It computes what ``models/layers._bn_act_chain`` computes in train mode with
float32 BatchNorm: the per-channel batch mean and biased variance
``E[z²] - E[z]²`` (clamped at 0), ``u = (z - mean)·rsqrt(var + eps)·w + b``,
``y = u·σ(u)`` in float32, returned in ``z``'s dtype, and the running
statistics moved as ``0.97·old + 0.03·batch``.  Four passes over the
activations (statistics, apply; the backward's two sums, the input
gradient) and a finalize launch after each reduction; the backward keeps
``z`` and four float32 numbers a channel, where the chain's autograd keeps
four float32 tensors of ``z``'s size.

Under a data-parallel step (``step_context.mesh``) the forward's ``(Σz,
Σz²)`` and the backward's ``(Σg, Σg·x̂)`` are summed over the ranks between a
reduction and its finalize, and ``N`` is the global pixel count (the ranks
hold equal slices, as ``layers.batch_stats`` assumes); ``dw`` and ``db``
stay the rank's own, as the chain's, for the step's gradient all-reduce.

Its plain version is the chain itself, which ``_bn_act`` runs off the card.
"""

from __future__ import annotations

import torch

from ...models import step_context
from ._build import F, I, Kernel, L, P

MAX_PARTS = 512  # CTAs of a reduction pass: its partial sums a channel

_REPLACES = "yolov5_obb_tpu_torch/models/layers.py:_bn_act_chain"
STATS_KERNEL = Kernel("bn_act_train", "bn_act_stats_launch",
                      [P, P, L, I, I, I], replaces=_REPLACES)
FWD_FINALIZE_KERNEL = Kernel("bn_act_train", "bn_act_fwd_finalize_launch",
                             [P, I, P, P, P, P, P, I, F, I],
                             replaces=_REPLACES)
FWD_KERNEL = Kernel("bn_act_train", "bn_act_fwd_launch",
                    [P, P, P, P, L, I, I, I], replaces=_REPLACES)
BWD_KERNEL = Kernel("bn_act_train", "bn_act_bwd_launch",
                    [P, P, P, P, P, L, I, I, I, I], replaces=_REPLACES)
BWD_FINALIZE_KERNEL = Kernel("bn_act_train", "bn_act_bwd_finalize_launch",
                             [P, I, P, P, P, I, F, I], replaces=_REPLACES)
DZ_KERNEL = Kernel("bn_act_train", "bn_act_dz_launch",
                   [P, P, P, P, P, P, L, I, I, I], replaces=_REPLACES)
KERNELS = {"bn_act_stats": STATS_KERNEL,
           "bn_act_fwd_finalize": FWD_FINALIZE_KERNEL,
           "bn_act_fwd": FWD_KERNEL, "bn_act_bwd": BWD_KERNEL,
           "bn_act_bwd_finalize": BWD_FINALIZE_KERNEL, "bn_act_dz": DZ_KERNEL}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def parts_for(rows: int) -> int:
    """CTAs of a reduction pass over ``rows`` pixels (a function of the
    shape alone, so a repeat sums the same partials in the same order)."""
    return max(1, min(MAX_PARTS, -(-rows // 64)))


def check(bn, z) -> None:
    """Raises ``ValueError`` unless the kernels take ``bn``'s train-mode
    BatchNorm of ``z``: a non-empty CUDA tensor in bfloat16 or float32, and
    float32 contiguous parameters and running statistics on its device."""
    bad = []
    if not z.is_cuda:
        bad.append(f"z on {z.device}, not a CUDA device")
    if z.dtype not in _DTYPES:
        bad.append(f"z in {z.dtype}, not bfloat16 or float32")
    if z.numel() == 0:
        bad.append(f"z empty, of shape {tuple(z.shape)}")
    for name in ("weight", "bias", "running_mean", "running_var"):
        t = getattr(bn, name)
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != z.device):
            bad.append(f"{name} in {t.dtype} on {t.device}, contiguous "
                       f"{t.is_contiguous()}: not float32, contiguous, on "
                       f"z's device")
    if bad:
        raise ValueError("bn_act_train: " + "; ".join(bad))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# A call's float32 scratch is one allocation: the partials (parts x 2 x C),
# then the sums or the coefficients (2 x C), passed as a pointer into it.

def _scratch(parts, C, device):
    tmp = torch.empty((parts + 1) * 2 * C, device=device)
    return tmp, tmp.data_ptr() + 4 * parts * 2 * C


def _fwd_kernels(z, bn, act, mesh, inv_n):
    C = z.shape[-1]
    R, dt = z.numel() // C, _DTYPES[z.dtype]
    parts = parts_for(R)
    tmp, sums = _scratch(parts, C, z.device)
    stats = torch.empty(4, C, device=z.device)
    w, rm, rv = bn.weight, bn.running_mean, bn.running_var
    STATS_KERNEL.launch(z, tmp, R, C, parts, dt)
    if mesh is None:
        FWD_FINALIZE_KERNEL.launch(tmp, parts, None, w, rm, rv, stats, C,
                                   inv_n, 0)
    else:
        FWD_FINALIZE_KERNEL.launch(tmp, parts, sums, w, rm, rv, stats, C,
                                   inv_n, 1)
        mesh.sum_(tmp[parts * 2 * C:])
        FWD_FINALIZE_KERNEL.launch(None, 0, sums, w, rm, rv, stats, C, inv_n,
                                   2)
    y = torch.empty_like(z)
    FWD_KERNEL.launch(z, stats, bn.bias, y, R, C, act, dt)
    return y, stats


def _bwd_kernels(dy, z, stats, bias, act, mesh, inv_n):
    C = z.shape[-1]
    R, dt = z.numel() // C, _DTYPES[z.dtype]
    parts = parts_for(R)
    tmp, coef = _scratch(parts, C, z.device)
    S = torch.empty(2, C, device=z.device)
    BWD_KERNEL.launch(dy, z, stats, bias, tmp, R, C, parts, act, dt)
    if mesh is None:
        BWD_FINALIZE_KERNEL.launch(tmp, parts, S, stats, coef, C, inv_n, 0)
    else:
        BWD_FINALIZE_KERNEL.launch(tmp, parts, S, stats, coef, C, inv_n, 1)
        Sg = mesh.sum_(S.clone())
        BWD_FINALIZE_KERNEL.launch(None, 0, Sg, stats, coef, C, inv_n, 2)
    dz = torch.empty_like(z)
    DZ_KERNEL.launch(dy, z, stats, bias, coef, dz, R, C, act, dt)
    return dz, S


class _BnActTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, weight, bias, bn, act):
        z = z.contiguous()
        mesh = step_context.mesh()
        n = z.numel() // z.shape[-1]
        inv_n = 1.0 / (n if mesh is None else n * mesh.world)
        y, stats = _fwd_kernels(z, bn, act, mesh, inv_n)
        ctx.save_for_backward(z, bias, stats)
        ctx.act, ctx.mesh, ctx.inv_n = act, mesh, inv_n
        return y

    @staticmethod
    def backward(ctx, dy):
        z, b, stats = ctx.saved_tensors
        dy = dy.to(z.dtype).contiguous()
        dz, S = _bwd_kernels(dy, z, stats, b, ctx.act, ctx.mesh, ctx.inv_n)
        db, dw = S.unbind(0)
        need = ctx.needs_input_grad
        return (dz if need[0] else None, dw if need[1] else None,
                db if need[2] else None, None, None)


def bn_act_train(bn, z, act: bool = True):
    """Train-mode BatchNorm of the NHWC ``z`` with ``bn``'s parameters and
    the batch's statistics (moving ``bn``'s running ones), then SiLU when
    ``act``; differentiable in ``z``, ``bn.weight`` and ``bn.bias``.
    Returns ``z``'s shape and dtype.  Raises ``ValueError`` on a tensor
    the kernels do not take (:func:`check`)."""
    check(bn, z)
    return _BnActTrain.apply(z, bn.weight, bn.bias, bn, int(bool(act)))
