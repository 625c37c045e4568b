"""The stat-carrying fused train passes of the ``fused_train`` region
(layers 0-3 of a packed-stem model in train mode: stem → down1 → C3 →
down2).  Counterpart of ``yolov5_obb_tpu/ops/pallas/train_fused.py``.

Each pass reads one activation tensor and writes one::

    z_out, (Σz, Σz²) = P(z_in, gb, w)
      y     = silu(z_in · g + b)      # the PREVIOUS conv's BatchNorm + SiLU
      z_out = conv(y)                 # 1x1, or 3x3 at stride 1 or 2
      Σz, Σz² per output channel, of the float32 accumulator

:func:`finalize_gb` turns a pass's sums into the next pass's ``(g, b)`` in
plain differentiable torch, so autograd composes the exact train-mode
BatchNorm backward along the chain: its batch-statistic terms arrive as the
``(ds1, ds2)`` cotangents of each pass's sums.  Nothing here computes a
BatchNorm backward as a whole.

Kernels (``csrc/train_fused_1x1.cu``, ``csrc/train_fused_3x3.cu``):

- ``pass_1x1`` forward and backward (TPU ``_k1x1`` :108, ``_k1x1_bwd``
  :151): grouped BN+SiLU inputs → one or two 1x1 outputs, statistics.
- ``pass_3x3s1`` / ``pass_3x3s2`` forward (TPU ``_k3x3s1`` :438,
  ``_k3x3s2`` :622).  Their backward is a library conv gradient and
  elementwise torch (TPU ``_xla_conv_bwd`` :523, XLA there too).

Every kernel has its plain PyTorch version here; a wrapper takes it for CPU
tensors, and a Function takes it everywhere with ``plain=True``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ._build import I, Kernel, P, check_aligned, check_cuda, query

_BF = torch.bfloat16
MAX_IN, MAX_W, MAX_OUT, MAX_PAIRS = 8, 4, 2, 2
# pixels per tile of the 1x1 forward (one statistics partial row each):
# csrc/train_fused_1x1.cu's kFwdTile
_TILE_1X1_FWD = 128
# output (rows, columns) per tile of a 3x3 pass, one statistics partial row
# per tile: csrc/conv3x3_mma.cuh's (kTileY, kTileX) at both strides
_TILE_3X3 = (8, 16)

_REPL = "yolov5_obb_tpu/ops/pallas/train_fused.py"
KERNEL_1X1 = Kernel("train_fused_1x1", "pass1x1_fwd_launch", [P, P, P, I],
                    replaces=f"{_REPL}:108")
KERNEL_1X1_BWD = Kernel("train_fused_1x1", "pass1x1_bwd_launch",
                        [P, P, P, I, I], replaces=f"{_REPL}:151")
KERNEL_3X3S1 = Kernel("train_fused_3x3", "pass3x3s1_launch",
                      [P, P, P, P, P, P, I, I, I, I, I],
                      replaces=f"{_REPL}:438")
KERNEL_3X3S2 = Kernel("train_fused_3x3", "pass3x3s2_launch",
                      [P, P, P, P, P, P, I, I, I, I, I],
                      replaces=f"{_REPL}:622")


def _silu(a):
    return a * torch.sigmoid(a)


def _dsilu(a):
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions in full float32 (cuDNN defaults to TF32)."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def _sums(acc):
    """``(2, co)`` float32: Σ and Σ² over every pixel of an NHWC tensor."""
    return torch.stack([acc.sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))])


# ---------------------------------------------------------------------------
# finalize: (Σz, Σz²) → per-channel (g, b) for the next pass
# ---------------------------------------------------------------------------


def finalize_gb(s1, s2, gamma, beta, n: int, eps: float = 1e-3):
    """``(Σz, Σz², γ, β)`` → ``(g, b, mean, var)`` with ``silu(z·g + b)`` ≡
    BatchNorm + SiLU.  Differentiable into ``(s1, s2)``.  The variance is
    not clamped (unlike ``layers.batch_norm_train``), as in the JAX pass
    chain."""
    mean = s1 / n
    var = s2 / n - mean * mean
    g = gamma * torch.rsqrt(var + eps)
    b = beta - mean * g
    return g, b, mean, var


# ---------------------------------------------------------------------------
# 1x1 grouped pass
# ---------------------------------------------------------------------------
#
# Static structure, as in the JAX pass:
#   ns_flags: per input, True → silu(z·g + b), False → z as it is;
#   groups:   tuples of input indices, each group's members summed in
#             float32 and rounded to bf16 → the group value;
#   outs:     per output, tuples of (group, weight): output o = Σ group @ w.
# Inputs (B, H, W, ci) bf16; gbs (2, ci) float32; weights (ci, co).


def _group_values(ns_flags, groups, z_ins, gbs):
    """Each group's float32 sum of its members' activations (an input with
    ``ns`` False as it is), rounded to bf16 (as float32 values)."""
    out = []
    for members in groups:
        acc = None
        for i in members:
            zf = z_ins[i].float()
            y = _silu(zf * gbs[i][0] + gbs[i][1]) if ns_flags[i] else zf
            acc = y if acc is None else acc + y
        out.append(acc.to(_BF).float())
    return out


def pass_1x1_fwd_plain(ns_flags, groups, outs, z_ins, gbs, ws):
    """Plain version of the forward: ``(z_outs, stats)``, tuples of the bf16
    outputs ``(B, H, W, co)`` and their ``(2, co)`` float32 sums, taken of
    the float32 products of the bf16 group values and bf16 weights."""
    gvals = _group_values(ns_flags, groups, z_ins, gbs)
    wq = [w.to(_BF).float() for w in ws]
    z_outs, stats = [], []
    for pairs in outs:
        acc = sum(gvals[g] @ wq[w] for g, w in pairs)
        z_outs.append(acc.to(_BF))
        stats.append(_sums(acc))
    return tuple(z_outs), tuple(stats)


def pass_1x1_bwd_plain(ns_flags, groups, outs, z_ins, gbs, ws, z_outs,
                       dz_outs, dstats):
    """Plain version of the backward: ``(dz_ins, dgbs, dws)``.

    ``dz_eff = dz + ds1 + 2·z_out·ds2`` rounded to bf16; ``dW = gᵀ·dz_eff``
    (float32); ``t_g = Σ dz_eff·Wᵀ``; an activated input takes
    ``dα = t·silu'(α)``, ``dz_in = dα·g`` (bf16) and ``(Σ dα·z, Σ dα)``, a
    plain one ``dz_in = t`` and zero ``dgb``.  dW in the weights' dtype."""
    ci = z_ins[0].shape[-1]
    dzeff = [(dz.float() + ds[0] + 2.0 * zo.float() * ds[1]).to(_BF).float()
             for zo, dz, ds in zip(z_outs, dz_outs, dstats)]
    gvals = _group_values(ns_flags, groups, z_ins, gbs)
    wq = [w.to(_BF).float() for w in ws]
    dws = [torch.zeros(w.shape, device=w.device) for w in ws]
    tgs = [None] * len(groups)
    for oi, pairs in enumerate(outs):
        e = dzeff[oi]
        for g, w in pairs:
            dws[w] += gvals[g].reshape(-1, ci).T @ e.reshape(-1, e.shape[-1])
            t = e @ wq[w].T
            tgs[g] = t if tgs[g] is None else tgs[g] + t
    dz_ins = [torch.zeros_like(z, dtype=_BF) for z in z_ins]
    dgbs = [torch.zeros(2, ci, device=z.device) for z in z_ins]
    for g, members in enumerate(groups):
        for i in members:
            if ns_flags[i]:
                zf = z_ins[i].float()
                da = tgs[g] * _dsilu(zf * gbs[i][0] + gbs[i][1])
                dz_ins[i] = (da * gbs[i][0]).to(_BF)
                dgbs[i] = _sums_da(da, zf)
            else:
                dz_ins[i] = tgs[g].to(_BF)
    return (tuple(dz_ins), tuple(dgbs),
            tuple(dw.to(w.dtype) for dw, w in zip(dws, ws)))


def _sums_da(da, zf):
    return torch.stack([(da * zf).sum((0, 1, 2)), da.sum((0, 1, 2))])


class _Desc(ctypes.Structure):
    """The pass structure handed to the 1x1 kernels (``Pass1x1Desc`` in
    ``csrc/train_fused_1x1.cu``; the two layouts must match)."""

    _fields_ = [("z", P * MAX_IN), ("gb", P * MAX_IN), ("w", P * MAX_W),
                ("out", P * MAX_OUT),
                ("dz_out", P * MAX_OUT), ("dstat", P * MAX_OUT),
                ("dz_in", P * MAX_IN), ("ns", I * MAX_IN),
                ("group", I * MAX_IN), ("npair", I * MAX_OUT),
                ("pair_g", I * (MAX_OUT * MAX_PAIRS)),
                ("pair_w", I * (MAX_OUT * MAX_PAIRS)), ("co", I * MAX_OUT),
                ("wco", I * MAX_W), ("n_in", I), ("n_groups", I),
                ("n_out", I), ("n_w", I), ("ci", I)]


def _check_1x1(ns_flags, groups, outs, z_ins, gbs, ws):
    """Validate a pass for the kernels; returns ``(B, H, W, ci, cos)``."""
    n_in, n_w = len(z_ins), len(ws)
    if not (1 <= n_in <= MAX_IN and 1 <= n_w <= MAX_W and len(groups) <= 2
            and 1 <= len(outs) <= MAX_OUT
            and all(1 <= len(p) <= MAX_PAIRS for p in outs)
            and len(ns_flags) == n_in == len(gbs)):
        raise ValueError(f"1x1 pass kernel: unsupported structure ns "
                         f"{ns_flags}, groups {groups}, outs {outs}")
    member = sorted(i for m in groups for i in m)
    if member != list(range(n_in)):
        raise ValueError(f"1x1 pass kernel: each input must be in exactly "
                         f"one group, got {groups} for {n_in} inputs")
    B, H, W, ci = z_ins[0].shape
    for z in z_ins:
        check_cuda("z_in", z, _BF, 4)
        if z.shape != z_ins[0].shape:
            raise ValueError(f"1x1 pass kernel: inputs of shapes "
                             f"{[tuple(t.shape) for t in z_ins]}")
    for gb in gbs:
        check_cuda("gb", gb, torch.float32, 2)
        if gb.shape != (2, ci):
            raise ValueError(f"1x1 pass kernel: gb {tuple(gb.shape)}")
    cos = []
    for pairs in outs:
        co = {ws[w].shape[1] for _, w in pairs}
        if len(co) != 1 or any(ws[w].shape[0] != ci for _, w in pairs):
            raise ValueError(f"1x1 pass kernel: weights "
                             f"{[tuple(w.shape) for w in ws]} for ci {ci}")
        cos.append(co.pop())
    if ci % 8 or any(c % 8 for c in cos) or B * H * W == 0:
        raise ValueError(f"1x1 pass kernel: channels {ci} → {cos} "
                         f"(multiples of 8), {B * H * W} pixels")
    return B, H, W, ci, cos


def _desc(ns_flags, groups, outs, z_ins, gbs, ws, cos):
    d = _Desc()
    for i, (z, gb) in enumerate(zip(z_ins, gbs)):
        d.z[i], d.gb[i], d.ns[i] = z.data_ptr(), gb.data_ptr(), int(ns_flags[i])
        d.group[i] = next(g for g, m in enumerate(groups) if i in m)
    for o, pairs in enumerate(outs):
        d.npair[o], d.co[o] = len(pairs), cos[o]
        for j, (g, w) in enumerate(pairs):
            d.pair_g[o * MAX_PAIRS + j], d.pair_w[o * MAX_PAIRS + j] = g, w
    for w, t in enumerate(ws):
        d.w[w], d.wco[w] = t.data_ptr(), t.shape[1]
    d.n_in, d.n_groups, d.n_out, d.n_w = (len(z_ins), len(groups), len(outs),
                                          len(ws))
    d.ci = z_ins[0].shape[-1]
    return d


def _named(name, tensors):
    return {f"{name}{i}": t for i, t in enumerate(tensors)}


def pass_1x1_partial_rows(n_pixels: int) -> int:
    """Rows of scratch for the 1x1 forward kernel's statistics partial: one
    per tile of pixels, the most CTAs it launches (each writes one row)."""
    return -(-n_pixels // _TILE_1X1_FWD)


def pass_1x1_bwd_parts(d: _Desc, n_pixels: int) -> int:
    """Rows of the 1x1 backward kernel's partial for a pass: the CTAs it
    launches along the pixels, planned by the kernel's own library
    (``pass1x1_bwd_parts``: the occupancy query at the pass's shared
    memory, over its rounds of dW units, at most one per tile)."""
    return query("train_fused_1x1", "pass1x1_bwd_parts",
                 ctypes.addressof(d), n_pixels, argtypes=[P, I])


def pass_1x1_fwd(ns_flags, groups, outs, z_ins, gbs, ws):
    """Forward of the grouped 1x1 pass → ``(z_outs, stats)`` as in
    :func:`pass_1x1_fwd_plain`.  CPU tensors take the plain version; CUDA
    tensors take the kernel (bf16 inputs, float32 ``gbs``; the weights are
    rounded to bf16 here)."""
    if z_ins[0].device.type == "cpu":
        return pass_1x1_fwd_plain(ns_flags, groups, outs, z_ins, gbs, ws)
    wq = [w.to(_BF).contiguous() for w in ws]
    B, H, W, ci, cos = _check_1x1(ns_flags, groups, outs, z_ins, gbs, wq)
    check_aligned(**_named("z_in", z_ins), **_named("w", wq))
    dev = z_ins[0].device
    z_outs = [torch.empty(B, H, W, co, dtype=_BF, device=dev) for co in cos]
    d = _desc(ns_flags, groups, outs, z_ins, gbs, wq, cos)
    for o, z in enumerate(z_outs):
        d.out[o] = z.data_ptr()
    N = B * H * W
    S = 2 * sum(cos)
    partial = torch.empty(pass_1x1_partial_rows(N), S, device=dev)
    stats = torch.empty(S, device=dev)
    KERNEL_1X1.launch(ctypes.addressof(d), partial, stats, N)
    offs = [2 * sum(cos[:o]) for o in range(len(cos))]
    return tuple(z_outs), tuple(stats[a:a + 2 * co].view(2, co)
                                for a, co in zip(offs, cos))


def pass_1x1_bwd(ns_flags, groups, outs, z_ins, gbs, ws, z_outs, dz_outs,
                 dstats):
    """Backward of the grouped 1x1 pass → ``(dz_ins, dgbs, dws)`` as in
    :func:`pass_1x1_bwd_plain`.  CPU tensors take the plain version; CUDA
    tensors take the kernel (bf16 ``z_outs`` and ``dz_outs``, float32
    ``dstats``)."""
    if z_ins[0].device.type == "cpu":
        return pass_1x1_bwd_plain(ns_flags, groups, outs, z_ins, gbs, ws,
                                  z_outs, dz_outs, dstats)
    wq = [w.to(_BF).contiguous() for w in ws]
    B, H, W, ci, cos = _check_1x1(ns_flags, groups, outs, z_ins, gbs, wq)
    if sorted(w for pairs in outs for _, w in pairs) != list(range(len(ws))):
        raise ValueError(f"1x1 pass backward kernel: each weight must be in "
                         f"exactly one pair, got {outs} for {len(ws)} "
                         f"weights")
    dev = z_ins[0].device
    d = _desc(ns_flags, groups, outs, z_ins, gbs, wq, cos)
    for o, (zo, dz, ds) in enumerate(zip(z_outs, dz_outs, dstats)):
        check_cuda("z_out", zo, _BF, 4)
        check_cuda("dz_out", dz, _BF, 4)
        check_cuda("dstat", ds, torch.float32, 2)
        if zo.shape != (B, H, W, cos[o]) or dz.shape != zo.shape or \
                ds.shape != (2, cos[o]):
            raise ValueError(f"1x1 pass backward: z_out {tuple(zo.shape)}, "
                             f"dz_out {tuple(dz.shape)}, dstat "
                             f"{tuple(ds.shape)}")
        d.out[o], d.dz_out[o], d.dstat[o] = (zo.data_ptr(), dz.data_ptr(),
                                             ds.data_ptr())
    check_aligned(**_named("z_in", z_ins), **_named("w", wq),
                  **_named("z_out", z_outs), **_named("dz_out", dz_outs))
    dz_ins = [torch.empty(B, H, W, ci, dtype=_BF, device=dev) for _ in z_ins]
    for i, t in enumerate(dz_ins):
        d.dz_in[i] = t.data_ptr()
    N = B * H * W
    parts = pass_1x1_bwd_parts(d, N)
    nwe = sum(w.numel() for w in wq)
    R = nwe + len(z_ins) * 2 * ci
    partial = torch.empty(parts, R, device=dev)
    sums = torch.empty(R, device=dev)
    KERNEL_1X1_BWD.launch(ctypes.addressof(d), partial, sums, N, parts)
    dws, a = [], 0
    for w in ws:
        dws.append(sums[a:a + w.numel()].view(w.shape).to(w.dtype))
        a += w.numel()
    dgbs = tuple(sums[a + 2 * ci * i:a + 2 * ci * (i + 1)].view(2, ci)
                 for i in range(len(z_ins)))
    return tuple(dz_ins), dgbs, tuple(dws)


class _Pass1x1(torch.autograd.Function):
    """The grouped 1x1 pass; its backward is the backward kernel (or its
    plain version).  ``spec = (ns_flags, groups, outs, n_in, plain)``;
    the tensors are the inputs, then their gbs, then the weights."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        ns_flags, groups, outs, n_in, plain = spec
        z_ins, gbs, ws = (tensors[:n_in], tensors[n_in:2 * n_in],
                          tensors[2 * n_in:])
        fwd = pass_1x1_fwd_plain if plain else pass_1x1_fwd
        z_outs, stats = fwd(ns_flags, groups, outs, z_ins, gbs, ws)
        ctx.spec = spec
        ctx.save_for_backward(*tensors, *z_outs)
        return (*z_outs, *stats)

    @staticmethod
    def backward(ctx, *cots):
        ns_flags, groups, outs, n_in, plain = ctx.spec
        saved = ctx.saved_tensors
        n_out = len(outs)
        tensors, z_outs = saved[:-n_out], saved[-n_out:]
        z_ins, gbs, ws = (tensors[:n_in], tensors[n_in:2 * n_in],
                          tensors[2 * n_in:])
        dz_outs = tuple(c.to(_BF).contiguous() for c in cots[:n_out])
        dstats = tuple(c.float().contiguous() for c in cots[n_out:])
        bwd = pass_1x1_bwd_plain if plain else pass_1x1_bwd
        dz_ins, dgbs, dws = bwd(ns_flags, groups, outs, z_ins, gbs, ws,
                                z_outs, dz_outs, dstats)
        return (None, *dz_ins, *dgbs, *dws)


def pass_1x1(ns_flags, groups, outs, z_ins, gbs, ws, plain: bool = False):
    """Grouped BN+SiLU → 1x1 conv pass, differentiable in every input, gb
    and weight.  ``z_ins``: tuple of ``(B, H, W, ci)`` bf16; ``gbs``: tuple
    of ``(2, ci)`` float32; ``ws``: tuple of ``(ci, co)``.  Returns
    ``(z_outs, stats)``: tuples of bf16 ``(B, H, W, co)`` and float32
    ``(2, co)`` [Σz; Σz²].  On the card the forward and backward kernels;
    on the CPU, or with ``plain``, their plain versions."""
    spec = (tuple(ns_flags), tuple(tuple(m) for m in groups),
            tuple(tuple(tuple(p) for p in o) for o in outs), len(z_ins),
            plain)
    res = _Pass1x1.apply(spec, *z_ins, *gbs, *ws)
    n_out = len(outs)
    return tuple(res[:n_out]), tuple(res[n_out:])


# ---------------------------------------------------------------------------
# 3x3 passes (stride 1 and 2)
# ---------------------------------------------------------------------------


def _taps_oihw(w_taps, ci):
    return w_taps.reshape(3, 3, ci, w_taps.shape[1]).permute(3, 2, 0, 1)


def pass_3x3_fwd_plain(z_in, gb, w_taps, stride: int):
    """Plain version of the 3x3 pass forward: ``silu(z·g + b)`` in float32
    rounded to bf16, a SAME 3x3 conv (pad 1; the padding is of the
    activated input) in float32 with the bf16-rounded taps ``(9*ci, co)``,
    row ``(3*dy + dx)*ci + c``.  Returns the bf16 output and the ``(2, co)``
    sums of the float32 accumulator."""
    ci = z_in.shape[-1]
    y = _silu(z_in.float() * gb[0] + gb[1]).to(_BF).float()
    k = _taps_oihw(w_taps.to(_BF).float(), ci)
    with _no_tf32():
        acc = F.conv2d(y.permute(0, 3, 1, 2), k, stride=stride, padding=1)
    acc = acc.permute(0, 2, 3, 1)
    return acc.to(_BF).contiguous(), _sums(acc)


def pass_3x3_partial_rows(B: int, H: int, W: int, stride: int) -> int:
    """Rows of the statistics partial a 3x3 pass kernel writes: one per
    output tile."""
    ty, tx = _TILE_3X3
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return B * -(-Ho // ty) * -(-Wo // tx)


def pass_3x3_fwd(z_in, gb, w_taps, stride: int):
    """Forward of a 3x3 pass → ``(z_out, stats)`` as in
    :func:`pass_3x3_fwd_plain`.  CPU tensors take the plain version; CUDA
    tensors take the stride's kernel (bf16 ``z_in``, float32 ``gb``; the
    taps are rounded to bf16 here)."""
    if z_in.device.type == "cpu":
        return pass_3x3_fwd_plain(z_in, gb, w_taps, stride)
    if stride not in (1, 2):
        raise ValueError(f"3x3 pass kernel: stride {stride}")
    wq = w_taps.to(_BF).contiguous()
    check_cuda("z_in", z_in, _BF, 4)
    check_cuda("gb", gb, torch.float32, 2)
    B, H, W, ci = z_in.shape
    co = wq.shape[1]
    if (wq.shape[0] != 9 * ci or gb.shape != (2, ci) or ci % 2 or co % 8
            or B * H * W == 0):
        raise ValueError(f"3x3 pass kernel: bad shapes z_in "
                         f"{tuple(z_in.shape)}, w_taps {tuple(wq.shape)}, gb "
                         f"{tuple(gb.shape)} (ci % 2 == 0, co % 8 == 0)")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    z = torch.empty(B, Ho, Wo, co, dtype=_BF, device=z_in.device)
    check_aligned(z_in=z_in, w_taps=wq)
    partial = torch.empty(pass_3x3_partial_rows(B, H, W, stride), 2 * co,
                          device=z_in.device)
    stats = torch.empty(2, co, device=z_in.device)
    kern = KERNEL_3X3S1 if stride == 1 else KERNEL_3X3S2
    kern.launch(z_in, gb, wq, z, partial, stats, B, H, W, ci, co)
    return z, stats


def pass_3x3_bwd(z_in, gb, w_taps, z_out, dz_out, dst, stride: int):
    """Backward of a 3x3 pass → ``(dz_in, dgb, dw)``: the JAX package's
    ``_xla_conv_bwd`` (train_fused.py:523), outside any kernel there and
    here.  ``dz_eff`` and the recomputed activation are bf16; the conv's
    input and weight gradients come back in bf16, as JAX's bf16 conv gives
    them (on the card cuDNN in bf16; on the CPU the float32 conv of the same
    bf16 values, rounded to bf16); ``dz_in`` in ``z_in.dtype``, ``dw`` in
    ``w_taps.dtype``."""
    ci, co = z_in.shape[-1], w_taps.shape[1]
    dz_eff = (dz_out.float() + dst[0] + 2.0 * z_out.float() * dst[1]).to(_BF)
    zf = z_in.float()
    a = zf * gb[0] + gb[1]
    ct = _BF if z_in.device.type == "cuda" else torch.float32
    y = _silu(a).to(_BF).to(ct).permute(0, 3, 1, 2)
    k = _taps_oihw(w_taps.to(_BF).to(ct), ci)
    dn = dz_eff.to(ct).permute(0, 3, 1, 2)
    with _no_tf32():
        dy = torch.nn.grad.conv2d_input(y.shape, k, dn, stride=stride,
                                        padding=1)
        dw = torch.nn.grad.conv2d_weight(y, k.shape, dn, stride=stride,
                                         padding=1)
    da = dy.to(_BF).float().permute(0, 2, 3, 1) * _dsilu(a)
    dz_in = (da * gb[0]).to(z_in.dtype)
    dw = dw.to(_BF).permute(2, 3, 1, 0).reshape(9 * ci, co)
    return dz_in, _sums_da(da, zf), dw.to(w_taps.dtype)


class _Pass3x3(torch.autograd.Function):
    """A 3x3 pass: the forward kernel (or its plain version), the library
    backward of :func:`pass_3x3_bwd`."""

    @staticmethod
    def forward(ctx, stride, plain, z_in, gb, w_taps):
        fwd = pass_3x3_fwd_plain if plain else pass_3x3_fwd
        z_out, stats = fwd(z_in, gb, w_taps, stride)
        ctx.stride = stride
        ctx.save_for_backward(z_in, gb, w_taps, z_out)
        return z_out, stats

    @staticmethod
    def backward(ctx, dz_out, dst):
        z_in, gb, w_taps, z_out = ctx.saved_tensors
        return (None, None, *pass_3x3_bwd(z_in, gb, w_taps, z_out, dz_out,
                                          dst, ctx.stride))


def pass_3x3s1(z_in, gb, w_taps, plain: bool = False):
    """BN+SiLU → SAME 3x3 stride-1 conv + statistics, differentiable.
    ``z_in (B, H, W, ci)`` bf16; ``gb (2, ci)`` float32; ``w_taps (9*ci,
    co)``.  Returns ``(z_out (B, H, W, co) bf16, stats (2, co) float32)``."""
    return _Pass3x3.apply(1, plain, z_in, gb, w_taps)


def pass_3x3s2(z_in, gb, w_taps, plain: bool = False):
    """BN+SiLU → SAME 3x3 stride-2 conv + statistics, differentiable.
    Returns ``(z_out (B, ceil(H/2), ceil(W/2), co) bf16, stats (2, co))``."""
    return _Pass3x3.apply(2, plain, z_in, gb, w_taps)
