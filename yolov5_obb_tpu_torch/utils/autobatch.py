"""Batch-size estimation (reference utils/autobatch.py:22-57).

``estimate_activation_bytes_per_image`` and ``autobatch`` are the JAX
package's analytic estimate (``yolov5_obb_tpu/utils/autobatch.py``:15-47),
copied with their arguments and results: on a TPU a probe costs a compile,
so the JAX package models the memory instead of measuring it.  Its
constant was calibrated on a TPU (yolov5m at 1024², ~0.6 GB an image in
bf16) and says nothing of the card.

:func:`autobatch_cuda` is what the reference does on CUDA: it measures the
peak memory of the model's forward (and backward) at a few small batches,
fits a line and returns the largest power of two under ``fraction`` of the
card's memory.  Its train probe takes the backward through the train
step's own loss (``ComputeLoss``): the backward of the outputs' sum alone
(the reference's probe) misses the loss's memory, which at yolov5m 1024²
on the H100 put the suggested batch's step above the fraction (PERF.md,
phase (m)).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..engine.loss import ComputeLoss
from .general import load_hyp, scale_hyp_gains


def estimate_activation_bytes_per_image(imgsz: int, width_multiple: float,
                                        depth_multiple: float,
                                        bytes_per_el: int = 2) -> float:
    """Rough activation footprint of a CSP backbone+PAN at `imgsz` (bf16).

    Activation volume is dominated by the early pyramid levels:
    sum over strides s of (imgsz/s)^2 * C(s) with C(s) ≈ 64·(s/2)·width.
    The constant was calibrated against yolov5m@1024 (~0.6 GB/img bf16)."""
    total = 0.0
    for s, base_c in ((2, 64), (4, 128), (8, 256), (16, 512), (32, 1024)):
        c = base_c * width_multiple
        reuse = 2.5 + 2.0 * depth_multiple  # residual stacks keep activations alive
        total += (imgsz / s) ** 2 * c * reuse
    return total * bytes_per_el


def autobatch(n_params: int, imgsz: int = 1024, width_multiple: float = 0.75,
              depth_multiple: float = 0.67, hbm_bytes: int = 16 << 30,
              train: bool = True, fraction: float = 0.85,
              remat: bool = False) -> int:
    """Suggest a per-chip batch size that fits in `hbm_bytes`."""
    # params + grads + momentum + EMA, fp32
    state_bytes = n_params * 4 * (4 if train else 1)
    act = estimate_activation_bytes_per_image(imgsz, width_multiple, depth_multiple)
    if train:
        act *= 2.0  # saved residuals for backward
        if remat:
            act *= 0.5
    budget = hbm_bytes * fraction - state_bytes
    if budget <= 0:
        return 1
    b = int(budget // act)
    # round down to a power of two for clean mesh sharding
    return max(1 << int(np.log2(max(b, 1))), 1)


def fit_batch(batches, peaks, budget: float) -> int:
    """The largest power-of-two batch whose peak, on the line fitted
    through ``(batches, peaks)`` bytes, stays within ``budget`` bytes (at
    least 1; reference autobatch.py:45-55 fits the same line)."""
    slope, intercept = np.polyfit(np.asarray(batches, np.float64),
                                  np.asarray(peaks, np.float64), 1)
    if slope <= 0:
        raise ValueError(f"peak memory does not grow with the batch: "
                         f"{dict(zip(batches, peaks))}")
    b = int((budget - intercept) // slope)
    return max(1 << int(np.log2(max(b, 1))), 1)


def _probe_peak(model, batch: int, imgsz: int, loss_fn=None) -> int:
    """Peak bytes allocated on the card by one forward of ``model`` at
    ``batch``; given ``loss_fn``, in train mode and then the backward of
    ``loss_fn(maps, targets, mask)`` on images without objects.
    ``model`` is the caller's copy, whose statistics and gradients this
    changes."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(batch)
    if model.packed_stem:  # the packed (B, H, 3W) uint8 image
        x = torch.randint(0, 256, (batch, imgsz, imgsz * 3),
                          dtype=torch.uint8, device=dev, generator=gen)
    else:
        x = torch.rand(batch, imgsz, imgsz, 3, device=dev, generator=gen)
    train = loss_fn is not None
    model.train(train)
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.set_grad_enabled(train):
        out = model(x)
        if train:
            targets = torch.zeros(batch, 1, 186, device=dev)
            mask = torch.zeros(batch, 1, dtype=torch.bool, device=dev)
            loss_fn(out, targets, mask)[0].backward()
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def autobatch_cuda(model, imgsz: int = 1024, train: bool = True,
                   fraction: float = 0.85, batches=(1, 2, 4), meta=None,
                   memory=None, total_memory: int | None = None) -> int:
    """The largest power-of-two batch of ``model`` at ``imgsz`` whose peak
    memory stays under ``fraction`` of the card's: the peak of the forward
    (with ``train`` also the backward through the train step's
    ``ComputeLoss``, built from ``meta`` and the default hyp) at each of
    ``batches`` (``torch.cuda.max_memory_allocated``), a
    line fitted through them.

    ``memory`` (``batch -> peak bytes``) replaces the probe and
    ``total_memory`` the card's size (for a model anywhere, the CPU too);
    without ``memory`` the model must be on the card, and a copy of it
    is probed (as the reference's ``deepcopy``), so ``model`` is left as it
    was."""
    if memory is None:
        if train and meta is None:
            raise ValueError("the train probe runs the step's loss: pass "
                             "the model's meta=")
        dev = next(model.parameters()).device
        if dev.type != "cuda":
            raise RuntimeError("autobatch_cuda probes the card's memory: "
                               "put the model on the card, or pass memory=")
        loss_fn = (ComputeLoss(meta, scale_hyp_gains(
            load_hyp(), meta.nl, meta.nc, imgsz)) if train else None)
        probe = copy.deepcopy(model)
        memory = lambda b: _probe_peak(probe, b, imgsz, loss_fn)  # noqa: E731
        if total_memory is None:
            total_memory = torch.cuda.get_device_properties(dev).total_memory
    if total_memory is None:
        raise ValueError("total_memory is needed with an injected memory "
                         "reader")
    peaks = [memory(b) for b in batches]
    batch = fit_batch(batches, peaks, total_memory * fraction)
    print("autobatch: peak GiB " + ", ".join(
        f"{b}: {p / 2**30:.2f}" for b, p in zip(batches, peaks))
        + f" → batch {batch} under {fraction:.2f} of "
          f"{total_memory / 2**30:.2f} GiB")
    return batch
