"""The training step: one ``make_train_step`` step object (the model, SGD
and its state, the EMA), driven from the seed's weights through the
checked steps and then, the same object, through the window.  A step is
one micro-batch: the optimizer folds its gradients into the mean of the
nominal batch and updates the parameters once in ``accumulate`` steps, as
the train CLI does.  Batches live
in pinned host memory and the step moves them itself; the window cycles
through a pool of distinct batches, reading nothing back until it closes,
as the train CLI does between its log lines.

End-to-end: ``train_img_per_s`` (images over the window's whole time) and
``train_peak_mem_gib`` (``torch.cuda.max_memory_allocated()`` over the
window).

Labels: every image draws its number of live labels from a fixed set,
the quantiles of a log-normal with the traffic's mean and sigma cut at
the label slots, dealt to the images in the seed's order, so every seed
has the same work; positions uniform over the tile, long sides
log-uniform over the traffic's range and short sides log-uniform between
its floor and the long side, angles uniform over the half circle, classes
uniform.
"""

from __future__ import annotations

import statistics
import time
import types

import numpy as np
import torch

from .. import bounds, compare, flops, trace
from .. import weights as W
from ..device import no_tf32
from ..reference import loss as RL


def checked_steps(accumulate: int) -> int:
    """Steps the check follows: three updates where each step updates the
    parameters, else two whole updates of ``accumulate`` micro-batches
    (the first update moves only biases: the weights' warmup learning
    rate starts at 0)."""
    return 3 if accumulate == 1 else 2 * accumulate


def mean_labels(tr: dict, size: int) -> float:
    """Objects a tile of ``size``² holds on average: the data set's
    instances an image over its mean image area, times the tile's area and
    the share of objects that overlapping tiles (``gap``) repeat."""
    lab = tr["labels"]
    per_px = lab["instances"] / lab["images"] / (lab["mean_image_mpx"] * 1e6)
    return per_px * size * size * (size / (size - lab["gap"])) ** 2


def label_counts(tr: dict, size: int, n: int, seed: int) -> np.ndarray:
    """The live labels of ``n`` images: fixed log-normal quantiles, in the
    seed's order."""
    lab = tr["labels"]
    mu = np.log(mean_labels(tr, size)) - lab["sigma"] ** 2 / 2
    z = [statistics.NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    counts = np.clip(np.round(np.exp(mu + lab["sigma"] * np.array(z))), 1,
                     tr["max_labels"]).astype(int)
    return np.random.default_rng(seed).permutation(counts)


def make_batches(tr: dict, size: int, seed: int, device) -> list:
    """``pool`` batches ``(image (B, H, W, 3) uint8, targets (B, M, 186),
    mask (B, M))`` in pinned host memory, made on the device."""
    B, P, M = tr["batch"], tr["pool"], tr["max_labels"]
    lo, hi = tr["box_px"]
    g = W.generator(seed + 2, device)
    counts = label_counts(tr, size, B * P, seed).reshape(P, B)
    out = []
    for p in range(P):
        img = torch.randint(0, 256, (B, size, size, 3), generator=g,
                            device=device, dtype=torch.uint8)
        u = torch.rand(B, M, 6, generator=g, device=device)
        cls = torch.randint(0, tr["classes"], (B, M), generator=g,
                            device=device).float()
        long_ = torch.exp(np.log(lo) + u[..., 2] * np.log(hi / lo))
        short = torch.exp(np.log(lo) + u[..., 3] * torch.log(long_ / lo))
        theta = (u[..., 4] - 0.5) * np.pi
        tg = torch.zeros(B, M, 186, device=device)
        tg[..., 0] = cls
        tg[..., 1] = u[..., 0] * size
        tg[..., 2] = u[..., 1] * size
        tg[..., 3], tg[..., 4], tg[..., 5] = long_, short, theta
        half = 90
        idx = torch.trunc(half - (theta * 180 / np.pi + 90))
        j = torch.arange(180, device=device, dtype=torch.float32)
        d = torch.remainder(j + idx[..., None], 180) - half
        tg[..., 6:] = torch.exp(-d ** 2 / (2.0 * tr["hyp"]["csl_radius"] ** 2))
        mask = (torch.arange(M, device=device)[None, :]
                < torch.as_tensor(counts[p], device=device)[:, None])
        tg *= mask[..., None]
        pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=device.type
                              == "cuda") for t in (img, tg, mask)]
        for a, b in zip(pinned, (img, tg, mask)):
            a.copy_(b)
        out.append(tuple(pinned))
    return out


def _record(losses, grads, named, ema, buffers, p0, b0) -> dict:
    """Norms by leaf of the checked steps' record."""
    with torch.no_grad():
        return {"losses": losses, "grad": grads,
                "update": {n: float((p.float() - p0[n]).norm())
                           for n, p in named},
                "ema": {n: float((ema[n].float() - p0[n]).norm())
                        for n, _ in named},
                "bn": {n: float((b.float() - b0[n]).norm())
                       for n, b in buffers}}


def _running(model):
    return [(n, b) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def setup(ctx):
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import (
        create_train_state,
        make_train_step,
    )
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import scale_hyp_gains

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    md, nc, size = cfg["model"], cfg["nc"], cfg["imgsz"]
    B = tr["batch"]
    sd = W.state_dict(md, nc, ctx.seed, dev.dev)
    W.quiet_batchnorm(sd)
    batches = make_batches(tr, size, ctx.seed, dev.dev)
    model, meta = create_model(md, nc=nc, dtype=getattr(torch, cfg["dtype"]),
                               device=dev.dev, packed_stem=cfg["packed_stem"])
    model.load_state_dict(sd)
    hyp = tr["hyp"]
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc, size))
    opt, _ = build_optimizer(model, hyp, epochs=tr["epochs"],
                             steps_per_epoch=tr["steps_per_epoch"],
                             batch_size=B, nominal_batch=tr["nominal_batch"])
    state = create_train_state(opt)
    step = make_train_step(model, loss_fn, opt, use_ema=tr["ema"],
                           device=dev.dev)
    packed = model.packed_stem
    feed = [((img.view(B, size, size * 3) if packed else img), t, m)
            for img, t, m in batches]
    st = types.SimpleNamespace(ctx=ctx, sd=sd, batches=batches, feed=feed,
                               model=model, opt=opt, state=state, step=step,
                               loss_fn=loss_fn)
    named = list(model.named_parameters())
    buffers = _running(model)
    p0 = {n: sd[n].float() for n, _ in named}
    b0 = {n: sd[n].float() for n, _ in buffers}
    st.checked = checked_steps(opt.accumulate)
    if st.checked > tr["pool"]:
        raise ValueError(f"{st.checked} checked steps need as many distinct "
                         f"batches; the pool holds {tr['pool']}")
    losses, grads = [], {}
    for s in range(st.checked):
        m = step(state, *feed[s])
        losses.append(float(m["loss"]))
        if s == 0:  # the first gradient, from the optimizer's state
            with torch.no_grad():
                for i, (n, p) in enumerate(named):
                    if opt.accumulate > 1:  # the micro-batches' mean
                        g = state.opt_state.acc[i].float()
                    else:  # the trace after one update: g + wd·p0
                        g = state.opt_state.trace[i].float()
                        if opt.decay[i]:
                            g = g - opt.weight_decay * p0[n]
                    grads[n] = float(g.norm())
    st.record = _record(losses, grads, named, state.ema, buffers, p0, b0)
    st.accumulate = opt.accumulate
    st.next = st.checked
    for _ in range(tr["warm_steps"]):
        float(step(state, *feed[st.next % tr["pool"]])["loss"])
        st.next += 1
    return st


def window(st, seconds: float) -> dict:
    tr, dev = st.ctx.traffic, st.ctx.device
    P, B = tr["pool"], tr["batch"]
    dev.reset_peak()
    dev.sync()
    losses = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        m = st.step(st.state, *st.feed[st.next % P])
        losses.append(m["loss"])
        st.next += 1
    dev.sync()
    st.window_s = time.perf_counter() - t_start
    st.calls = n = len(losses)
    peak = dev.peak_bytes()
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return {"metrics": {"train_img_per_s": n * B / st.window_s,
                        "train_peak_mem_gib": peak / 2 ** 30},
            "attempted": n, "failed": failed}


def _kernels():
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel, stem_kernel

    return {"stem_train_fwd": stem_kernel.TRAIN_FWD_KERNEL,
            "stem_train_wgrad": stem_kernel.TRAIN_WGRAD_KERNEL,
            "down_train_fwd": down_kernel.TRAIN_FWD_KERNEL,
            "down_train_wgrad": down_kernel.TRAIN_WGRAD_KERNEL}


def observe(st) -> dict:
    """The traced run's readings: the device trace of one update's
    ``accumulate`` steps."""
    cfg, tr = st.ctx.config, st.ctx.traffic
    kern = _kernels()
    before = {k: v.launches for k, v in kern.items()}
    per = st.accumulate

    def cycle():
        for _ in range(per):
            m = st.step(st.state, *st.feed[st.next % tr["pool"]])
            st.next += 1
        float(m["loss"])

    tr_ = trace.record(cycle, st.ctx.device, per)
    launches = {k: (v.launches - before[k]) / (2 * per)
                for k, v in kern.items()}
    return {"kind": "train_step", "trace": tr_, "launches": launches,
            "bounds_s": bounds.train_rows(cfg["model"], tr["batch"],
                                          cfg["imgsz"]),
            "flops_per_call": flops.train_flops(
                cfg["model"], cfg["nc"], tr["batch"], cfg["imgsz"]),
            "calls": st.calls, "window_s": st.window_s}


def release(st):
    st.model = st.opt = st.state = st.step = st.loss_fn = st.feed = None
    st.ctx.device.free()


def reference_record(st, control=None) -> dict:
    """The reference's record of the checked steps from the same weights
    and batches (``control``: computed in that rounding)."""
    cfg, tr, dev = st.ctx.config, st.ctx.traffic, st.ctx.device
    md, nc, size = cfg["model"], cfg["nc"], cfg["imgsz"]
    ref = W.reference_model(md, nc, st.sd, dev.dev).train()
    ref.remat, ref.lowp = True, control
    named = list(ref.named_parameters())
    buffers = _running(ref)
    p0 = {n: st.sd[n].float() for n, _ in named}
    b0 = {n: st.sd[n].float() for n, _ in buffers}
    hyp = RL.scaled_gains(tr["hyp"], ref.nl, nc, size)
    sgd = RL.SGD(named, tr["hyp"], tr["epochs"], tr["steps_per_epoch"],
                 tr["batch"], tr["nominal_batch"])
    ema = {n: p.detach().clone() for n, p in named}
    params = [p for _, p in named]
    if sgd.accumulate != st.accumulate:
        raise ValueError("the reference and the program accumulate "
                         "differently")
    losses, grads = [], {}
    for s in range(st.checked):
        img, tg, mask = (t.to(dev.dev) for t in st.batches[s])
        with no_tf32():
            maps = ref(img)
            total, _ = RL.loss(maps, tg, mask, ref.anchors_px, ref.strides,
                               nc, hyp)
            g = torch.autograd.grad(total, params)
        del maps
        ref.commit_running_stats()
        losses.append(float(total.detach()))
        if s == 0:
            grads = {n: float(x.norm()) for (n, _), x in zip(named, g)}
        sgd.apply(g)
        if tr["ema"]:
            RL.ema_update(ema, named, s + 1)
        del g
    return _record(losses, grads, named, ema, buffers, p0, b0)


def check(st, control=None) -> dict:
    """The checked steps' numbers against the reference.  With
    ``control`` (a rounding), the reference computed in that precision
    stands in for the program's record."""
    got = st.record if control is None else reference_record(st, control)
    return compare.train_numbers(got, reference_record(st))
