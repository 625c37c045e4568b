"""Offline tile inference: a pool of distinct uint8 tile batches, made on
the device from the seed, dispatched back to back through the port's
``make_predict_fn`` (forward, decode, selection, rotated NMS); each batch's
detections are read back to the host before the next is sent.

End-to-end: ``infer_img_per_s`` (images completed over the window's whole
time) and ``infer_batch_p95_ms`` (95th percentile of every batch's time
from its ``predict`` call to its detections readable on the host).

The objectness bias is set before the program is built, from the
benchmark's reference: the obj-bias move that gives the traffic's
``density`` detections an image on the first images of the pool, by
bisection (the port's ``chip_smoke.tune_density`` recipe).  That work of
the reference on the weights (with the BatchNorm statistics settled and
the head scaled before it) is timed apart, as ``reference_s``, and left
out of ``setup_s``.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from .. import bounds, compare, flops, trace
from .. import weights as W
from ..device import no_tf32
from ..reference import nms as RN

DENSITY_IMAGES = 2
BISECTIONS = 9
OBJ_RANGE = (-5.0, 15.0)  # the objectness-bias moves searched
REF_BLOCK = 8  # images a reference forward takes at once


def _nms_args(tr: dict) -> dict:
    """The reference NMS's settings of a traffic (or of its
    ``density_regime``)."""
    return dict(conf_thr=tr["conf"], iou_thr=tr["iou"],
                max_candidates=tr["max_candidates"], max_det=tr["max_det"],
                multi_label=tr["multi_label"])


def reference_maps(ref, images):
    """The reference's float32 Detect maps of ``images`` (NHWC uint8), in
    blocks of ``REF_BLOCK`` images."""
    parts = []
    with torch.no_grad(), no_tf32():
        for s in range(0, images.shape[0], REF_BLOCK):
            parts.append(ref(images[s:s + REF_BLOCK]))
    return [torch.cat(level, 0) for level in zip(*parts)]


def reference_dets(ref, maps, nc: int, tr: dict) -> list:
    return RN.nms(maps, ref.anchors_px, ref.strides, nc, **_nms_args(tr))


def tune_density(sd, md, nc, images, tr, device) -> float:
    """The objectness-bias move that gives ~``tr['density']`` reference
    detections an image on ``images`` at ``tr``'s settings (detections
    rise with it)."""
    ref = W.reference_model(md, nc, sd, device).eval()
    maps = reference_maps(ref, images)
    na, no = ref.na, ref.no
    lo, hi = OBJ_RANGE
    for _ in range(BISECTIONS):
        mid = (lo + hi) / 2
        moved = [m.clone().view(m.shape[0], -1, na, no) for m in maps]
        for m in moved:
            m[..., 4] += mid
        moved = [m.view(m.shape[0], -1, no) for m in moved]
        dets = reference_dets(ref, moved, nc, tr)
        d = float(np.mean([len(x) for x in dets]))
        lo, hi = (mid, hi) if d < tr["density"] else (lo, mid)
    return (lo + hi) / 2


def _kernels():
    from yolov5_obb_tpu_torch.ops.kernels import (
        c3_kernel,
        down_kernel,
        stem_kernel,
    )

    return {"stem_l1": stem_kernel.KERNEL, "c3": c3_kernel.KERNEL,
            "down": down_kernel.KERNEL}


def setup(ctx):
    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    md, nc, size = cfg["model"], cfg["nc"], cfg["imgsz"]
    B, P = tr["batch"], tr["pool"]
    sd = W.state_dict(md, nc, ctx.seed, dev.dev)
    g = W.generator(ctx.seed + 1, dev.dev)
    pool = torch.randint(0, 256, (P, B, size, size, 3), generator=g,
                         device=dev.dev, dtype=torch.uint8)
    W.quiet_batchnorm(sd)
    # the reference's work on the weights: not the program's set-up
    dev.sync()
    t = time.perf_counter()
    with no_tf32():
        W.settle_batchnorm(sd, md, nc, pool[0, :DENSITY_IMAGES])
        W.scale_head(sd, md, nc, pool[0, :DENSITY_IMAGES])
    delta = tune_density(sd, md, nc, pool[0, :DENSITY_IMAGES],
                         {**tr, **tr["density_regime"]}, dev.dev)
    W.shift_objectness(sd, md, nc, delta)
    dev.sync()
    reference_s = time.perf_counter() - t

    model, meta = create_model(md, nc=nc, dtype=getattr(torch, cfg["dtype"]),
                               device=dev.dev, packed_stem=cfg["packed_stem"])
    model.load_state_dict(sd)
    fuse_conv_bn(model)
    predict = make_predict_fn(model, meta, tr["conf"], tr["iou"],
                              tr["max_det"], multi_label=tr["multi_label"],
                              max_candidates=tr["max_candidates"])
    seen = {}
    hook = model.model[-1].register_forward_hook(
        lambda mod, args, out: seen.__setitem__("maps", out))
    packed = predict.packed_stem
    inputs = [pool[i].view(B, size, size * 3) if packed else pool[i]
              for i in range(P)]
    st = types.SimpleNamespace(ctx=ctx, sd=sd, pool=pool, inputs=inputs,
                               model=model, meta=meta, predict=predict,
                               hook=hook, seen=seen, delta=delta,
                               reference_s=reference_s)
    for x in inputs:  # every batch's shapes and NMS tier, built and warm
        call(st, x)
    t = time.perf_counter()
    for x in inputs:
        call(st, x)
    st.rate = P / (time.perf_counter() - t)
    return st


def call(st, x):
    """One batch: ``predict`` and the detections read back to the host."""
    dets, num = st.predict(x)
    return dets, num, dets.cpu(), num.cpu()


def window(st, seconds: float) -> dict:
    ctx, tr = st.ctx, st.ctx.traffic
    P, B = tr["pool"], tr["batch"]
    rng = np.random.default_rng(ctx.seed)
    cycles = max(int(0.5 * st.rate * seconds / P), 1)
    items = rng.choice(P, size=min(tr["compare_batches"], P), replace=False)
    sample = {int(rng.integers(cycles)) * P + int(i) for i in items}
    st.kept, lat, failed = [], [], 0
    ctx.device.reset_peak()
    ctx.device.sync()
    t_start = time.perf_counter()
    n = 0
    last = max(sample)
    # the window runs on past its time, if need be, to the last sampled call
    while time.perf_counter() - t_start < seconds or n <= last:
        t0 = time.perf_counter()
        dets, num, d_host, n_host = call(st, st.inputs[n % P])
        lat.append(time.perf_counter() - t0)
        # on the host in numpy: a torch CPU op here wakes its thread pool
        failed += int(not np.isfinite(d_host.numpy()).all())
        if n in sample:
            st.kept.append((n % P, st.seen["maps"], dets, num))
        n += 1
    st.window_s = time.perf_counter() - t_start
    st.calls = n
    st.missing = len(sample) - len(st.kept)
    return {"metrics": {"infer_img_per_s": n * B / st.window_s,
                        "infer_batch_p95_ms":
                            float(np.percentile(lat, 95)) * 1e3},
            "attempted": n, "failed": failed}


def observe(st) -> dict:
    """The traced run's readings: the forward and post-processing spans
    over every pool batch, then the device trace of two batches."""
    from yolov5_obb_tpu_torch.ops.rotated_nms import (
        non_max_suppression_from_maps,
    )

    ctx, tr = st.ctx, st.ctx.traffic
    cfg, dev = ctx.config, ctx.device
    fwd, post = [], []
    with torch.inference_mode():
        for x in st.inputs:
            start, stop = dev.timer()
            start()
            maps = st.model(x)
            fwd.append(stop())
            t0 = time.perf_counter()
            non_max_suppression_from_maps(
                maps, st.meta, tr["conf"], tr["iou"], tr["max_candidates"],
                tr["max_det"], multi_label=tr["multi_label"])
            dev.sync()
            post.append(time.perf_counter() - t0)
    kern = _kernels()
    before = {k: v.launches for k, v in kern.items()}
    per = 2
    tr_ = trace.record(lambda: [call(st, x) for x in st.inputs[:per]],
                       dev, per)
    launches = {k: (v.launches - before[k]) / (2 * per)
                for k, v in kern.items()}
    return {"kind": "predict", "forward_ms": float(np.mean(fwd)) * 1e3,
            "postproc_ms": float(np.mean(post)) * 1e3, "trace": tr_,
            "launches": launches,
            "bounds_s": bounds.infer_rows(cfg["model"], tr["batch"],
                                          cfg["imgsz"]),
            "flops_per_call": flops.forward_flops(
                cfg["model"], cfg["nc"], tr["batch"], cfg["imgsz"]),
            "calls": st.calls, "window_s": st.window_s}


def release(st):
    st.hook.remove()
    st.model = st.predict = st.seen = st.inputs = None
    st.ctx.device.free()


def program_dets(dets, num) -> list:
    d, n = dets.double().cpu().numpy(), num.cpu().numpy()
    return [d[i, :n[i]] for i in range(len(n))]


def judge(ref, nc, tr, maps_got, dets_got, maps_want) -> dict:
    """The forward against the reference's maps; the post-processing
    against the reference's NMS on the program's own maps (the stage
    alone: the bf16 maps' rounding moves scores across the thresholds and
    boxes across the NMS chains, which the forward's number covers); and
    the whole predict: the detections against the reference's from its own
    maps."""
    rel = max(compare.rel_err(a.float(), b) for a, b in zip(maps_got,
                                                            maps_want))
    dev = maps_want[0].device
    stage = compare.detections(dets_got, reference_dets(
        ref, [m.float() for m in maps_got], nc, tr), dev)
    whole = compare.detections(dets_got, reference_dets(ref, maps_want, nc,
                                                        tr), dev)
    return {"maps_rel_err": rel, **stage,
            "whole_unmatched": whole["unmatched"],
            "whole_total": whole["total"]}


def merge(parts: list) -> dict:
    """Numbers over the compared batches: the worst map error, the shares
    over all their detections."""
    tot = lambda k: sum(p[k] for p in parts)
    return {"maps_rel_err": max(p["maps_rel_err"] for p in parts),
            "det_unmatched": tot("unmatched") / max(tot("total"), 1),
            "det_unmatched_vs_reference_maps":
                tot("whole_unmatched") / max(tot("whole_total"), 1),
            "dets_per_img": tot("dets_program") / tot("images")}


def check(st, control=None) -> dict:
    """The numbers of the compared batches against the reference.  With
    ``control`` (a rounding), the reference computed in that precision
    stands in for the program's outputs."""
    ctx, tr = st.ctx, st.ctx.traffic
    md, nc = ctx.config["model"], ctx.config["nc"]
    ref = W.reference_model(md, nc, st.sd, ctx.device.dev).eval()
    parts = []
    for item, maps_p, dets_p, num_p in st.kept:
        images = st.pool[item]
        want = reference_maps(ref, images)
        if control is None:
            got, dets_g = maps_p, program_dets(dets_p, num_p)
        else:
            ref.lowp = control
            got = reference_maps(ref, images)
            ref.lowp = None
            dets_g = reference_dets(ref, got, nc, tr)
        parts.append({**judge(ref, nc, tr, got, dets_g, want),
                      "images": images.shape[0]})
        del want, got
    out = merge(parts) if parts else {}
    out["missing_batches"] = st.missing
    return out
