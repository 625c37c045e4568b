#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yolov5_obb_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # run from the root of a checkout

Phases, each fatal on failure:
  (a) set-up: card name and power limit, torch/CUDA versions, build of the
      four CUDA kernels from yolov5_obb_tpu_torch/csrc (one nvcc per source,
      in parallel), timed;
  (b) each kernel against its plain PyTorch version on the card at the main
      path's shapes (bf16 convs; neighbour kernel at n = 512/1024/2048 and on
      a clustered input that overflows M=64), with kernel / plain / library
      times and the bound from the bytes and operations of the shape;
  (c) the main path: yolov5m, batch 16, 1024², conf 0.25, IoU 0.45,
      single-label, 2048 candidates, max_det 1500, random weights from a seed
      with the detection density tuned to ~300 dets/img; every kernel's launch
      count must move; the same path with the plain versions is the
      reference (keep masks on the same candidates, detections per image).

Prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# scalar float32 operations per neighbour-kernel step (edge test of one
# pair; exact IoU of one selected pair), counted from csrc/rotated_iou.cuh
EDGE_OPS = 10
IOU_OPS = 750

BATCH, IMGSZ, MAXC, MAX_DET = 16, 1024, 2048, 1500
CONF, IOU = 0.25, 0.45
DENSITY = 300  # target dets/img for the density bisection


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require(cond, msg) -> None:
    """A phase's check: raises (and so fails the run) when ``cond`` is
    false; unlike ``assert`` it holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, *work):
    """Least time in ms for moving ``nbytes`` and doing ``work``, pairs of
    (operations, peak rate of their type), with what bounds it."""
    t_ops = sum(ops / peak for ops, peak in work) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# (b) each kernel against its plain version
# ---------------------------------------------------------------------------


def conv_weights(gen, co, ci, k, dev):
    import torch

    w = torch.randn(co, ci, k, k, generator=gen, device=dev)
    return w / (ci * k * k) ** 0.5


def bn_stats(gen, c, dev):
    import types

    import torch

    r = lambda lo, hi: lo + (hi - lo) * torch.rand(c, generator=gen, device=dev)
    return types.SimpleNamespace(weight=r(0.5, 1.5), bias=r(-0.2, 0.2),
                                 running_mean=r(-0.3, 0.3),
                                 running_var=r(0.5, 2.0))


def check_stem(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    c2, c3 = 48, 96
    x = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                      device=dev, dtype=torch.uint8)
    ops = S.fold_stem_l1_params(conv_weights(gen, c2, 3, 6, dev),
                                bn_stats(gen, c2, dev),
                                conv_weights(gen, c3, c2, 3, dev),
                                bn_stats(gen, c3, dev))
    got = S.fused_stem_l1(x, *ops)
    want = S.fused_stem_l1_plain(x, *ops)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    k0 = ops[0].reshape(6, 6, 3, c2).permute(3, 2, 0, 1).to(torch.bfloat16)
    k1 = ops[2].reshape(3, 3, c2, c3).permute(3, 2, 0, 1)
    xb = x.view(BATCH, IMGSZ, IMGSZ, 3).permute(0, 3, 1, 2)

    def library():  # the same two convs (+ SiLU) through cuDNN in bf16
        s = F.silu(F.conv2d(xb.to(torch.bfloat16), k0, ops[1].bfloat16(), 2, 2))
        return F.silu(F.conv2d(s, k1, ops[3].bfloat16(), 2, 1))

    # the stem multiplies uint8 values by float32 weights (float32 work);
    # layer 1 multiplies bf16 activations by bf16 weights
    hs = IMGSZ // 2
    f_stem = 2 * BATCH * hs * hs * 108 * c2
    f_l1 = 2 * BATCH * (hs // 2) ** 2 * 9 * c2 * c3
    flops = f_stem + f_l1
    nbytes = x.numel() + got.numel() * 2
    return "stem_l1", S, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "tolerance": "bf16: 1 ulp of the output, abs <= 0.05",
        "ok": float(err.max()) <= 0.05,
        "ms": cuda_time(lambda: S.fused_stem_l1(x, *ops), 5),
        "plain_ms": cuda_time(lambda: S.fused_stem_l1_plain(x, *ops), 3),
        "library_ms": cuda_time(library, 5),
        "bound": bound(nbytes, (f_stem, PEAK_FP32), (f_l1, PEAK_BF16)),
        "flops": flops, "bytes": nbytes,
    }


def check_c3(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.models.layers import C3
    from yolov5_obb_tpu_torch.ops.kernels import c3_kernel as K

    c, n, H = 96, 2, IMGSZ // 4
    c_ = c // 2
    m = C3(c, c, n).to(dev)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Conv2d):
                co, ci, k, _ = mod.weight.shape
                mod.weight.copy_(conv_weights(gen, co, ci, k, dev))
            elif isinstance(mod, torch.nn.BatchNorm2d):
                st = bn_stats(gen, mod.num_features, dev)
                for a in ("weight", "bias", "running_mean", "running_var"):
                    getattr(mod, a).copy_(getattr(st, a))
    p = K.fold_c3_params(m)
    x = torch.randn(BATCH, H, H, c, generator=gen, device=dev).to(torch.bfloat16)
    got = K.fused_c3(x, p)
    want = K.fused_c3_plain(x, p)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()

    def conv(t, w, ss, pad=0):  # NCHW channels-last bf16 conv + folded BN + SiLU
        y = F.conv2d(t, w.permute(3, 2, 0, 1), padding=pad)
        return F.silu(y * ss[0, :, None, None].bfloat16()
                      + ss[1, :, None, None].bfloat16())

    def library():  # the same convs through cuDNN in bf16
        xt = x.permute(0, 3, 1, 2)
        cur = conv(xt, p["w1"][None, None], p["s1"])
        for k in range(n):
            h = conv(cur, p["wa"][k][None, None], p["sa"][k])
            cur = cur + conv(h, p["wt"][k].reshape(3, 3, c_, c_), p["st"][k], 1)
        c2c = conv(xt, p["w2"][None, None], p["s2"])
        w3 = torch.cat([p["w3a"], p["w3b"]])[None, None]
        return conv(torch.cat([cur, c2c], 1), w3, p["s3"])

    macs = c * c_ + n * (c_ * c_ + 9 * c_ * c_) + c * c_ + 2 * c_ * c
    flops = 2 * BATCH * H * H * macs
    nbytes = 2 * x.numel() * 2
    return "c3", K, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "tolerance": "bf16 rounding of the intermediates, abs <= 0.06",
        "ok": float(err.max()) <= 0.06,
        "ms": cuda_time(lambda: K.fused_c3(x, p), 5),
        "plain_ms": cuda_time(lambda: K.fused_c3_plain(x, p), 3),
        "library_ms": cuda_time(library, 5),
        "bound": bound(nbytes, (flops, PEAK_BF16)), "flops": flops,
        "bytes": nbytes,
    }


def check_down(gen, dev):
    import torch
    import torch.nn.functional as F

    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    ci, co, H = 96, 192, IMGSZ // 4
    w = conv_weights(gen, co, ci, 3, dev)
    st = bn_stats(gen, co, dev)
    import types

    wt, ss = D.fold_down_params(types.SimpleNamespace(weight=w), st)
    x = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(torch.bfloat16)
    got = D.fused_down(x, wt, ss)
    want = D.fused_down_plain(x, wt, ss)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    wb = w.to(torch.bfloat16)
    xt = x.permute(0, 3, 1, 2)

    def library():
        y = F.conv2d(xt, wb, stride=2, padding=1)
        return F.silu(y * ss[0, :, None, None].bfloat16()
                      + ss[1, :, None, None].bfloat16())

    flops = 2 * BATCH * (H // 2) ** 2 * 9 * ci * co
    nbytes = x.numel() * 2 + got.numel() * 2
    return "down", D, {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / want.float().abs().clamp(min=1e-2)).max()),
        "tolerance": "bf16: 1 ulp of the output, abs <= 0.05",
        "ok": float(err.max()) <= 0.05,
        "ms": cuda_time(lambda: D.fused_down(x, wt, ss), 5),
        "plain_ms": cuda_time(lambda: D.fused_down_plain(x, wt, ss), 3),
        "library_ms": cuda_time(library, 5),
        "bound": bound(nbytes, (flops, PEAK_BF16)), "flops": flops,
        "bytes": nbytes,
    }


def synthetic_candidates(gen, n, clustered, dev):
    import torch

    u = lambda *s: torch.rand(*s, generator=gen, device=dev)
    rb = torch.empty(BATCH, n, 5, device=dev)
    if clustered:  # a few tight clusters: rows overflow M = 64
        ctr = 100 + 800 * u(BATCH, 4, 2)
        which = (u(BATCH, n) * 4).long()
        rb[..., :2] = torch.gather(ctr, 1, which[..., None].expand(-1, -1, 2)) \
            + 6 * torch.randn(BATCH, n, 2, generator=gen, device=dev)
    else:
        rb[..., :2] = IMGSZ * u(BATCH, n, 2)
    rb[..., 2] = 20 + 70 * u(BATCH, n)
    rb[..., 3] = rb[..., 2] * (0.3 + 0.7 * u(BATCH, n))
    rb[..., 4] = (u(BATCH, n) - 0.5) * np.pi
    cls = (u(BATCH, n) * (2 if clustered else 15)).to(torch.int32)
    valid = torch.arange(n, device=dev)[None] < (0.8 * n)
    return rb, cls, valid.expand(BATCH, n).contiguous()


def neighbor_ops(rb, cls, valid, M) -> float:
    """Scalar operations this input needs: each valid row tests its
    higher-scored columns until its M-th edge, then computes the exact IoU
    of its selected pairs."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    edge = N.edge_matrix(rb, cls, valid, IOU)
    pos = torch.cumsum(edge.to(torch.int32), -1)
    nsel = pos[..., -1].clamp(max=M)
    rows = torch.arange(rb.shape[1], device=rb.device)[None].expand_as(nsel)
    full = pos[..., -1] >= M
    mth = torch.argmax((pos >= M).to(torch.uint8), -1)  # column of M-th edge
    scanned = torch.where(full, mth + 1, rows) * valid
    return float(scanned.sum()) * EDGE_OPS + float(nsel.sum()) * IOU_OPS


def compare_neighbors(rb, cls, valid, M=64):
    """Kernel vs plain on the same candidates: mismatch counts + timings."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    idx, sup = N.fused_neighbor_iou(rb, cls, valid, IOU, M)
    pidx, psup = N.fused_neighbor_iou_plain(rb, cls, valid, IOU, M)
    torch.cuda.synchronize()
    return {
        "nbr_idx_mismatches": int((idx != pidx).sum()),
        "sup_in_mismatches": int((sup != psup).sum()),
        "rows_over_M": int((pidx[..., -1] > 0).sum()),
        "sup_edges": int(psup.sum()),
    }, pidx, psup


def check_neighbor(gen, dev):
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    M = 64
    cases = {}
    for n, clustered in ((512, False), (1024, False), (2048, False),
                         (2048, True)):
        rb, cls, valid = synthetic_candidates(gen, n, clustered, dev)
        res, pidx, psup = compare_neighbors(rb, cls, valid, M)
        res["ms"] = cuda_time(lambda: N.fused_neighbor_iou(rb, cls, valid,
                                                           IOU, M), 10)
        res["plain_ms"] = cuda_time(
            lambda: N.fused_neighbor_iou_plain(rb, cls, valid, IOU, M), 2, 1)
        cases[f"n{n}{'_clustered' if clustered else ''}"] = res
        if n == 2048 and not clustered:
            ops = neighbor_ops(rb, cls, valid, M)
    n = 2048
    nbytes = BATCH * n * (5 * 4 + 4 + 1) + BATCH * n * M * 5
    mism = sum(c["nbr_idx_mismatches"] + c["sup_in_mismatches"]
               for c in cases.values())
    return "neighbor", N, {
        "max_abs_err": float(mism),
        "tolerance": "exact: 0 nbr_idx and 0 sup_in mismatches",
        "ok": mism == 0,
        "ms": cases["n2048"]["ms"], "plain_ms": cases["n2048"]["plain_ms"],
        "library_ms": None,
        "bound": bound(nbytes, (ops, PEAK_FP32)), "flops": ops,
        "bytes": nbytes,
        "cases": cases,
    }


# ---------------------------------------------------------------------------
# (c) the main path
# ---------------------------------------------------------------------------


def main_path(dev, report):
    import torch

    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.ops import rotated_nms as R
    from yolov5_obb_tpu_torch.ops.kernels import _build
    from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn

    t0 = time.perf_counter()
    model, meta = create_model("yolov5m.yaml", nc=15, dtype=torch.bfloat16,
                               device=dev, seed=0, packed_stem=True)
    det = model.model[-1]
    na, no, nc = meta.na, meta.no, meta.nc
    # spread the class biases so conf = obj*cls clears 0.25 for some
    # (anchor, class) pairs (bench.py's recipe), then fold Conv+BN
    rngb = np.random.default_rng(7)
    with torch.no_grad():
        for li in range(meta.nl):
            b = det.m[li].bias.view(na, no)
            b[:, 5:5 + nc] += torch.as_tensor(
                rngb.normal(0.0, 2.0, (na, nc)), dtype=b.dtype, device=dev)
    fuse_conv_bn(model)
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ * 3), generator=gen,
                        device=dev, dtype=torch.uint8) for _ in range(3)]
    require(all(xs[i].data_ptr() != xs[j].data_ptr()
                for i in range(3) for j in range(i)), "batches share buffers")
    predict = make_predict_fn(model, meta, CONF, IOU, MAX_DET,
                              max_candidates=MAXC)

    def set_obj(delta):
        with torch.no_grad():
            for li in range(meta.nl):
                det.m[li].bias.view(na, no)[:, 4] += delta

    lo, hi = 0.0, 10.0  # dets/img is monotone in the obj-bias delta
    for _ in range(7):
        mid = (lo + hi) / 2
        set_obj(mid)
        d = float(predict(xs[0])[1].float().mean())
        set_obj(-mid)
        lo, hi = (mid, hi) if d < DENSITY else (lo, mid)
    delta = (lo + hi) / 2
    set_obj(delta)
    log(f"density: obj delta {delta:.4f}  set-up {time.perf_counter() - t0:.1f}s")

    # the counted run: three distinct batches through the user entry point
    for k in _named_kernels().values():
        k.launches = 0
    torch.cuda.synchronize()
    outs = [predict(x) for x in xs]
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _named_kernels().items()}
    log(f"launches over 3 predict calls: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"kernel not launched: {launches}")

    for d_, n_ in outs:
        require(d_.shape == (BATCH, MAX_DET, 7) and n_.shape == (BATCH,),
                f"detections of shape {tuple(d_.shape)}, {tuple(n_.shape)}")
        require(bool(torch.isfinite(d_).all()), "non-finite detections")
    dets_per_img = float(torch.stack([n_ for _, n_ in outs]).float().mean())

    # reference: the same path through the plain versions on the card
    predict_plain = make_predict_fn(model, meta, CONF, IOU, MAX_DET,
                                    max_candidates=MAXC, plain=True)
    img_mismatch, det_diff, cls_mismatch, map_err = 0, 0, 0, 0.0
    keep_mismatch, idx_mismatch, sup_mismatch, cand = 0, 0, 0, 0
    with torch.inference_mode():
        for x, (d_k, n_k) in zip(xs, outs):
            maps_k = model(x)
            maps_p = model(x, plain=True)
            map_err = max(map_err, max(float((a.float() - b.float()).abs().max())
                                       for a, b in zip(maps_k, maps_p)))
            d_p, n_p = predict_plain(x)
            for i in range(BATCH):
                a, b = int(n_k[i]), int(n_p[i])
                same = a == b and torch.equal(d_k[i, :a, 6], d_p[i, :b, 6])
                img_mismatch += not same
                det_diff += abs(a - b)
                if a == b:
                    cls_mismatch += int((d_k[i, :a, 6] != d_p[i, :a, 6]).sum())
            # the kernel path's own candidates through both NMS versions
            pl = R.decode_planes(maps_k, meta)
            gate = torch.where((pl["best"] > CONF) & (pl["obj"] > CONF),
                               pl["best"], torch.zeros_like(pl["best"]))
            sc, idx = R.exact_select(gate, min(MAXC, gate.shape[1]))
            kk = R._tier(sc.shape[1], int((sc > 0).sum(1).max()))
            cid = torch.gather(pl["cid"], 1, idx)[:, :kk]
            th = (torch.gather(pl["th"], 1, idx).float() - 90.0) / 180.0 * R.PI
            rb = torch.stack([torch.gather(pl[c], 1, idx) for c in "xywh"]
                             + [th], -1)[:, :kk].contiguous()
            sc = sc[:, :kk]
            keep_k = R.nms_rotated(rb, sc, IOU, cid, presorted=True)
            keep_p = R.nms_rotated(rb, sc, IOU, cid, presorted=True, plain=True)
            keep_mismatch += int((keep_k != keep_p).sum())
            res, _, _ = compare_neighbors(rb, cid, sc > 0)
            idx_mismatch += res["nbr_idx_mismatches"]
            sup_mismatch += res["sup_in_mismatches"]
            cand = max(cand, int((sc > 0).sum(1).max()))
    log(f"plain reference: maps max|Δ| {map_err:.4g}, images differing "
        f"{img_mismatch}/{3 * BATCH}, Σ|Δdets| {det_diff}, cls mismatches "
        f"{cls_mismatch}; same candidates (≤{cand}/img, tier {kk}): keep "
        f"mismatches {keep_mismatch}, nbr_idx {idx_mismatch}, sup_in "
        f"{sup_mismatch}")
    require(keep_mismatch == 0 and idx_mismatch == 0 and sup_mismatch == 0,
            "neighbour kernel disagrees with its plain version on the main path")
    # bf16 conv rounding differs between the kernels and their plain
    # versions, so a few scores near 0.25 may cross; bound the effect
    total = dets_per_img * 3 * BATCH
    require(det_diff <= max(10, 0.02 * total),
            f"{det_diff} detections differ from the plain path of {total}")

    # timing, as bench.py does it: pipelined, 12 iterations, sync at the end
    torch.cuda.reset_peak_memory_stats()
    predict(xs[0])
    torch.cuda.synchronize()
    iters = 12
    t = time.perf_counter()
    acc = torch.zeros((), device=dev)
    for i in range(iters):
        d_, n_ = predict(xs[i % 3])
        acc = acc + d_.sum() + n_.sum()
    final = float(acc)
    dt = (time.perf_counter() - t) / iters
    require(np.isfinite(final), "non-finite timing checksum")
    # where a batch's time goes: the model forward alone (CUDA events); the
    # rest of a predict call is decode + selection + rotated NMS
    with torch.inference_mode():
        forward_ms = cuda_time(lambda: model(xs[1]), 5)
    report.update({
        "ms_per_img": dt * 1e3 / BATCH, "dets_per_img": dets_per_img,
        "predict_ms_per_batch": dt * 1e3, "forward_ms_per_batch": forward_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "obj_delta": delta, "maps_max_abs_err_vs_plain": map_err,
        "images_differing_vs_plain": img_mismatch,
        "dets_abs_diff_vs_plain": det_diff,
        "keep_mask_mismatches": keep_mismatch,
        "launches_per_3_predicts": launches,
    })
    return launches


def _named_kernels():
    from yolov5_obb_tpu_torch.ops.kernels import (
        c3_kernel,
        down_kernel,
        neighbor_kernel,
        stem_kernel,
    )

    return {"stem_l1": stem_kernel.KERNEL, "c3": c3_kernel.KERNEL,
            "down": down_kernel.KERNEL, "neighbor": neighbor_kernel.KERNEL}


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on an NVIDIA card")
        return 1
    try:
        from yolov5_obb_tpu_torch.ops.kernels import _build
    except ImportError as e:
        log(f"run from the root of a checkout ({e})")
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # (a) set-up
    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    secs = _build.build()
    log(f"kernel build {time.perf_counter() - t:.1f}s wall  {secs}")
    for name, text in _build.PTXAS_LOG.items():
        log(f"--- ptxas {name}\n" + "\n".join(
            l for l in text.splitlines() if "registers" in l or "spill" in l))

    # (b) kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for check in (check_stem, check_c3, check_down, check_neighbor):
        name, mod, res = check(gen, dev)
        log(f"{name}: " + json.dumps({k: v for k, v in res.items()
                                      if k not in ("bound",)}))
        require(res["ok"], f"{name} disagrees with its plain version")
        results[name] = (mod, res)
        torch.cuda.empty_cache()

    # (c) the main path
    report = {}
    launches = main_path(dev, report)
    log("main path: " + json.dumps(report))

    kernels = []
    for name, (mod, res) in results.items():
        b_ms, b_by = res["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": mod.KERNEL.path,
            "replaces": mod.KERNEL.replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "kernel_ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": res["library_ms"],
        })
    print(json.dumps({"kernels": kernels, "main_path": report,
                      "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
