#!/usr/bin/env python3
"""A/B variants of the port's hand-written kernels on one NVIDIA card.

    python3 tools/torch_conv3x3_ab.py [--csrc NAME=DIR ...] [variants.json [case ...]]

``variants.json`` maps a name to a list of substitutions, each
``[regex, replacement]`` (applied to ``csrc/conv3x3_mma.cuh``) or
``[file, regex, replacement]`` (applied to ``csrc/<file>``), in the
directory ``yolov5_obb_tpu_torch``.  Each ``--csrc NAME=DIR`` adds the
variant NAME: the sources of another ``csrc`` directory (e.g. a parent
commit's, unpacked under the gitignored ``chip_tree/``) in place of the
port's.  Each variant's
tensor-core libraries (``stem_l1.cu``, ``stem.cu``, ``c3.cu``,
``stem_train.cu``, ``down.cu``, ``down_train.cu``, ``train_fused_3x3.cu``,
``train_fused_1x1.cu``) whose sources differ from the port's are compiled
with the port's flags into the (gitignored) build directory.  At the
yolov5m b16 1024² shapes of every tensor-core kernel — the stem+L1 kernel
(row 1: the packed 1024² image → 256² x 96), the C3 kernel (row 2: layer
2, 256² x 96, n = 2; and layer 4, 128² x 192, n = 4), the stem-only
kernel (row 6: the packed 1024² image → 512² x 48), the train stem's
forward (row 7a: the same shapes) and its weight gradient (row 7b: dz
512² x 48 bf16), the inference downsample (row 3, layer 3:
256² x 96 → 128² x 192), the raw train downsample (row 8a, L1: 512² x 48 →
96, L3) and its weight gradient (row 8b, L1, L3), the grouped 1x1 pass
forward (row 9a) and backward (row 9b), each at the four structures of the
C3 region at 256², the stride-1 bottleneck pass (row 10, 256² x 48 → 48)
and the stride-2 passes (row 11, L1, L3) — every build runs through the
port's own wrapper (the variant's entry point bound in place of the main
build's, and its launch plans, such as the partial counts, asked of it), is
held to the plain version and to the main build's outputs (bit for bit:
``same_as_main``) and timed with CUDA events, in the order main, variants,
variants reversed, main; the library call (cuDNN, bf16; for rows 1, 6 and
7a the same function, the stem in float32) beside it; then a profiler split
of the main build's call into its kernels.  Prints the card line and one
JSON line per case.  Case names after the variants file (``{}`` for none)
keep only the cases named so or starting with one of them and "_", e.g.
``row1 row9b``.

The rotated-IoU kernels (``neighbor.cu``, row 4, and ``pairs_iou.cu``, row
5, built with ``-fmad=false``) run at chip_smoke.py's phase (b) inputs
(``row4_*``: its seeded candidates at n = 1024 and 2048, uniform and
clustered; ``row5``: the sparse form on the clustered n = 4096 candidates,
each row's first 64 admissible neighbours).  Each build's outputs are held
to the plain version (mismatch counts; max |IoU Δ|) and to the first
build's (``same_as_main``, bit for bit), timed as whole calls (``ms``) and
as the bare launches on prepared operands (``bare_ms``: the kernels alone,
CUDA events), with the host's enqueue time of a call (``host_ms``) and a
profiler split of every build's call into its kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCES = ("stem_l1", "stem", "c3", "stem_train", "down", "down_train",
           "train_fused_3x3", "train_fused_1x1", "neighbor", "pairs_iou",
           "riou_boxes")
# case → (kind, ci, co or 1x1 structure or C3 depth, input side, stride)
CASES = (("row1", "stem_l1", 48, 96, 1024, 2),
         ("row2", "c3", 96, 2, 256, 1),
         ("row2_L4", "c3", 192, 4, 128, 1),
         ("row6", "stem", 3, 48, 1024, 2),
         ("row7a", "stem_train", 3, 48, 1024, 2),
         ("row7b", "stem_wgrad", 3, 48, 1024, 2),
         ("row3_L3", "down", 96, 192, 256, 2),
         ("row8a_L1", "down_train", 48, 96, 512, 2),
         ("row8a_L3", "down_train", 96, 192, 256, 2),
         ("row8b_L1", "wgrad", 48, 96, 512, 2),
         ("row8b_L3", "wgrad", 96, 192, 256, 2),
         ("row9a_cv1_cv2", "p1x1", 96, "cv1_cv2", 256, 1),
         ("row9a_b0_cv1", "p1x1", 48, "b0_cv1", 256, 1),
         ("row9a_b1_cv1", "p1x1", 48, "b1_cv1", 256, 1),
         ("row9a_cv3", "p1x1", 48, "cv3", 256, 1),
         # yolov5x's cv3 (4 bottlenecks, 80 channels): more inputs than the
         # forward's shared memory stages
         ("row9a_cv3_x", "p1x1", 80, "cv3_x", 256, 1),
         ("row9b_cv1_cv2", "p1x1_bwd", 96, "cv1_cv2", 256, 1),
         ("row9b_b0_cv1", "p1x1_bwd", 48, "b0_cv1", 256, 1),
         ("row9b_b1_cv1", "p1x1_bwd", 48, "b1_cv1", 256, 1),
         ("row9b_cv3", "p1x1_bwd", 48, "cv3", 256, 1),
         ("row9b_cv3_x", "p1x1_bwd", 80, "cv3_x", 256, 1),
         ("row10_bottleneck", "pass", 48, 48, 256, 1),
         ("row11_L1", "pass", 48, 96, 512, 2),
         ("row11_L3", "pass", 96, 192, 256, 2))
# the rotated-IoU cases: (case, kernel, candidates per image, clustered)
RIOU_CASES = (("row4_n1024", "neighbor", 1024, False),
              ("row4_n2048", "neighbor", 2048, False),
              ("row4_n2048_clustered", "neighbor", 2048, True),
              ("row5", "pairs_iou", 4096, True))
BATCH = 16
# 1x1 structures beside chip_smoke's (ns, groups, outs, ci, output widths)
X_1X1 = {"cv3_x": ((True,) * 6, ((0, 1, 2, 3, 4), (5,)),
                   (((0, 0), (1, 1)),), 80, (160, 160))}


def cuda_time(fn, iters=10, warmup=2):
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


def _kernels():
    """The hand-written kernels' Kernel objects (their wrappers launch)."""
    from yolov5_obb_tpu_torch.ops.kernels import c3_kernel as C
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import iou
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N
    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    return [S.KERNEL, S.STEM_KERNEL, C.KERNEL, S.TRAIN_FWD_KERNEL,
            S.TRAIN_WGRAD_KERNEL, D.KERNEL,
            D.TRAIN_FWD_KERNEL, D.TRAIN_WGRAD_KERNEL, TF.KERNEL_1X1,
            TF.KERNEL_1X1_BWD, TF.KERNEL_3X3S1, TF.KERNEL_3X3S2,
            N.KERNEL, iou.KERNEL, iou.BOXES_KERNEL]


def _includes(d, name):
    """The headers ``d/name`` includes, directly or through another."""
    seen, todo = set(), [name]
    while todo:
        for inc in re.findall(r'^#include "([^"]+)"',
                              (d / todo.pop()).read_text(), re.M):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


def start_variant(name, subs):
    """Copy the sources, apply the variant's substitutions and start the
    compiles of the libraries they touch (a source, or a header it
    includes); returns ``(directory, {source: compile})``, or None when a
    substitution changes nothing."""
    from yolov5_obb_tpu_torch.ops.kernels import _build

    d = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    if isinstance(subs, Path):  # another csrc directory
        shutil.copytree(subs, d)
        subs = []
    else:
        shutil.copytree(_build.CSRC_DIR, d)
    for sub in subs:
        file, pat, rep = sub if len(sub) == 3 else ("conv3x3_mma.cuh", *sub)
        text = (d / file).read_text()
        new = re.sub(pat, rep, text, flags=re.S)
        if new == text:
            print(f"{name}: {pat!r} changes nothing in {file}; variant "
                  f"skipped", flush=True)
            return None
        (d / file).write_text(new)
    main = lambda f: _build.CSRC_DIR / f.name
    changed = {f.name for f in d.iterdir() if f.suffix in (".cu", ".cuh")
               and (not main(f).exists()
                    or f.read_bytes() != main(f).read_bytes())}
    changed |= {f.name for f in _build.CSRC_DIR.iterdir()
                if f.suffix == ".cuh" and not (d / f.name).exists()}
    return d, {src: subprocess.Popen(
        [_build._nvcc(), *_build._flags(src), "-I", str(d), "-o",
         str(d / f"{src}.so"), str(d / f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in SOURCES
        if changed & ({f"{src}.cu"} | _includes(d, f"{src}.cu"))}


def _ptxas_summary(log):
    regs = re.findall(r"Used (\d+) registers", log)
    stack = sorted({int(b) for b in re.findall(r"(\d+) bytes stack frame",
                                                log)})
    spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                 log)})
    return f"registers {regs}, stack frame {stack}, spill stores {spills}"


def finish_variant(name, started):
    """The variant's ``(entry points, libraries)``: ``(source, symbol) →
    ctypes function`` and ``source → CDLL`` (the main build's where the
    variant compiled none); or None when a compile fails."""
    from yolov5_obb_tpu_torch.ops.kernels import _build

    d, procs = started
    libs = {src: _build.library(src) for src in SOURCES if src not in procs}
    for src, proc in procs.items():
        log = proc.communicate()[0]
        print(f"{name} {src}: nvcc {proc.returncode}, {_ptxas_summary(log)}",
              flush=True)
        if proc.returncode:
            print(log, flush=True)
            return None
        libs[src] = ctypes.CDLL(str(d / f"{src}.so"))
    fns = {}
    for k in _kernels():
        fn = getattr(libs[k.source], k.symbol)
        fn.argtypes = k.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[(k.source, k.symbol)] = fn
    return fns, libs


@contextlib.contextmanager
def bound_to(build):
    """The port's wrappers launch a variant's entry points and ask its
    libraries for their launch plans, in place of the main build's;
    ``None`` keeps the main build."""
    from yolov5_obb_tpu_torch.ops.kernels import _build

    kerns = _kernels()
    saved = [k._fn for k in kerns]
    saved_libs = dict(_build._LIBS)
    try:
        if build is not None:
            fns, libs = build
            for k in kerns:
                k._fn = fns[(k.source, k.symbol)]
            _build._LIBS.update(libs)
        yield
    finally:
        for k, fn in zip(kerns, saved):
            k._fn = fn
        _build._LIBS.clear()
        _build._LIBS.update(saved_libs)


def _case(kind, ci, co, H, stride, gen, dev):
    """``(call, plain, library)``: the wrapper's call, its plain version and
    the library yardstick on the case's seeded inputs."""
    import torch
    import torch.nn.functional as F

    from chip_smoke import _PASS_1X1
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    bf = torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    gbf = lambda c: torch.stack([1 + 0.3 * rnd(c), 0.2 * rnd(c)])
    if kind == "c3":  # co: the depth n
        from chip_smoke import check_c3_operands

        x, p, library = check_c3_operands(gen, dev, ci, co, H)
        from yolov5_obb_tpu_torch.ops.kernels import c3_kernel as K

        return (lambda: K.fused_c3(x, p), lambda: K.fused_c3_plain(x, p),
                library)
    if kind.startswith("stem"):
        from chip_smoke import bn_stats
        from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

        x = torch.randint(0, 256, (BATCH, H, 3 * H), generator=gen,
                          device=dev, dtype=torch.uint8)
        xn = x.view(BATCH, H, H, 3).permute(0, 3, 1, 2)
        bn = lambda c: bn_stats(gen, c, dev)
    if kind == "stem":
        w0, b0 = S.fold_stem_params(rnd(co, 3, 6, 6) / 108 ** 0.5, bn(co))
        k0 = w0.reshape(6, 6, 3, co).permute(3, 2, 0, 1).contiguous()
        return (lambda: S.fused_stem(x, w0, b0),
                lambda: S.fused_stem_plain(x, w0, b0),
                # the same function: the float32 conv (TF32 off), SiLU
                lambda: F.silu(F.conv2d(xn.float(), k0, b0, 2, 2)).to(bf))
    if kind == "stem_train":
        w = rnd(co, 3, 6, 6) / 108 ** 0.5 / 255.0
        return (lambda: S.stem_train_fwd(x, w),
                lambda: S.stem_train_fwd_plain(x, w),
                # the same function: the float32 conv (TF32 off)
                lambda: F.conv2d(xn.float(), w, None, 2, 2).to(bf))
    if kind == "stem_wgrad":
        hs = (H - 2) // 2 + 1
        dz = rnd(BATCH, hs, hs, co).to(bf)
        dzn = dz.permute(0, 3, 1, 2)
        return (lambda: S.stem_train_wgrad(x, dz),
                lambda: S.stem_train_wgrad_plain(x, dz),
                # the same function: bf16 products, float32 sums (cuDNN)
                lambda: torch.nn.grad.conv2d_weight(
                    xn.to(bf), (co, 3, 6, 6), dzn, 2, 2))
    if kind == "stem_l1":
        ops = S.fold_stem_l1_params(rnd(ci, 3, 6, 6) / 108 ** 0.5, bn(ci),
                                    rnd(co, ci, 3, 3) / (9 * ci) ** 0.5,
                                    bn(co))
        k0 = ops[0].reshape(6, 6, 3, ci).permute(3, 2, 0, 1).contiguous()
        k1 = ops[2].reshape(3, 3, ci, co).permute(3, 2, 0, 1)
        xn = x.view(BATCH, H, H, 3).permute(0, 3, 1, 2)

        def library():  # the stem in float32 (no TF32), layer 1 in bf16
            s = F.silu(F.conv2d(xn.float(), k0, ops[1], 2, 2)).to(bf)
            return F.silu(F.conv2d(s, k1, ops[3].to(bf), 2, 1))

        return (lambda: S.fused_stem_l1(x, *ops),
                lambda: S.fused_stem_l1_plain(x, *ops), library)
    if kind in ("p1x1", "p1x1_bwd"):
        ns, groups, outs, _, cos = {**_PASS_1X1, **X_1X1}[co]
        zs = [rnd(BATCH, H, H, ci).to(bf) for _ in ns]
        gbs = [gbf(ci) for _ in ns]
        ws = [rnd(ci, c) / ci ** 0.5 for c in cos]
        args = (ns, groups, outs, zs, gbs, ws)
        gv = torch.cat(TF._group_values(ns, groups, zs, gbs), -1).to(
            bf).permute(0, 3, 1, 2)
        wl = (torch.cat([torch.cat([ws[w] for _, w in o], 0) for o in outs],
                        1).T.contiguous().to(bf)[:, :, None, None])
        if kind == "p1x1":
            return (lambda: TF.pass_1x1_fwd(*args),
                    lambda: TF.pass_1x1_fwd_plain(*args),
                    lambda: F.conv2d(gv, wl))
        zp = TF.pass_1x1_fwd_plain(*args)[0]
        dz = [rnd(*z.shape).to(bf) for z in zp]
        dst = [1e-3 * rnd(2, z.shape[-1]) for z in zp]
        bargs = (*args, zp, dz, dst)
        el = torch.cat(dz, -1).permute(0, 3, 1, 2)
        return (lambda: TF.pass_1x1_bwd(*bargs),
                lambda: TF.pass_1x1_bwd_plain(*bargs),
                lambda: (torch.nn.grad.conv2d_weight(gv, wl.shape, el),
                         torch.nn.grad.conv2d_input(gv.shape, wl, el)))
    x = rnd(BATCH, H, H, ci).to(bf)
    wf = rnd(9 * ci, co) / (9 * ci) ** .5
    wq = wf.to(bf)
    k = wq.reshape(3, 3, ci, co).permute(3, 2, 0, 1)
    xn = x.permute(0, 3, 1, 2)
    conv = lambda: F.conv2d(xn, k, None, stride, 1)
    if kind == "down":
        ss = torch.stack([0.5 + torch.rand(co, generator=gen, device=dev),
                          0.2 * rnd(co)])
        return (lambda: D.fused_down(x, wq, ss),
                lambda: D.fused_down_plain(x, wq, ss), conv)
    if kind == "down_train":
        return (lambda: D.down_train_fwd(x, wq),
                lambda: D.down_train_fwd_plain(x, wq), conv)
    if kind == "wgrad":
        Ho = (H + 1) // 2
        dz = rnd(BATCH, Ho, Ho, co).to(bf)
        dzn = dz.permute(0, 3, 1, 2)
        return (lambda: D.down_train_wgrad(x, dz),
                lambda: D.down_train_wgrad_plain(x, dz),
                lambda: torch.nn.grad.conv2d_weight(xn, k.shape, dzn, 2, 1))
    gb = gbf(ci)
    return (lambda: TF.pass_3x3_fwd(x, gb, wf, stride),
            lambda: TF.pass_3x3_fwd_plain(x, gb, wf, stride), conv)


def _riou_inputs(kind, n, clustered, gen, dev):
    """chip_smoke.py's phase (b) inputs: the seeded candidates, and for
    row 5 each row's first 64 admissible neighbours."""
    from chip_smoke import IOU, synthetic_candidates
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    rb, cls, valid = synthetic_candidates(gen, n, clustered, dev)
    if kind == "neighbor":
        return rb, cls, valid
    idx, _ = N.first_m_neighbors(N.edge_matrix(rb, cls, valid, IOU), 64)
    return rb, idx


def _riou_plain(kind, inp):
    from chip_smoke import IOU
    from yolov5_obb_tpu_torch.ops.kernels import iou
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    if kind == "neighbor":
        return lambda: N.fused_neighbor_iou_plain(*inp, IOU, 64)
    return lambda: iou.sparse_rotated_iou_plain(*inp)


def _riou_calls(kind, inp):
    """``(call, bare)`` through the port's wrapper: ``call`` the wrapper,
    ``bare`` its launches alone (the records, then the kernel) on operands
    prepared once."""
    import torch

    from chip_smoke import IOU
    from yolov5_obb_tpu_torch.ops.kernels import iou
    from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N

    rb = inp[0]
    B, n, _ = rb.shape
    rec = iou.box_records(rb, *inp[1:] if kind == "neighbor" else ())
    if kind == "neighbor":
        cls, valid = inp[1], inp[2]
        idx = torch.empty(B, n, 64, dtype=torch.int32, device=rb.device)
        sup = torch.empty(B, n, 64, dtype=torch.bool, device=rb.device)
        pairs = torch.empty(B * n * 64 + 1, dtype=torch.int32, device=rb.device)

        def bare():
            iou.BOXES_KERNEL.launch(rb, cls, valid, B * n, rec)
            N.KERNEL.launch(rec, B, n, 64, float(IOU * N.EDGE_SLACK),
                            float(IOU), idx, sup, pairs)

        return lambda: N.fused_neighbor_iou(*inp, IOU, 64), bare
    out = torch.empty(inp[1].shape, device=rb.device)

    def bare():
        iou.BOXES_KERNEL.launch(rb, None, None, B * n, rec)
        iou.KERNEL.launch(rec, None, inp[1], out, B, n, inp[1].shape[2])

    return lambda: iou.sparse_rotated_iou(*inp), bare


def run_riou_case(case, kind, n, clustered, builds, gen, dev):
    """One rotated-IoU case over every build, in turns; returns its
    result dict."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    inp = _riou_inputs(kind, n, clustered, gen, dev)
    plain = _riou_plain(kind, inp)
    want = plain()
    calls = {}
    for name, build in builds.items():
        with bound_to(build):
            calls[name] = _riou_calls(kind, inp)
    res, first = {}, None
    order = list(builds)
    for name in order + order[::-1]:
        call, bare = calls[name]
        with bound_to(builds[name]):
            got = call()
            torch.cuda.synchronize()
            first = got if first is None else first
            r = res.setdefault(name, {
                **_riou_errors(got, want), "same_as_main": _same(got, first),
                "ms": [], "bare_ms": [], "host_ms": []})
            r["ms"].append(cuda_time(call))
            r["bare_ms"].append(cuda_time(bare))
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                call()
            r["host_ms"].append((time.perf_counter() - t) / 20 * 1e3)
            torch.cuda.synchronize()
    for name in order:
        call, _ = calls[name]
        with bound_to(builds[name]):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
        res[name]["kernels_ms"] = {
            e.key[:60]: e.self_device_time_total / 1e3 / 5
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}
    res["plain_ms"] = cuda_time(plain, 2, 1)
    return res


def _riou_errors(got, want):
    """Mismatch counts of the index and flag outputs, max |Δ| of the IoU."""
    import torch

    out = {}
    for k, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        if g.dtype == torch.float32:
            out["max_abs_err"] = float((g - w).abs().max())
            out["decision_mismatches"] = int(((g > 0.45) != (w > 0.45)).sum())
        else:
            out[("nbr_idx", "sup_in")[k] + "_mismatches"] = int((g != w).sum())
    return out


def _flat(t):
    import torch

    return [t] if isinstance(t, torch.Tensor) else [u for v in t
                                                     for u in _flat(v)]


def _same(got, main) -> bool:
    """Bit for bit the main build's outputs."""
    import torch

    return all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(main)))


def _errors(got, want):
    """bf16 outputs: max |Δ| against one ulp of the largest; float32 ones
    (statistics, weight gradients): max |Δ| over the largest."""
    import torch

    res = {"err": 0.0, "tol": 0.0, "rel": 0.0}
    for g, w in zip(_flat(got), _flat(want)):
        if w.dtype == torch.bfloat16:
            res["err"] = max(res["err"], float(
                (g.float() - w.float()).abs().max()))
            res["tol"] = max(res["tol"], float(w.float().abs().max()) / 128)
        else:
            res["rel"] = max(res["rel"], float(
                (g - w).abs().max() / w.abs().max()))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    variants = {}
    while args[:1] == ["--csrc"]:
        name, _, where = args[1].partition("=")
        csrc = Path(where).resolve()
        if not (csrc / "mma.cuh").is_file():
            print(f"--csrc {args[1]}: no csrc directory there",
                  file=sys.stderr)
            return 1
        variants[name] = csrc
        args = args[2:]
    if args:  # a file, or the JSON itself (e.g. ``{}``)
        variants.update(json.loads(args[0] if args[0].lstrip().startswith("{")
                                   else Path(args[0]).read_text()))
    only = tuple(args[1:])
    from yolov5_obb_tpu_torch.ops.kernels import _build

    _build.build()  # the main build, then every variant's compiles at once
    for src in ("riou_boxes", "neighbor", "pairs_iou"):
        if src in _build.PTXAS_LOG:
            print(f"main {src}: {_ptxas_summary(_build.PTXAS_LOG[src])}",
                  flush=True)
    started = {name: start_variant(name, subs)
               for name, subs in variants.items()}
    builds = {"main": None}
    for name, st in started.items():
        build = st and finish_variant(name, st)
        if build is not None:
            builds[name] = build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, kind, ci, co, H, stride in CASES:
        if only and not any(case == o or case.startswith(o + "_")
                            for o in only):
            continue
        call, plain, library = _case(kind, ci, co, H, stride, gen, dev)
        want = plain()
        res, first = {}, None
        order = list(builds)
        for name in order + order[::-1]:
            with bound_to(builds[name]):
                try:
                    got = call()
                    torch.cuda.synchronize()
                except (RuntimeError, AttributeError) as e:  # a variant
                    # that refuses the case or lacks an entry point
                    if name == "main":
                        raise
                    res[name] = {"error": str(e)}
                    continue
                first = got if first is None else first
                r = res.setdefault(name, {**_errors(got, want), "ms": [],
                                          "same_as_main": _same(got, first)})
                r["ms"].append(cuda_time(call))
        res["library_ms"] = cuda_time(library)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        res["main_kernels_ms"] = {
            e.key[:60]: e.self_device_time_total / 1e3 / 5
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}
        print(case, json.dumps(res), flush=True)
        del call, plain, library, want, got
        torch.cuda.empty_cache()
    for case, kind, n, clustered in RIOU_CASES:
        if only and not any(case == o or case.startswith(o + "_")
                            for o in only):
            continue
        print(case, json.dumps(run_riou_case(case, kind, n, clustered, builds,
                                             gen, dev)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
