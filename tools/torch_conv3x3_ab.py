#!/usr/bin/env python3
"""A/B variants of the port's tensor-core 3x3 conv on one NVIDIA card.

    python3 tools/torch_conv3x3_ab.py [variants.json]

``variants.json`` maps a name to a list of ``[regex, replacement]`` pairs
applied to ``yolov5_obb_tpu_torch/csrc/conv3x3_mma.cuh``.  Each variant's
``down.cu``, ``down_train.cu`` and ``train_fused_3x3.cu`` are compiled with
the port's flags into the (gitignored) build directory.  At the yolov5m b16
1024² shapes of the kernels on that body — the inference downsample (row
3, layer 3: 256² x 96 → 128² x 192), the raw train downsample (row 8a, L1:
512² x 48 → 96, L3), the stride-1 bottleneck pass (row 10, 256² x 48 → 48)
and the stride-2 passes (row 11, L1, L3) — every build's kernel is held to
its plain version and timed with CUDA events, in the order main, variants,
variants reversed, main; the library conv (cuDNN, bf16) beside it; then a
profiler split of the main build's passes into their kernels.  Prints the
card line and one JSON line per case.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# case → (entry point, ci, co, input side, stride)
CASES = (("row3_L3", "down", 96, 192, 256, 2),
         ("row8a_L1", "down_train", 48, 96, 512, 2),
         ("row8a_L3", "down_train", 96, 192, 256, 2),
         ("row10_bottleneck", "pass", 48, 48, 256, 1),
         ("row11_L1", "pass", 48, 96, 512, 2),
         ("row11_L3", "pass", 96, 192, 256, 2))
BATCH = 16


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
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    return {"down": D.KERNEL, "down_train": D.TRAIN_FWD_KERNEL,
            "pass1": TF.KERNEL_3X3S1, "pass2": TF.KERNEL_3X3S2}


def build_variant(name, subs):
    """The variant's entry points as Kernels (keyed as in ``_kernels``)."""
    from yolov5_obb_tpu_torch.ops.kernels import _build

    d = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, d)
    h = (d / "conv3x3_mma.cuh").read_text()
    for pat, rep in subs:
        new = re.sub(pat, rep, h, flags=re.S)
        if new == h:
            print(f"{name}: {pat!r} changes nothing; variant skipped",
                  flush=True)
            return None
        h = new
    (d / "conv3x3_mma.cuh").write_text(h)
    libs = {}
    for src in ("down", "down_train", "train_fused_3x3"):
        so = d / f"{src}.so"
        r = subprocess.run([_build._nvcc(), *_build._flags(src), "-I", str(d),
                            "-o", str(so), str(d / f"{src}.cu")],
                           capture_output=True, text=True, check=False)
        regs = re.findall(r"Used (\d+) registers", r.stdout + r.stderr)
        print(f"{name} {src}: nvcc {r.returncode}, registers {regs}",
              flush=True)
        if r.returncode:
            print(r.stdout + r.stderr, flush=True)
            return None
        libs[src] = ctypes.CDLL(str(so))
    kerns = {}
    for key, k in _kernels().items():
        fn = getattr(libs[k.source], k.symbol)
        fn.argtypes = k.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kerns[key] = _build.Kernel(k.source, k.symbol, k.argtypes, k.replaces)
        kerns[key]._fn = fn
    return kerns


def _case_fns(kind, stride, x, wq, wf, gb, ss, kerns):
    """The case's call on the main build (``kerns`` None) or a variant's
    kernels: a function returning the output tensor(s)."""
    import torch

    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    if kerns is None:
        return {"down": lambda: D.fused_down(x, wq, ss),
                "down_train": lambda: D.down_train_fwd(x, wq),
                "pass": lambda: TF.pass_3x3_fwd(x, gb, wf, stride)}[kind]
    B, H, W, ci = x.shape
    co = wq.shape[1]
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    z = torch.empty(B, Ho, Wo, co, dtype=torch.bfloat16, device=x.device)
    if kind == "down":
        return lambda: (kerns["down"].launch(x, wq, ss, z, B, H, W, ci, co),
                        z)[1]
    if kind == "down_train":
        return lambda: (kerns["down_train"].launch(x, wq, z, B, H, W, ci, co),
                        z)[1]
    st = torch.empty(2, co, device=x.device)
    part = torch.empty(TF.pass_3x3_partial_rows(B, H, W, stride), 2 * co,
                       device=x.device)
    k = kerns[f"pass{stride}"]
    return lambda: (k.launch(x, gb, wq, z, part, st, B, H, W, ci, co),
                    (z, st))[1]


def _errors(got, want):
    if isinstance(want, tuple):
        (z, s), (zp, sp) = got, want
        return {"err": float((z.float() - zp.float()).abs().max()),
                "tol": float(zp.float().abs().max()) / 128,
                "stats_rel": float((s - sp).abs().max() / sp.abs().max())}
    return {"err": float((got.float() - want.float()).abs().max()),
            "tol": float(want.float().abs().max()) / 128}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = (json.loads(Path(sys.argv[1]).read_text())
                if len(sys.argv) > 1 else {})
    builds = {"main": None}
    for name, subs in variants.items():
        builds[name] = build_variant(name, subs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, kind, ci, co, H, stride in CASES:
        x = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(
            torch.bfloat16)
        wf = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** .5
        wq = wf.to(torch.bfloat16)
        gb = torch.stack([1 + 0.3 * torch.randn(ci, generator=gen, device=dev),
                          0.2 * torch.randn(ci, generator=gen, device=dev)])
        ss = torch.stack([0.5 + torch.rand(co, generator=gen, device=dev),
                          0.2 * torch.randn(co, generator=gen, device=dev)])
        want = {"down": lambda: D.fused_down_plain(x, wq, ss),
                "down_train": lambda: D.down_train_fwd_plain(x, wq),
                "pass": lambda: TF.pass_3x3_fwd_plain(x, gb, wf, stride)}[
                    kind]()
        res = {}
        order = [n for n in builds if n == "main" or builds[n]]
        for name in order + order[::-1]:
            fn = _case_fns(kind, stride, x, wq, wf, gb, ss, builds[name])
            got = fn()
            torch.cuda.synchronize()
            r = res.setdefault(name, {**_errors(got, want), "ms": []})
            r["ms"].append(cuda_time(fn))
        k = wq.reshape(3, 3, ci, co).permute(3, 2, 0, 1)
        xn = x.permute(0, 3, 1, 2)
        res["library_ms"] = cuda_time(lambda: F.conv2d(xn, k, None, stride, 1))
        if kind == "pass":
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    TF.pass_3x3_fwd(x, gb, wf, stride)
                torch.cuda.synchronize()
            res["main_pass_kernels_ms"] = {
                e.key[:60]: e.self_device_time_total / 1e3 / 5
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0}
        print(case, json.dumps(res), flush=True)
        del x, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
