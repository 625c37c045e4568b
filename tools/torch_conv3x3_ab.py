#!/usr/bin/env python3
"""A/B variants of the port's tensor-core 3x3 conv on one NVIDIA card.

    python3 tools/torch_conv3x3_ab.py [variants.json]

``variants.json`` maps a name to a list of ``[regex, replacement]`` pairs
applied to ``yolov5_obb_tpu_torch/csrc/conv3x3_mma.cuh``.  Each variant's
``down_train.cu`` and ``train_fused_3x3.cu`` are compiled with the port's
flags into the (gitignored) build directory.  At the yolov5m b16 1024²
shapes of the two stride-2 train convs (L1: 512² x 48 → 96, L3: 256² x 96
→ 192) every build's raw conv (row 8a) and BN+SiLU pass (row 11) are held
to their plain versions and timed with CUDA events, in the order main,
variants, variants reversed, main; the library conv (cuDNN, bf16) beside
them; then a profiler split of the main build's pass into its kernels.
Prints the card line and one JSON line per layer.
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
SHAPES = (("L1", 48, 96, 512), ("L3", 96, 192, 256))
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


def build_variant(name, subs):
    """The variant's two entry points as Kernels, and its tile (rows,
    columns)."""
    from yolov5_obb_tpu_torch.ops.kernels import _build
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

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
    tile = tuple(int(re.search(rf"constexpr int {k} = (\d+);", h).group(1))
                 for k in ("kTileY", "kTileX"))
    kerns = {}
    for src, k in (("down_train", D.TRAIN_FWD_KERNEL),
                   ("train_fused_3x3", TF.KERNEL_3X3S2)):
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
        fn = getattr(ctypes.CDLL(str(so)), k.symbol)
        fn.argtypes = k.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        kerns[src] = _build.Kernel(k.source, k.symbol, k.argtypes, k.replaces)
        kerns[src]._fn = fn
    return kerns, tile


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
    for layer, ci, co, H in SHAPES:
        x = torch.randn(BATCH, H, H, ci, generator=gen, device=dev).to(
            torch.bfloat16)
        wf = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** .5
        wq = wf.to(torch.bfloat16)
        gb = torch.stack([1 + 0.3 * torch.randn(ci, generator=gen, device=dev),
                          0.2 * torch.randn(ci, generator=gen, device=dev)])
        zp = D.down_train_fwd_plain(x, wq)
        zpp, sp = TF.pass_3x3_fwd_plain(x, gb, wf, 2)
        Ho = (H + 1) // 2
        res = {}
        order = [n for n in builds if n == "main" or builds[n]]
        for name in order + order[::-1]:
            if name == "main":
                fd = lambda: D.down_train_fwd(x, wq)
                fp = lambda: TF.pass_3x3_fwd(x, gb, wf, 2)
            else:
                kerns, (ty, tx) = builds[name]
                z1 = torch.empty(BATCH, Ho, Ho, co, dtype=torch.bfloat16,
                                 device=dev)
                z2, s2 = torch.empty_like(z1), torch.empty(2, co, device=dev)
                part = torch.empty(BATCH * -(-Ho // ty) * -(-Ho // tx), 2 * co,
                                   device=dev)
                fd = lambda: (kerns["down_train"].launch(
                    x, wq, z1, BATCH, H, H, ci, co), z1)[1]
                fp = lambda: (kerns["train_fused_3x3"].launch(
                    x, gb, wq, z2, part, s2, BATCH, H, H, ci, co), (z2, s2))[1]
            zd, (zk, sk) = fd(), fp()
            torch.cuda.synchronize()
            r = res.setdefault(name, {
                "raw_err": float((zd.float() - zp.float()).abs().max()),
                "pass_err": float((zk.float() - zpp.float()).abs().max()),
                "pass_tol": float(zpp.float().abs().max()) / 128,
                "stats_rel": float((sk - sp).abs().max() / sp.abs().max()),
                "raw_ms": [], "pass_ms": []})
            r["raw_ms"].append(cuda_time(fd))
            r["pass_ms"].append(cuda_time(fp))
        k = wq.reshape(3, 3, ci, co).permute(3, 2, 0, 1)
        xn = x.permute(0, 3, 1, 2)
        res["library_ms"] = cuda_time(lambda: F.conv2d(xn, k, None, 2, 1))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                TF.pass_3x3_fwd(x, gb, wf, 2)
            torch.cuda.synchronize()
        res["main_pass_kernels_ms"] = {
            e.key[:60]: e.self_device_time_total / 1e3 / 5
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}
        print(layer, json.dumps(res), flush=True)
        del x, zp, zpp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
