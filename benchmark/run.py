"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks
for.  It builds the cell from ``BENCHMARK.json`` and the files it names
(``benchmark/spec.py``), sets up (weights and inputs from the seed, the
program built and warmed on every shape the cell uses), measures for
``--seconds``, with ``--trace 1`` reads the per-layer metrics, frees the
program, compares what the timed path produced with the plain reference,
and prints one JSON line last on standard output.  The numbers compared,
each beside its limit, are the last lines on standard error and the last
key of that line.  It exits non-zero, printing no result, without the
cards the cell asks for, or if JAX or the port's JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yolov5_obb_tpu")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``yolov5_obb_tpu_torch`` is not ``yolov5_obb_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number present, finite and at
    most its limit."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok &= good
        checks[name] = {"value": v, "limit": lim["limit"]}
    return ok, checks


def run(args, root: Path | None = None, allow_cpu: bool = False,
        out=sys.stdout) -> int:
    """One run; returns the exit code.  ``allow_cpu``: the harness's own
    tests, which run the rest of a run without a card."""
    from .spec import Spec

    spec = Spec(root)
    for var, sub in CACHES.items():
        os.environ[var] = str(spec.root / ".bench_cache" / sub)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(
        cell["traffic"])
    limits = spec.limits(cell["name"])

    import torch

    from .device import Device

    if torch.cuda.is_available() and torch.cuda.device_count() >= \
            cell["chips"]:
        dev = Device(torch.device("cuda", 0))
    elif allow_cpu:
        dev = Device(torch.device("cpu"))
    else:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    driver = spec.driver(traffic["driver"])
    ctx = types.SimpleNamespace(seed=args.seed, config=config,
                                traffic=traffic, cell=cell, device=dev)
    st = driver.setup(ctx)
    dev.sync()
    # the reference's seconds inside set-up (a driver's ``reference_s``)
    # are not the program's set-up
    reference_s = getattr(st, "reference_s", 0.0)
    setup_s = time.perf_counter() - T0 - reference_s
    log(f"{cell['name']}: set-up {setup_s:.2f} s, and {reference_s:.2f} s "
        "of the reference's work on the weights left out of it")
    res = driver.window(st, args.seconds)
    peak = dev.peak_bytes()
    res["metrics"]["setup_s"] = setup_s
    device = {**dev.describe(cell["chips"]), "memory_peak_bytes": peak}
    metrics = {}
    if args.trace:
        obs = driver.observe(st)
        tr = obs["trace"]
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        for m in spec.per_layer(cell["name"]):
            v = spec.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = tr.breakdown()
    else:
        for m in spec.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": res["metrics"][m["name"]],
                                  "unit": m["unit"]}
    log(f"{cell['name']}: " + json.dumps(res["metrics"]))
    driver.release(st)
    numbers = driver.check(st)
    correct, checks = judge(numbers, limits)
    info = {k: v for k, v in numbers.items() if k not in checks}
    log(f"{cell['name']}: also read {json.dumps(info)}")
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules that the port must not load: {bad}")
        return 3
    line = {"correct": bool(correct and res["failed"] == 0),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if args.trace:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == "__main__":
    sys.exit(main())
