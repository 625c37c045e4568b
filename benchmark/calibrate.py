"""The readings a cell's correctness limits are set from (on the card, at
the cell's own size, all seeds in one process):

    python3 -m benchmark.calibrate --workload NAME --seeds 1 2 ... \\
        --control-seeds 101 102 103 [--fault half_batch ...] [--seconds 2]

- the program: each seed's numbers after a short window at the cell's
  load (the lower readings);
- the control: the reference put in the program's place and computed one
  precision below the configuration's (``reference/lowp.py``), on the
  control seeds (the upper readings);
- ``--fault``: the program with a fault planted underneath the timed path
  (``faults.py``), on the control seeds.

Each reading is a JSON line on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

from . import faults
from .reference.lowp import Rounding
from .run import forbidden_modules
from .spec import Spec


def readings(cell: str, seed: int, seconds: float, control=None,
             fault=None, overrides=None, traffic_overrides=None) -> dict:
    import torch

    from .device import Device

    spec = Spec()
    cellspec = spec.cell(cell)
    traffic = {**spec.traffic(cellspec["traffic"]),
               **(traffic_overrides or {})}
    config = {**spec.config(cellspec["config"]), **(overrides or {})}
    ctx = types.SimpleNamespace(
        seed=seed, config=config, traffic=traffic,
        cell=cellspec, device=Device(torch.device("cuda", 0)))
    driver = spec.driver(traffic["driver"])
    t = time.perf_counter()
    with faults.planted(fault):
        st = driver.setup(ctx)
        res = driver.window(st, seconds)
    driver.release(st)
    numbers = driver.check(st, control=control)
    return {"cell": cell, "seed": seed,
            "side": "control" if control else (fault or "program"),
            "overrides": {**(overrides or {}), **(traffic_overrides or {})},
            "seconds": time.perf_counter() - t,
            "e2e": res["metrics"], "numbers": numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=sorted(faults.FAULTS), action="append",
                   default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--set", action="append", default=[],
                   help="a witness run: KEY=JSON overrides the configuration "
                        "(e.g. dtype='\"float32\"' packed_stem=false); a "
                        "float32 program runs with TF32 off")
    p.add_argument("--set-traffic", action="append", default=[],
                   help="a witness run: KEY=JSON overrides the traffic")
    args = p.parse_args(argv)
    overrides = {k: json.loads(v) for k, v in
                 (a.split("=", 1) for a in args.set)}
    traffic_overrides = {k: json.loads(v) for k, v in
                         (a.split("=", 1) for a in args.set_traffic)}
    if overrides.get("dtype") == "float32":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runs = [(s, None, None) for s in args.seeds]
    runs += [(s, Rounding(), None) for s in args.control_seeds]
    runs += [(s, None, f) for f in args.fault for s in args.control_seeds]
    for seed, control, fault in runs:
        r = readings(args.workload, seed, args.seconds, control, fault,
                     overrides, traffic_overrides)
        print(json.dumps(r), flush=True)
    if forbidden_modules():
        print(f"forbidden modules loaded: {forbidden_modules()}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
