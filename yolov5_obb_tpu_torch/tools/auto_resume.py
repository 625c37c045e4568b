"""Find interrupted trainings under a runs directory and resume them.

    python -m yolov5_obb_tpu_torch.tools.auto_resume [--root runs/train] \\
        [--epochs 300] [--data data.yaml] [--dry-run]

Counterpart of the JAX package's ``tools/auto_resume.py`` (reference
utils/aws/resume.py:17-40): a run is resumable when its ``last``
checkpoint's ``meta.json`` (``utils/checkpoint.py``) records an epoch
below ``--epochs``; it is relaunched as ``python -m
yolov5_obb_tpu_torch.train --resume <run>/last`` with the run's config,
image size, project and name (``--data`` is needed to relaunch).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def find_resumable(root) -> list:
    """``(last checkpoint directory, its meta.json)`` of every run under
    ``root``."""
    return [(meta_f.parent, json.loads(meta_f.read_text()))
            for meta_f in sorted(Path(root).glob("**/last/meta.json"))]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m yolov5_obb_tpu_torch.tools.auto_resume")
    p.add_argument("--root", default="runs/train")
    p.add_argument("--epochs", type=int, default=300,
                   help="target total epochs")
    p.add_argument("--data", required=False,
                   help="dataset yaml (required to relaunch)")
    p.add_argument("--dry-run", action="store_true")
    a = p.parse_args(argv)

    for last, meta in find_resumable(a.root):
        epoch = int(meta.get("epoch", -1))
        if epoch + 1 >= a.epochs:
            print(f"{last}: finished ({epoch + 1}/{a.epochs})")
            continue
        cmd = [
            sys.executable, "-m", "yolov5_obb_tpu_torch.train",
            "--resume", str(last),
            "--cfg", meta.get("cfg", "yolov5m.yaml"),
            "--imgsz", str(meta.get("imgsz", 1024)),
            "--epochs", str(a.epochs),
            "--project", str(last.parent.parent),
            "--name", last.parent.name,
            "--exist-ok",
        ]
        if a.data:
            cmd += ["--data", a.data]
        print("resume:", " ".join(cmd))
        if not a.dry_run:
            if not a.data:
                print("  skipped (--data required to relaunch)")
                continue
            subprocess.run(cmd, check=False)


if __name__ == "__main__":
    main()
