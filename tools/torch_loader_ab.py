#!/usr/bin/env python3
"""A/B of the train CLI's loader workers' start method on one NVIDIA card.

    python3 tools/torch_loader_ab.py [OUT.json]

Runs the port's train CLI as ``chip_smoke.py``'s phase (g) does (yolov5m,
1024², b16, bf16, nc 15, 48 seeded images replayed from ``--cache shards``
by 2 loader workers, 3 steps an epoch, ``--noval --noautoanchor``) for 2
epochs a run: once with ``--workers 0`` (the kernels' build and the
card's warm-up), then in the order fork, spawn, spawn, fork, the
``WorkerPool``'s ``DataLoader`` set to start its workers by that method.
Each run gives, from ``chip_smoke.cli_run``'s callbacks on the host's
clock, its img/s over the whole call, and per epoch the first batch's
wait, the img/s with the saves and over the loop alone, and the loader
wait's share of the loop.  Prints the card line and one JSON line (also
written to OUT.json when given).
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ORDER = ("fork", "spawn", "spawn", "fork")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device: this A/B runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    from yolov5_obb_tpu_torch.data import loader
    from yolov5_obb_tpu_torch.data.shards import write_shards
    from yolov5_obb_tpu_torch.ops.kernels import _build
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = C.card_line()
    print(card, flush=True)
    _build.build()
    init, method = loader.WorkerPool.__init__, {}

    def start_by(self, dataset, num_workers):
        init(self, dataset, num_workers)
        self._loader.multiprocessing_context = method["ctx"]

    loader.WorkerPool.__init__ = start_by
    tmp = Path(tempfile.mkdtemp(prefix="loader_ab_"))
    try:
        data, images = C.write_seeded_dota(tmp / "dota", C.CLI_IMAGES,
                                           C.IMGSZ, 11,
                                           [f"c{i}" for i in range(15)])
        shards = write_shards(
            C.seeded_train_set(data, images, C.MAX_LABELS, load_hyp()),
            tmp / "shards", aug_epochs=C.CLI_AUG_EPOCHS, seed=0,
            verbose=False)
        del images
        base = ["--cfg", "yolov5m.yaml", "--data", str(data), "--imgsz",
                str(C.IMGSZ), "--batch-size", str(C.BATCH), "--nominal-batch",
                str(C.BATCH), "--max-labels", str(C.MAX_LABELS), "--cache",
                "shards", "--noval", "--noautoanchor", "--device", "cuda",
                "--exist-ok", "--project", str(tmp / "runs"), "--epochs",
                str(C.CLI_EPOCHS)]
        runs = []
        for i, ctx in enumerate(("warm-up",) + ORDER):
            name = f"run{i}"
            (tmp / "runs" / name / "cache").mkdir(parents=True)
            (tmp / "runs" / name / "cache" / "shards").symlink_to(shards)
            method["ctx"] = None if ctx == "warm-up" else ctx
            workers = "0" if ctx == "warm-up" else "2"
            _, r = C.cli_run(base + ["--name", name, "--workers", workers],
                             C.TRAIN_LAUNCHES, C.BATCH)
            runs.append({"start": ctx, "run_s": r["run_s"],
                         "imgs_per_s": r["imgs_per_s"], "epochs": [{
                             k: e[k] for k in (
                                 "first_batch_wait_s", "imgs_per_s",
                                 "loop_imgs_per_s", "loader_wait_share",
                                 "step_host_s", "total_s")}
                             for e in r["epochs"]]})
            C.log(f"{ctx}: {json.dumps(runs[-1])}")
    finally:
        loader.WorkerPool.__init__ = init
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": card, "runs": runs}
    if argv:
        Path(argv[0]).parent.mkdir(parents=True, exist_ok=True)
        Path(argv[0]).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
