#!/usr/bin/env python3
"""Phase (f)'s predict timing of ``chip_smoke.py`` in one checkout, for
turns between two trees on one NVIDIA card.

    python3 tools/predict_turns.py TREE LABEL

TREE is the root of a checkout (this one, or a parent commit unpacked with
``git archive``); its own ``chip_smoke.py`` and ``yolov5_obb_tpu_torch``
are imported, its kernels built.  yolov5m b16 1024² with phase (c)'s
density-tuned weights (objectness shift 3.1640625, what phase (c) tunes
to at seed 0) predicts phase (f)'s 48 seeded images (multi-label, conf
0.01, IoU 0.4, 4096 candidates) as ``val_path`` times them: 6 calls over
three batches, host clock, 5 turns.  Then the rotated-NMS neighbour call
on the first batch's candidates (the predict's tier): CUDA events over 20
calls, the profiler's device time of each kernel, the host's enqueue time
and the allocation of its pair list.  Run it for each tree in alternating
processes; prints one JSON line.
"""
import json
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as C  # noqa: E402
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn  # noqa: E402
from yolov5_obb_tpu_torch.ops.kernels import _build  # noqa: E402
from yolov5_obb_tpu_torch.ops.kernels import neighbor_kernel as N  # noqa: E402

OBJ_DELTA = 3.1640625


def main() -> int:
    _build.build()
    dev = torch.device("cuda")
    model, meta, set_obj = C.density_model(dev)
    set_obj(OBJ_DELTA)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (C.VAL_IMAGES, C.IMGSZ, C.IMGSZ, 3),
                          dtype=np.uint8)
    xs = [torch.from_numpy(images[i:i + C.BATCH]).to(dev).reshape(
        C.BATCH, C.IMGSZ, -1) for i in range(0, C.VAL_IMAGES, C.BATCH)]
    predict = make_predict_fn(model, meta, C.VAL_CONF, C.VAL_IOU, C.MAX_DET,
                              max_candidates=C.VAL_MAXC)
    predict(xs[0])
    torch.cuda.synchronize()
    turns = []
    for _ in range(5):
        t = time.perf_counter()
        acc = torch.zeros((), device=dev)
        for i in range(6):
            d_, n_ = predict(xs[i % 3])
            acc = acc + d_.sum() + n_.sum()
        float(acc)
        turns.append((time.perf_counter() - t) / 6 * 1e3 / C.BATCH)

    rb, sc, cid, _, tier = C.val_candidates(model, meta, xs[0])
    valid = (sc > 0).contiguous()
    call = lambda: N.fused_neighbor_iou(rb, cid, valid, C.VAL_IOU, 64)
    call_ms = C.cuda_time(call, 20)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    device_ms = {e.key[:50]: e.self_device_time_total / 1e3 / 10
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(50):
        call()
    host_ms = (time.perf_counter() - t) / 50 * 1e3
    torch.cuda.synchronize()
    B, n = rb.shape[:2]
    alloc_ms = C.cuda_time(lambda: torch.empty(
        B * n * 64 + 1, dtype=torch.int32, device=dev), 50)
    print(json.dumps({"label": sys.argv[2], "predict_ms_per_img": turns,
                      "tier": tier, "live_rows": int(valid.sum(1).max()),
                      "row4_call_ms": call_ms, "row4_host_enqueue_ms": host_ms,
                      "row4_device_ms": device_ms,
                      "pair_list_alloc_ms": alloc_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
