"""Merge per-tile detections and score them with the exact OBB mAP (the
reference DOTA_devkit/ResultMerge_multi_process.py,
dota_evaluation_task1.py and tools/TestJson2VocClassTxt.py).

After ``python -m yolov5_obb_tpu_torch.val --save-json`` on a split set:

    python -m yolov5_obb_tpu_torch.tools.dota_merge_eval \\
        --json runs/val/exp/best_obb_predictions.json --data dotav1.yaml \\
        --anno /data/dota/val/labelTxt --out runs/val/exp/merged --maoe

The flags and printed lines of the JAX package's
``tools/dota_merge_eval.py``; host NumPy and C++ (``native/``), no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..devkit.converters import json_to_task1
from ..devkit.evaluate import evaluate_maoe, evaluate_task1
from ..devkit.result_merge import merge_by_poly_nms, results_obb2hbb
from ..utils.general import load_dataset_config


def parse_opt(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m yolov5_obb_tpu_torch.tools.dota_merge_eval")
    p.add_argument("--json", help="val --save-json output")
    p.add_argument("--task1", help="or: dir of raw per-class Task1 txts")
    p.add_argument("--data", required=True, help="dataset yaml (names)")
    p.add_argument("--out", required=True)
    p.add_argument("--nms-thresh", type=float, default=0.2)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--anno",
                   help="original (unsplit) labelTxt dir → run OBB mAP")
    p.add_argument("--imageset",
                   help="txt of image ids; default = all in --anno")
    p.add_argument("--ovthresh", type=float, default=0.5)
    p.add_argument("--maoe", action="store_true", help="also compute mAOE")
    p.add_argument("--obb2hbb", action="store_true",
                   help="emit Task2 HBB files too")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns ``{"map", "classaps", "maoe", "maoe_per_class"}`` for what
    was computed."""
    a = parse_opt(argv)
    names = load_dataset_config(a.data)["names"]
    out = Path(a.out)
    raw = (Path(a.task1) if a.task1
           else json_to_task1(a.json, out / "task1_raw", names))
    merged = out / "task1_merged"
    merge_by_poly_nms(raw, merged, nms_thresh=a.nms_thresh,
                      num_workers=a.workers)
    print(f"merged results → {merged}")
    if a.obb2hbb:
        results_obb2hbb(merged, out / "task2_merged")
        print(f"HBB results → {out / 'task2_merged'}")
    res = {}
    if a.anno:
        image_ids = a.imageset or sorted(
            f.stem for f in Path(a.anno).glob("*.txt"))
        res["map"], res["classaps"] = evaluate_task1(
            merged, a.anno, image_ids, names, ovthresh=a.ovthresh)
        print("classaps:")
        for k, v in res["classaps"].items():
            print(f"  {k:>22}: {100 * v:.2f}")
        print(f"map: {res['map']:.4f}")
        if a.maoe:
            res["maoe"], res["maoe_per_class"] = evaluate_maoe(
                merged, a.anno, image_ids, names)
            print(f"mAOE: {res['maoe']:.2f}° ({res['maoe_per_class']})")
    return res


if __name__ == "__main__":
    main()
