#!/usr/bin/env python
"""The golden yolov5n's reference numbers on the set it was trained on.

    JAX_PLATFORMS=cpu python tools/golden_reference.py --out /tmp/golden_ref

Regenerates the set of ``releases/golden_yolov5n_192`` (PARITY.md's r4
row: ``tools/golden_e2e.generate_raw(10 images, 768², grid 4, seed 3)``,
split into 90 tiles of 384 at gap 128), then runs the JAX package's val
(192 px, conf 0.01, IoU 0.4, max_det 200, batch 4, float32, ``--save-json``),
``json_to_task1``, the polygon-NMS merge at 0.2, ``evaluate_task1`` and
``evaluate_maoe`` against the unsplit labels: the numbers that
``chip_smoke.py`` phase (k2) holds the port's card run to.  With
``--port`` the port's own ``tools/golden_e2e.val_merge_eval`` runs the same
flow on the CPU with ``releases/golden_yolov5n_192_torch``, in float32 and
in bfloat16.  Prints one JSON line.

Runs on the CPU and needs the JAX package (and, with ``--port``, the port).
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]


def jax_reference(out: Path) -> dict:
    import val as val_cli
    from golden_e2e import generate_raw, write_configs
    from yolov5_obb_tpu.data.dota import DOTA_V1_NAMES
    from yolov5_obb_tpu.devkit.converters import json_to_task1
    from yolov5_obb_tpu.devkit.evaluate import evaluate_maoe, evaluate_task1
    from yolov5_obb_tpu.devkit.img_split import split_dataset
    from yolov5_obb_tpu.devkit.result_merge import merge_by_poly_nms

    raw = generate_raw(out / "raw", n_images=10, size=768, grid=4, seed=3)
    tiles = split_dataset(raw, out / "split", rate=1.0, subsize=384, gap=128,
                          num_workers=1)
    data_yaml, _ = write_configs(out, out / "split")
    vres = val_cli.run(types.SimpleNamespace(
        weights=str(ROOT / "releases" / "golden_yolov5n_192"),
        cfg="yolov5n.yaml", data=str(data_yaml), task="val", imgsz=192,
        batch_size=4, conf_thres=0.01, iou_thres=0.4, max_det=200,
        max_images=None, save_json=True, save_task1=False, save_txt=False,
        save_conf=False, hyp=None, project=str(out / "val"), name="jax",
        exist_ok=True, no_plots=True))
    json_path = out / "val" / "jax" / "best_obb_predictions.json"
    merged = out / "merge" / "jax" / "merged"
    json_to_task1(json_path, out / "merge" / "jax" / "task1_raw",
                  DOTA_V1_NAMES)
    merge_by_poly_nms(out / "merge" / "jax" / "task1_raw", merged,
                      nms_thresh=0.2, num_workers=1)
    ids = sorted(p.stem for p in (raw / "labelTxt").glob("*.txt"))
    mean_ap, _ = evaluate_task1(merged, raw / "labelTxt", ids, DOTA_V1_NAMES,
                                ovthresh=0.5)
    maoe, maoe_cls = evaluate_maoe(merged, raw / "labelTxt", ids,
                                   DOTA_V1_NAMES, conf_thresh=0.1)
    return {"tiles": tiles, "json_rows": len(json.loads(json_path.read_text())),
            "golden_obb_map": float(mean_ap), "hbb_map50": float(vres["map50"]),
            "hbb_map": float(vres["map"]), "maoe_deg": float(maoe),
            "worst_class_maoe_deg": max(maoe_cls.values())}


def port_reference(out: Path, dtype: str) -> dict:
    from yolov5_obb_tpu_torch.tools.golden_e2e import val_merge_eval

    r = val_merge_eval(out, out / "data.yaml", out / "raw",
                       ROOT / "releases" / "golden_yolov5n_192_torch",
                       imgsz=192, batch=4, device="cpu", dtype=dtype,
                       name=f"port_{dtype}", val_argv=["--no-plots"])
    return {"golden_obb_map": r["golden_obb_map"],
            "hbb_map50": float(r["val"]["map50"]),
            "hbb_map": float(r["val"]["map"]), "maoe_deg": r["maoe_deg"],
            "worst_class_maoe_deg": max(r["maoe_classes"].values())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=str, default="runs/golden_reference")
    p.add_argument("--port", action="store_true",
                   help="also the port's flow on the CPU, float32 and bf16")
    a = p.parse_args(argv)
    out = Path(a.out)
    res = {"jax": jax_reference(out)}
    if a.port:
        for dtype in ("float32", "bfloat16"):
            res[f"port_{dtype}"] = port_reference(out, dtype)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
