"""Golden end-to-end accuracy harness: synthetic DOTA → split → train →
val → merge → exact devkit OBB mAP, through the port's own entry points.

    python -m yolov5_obb_tpu_torch.tools.golden_e2e --quick        # the card
    python -m yolov5_obb_tpu_torch.tools.golden_e2e --quick --device cpu

Counterpart of the JAX package's ``tools/golden_e2e.py``: the same seeded
synthetic set (15 classes, each a hue and an aspect ratio, drawn with
OpenCV), written as PNG files and split into tiles
(``devkit/img_split.split_dataset``); the train CLI (``train.run`` on real
argv) decodes the tiles and trains with the real augmentation pipeline
(mosaic 0.5, flips, affine, HSV) and autoanchor; the val CLI saves the
detections as DOTA JSON; ``json_to_task1``, the polygon-NMS merge at 0.2,
``evaluate_task1`` and ``evaluate_maoe`` score them against the unsplit
labels.  A converged run shows that the whole stack learns: assignment,
CSL theta, decode, rotated NMS, the tile merge and the evaluator.

Runs on the card unless ``--device cpu``.  Prints one JSON line, the JAX
script's keys (``golden_obb_map``, ``hbb_map50``, ``maoe_deg`` ...) and the
seconds of each stage.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..data.dota import DOTA_V1_NAMES
from ..utils.device import resolve_device

HYP_BASE = (Path(__file__).resolve().parents[1] / "data" / "configs"
            / "hyp_finetune_dota.yaml")

# class identity = hue (well separated) + aspect ratio; both survive the
# training augmentations (hsv_h 0.015 ≈ ±5° of hue, the affine keeps the
# aspect).  Aspects stop at ~2.6: thinner boxes would make IoU 0.5 a test
# of sub-degree theta rather than of the flow.
_ASPECTS = [1.3 + 0.095 * i for i in range(15)]  # 1.3 .. 2.63


def _class_colors():
    """15 well-separated BGR colours (a walk round the HSV hue wheel)."""
    import cv2

    hsv = np.zeros((15, 1, 3), np.uint8)
    hsv[:, 0, 0] = (np.arange(15) * 180 // 15).astype(np.uint8)
    hsv[:, 0, 1] = 220
    hsv[:, 0, 2] = 230
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[:, 0, :]


def generate_raw(root: Path, n_images: int = 8, size: int = 768,
                 grid: int = 4, seed: int = 3, hard: bool = False):
    """Synthetic DOTA-format raw set: ``images/`` (PNG) and ``labelTxt/``
    with all 15 classes, rotated boxes on a jittered grid, none
    overlapping.

    ``hard`` adds what real DOTA has and the easy tier lacks: background
    ellipses near the class hues, background-coloured stripes over the
    objects, overlapping same-class pairs, smaller objects and stronger
    noise."""
    import cv2

    from ..ops.geometry import rbox2poly

    root.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    (root / "labelTxt").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = _class_colors()
    cell = size // grid
    cls_cursor = 0  # round-robin so that every class appears many times
    for k in range(n_images):
        img = np.full((size, size, 3), 70, np.uint8)
        img += rng.integers(0, 25, img.shape, dtype=np.uint8)  # texture
        lines = ["imagesource:synthetic", "gsd:1.0"]

        def draw_box(cid, cx, cy, l, s, t, dim=1.0):
            poly = rbox2poly(np.array([[cx, cy, l, s, t]]))[0]
            pts = poly.reshape(4, 2).astype(np.int32)
            col = tuple(int(v * dim) for v in colors[cid])
            cv2.fillPoly(img, [pts], color=col)
            # a darker inner core: more texture and edges
            inner = rbox2poly(np.array([[cx, cy, l * 0.55, s * 0.55, t]]))[0]
            cv2.fillPoly(img, [inner.reshape(4, 2).astype(np.int32)],
                         color=tuple(int(v * 0.55) for v in col))
            lines.append(" ".join(f"{v:.1f}" for v in poly)
                         + f" {DOTA_V1_NAMES[cid]} 0")

        if hard:
            # elliptical distractors near a class hue, under the objects
            for _ in range(grid * grid):
                dc = colors[int(rng.integers(0, 15))].astype(np.int32)
                dc = tuple(int(np.clip(v + rng.integers(-40, 40), 0, 255))
                           for v in dc)
                c = (int(rng.uniform(0, size)), int(rng.uniform(0, size)))
                ax = (int(rng.uniform(6, cell * 0.5)),
                      int(rng.uniform(4, cell * 0.3)))
                cv2.ellipse(img, c, ax, float(rng.uniform(0, 180)),
                            0, 360, dc, -1)

        for gy in range(grid):
            for gx in range(grid):
                if rng.uniform() < 0.15:
                    continue  # some cells stay empty (background)
                cid = cls_cursor % 15
                cls_cursor += 1
                asp = _ASPECTS[cid]
                # sized to stay inside its cell at any rotation
                l = rng.uniform(0.55, 0.8) * cell
                s = float(np.clip(l / asp, 10.0, None))
                cx = gx * cell + cell / 2 + rng.uniform(-0.08, 0.08) * cell
                cy = gy * cell + cell / 2 + rng.uniform(-0.08, 0.08) * cell
                t = rng.uniform(-np.pi / 2, np.pi / 2)
                if hard:
                    # smaller objects, varied brightness
                    l *= rng.uniform(0.55, 0.8)
                    s = float(np.clip(l / asp, 7.0, None))
                    draw_box(cid, cx, cy, l, s, t,
                             dim=float(rng.uniform(0.6, 1.0)))
                    # a second instance of the class, offset by ~0.7 short
                    # sides (IoU ≈ 0.2-0.4 with the first): NMS and the
                    # merge see overlaps that still match
                    if rng.uniform() < 0.3:
                        off = (0.7 + 0.3 * rng.uniform()) * s
                        draw_box(cid, cx + off * np.sin(t) * -1,
                                 cy + off * np.cos(t),
                                 l * rng.uniform(0.85, 1.0), s, t,
                                 dim=float(rng.uniform(0.6, 1.0)))
                else:
                    draw_box(cid, cx, cy, l, s, t)
        if hard:
            # background-coloured stripes over the objects
            for _ in range(grid):
                x0 = int(rng.uniform(0, size))
                w = int(rng.uniform(2, max(3, cell // 8)))
                if rng.uniform() < 0.5:
                    img[:, x0:x0 + w] = 74
                else:
                    img[x0:x0 + w, :] = 74
            # heavier sensor noise
            noise = rng.integers(-18, 18, img.shape, dtype=np.int16)
            img = np.clip(img.astype(np.int16) + noise, 0,
                          255).astype(np.uint8)
        cv2.imwrite(str(root / "images" / f"G{k:03d}.png"), img)
        (root / "labelTxt" / f"G{k:03d}.txt").write_text("\n".join(lines))
    return root


def write_configs(root: Path, split_dir: Path,
                  hyp_overrides: dict | None = None):
    """``data.yaml`` over the split tiles and ``hyp.yaml``: the bundled
    ``hyp_finetune_dota.yaml`` with the real augmentation pipeline tamed
    for a small set (mosaic, flips and a mild affine stay on)."""
    import yaml

    data_yaml = root / "data.yaml"
    data_yaml.write_text(
        f"path: {split_dir}\ntrain: images\nval: images\nnc: 15\n"
        + "names: [" + ", ".join(DOTA_V1_NAMES) + "]\n")
    hyp = yaml.safe_load(HYP_BASE.read_text())
    hyp.update(dict(lr0=0.02, warmup_epochs=3, mosaic=0.5, mixup=0.0,
                    fliplr=0.5, flipud=0.0, degrees=5.0, scale=0.15,
                    translate=0.05, shear=0.0, perspective=0.0))
    hyp.update(hyp_overrides or {})
    hyp_yaml = root / "hyp.yaml"
    hyp_yaml.write_text(yaml.dump(hyp))
    return data_yaml, hyp_yaml


def raw_weights(run_dir: Path) -> Path:
    """``last/``'s raw parameters and BatchNorm buffers (not the EMA) as a
    weights checkpoint ``raw/``, its metadata (names, evolved anchors)
    with it: after a short run the EMA is still mostly the initial
    weights (its decay ramps over ~2000 updates)."""
    from ..utils.checkpoint import load_weights, save_weights

    sd, meta = load_weights(run_dir / "last")
    return save_weights(run_dir / "raw", sd, meta)


def val_merge_eval(out: Path, data_yaml: Path, raw: Path, weights, *,
                   imgsz: int, batch: int, device: str | None = None,
                   dtype: str = "float32", name: str = "run",
                   val_argv=()) -> dict:
    """The val CLI with ``--save-json`` on the tiles of ``data_yaml`` →
    ``json_to_task1`` → the polygon-NMS merge at 0.2 → ``evaluate_task1``
    and ``evaluate_maoe`` against the unsplit labels of ``raw``.  Returns
    the scores, the val CLI's result (``val``) and the stages' seconds."""
    from .. import val as val_cli
    from ..devkit.converters import json_to_task1
    from ..devkit.evaluate import evaluate_maoe, evaluate_task1
    from ..devkit.result_merge import merge_by_poly_nms

    secs = {}
    t = time.perf_counter()
    argv = ["--weights", str(weights), "--cfg", "yolov5n.yaml",
            "--data", str(data_yaml), "--imgsz", str(imgsz),
            "--batch-size", str(batch), "--conf-thres", "0.01",
            "--iou-thres", "0.4", "--max-det", "200", "--save-json",
            "--dtype", dtype, "--project", str(out / "val"), "--name", name,
            "--exist-ok", *(["--device", device] if device else []),
            *val_argv]
    vres = val_cli.run(val_cli.parse_opt(argv))
    secs["val"] = time.perf_counter() - t
    json_path = out / "val" / name / "best_obb_predictions.json"

    # tile-name offsets → the raw image's coordinates → polygon NMS across
    # tiles → exact polygon-IoU VOC mAP against the unsplit labels
    t = time.perf_counter()
    task1 = out / "merge" / name / "task1_raw"
    json_to_task1(json_path, task1, DOTA_V1_NAMES)
    merged = out / "merge" / name / "merged"
    merge_by_poly_nms(task1, merged, nms_thresh=0.2, num_workers=1)
    secs["merge"] = time.perf_counter() - t
    t = time.perf_counter()
    image_ids = sorted(p.stem for p in (raw / "labelTxt").glob("*.txt"))
    mean_ap, classaps = evaluate_task1(merged, raw / "labelTxt", image_ids,
                                       DOTA_V1_NAMES, ovthresh=0.5)
    # the angle: mean angle-orientation error of the matched detections
    maoe, maoe_cls = evaluate_maoe(merged, raw / "labelTxt", image_ids,
                                   DOTA_V1_NAMES, conf_thresh=0.1)
    secs["eval"] = time.perf_counter() - t
    return {
        "golden_obb_map": round(float(mean_ap), 4),
        "hbb_map50": round(float(vres["map50"]), 4),
        "maoe_deg": round(float(maoe), 2),
        "maoe_classes": {k: round(float(v), 2) for k, v in maoe_cls.items()},
        "classaps": {k: round(float(v), 3) for k, v in classaps.items()},
        "merged": merged, "val": vres, "seconds": secs,
    }


def run_flow(out: Path, *, n_images=8, raw_size=768, subsize=384, gap=128,
             imgsz=192, epochs=150, batch=8, seed=3, use_ema=None,
             hyp_overrides=None, max_labels=32, grid=4, hard=False,
             device: str | None = None, callbacks=None):
    """The whole golden flow → the merged OBB mAP and the stages' facts:
    the JAX script's keys, plus ``seconds`` (split, train, val, merge,
    eval) and ``val_ms_per_tile``.  ``callbacks`` go to the train CLI."""
    from .. import train as train_cli
    from ..devkit.img_split import split_dataset

    out.mkdir(parents=True, exist_ok=True)
    secs = {}
    raw = generate_raw(out / "raw", n_images=n_images, size=raw_size,
                       seed=seed, grid=grid, hard=hard)
    t = time.perf_counter()
    n_tiles = split_dataset(raw, out / "split", rate=1.0, subsize=subsize,
                            gap=gap, num_workers=1)
    secs["split"] = time.perf_counter() - t
    print(f"[golden] split: {n_tiles} tiles from {n_images} raw images")
    data_yaml, hyp_yaml = write_configs(out, out / "split", hyp_overrides)

    t = time.perf_counter()
    targv = ["--cfg", "yolov5n.yaml", "--data", str(data_yaml),
             "--hyp", str(hyp_yaml), "--epochs", str(epochs),
             "--batch-size", str(batch), "--nominal-batch", str(batch),
             "--imgsz", str(imgsz), "--max-labels", str(max_labels),
             "--workers", "0", "--dtype", "float32", "--seed", str(seed),
             "--noval", "--val-images", "4", "--patience", str(10**9),
             "--log-interval", str(10**9), "--label-smoothing", "0.0",
             "--project", str(out / "train"), "--name", "run", "--exist-ok",
             *(["--device", device] if device else [])]
    save_dir, _, _ = train_cli.run(train_cli.parse_opt(targv),
                                   callbacks=callbacks)
    secs["train"] = time.perf_counter() - t

    # short runs: the EMA is still ~the initial weights; take the raw
    # parameters unless the run was long enough for the EMA to catch up
    steps = epochs * max(1, n_tiles // batch)
    weights = save_dir / "last"
    if use_ema is None:
        use_ema = steps > 6000
    if not use_ema:
        weights = raw_weights(save_dir)

    res = val_merge_eval(out, data_yaml, raw, weights, imgsz=imgsz,
                         batch=max(2, batch // 2), device=device)
    secs.update(res["seconds"])
    return {
        "golden_obb_map": res["golden_obb_map"],
        "hbb_map50": res["hbb_map50"],
        "maoe_deg": res["maoe_deg"],
        "maoe_classes": res["maoe_classes"],
        "tiles": n_tiles, "epochs": epochs, "imgsz": imgsz,
        "classaps": res["classaps"],
        "seconds": {k: round(v, 3) for k, v in secs.items()},
        "val_ms_per_tile": round(float(res["val"]["speed_ms_per_img"]), 3),
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m yolov5_obb_tpu_torch.tools.golden_e2e")
    p.add_argument("--out", type=str, default="runs/golden_e2e")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--imgsz", type=int, default=192)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n-images", type=int, default=8)
    p.add_argument("--quick", action="store_true",
                   help="reduced scale (fewer raw images and epochs)")
    p.add_argument("--hard", action="store_true",
                   help="hard tier: distractors, occlusion, overlapping "
                        "pairs, a denser grid")
    p.add_argument("--grid", type=int, default=None)
    p.add_argument("--assert-map", type=float, default=None,
                   help="exit 1 if the merged OBB mAP is below this")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    resolve_device(a.device)  # no card and no --device cpu: stop here
    if a.quick:
        kw = dict(n_images=4, raw_size=640, subsize=384, gap=128,
                  epochs=min(a.epochs, 60))
    else:
        kw = dict(n_images=a.n_images, epochs=a.epochs)
    if a.hard:
        kw.update(hard=True, grid=a.grid or 5)
    elif a.grid:
        kw.update(grid=a.grid)
    res = run_flow(Path(a.out), imgsz=a.imgsz, batch=a.batch,
                   device=a.device, **kw)
    print(json.dumps(res))
    if a.assert_map is not None and res["golden_obb_map"] < a.assert_map:
        print(f"FAIL: map {res['golden_obb_map']} < {a.assert_map}")
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
