"""A tiny copy of the benchmark for the harness's CPU tests: the repo's
``BENCHMARK.json`` and ``benchmark/`` with two more cells at test sizes
(``tiny.infer``: yolov5m's graph at width 0.25, depth 0.33, 256² tiles,
b2; ``tiny.train``: the same at 64², b2, 16 label slots), their own
configuration, traffic and limits files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

TINY_LIMITS = {
    "tiny.infer": {"maps_rel_err": 0.2, "det_unmatched": 0.02,
                   "missing_batches": 0},
    # set from CPU readings at these sizes, two micro-batches an update
    # (six seeds: the program's loss_gap <= 0.0009, update_median_gap <=
    # 0.0087; the fp8 control's update_median_gap >= 0.059; half the
    # batch: loss_gap >= 0.55; a state left unchanged: update_median_gap 1)
    "tiny.train": {"loss_gap": 0.01, "update_median_gap": 0.03},
}


def _tiny_config(size: int) -> dict:
    cfg = json.loads((BENCH / "configs" / "yolov5m-obb-1024.json").read_text())
    cfg["model"].update(depth_multiple=0.33, width_multiple=0.25)
    cfg.update(name=f"tiny-{size}", imgsz=size)
    return cfg


def write_cell(root: Path, name: str, config: dict, traffic: dict,
               limits: dict) -> None:
    """Add a cell to the copy under ``root`` as files and a
    ``BENCHMARK.json`` entry: nothing else changes."""
    b = root / "benchmark"
    (b / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (b / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (b / "limits" / f"{name}.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in limits.items()}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if not any(c["name"] == config["name"] for c in bench["configs"]):
        bench["configs"].append({
            "name": config["name"], "source": "test size",
            "file": f"benchmark/configs/{config['name']}.json",
            "reduced": [], "why": "test size"})
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": name, "chips": 1, "why": "test"})
    kind = traffic["driver"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and (("infer" in m["name"]) ==
                                 (kind == "predict")):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    infer = json.loads((BENCH / "traffic" / "tiles_b16_single.json")
                       .read_text())
    infer.update(batch=2, pool=2, density=30)
    write_cell(root, "tiny.infer", _tiny_config(256), infer,
               TINY_LIMITS["tiny.infer"])
    train = json.loads((BENCH / "traffic" / "train_b16_dota.json")
                       .read_text())
    # two micro-batches an update, as the cells accumulate four
    train.update(batch=2, pool=4, max_labels=16, box_px=[4, 30],
                 nominal_batch=4)
    train["labels"]["gap"] = 16
    write_cell(root, "tiny.train", _tiny_config(64), train,
               TINY_LIMITS["tiny.train"])
    return root
