"""Hyperparameter evolution: the reference's GA loop (train.py:536-620).

A copy of ``yolov5_obb_tpu/engine/evolve.py`` (:15-105): for the same
generator and parent rows it draws the same numbers in the same order and
gives the same hyps.  Mutates hyps within per-key (gain, min, max) bounds
for short trainings (``train.evolve``), selects parents from the top 5 by
fitness, writes ``evolve.csv``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

# key: (mutation gain, min, max) — reference train.py:540-568 ("meta")
EVOLVE_META = {
    "lr0": (1, 1e-5, 0.1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "theta": (1, 0.2, 4.0),
    "theta_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 180.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
}


def mutate(hyp: dict, rng: np.random.Generator, parent_rows=None,
           mp: float = 0.8, sigma: float = 0.2) -> dict:
    """One GA mutation (reference train.py:576-596)."""
    keys = [k for k in EVOLVE_META if k in hyp]
    if parent_rows:
        # weighted parent selection from top-n
        rows = np.array([r[1] for r in parent_rows])  # fitness values
        w = rows - rows.min() + 1e-6
        pick = parent_rows[int(rng.choice(len(parent_rows), p=w / w.sum()))][0]
        base = {k: pick.get(k, hyp[k]) for k in keys}
    else:
        base = {k: hyp[k] for k in keys}

    g = np.array([EVOLVE_META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (
            (rng.random(len(keys)) < mp)
            * rng.random()
            * rng.normal(1, sigma, len(keys))
            * g
            + 1
        ).clip(0.3, 3.0)
    out = dict(hyp)
    for k, vi in zip(keys, v):
        lo, hi = EVOLVE_META[k][1], EVOLVE_META[k][2]
        out[k] = float(np.clip(base[k] * vi, lo, hi))
    return out


def log_generation(evolve_csv, hyp: dict, metrics: dict, fit: float):
    path = Path(evolve_csv)
    keys = sorted(k for k in EVOLVE_META if k in hyp)
    new = not path.exists()
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["fitness", "map50", "map", *keys])
        w.writerow(
            [f"{fit:.5f}", f"{metrics.get('map50', 0):.5f}",
             f"{metrics.get('map', 0):.5f}", *(f"{hyp[k]:.6g}" for k in keys)]
        )


def read_population(evolve_csv, top_n: int = 5):
    """Top-n (hyp_dict, fitness) rows from evolve.csv."""
    path = Path(evolve_csv)
    if not path.exists():
        return []
    with open(path) as f:
        rows = list(csv.DictReader(f))
    rows.sort(key=lambda r: -float(r["fitness"]))
    out = []
    for r in rows[:top_n]:
        hyp = {k: float(v) for k, v in r.items() if k in EVOLVE_META}
        out.append((hyp, float(r["fitness"])))
    return out
