"""The FLOP count of the plain reference, from which the ``mfu.*`` metrics
are taken, against the port's own count: 2062.6 GFLOPs for a b16 1024²
yolov5m forward (``utils/fuse.model_info`` on the card, PERF.md), and the
kernels' bounds at the cells' shapes."""

from __future__ import annotations

import json

import pytest

from benchmark import bounds, flops

from .conftest import BENCH


def _model(cfg):
    return json.loads((BENCH / "configs" / f"{cfg}.json").read_text())


def test_forward_matches_model_info():
    md = _model("yolov5m-obb-1024")["model"]
    assert flops.forward_flops(md, 15, 16, 1024) == pytest.approx(
        2062.6e9, rel=5e-5)


def test_train_counts_forward_and_backward():
    """A backward is two forwards' products but for the image's own
    gradient, which no one takes."""
    md = _model("yolov5m-obb-1024")["model"]
    fwd = flops.forward_flops(md, 15, 16, 1024)
    assert 2.95 * fwd < flops.train_flops(md, 15, 16, 1024) < 3 * fwd


def test_p6_counts_more():
    m = flops.forward_flops(_model("yolov5m-obb-1024")["model"], 15, 16,
                            1280)
    m6 = flops.forward_flops(_model("yolov5m6-obb-1280")["model"], 15, 16,
                             1280)
    assert m < m6 < 1.3 * m


def test_bounds_at_the_cells_shapes():
    """Rows 1-3 at yolov5m b16 1024² as PERF.md's kernel table states them
    (0.220, 0.137, 0.090 ms), the train rows positive and both
    configurations' layers 0-3 alike."""
    md = _model("yolov5m-obb-1024")["model"]
    rows = bounds.infer_rows(md, 16, 1024)
    assert rows["stem_l1"] * 1e3 == pytest.approx(0.220, abs=5e-4)
    assert rows["c3"] * 1e3 == pytest.approx(0.137, abs=5e-4)
    assert rows["down"] * 1e3 == pytest.approx(0.090, abs=5e-4)
    train = bounds.train_rows(md, 16, 1024)
    assert set(train) == set(bounds.TRAIN_LAUNCHES)
    assert all(v > 0 for v in train.values())
    assert bounds.widths(md) == bounds.widths(
        _model("yolov5m6-obb-1280")["model"])
