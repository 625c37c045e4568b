"""The port's rotated IoU on hard pairs (tests/riou_cases.py: identical,
nested, touching, collinear and parallel edges, quarter and half turns,
zero-width boxes, tied pseudo-angles): the plain pair math and the plain
per-box records it is built on, against the JAX kernel's math
(``iou_kernel._pairs_iou_math``) and the 24-point clipper
(``ops/rotated_iou.rotated_iou``) on the CPU; and the records' cover and
area against the neighbour kernel's plain edge inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from riou_cases import CASES, hard_pairs
from yolov5_obb_tpu.ops.pallas.iou_kernel import _pairs_iou_math
from yolov5_obb_tpu.ops.rotated_iou import rotated_iou as jax_clipper
from yolov5_obb_tpu_torch.ops.kernels.iou import box_records_plain
from yolov5_obb_tpu_torch.ops.kernels.neighbor_kernel import _edge_inputs
from yolov5_obb_tpu_torch.ops.rotated_iou import (
    REC_CLS,
    REC_VALID,
    RECORD_FIELDS,
    pairs_iou_math,
    pairs_iou_records,
    record_cover_area,
)


def _jax_pairs(a, b):
    return np.asarray(_pairs_iou_math(*(jnp.asarray(a[:, i]) for i in range(5)),
                                      *(jnp.asarray(b[:, i]) for i in range(5))))


@pytest.mark.parametrize("case", CASES)
def test_hard_pairs_match_jax(case):
    a, b = hard_pairs(case)
    want = _jax_pairs(a, b)
    got = pairs_iou_math(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.array_equal(got > 0.45, want > 0.45)


@pytest.mark.parametrize("case", CASES)
def test_hard_pairs_on_records_match_jax(case):
    """The pair math on the per-box records (the kernels' split: each box's
    trig and half vectors once, then the pair)."""
    a, b = hard_pairs(case)
    ra = box_records_plain(torch.from_numpy(a))
    rb = box_records_plain(torch.from_numpy(b))
    got = pairs_iou_records(ra, rb).numpy()
    want = _jax_pairs(a, b)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.array_equal(got > 0.45, want > 0.45)
    # the records' split changes no bit of the pair math
    assert np.array_equal(got, pairs_iou_math(torch.from_numpy(a),
                                              torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("case", CASES)
def test_hard_pairs_match_clipper(case):
    a, b = hard_pairs(case)
    got = pairs_iou_math(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_clipper(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_hard_pairs_expected_values():
    """The cases are what they say: a box with itself, a half turn, a
    square's quarter turn give 1; touching gives 0 and zero-width 0 up to
    float rounding of a degenerate ring; nested gives the area ratio;
    half-length and half-width shifts give 1/3."""
    iou = {c: pairs_iou_math(*map(torch.from_numpy, hard_pairs(c))).numpy()
           for c in CASES}
    n = 24
    assert (iou["identical"] > 1 - 1e-5).all()
    assert (iou["turn180"] > 1 - 1e-4).all()
    assert (iou["turn90"][n:] > 1 - 1e-4).all()
    assert (iou["touching"] == 0).all() and (iou["shared_edge"] == 0).all()
    assert (iou["zero_width"] < 1e-6).all()
    a, b = hard_pairs("nested")
    ratio = b[:, 2] * b[:, 3] / (a[:, 2] * a[:, 3])
    np.testing.assert_allclose(iou["nested"], ratio, rtol=1e-4)
    np.testing.assert_allclose(iou["collinear"], 1 / 3, atol=1e-6)
    np.testing.assert_allclose(iou["parallel"], 1 / 3, atol=1e-4)


@pytest.mark.parametrize("n,clustered", [(64, False), (96, True)])
def test_records_cover_and_area_equal_edge_inputs(n, clustered):
    """The plain records carry the neighbour kernel's plain cover and area
    bit for bit, the class and valid bits and the centre; the unused fields
    are 0."""
    rng = np.random.default_rng(n)
    a, _ = hard_pairs("nested" if clustered else "identical", n=n)
    boxes = torch.from_numpy(a).reshape(2, n // 2, 5)
    cls = torch.from_numpy(rng.integers(0, 15, (2, n // 2)).astype(np.int32))
    valid = torch.from_numpy(rng.random((2, n // 2)) < 0.7)
    rec = box_records_plain(boxes, cls, valid)
    assert rec.shape == (2, n // 2, 16) == (2, n // 2, len(RECORD_FIELDS))
    assert torch.equal(record_cover_area(rec), _edge_inputs(boxes))
    assert torch.equal(rec[..., REC_CLS].view(torch.int32), cls)
    assert torch.equal(rec[..., REC_VALID].view(torch.int32),
                       valid.to(torch.int32))
    assert torch.equal(rec[..., :2], boxes[..., :2])
    unused = [i for i, f in enumerate(RECORD_FIELDS) if f == "-"]
    assert not rec[..., unused].any()
    plain = box_records_plain(boxes)  # no class: 0; no flags: all valid
    assert (plain[..., REC_CLS].view(torch.int32) == 0).all()
    assert (plain[..., REC_VALID].view(torch.int32) == 1).all()
