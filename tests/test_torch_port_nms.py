"""The port's rotated NMS and decode+NMS against the JAX package (CPU path)
and the greedy NumPy oracle, on the same numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_obb_tpu.devkit.poly_iou import poly_iou
from yolov5_obb_tpu.models.yolo import ModelMeta as JaxMeta
from yolov5_obb_tpu.ops import geometry as G
from yolov5_obb_tpu.ops import rotated_nms as jnms
from yolov5_obb_tpu_torch.models.yolo import ModelMeta
from yolov5_obb_tpu_torch.ops import rotated_nms as pnms


def _clustered_rboxes(rng, n, n_clusters=8, spread=400.0):
    centers = rng.uniform(100, spread, (n_clusters, 2))
    which = rng.integers(0, n_clusters, n)
    cx = centers[which, 0] + rng.normal(0, 12, n)
    cy = centers[which, 1] + rng.normal(0, 12, n)
    l = rng.uniform(20, 60, n)
    s = l * rng.uniform(0.3, 1.0, n)
    t = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return np.stack([cx, cy, l, s, t], -1).astype(np.float32)


def _oracle_iou(a, b):
    return poly_iou(G.rbox2poly(a[None])[0], G.rbox2poly(b[None])[0])


@pytest.mark.parametrize("seed", range(4))
def test_nms_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 64
    boxes = _clustered_rboxes(rng, n)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    scores[-5:] = 0.0  # padding rows
    cls = rng.integers(0, 2, n).astype(np.int32)
    got = pnms.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.4).numpy()
    want = np.asarray(jnms.nms_rotated(boxes, scores, 0.4))
    oracle = jnms.nms_rotated_np(boxes, scores, 0.4, _oracle_iou)
    assert (got == want).all() and (got == oracle).all()
    got_c = pnms.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                             0.4, class_ids=torch.from_numpy(cls)).numpy()
    want_c = np.asarray(jnms.nms_rotated(boxes, scores, 0.4,
                                         class_ids=jnp.asarray(cls)))
    assert (got_c == want_c).all()
    assert not got[-5:].any()


def test_nms_batched_presorted_matches_per_image():
    rng = np.random.default_rng(11)
    B, n = 3, 96
    boxes = np.stack([_clustered_rboxes(rng, n) for _ in range(B)])
    scores = -np.sort(-rng.uniform(0.0, 1.0, (B, n)), 1).astype(np.float32)
    scores[:, -10:] = 0.0
    got = pnms.nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.45, presorted=True).numpy()
    for i in range(B):
        want = np.asarray(jnms.nms_rotated(boxes[i], scores[i], 0.45,
                                           presorted=True))
        assert (got[i] == want).all()


def _random_maps(rng, B, sizes, nc, na=3, ties=False):
    no = nc + 5 + 180
    maps = []
    for s in sizes:
        m = rng.normal(0, 1.5, (B, s * s * na, no)).astype(np.float32)
        m[..., 4] += 1.0  # objectness: plenty of candidates at conf 0.25
        m[..., 5:5 + nc] += 1.0
        if ties:  # bf16-valued maps: equal scores and theta logits are common
            m = np.array(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
        maps.append(m)
    return maps


@pytest.mark.parametrize("ties,agnostic,classes", [
    (False, False, None), (True, False, None), (True, True, (0, 2, 3))])
def test_decode_nms_from_maps_matches_jax(ties, agnostic, classes):
    rng = np.random.default_rng(3)
    nc, sizes = 4, (16, 8, 4)
    anchors = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]],
                       np.float32).reshape(3, 3, 2)
    strides = (8.0, 16.0, 32.0)
    maps = _random_maps(rng, 2, sizes, nc, ties=ties)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_candidates=512,
              max_det=300, agnostic=agnostic, classes=classes)
    jd, jn = jnms.non_max_suppression_from_maps(
        [jnp.asarray(m) for m in maps],
        JaxMeta(nc=nc, nl=3, na=3, strides=strides, anchors_px=anchors), **kw)
    pd, pn = pnms.non_max_suppression_from_maps(
        [torch.from_numpy(m) for m in maps],
        ModelMeta(nc=nc, nl=3, na=3, strides=strides, anchors_px=anchors),
        **kw)
    jd, jn, pd, pn = np.asarray(jd), np.asarray(jn), pd.numpy(), pn.numpy()
    assert (jn == pn).all() and jn.min() > 20
    assert pd.shape == jd.shape == (2, 300, 7)
    for i in range(2):
        k = jn[i]
        np.testing.assert_array_equal(pd[i, :k, 6], jd[i, :k, 6])  # class, order
        np.testing.assert_allclose(pd[i, :k, :4], jd[i, :k, :4], atol=1e-3)
        np.testing.assert_allclose(pd[i, :k, 4:6], jd[i, :k, 4:6], atol=1e-5)
        assert not pd[i, k:].any()
        if classes is not None:
            assert set(np.unique(pd[i, :k, 6])) <= set(classes)


def test_tier_ladder_and_compaction():
    # the tier never changes the result: rows past the count are padding
    assert pnms._tier(2048, 300) == 512 and pnms._tier(2048, 600) == 1024
    assert pnms._tier(2048, 1500) == 2048 and pnms._tier(1008, 400) == 504
    assert pnms._tier(384, 10) == 384
    rng = np.random.default_rng(4)
    B, n = 2, 700
    boxes = np.stack([_clustered_rboxes(rng, n) for _ in range(B)])
    scores = -np.sort(-rng.uniform(0.0, 1.0, (B, n)), 1).astype(np.float32)
    scores[0, 200:] = 0.0
    scores[1, 240:] = 0.0
    cls = rng.integers(0, 3, (B, n)).astype(np.int32)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(cls), 0.45, False, 100)
    d_tier, n_tier = pnms._suppress_compact_batch(*args)
    keep = pnms.nms_rotated(args[0], args[1], 0.45, class_ids=args[2],
                            presorted=True)
    d_full, n_full = pnms._compact_dets(args[0], args[1], args[2], keep, 100)
    assert torch.equal(n_tier, n_full) and torch.equal(d_tier, d_full)
    for i in range(B):
        jd, jnum = jnms._compact_dets(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                      jnp.asarray(cls[i]), jnp.asarray(keep[i].numpy()),
                                      100)
        assert int(jnum) == int(n_full[i])
        np.testing.assert_array_equal(np.asarray(jd), d_full[i].numpy())
