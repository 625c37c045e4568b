"""The whole slice on the CPU: the port's model + decode + rotated NMS
against the JAX package's, float32, weights carried across with
``from_jax_variables``.

The port runs its packed-stem path with its kernel gates lowered, so layers
0-3 (and every other eligible C3/downsample) go through the kernel modules'
plain versions; the JAX side stays on its stock path, which computes the
same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_obb_tpu.engine.evaluator import make_predict_fn as jax_predict_fn
from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu.utils.fuse import fuse_conv_bn as jax_fuse
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn, pack_images
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S, B = 128, 2


def _jax_model(cfg, seed):
    """JAX model + numpy-seeded variables (trained-like BN statistics) with
    the Detect biases spread so that conf 0.25 passes ~100 anchors/img."""
    model, meta, _ = jax_build_model(cfg, nc=15, dtype=jnp.float32)
    meta = jax_probe_strides(model, meta)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (rng.normal(0, 0.1, s.shape)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    v = jax.tree.map(np.asarray, dict(v))
    det = v["params"][f"m{len(model.specs) - 1}"]
    for li in range(meta.nl):
        b = det[f"conv{li}"]["bias"].reshape(meta.na, meta.no)
        b[:, 4] += 2.0
        b[:, 5:5 + meta.nc] += rng.normal(0.0, 2.0, (meta.na, meta.nc))
    return model, meta, v


@pytest.fixture
def low_gates(monkeypatch):
    monkeypatch.setattr(layers, "FUSED_C3_MIN_SPATIAL", 0)
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)


@pytest.mark.parametrize("cfg", ["yolov5n.yaml", "yolov5m.yaml"])
def test_slice_matches_jax(cfg, low_gates):
    jm, jmeta, v = _jax_model(cfg, seed=1)
    vf = jax_fuse(v)
    port, meta = create_model(cfg, nc=15, device="cpu", packed_stem=True)
    assert meta.strides == jmeta.strides
    np.testing.assert_array_equal(meta.anchors_px, jmeta.anchors_px)

    # the port's Conv+BN folding equals the JAX package's
    port.load_state_dict(from_jax_variables(v, port.specs))
    fuse_conv_bn(port)
    want_sd = from_jax_variables(vf, port.specs)
    for k, t in port.state_dict().items():
        torch.testing.assert_close(t, want_sd[k], atol=1e-6, rtol=1e-6)
    port.load_state_dict(want_sd)

    img = np.random.default_rng(0).integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    x = torch.from_numpy(pack_images(img))
    with torch.no_grad():
        maps = port(x)
    assert any(m.eligible(torch.empty(B, S // 4, S // 4, 1))
               for m in port.modules() if isinstance(m, layers.C3))
    jmaps = jm.apply(vf, jnp.asarray(img, jnp.float32) / 255.0, train=False,
                     flat=True)
    for a, b in zip(maps, jmaps):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)

    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=1500,
              multi_label=False, max_candidates=2048)
    jd, jn = jax_predict_fn(jm, jmeta, **kw)(vf, jnp.asarray(img))
    pd, pn = make_predict_fn(port, meta, **kw)(x)
    jd, jn, pd, pn = np.asarray(jd), np.asarray(jn), pd.numpy(), pn.numpy()
    np.testing.assert_array_equal(pn, jn)
    assert pn.min() >= 5, "too few detections to test the NMS"
    for i in range(B):
        _assert_same_dets(pd[i, :jn[i]], jd[i, :jn[i]])
        assert not pd[i, jn[i]:].any()


def _assert_same_dets(p, j, tie=2e-6):
    """Same detections in the same order, boxes within 1e-3 px, scores within
    1e-5.  Random weights give many scores a few float32 ulps apart; where
    neighbouring scores differ by less than ``tie`` the two packages may rank
    them either way, so such runs compare as sets."""
    np.testing.assert_allclose(p[:, 5], j[:, 5], atol=1e-5)
    cuts = np.flatnonzero(np.abs(np.diff(j[:, 5])) > tie) + 1
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(j)]):
        pg, jg = p[a:b], j[a:b]
        pg = pg[np.lexsort((pg[:, 1], pg[:, 0], pg[:, 6]))]
        jg = jg[np.lexsort((jg[:, 1], jg[:, 0], jg[:, 6]))]
        np.testing.assert_array_equal(pg[:, 6], jg[:, 6])  # class ids
        np.testing.assert_allclose(pg[:, :4], jg[:, :4], atol=1e-3)
        np.testing.assert_allclose(pg[:, 4], jg[:, 4], atol=1e-5)


def test_golden_checkpoint_loads():
    """The in-repo trained checkpoint (yolov5n @192) loads through the JAX
    checkpoint reader → from_jax_variables and gives the same maps."""
    from yolov5_obb_tpu.utils.checkpoint import load_weights

    v, wmeta = load_weights("releases/golden_yolov5n_192")
    v = jax.tree.map(np.asarray, v)
    jm, _, _ = jax_build_model("yolov5n.yaml", nc=15, dtype=jnp.float32)
    port, meta = create_model("yolov5n.yaml", nc=15, device="cpu",
                              packed_stem=True)
    np.testing.assert_array_equal(meta.anchors_px,
                                  np.asarray(wmeta["anchors"], np.float32))
    port.load_state_dict(from_jax_variables(v, port.specs))
    img = np.random.default_rng(2).integers(0, 256, (1, 192, 192, 3),
                                            dtype=np.uint8)
    with torch.no_grad():
        maps = port(torch.from_numpy(pack_images(img)))
    jmaps = jm.apply(v, jnp.asarray(img, jnp.float32) / 255.0, train=False,
                     flat=True)
    for a, b in zip(maps, jmaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
