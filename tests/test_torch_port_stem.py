"""The stem-only path against the JAX package on the CPU: ``fused_stem``'s
plain version against the Pallas kernel in interpret mode, the stem fold,
and the models whose layer 1 cannot join the stem (yolov5s-ghost, and any
model with ``PACKED_L1=0``) against JAX's stock path with the same weights
(float32)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu.ops.pallas.stem_kernel import fold_stem_params as jax_fold
from yolov5_obb_tpu.ops.pallas.stem_kernel import fused_stem as jax_fused_stem
from yolov5_obb_tpu.ops.pallas.stem_kernel import remap_w6
from yolov5_obb_tpu.utils.fuse import fuse_conv_bn as jax_fuse
from yolov5_obb_tpu_torch.engine.evaluator import pack_images
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.ops.kernels import stem_kernel
from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables


# the stem widths of yolov5s-ghost and yolov5m
@pytest.mark.parametrize("c2", [32, 48])
def test_fused_stem_plain_matches_pallas(c2):
    """fused_stem_plain against JAX fused_stem(use_pallas=True) at H = 64
    (tests/test_stem_kernel.py's shape): one bf16 ulp of the largest
    output; fold_stem_params against JAX's (its taps through remap_w6)."""
    rng = np.random.default_rng(0)
    B, H, W = 2, 64, 64
    img = rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8)
    k = (rng.standard_normal((6, 6, 3, c2)) / np.sqrt(108)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c2), rng.normal(0, 0.2, c2)
    mean, var = rng.normal(0, 0.5, c2), rng.uniform(0.5, 2.0, c2)
    f32 = lambda a: np.asarray(a, np.float32)
    w108, b = jax_fold(jnp.asarray(k), *(jnp.asarray(f32(a)) for a in
                                         (scale, bias, mean, var)))
    bn = types.SimpleNamespace(**{n: torch.from_numpy(f32(a)) for n, a in (
        ("weight", scale), ("bias", bias), ("running_mean", mean),
        ("running_var", var))})
    w0, b0 = stem_kernel.fold_stem_params(
        torch.from_numpy(k).permute(3, 2, 0, 1), bn)
    assert w0.shape == (108, c2) and w0.dtype == torch.float32
    np.testing.assert_allclose(remap_w6(w0.numpy().reshape(6, 6, 3, c2)),
                               np.asarray(w108), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(b0.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)

    want = np.asarray(jax_fused_stem(jnp.asarray(img.reshape(B, H, -1)),
                                     w108, b, H, W, use_pallas=True),
                      np.float32)
    got = stem_kernel.fused_stem(torch.from_numpy(pack_images(img)), w0, b0)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= np.abs(want).max() / 128


def _variables(model, imgsz, rng):
    """numpy-seeded variables of a JAX model (trained-like BN statistics)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, imgsz, imgsz, 3)))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree.map(np.asarray, dict(
        jax.tree_util.tree_map_with_path(fill, shapes)))


def _maps_close(got, want, rel=1e-4):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= rel * np.abs(b).max()


@pytest.fixture(scope="module")
def ghost():
    model, meta, _ = jax_build_model("yolov5s-ghost.yaml", nc=15,
                                     dtype=jnp.float32)
    meta = jax_probe_strides(model, meta)
    return model, meta, _variables(model, 64, np.random.default_rng(1))


@pytest.mark.parametrize("packed", [False, True])
def test_ghost_forward_matches_jax(ghost, packed, monkeypatch):
    """yolov5s-ghost (GhostConv, C3Ghost, depthwise convs) stock and with
    the packed stem, whose layer 0 is the stem kernel's plain version and
    layer 1 a GhostConv, against JAX with weights from from_jax_variables:
    within 1e-4 of the largest, unfolded and Conv+BN-folded."""
    jm, jmeta, v = ghost
    calls = []
    monkeypatch.setattr(layers, "fused_stem",
                        lambda *a: calls.append(1) or stem_kernel.fused_stem(*a))
    port, meta = create_model("yolov5s-ghost.yaml", nc=15, device="cpu",
                              packed_stem=packed)
    assert meta.strides == jmeta.strides
    assert port.packed_stem == packed and not port.packed_l1
    assert type(port.model[1]).__name__ == "GhostConv"
    port.load_state_dict(from_jax_variables(v, port.specs))
    img = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    x = (torch.from_numpy(pack_images(img)) if packed
         else torch.from_numpy(img).float() / 255.0)
    jx = jnp.asarray(img, jnp.float32) / 255.0
    with torch.no_grad():
        _maps_close(port(x), jm.apply(v, jx, train=False, flat=True))
        # the port's folding equals the JAX package's
        vf = jax_fuse(v)
        fuse_conv_bn(port)
        want_sd = from_jax_variables(vf, port.specs)
        for k, t in port.state_dict().items():
            torch.testing.assert_close(t, want_sd[k], atol=1e-6, rtol=1e-6)
        _maps_close(port(x), jm.apply(vf, jx, train=False, flat=True))
    assert len(calls) == (2 if packed else 0)


def test_packed_l1_off_matches_jax(monkeypatch):
    """yolov5n with PACKED_L1=0: layer 0 is the stem kernel (its plain
    version here) and layer 1 the stock downsample; against JAX's stock
    path and against the same model with the stem+L1 kernel."""
    jm, jmeta, _ = jax_build_model("yolov5n.yaml", nc=15, dtype=jnp.float32)
    v = _variables(jm, 64, np.random.default_rng(3))
    img = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    x = torch.from_numpy(pack_images(img))
    calls = []
    monkeypatch.setattr(layers, "fused_stem",
                        lambda *a: calls.append(1) or stem_kernel.fused_stem(*a))
    maps = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("PACKED_L1", flag)
        port, _ = create_model("yolov5n.yaml", nc=15, device="cpu",
                               packed_stem=True)
        assert port.packed_stem and port.packed_l1 == (flag == "1")
        port.load_state_dict(from_jax_variables(v, port.specs))
        with torch.no_grad():
            maps[flag] = port(x)
    assert len(calls) == 1
    jmaps = jm.apply(v, jnp.asarray(img, jnp.float32) / 255.0, train=False,
                     flat=True)
    _maps_close(maps["0"], jmaps)
    _maps_close(maps["0"], [m.numpy() for m in maps["1"]], rel=1e-5)
