"""Faults of the port against the JAX package, repaired: the Detect anchors
of a reference state dict, and the environment knobs that the JAX package
reads (``FUSED_DOWN_MIN_SPATIAL``, ``FUSED_C3_MIN_SPATIAL``,
``YOLO_DENSE_LOSS``)."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from yolov5_obb_tpu.engine.loss import ComputeLoss as JaxLoss
from yolov5_obb_tpu.models.yolo import ModelMeta as JaxMeta
from yolov5_obb_tpu.utils.checkpoint import restore_model_meta
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.models.yolo import create_model, load_config
from yolov5_obb_tpu_torch.ops.rotated_nms import decode_planes
from yolov5_obb_tpu_torch.utils.checkpoint import load_state_dict

ROOT = Path(__file__).resolve().parents[1]


def _evolved_state_dict(tmp_path, buffer_shape=None):
    """A reference-named state dict of a seeded yolov5n whose Detect
    ``anchors`` buffer (anchors / stride, as the reference stores it) holds
    anchors other than the config's; → (path, anchors in pixels)."""
    model, meta = create_model("yolov5n.yaml", nc=3, device="cpu", seed=1)
    rng = np.random.default_rng(0)
    px = (meta.anchors_px * rng.uniform(0.6, 1.6, meta.anchors_px.shape))
    px = px.astype(np.float32)
    grid = px / np.asarray(meta.strides, np.float32)[:, None, None]
    if buffer_shape is not None:
        grid = np.resize(grid, buffer_shape)
    sd = dict(model.state_dict())
    sd["model.24.anchors"] = torch.from_numpy(grid)
    path = tmp_path / "evolved.pt"
    torch.save(sd, path)
    return path, px


def _planes(model, meta):
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        return decode_planes(model(x), meta)


def test_load_state_dict_takes_the_detect_anchors(tmp_path):
    path, px = _evolved_state_dict(tmp_path)
    model, meta = create_model("yolov5n.yaml", nc=3, device="cpu", seed=2)
    config_px = meta.anchors_px.copy()
    load_state_dict(model, path, meta)
    np.testing.assert_allclose(meta.anchors_px, px, rtol=1e-6)
    # the JAX package's checkpoint restore takes the same anchors
    jmeta = JaxMeta(nc=3, nl=3, na=3, strides=meta.strides,
                    anchors_px=config_px)
    restore_model_meta(jmeta, {"anchors": px.tolist()})
    np.testing.assert_allclose(meta.anchors_px, jmeta.anchors_px, rtol=1e-6)

    # decoded boxes equal those of a model built with those anchors
    cfg = load_config("yolov5n.yaml")
    cfg["anchors"] = px.reshape(3, -1).tolist()
    built, bmeta = create_model(cfg, nc=3, device="cpu", seed=4)
    np.testing.assert_allclose(bmeta.anchors_px, px, rtol=1e-6)
    load_state_dict(built, path, bmeta)
    got, want = _planes(model, meta), _planes(built, bmeta)
    for k in ("x", "y", "w", "h"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-4)
    # ... and differ from the config anchors' boxes
    config = _planes(model, types.SimpleNamespace(
        **{**vars(meta), "anchors_px": config_px}))
    assert not torch.allclose(config["w"], got["w"])


@pytest.mark.parametrize("buffer_shape", [None, (3, 2, 2)])
def test_load_state_dict_keeps_the_config_anchors(tmp_path, buffer_shape):
    """No buffer, or one of another shape: the config's anchors stay (the
    JAX restore takes anchors only where the shape matches)."""
    path, _ = _evolved_state_dict(tmp_path, buffer_shape)
    if buffer_shape is None:
        sd = torch.load(path, weights_only=True)
        del sd["model.24.anchors"]
        torch.save(sd, path)
    model, meta = create_model("yolov5n.yaml", nc=3, device="cpu", seed=2)
    config_px = meta.anchors_px.copy()
    load_state_dict(model, path, meta)
    np.testing.assert_array_equal(meta.anchors_px, config_px)


@pytest.mark.parametrize("env,dense", [(None, False), ("0", False),
                                       ("1", True)])
def test_compute_loss_dense_follows_the_environment(monkeypatch, env, dense):
    if env is None:
        monkeypatch.delenv("YOLO_DENSE_LOSS", raising=False)
    else:
        monkeypatch.setenv("YOLO_DENSE_LOSS", env)
    meta = types.SimpleNamespace(nc=3, strides=(8.0, 16.0, 32.0),
                                 anchors_grid=np.ones((3, 3, 2), np.float32))
    assert ComputeLoss(meta).dense is JaxLoss(meta).dense is dense
    # an explicit argument wins over the environment in both packages
    assert ComputeLoss(meta, dense=not dense).dense is (not dense)
    assert JaxLoss(meta, dense=not dense).dense is (not dense)


# Run in a fresh process (both packages read the gates when their layers
# module is imported): which function the downsample and the C3 call at 32²
# and 64² inputs, in each package, with its kernel replaced by a spy.
_GATE_SCRIPT = r"""
import json
import jax
import jax.numpy as jnp
import numpy as np
import torch
from yolov5_obb_tpu.models import layers as JL
from yolov5_obb_tpu.ops.pallas import c3_kernel as JC
from yolov5_obb_tpu.ops.pallas import down_kernel as JD
from yolov5_obb_tpu_torch.models import layers as PL

calls = []


def spy(tag, out):
    def f(x, *a, **k):
        calls.append(tag)
        return out(x)
    return f


JD.fused_down = spy("down", lambda x: jnp.zeros(
    (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, 16), jnp.bfloat16))
JC.fused_c3 = spy("c3", lambda x: x)
PL.fused_down = spy("down", lambda x: torch.zeros(
    x.shape[0], x.shape[1] // 2, x.shape[2] // 2, 16))
PL.fused_c3 = spy("c3", lambda x: x)
res = {"jax": {}, "port": {}}
for s in (32, 64):
    x = np.random.default_rng(0).standard_normal((1, s, s, 16), np.float32)
    for name, jm, pm in (
            ("down", JL.ConvBnAct(16, 3, 2, fused=True),
             PL.ConvBnAct(16, 16, 3, 2, fused=True)),
            ("c3", JL.C3(16, 16, 1, fused=True), PL.C3(16, 16, 1, fused=True))):
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        calls.clear()
        jm.apply(v, jnp.asarray(x), train=False)
        res["jax"][f"{name}@{s}"] = calls == [name]
        calls.clear()
        with torch.no_grad():
            pm.eval()(torch.from_numpy(x))
        res["port"][f"{name}@{s}"] = calls == [name]
print(json.dumps(res))
"""


@pytest.mark.parametrize("gate", [None, 64 * 64])
def test_layer_gates_follow_the_environment(gate):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FUSED_DOWN_MIN_SPATIAL", "FUSED_C3_MIN_SPATIAL")}
    if gate is not None:
        env["FUSED_DOWN_MIN_SPATIAL"] = env["FUSED_C3_MIN_SPATIAL"] = str(gate)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), *filter(None, [env.get("PYTHONPATH")])])
    out = subprocess.run([sys.executable, "-c", _GATE_SCRIPT], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    fused = gate is not None  # 64² passes a 64² gate, never the default 256²
    want = {"down@32": False, "c3@32": False, "down@64": fused,
            "c3@64": fused}
    assert res["port"] == res["jax"] == want
