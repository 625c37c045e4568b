"""Every bundled config of the port, against the JAX package's on the CPU.

The port alone, at published widths, on the meta device (the counterpart
of ``tests/test_model_configs.py``): each of the 21 configs builds and
probes, its stride ladder strictly increasing and its outputs of the
expected shapes at 128²; ``anchors.yaml`` and the integer ``anchors: N``
spec.  Then against the JAX package, each config with ``width_multiple``
scaled to 0.125 and ``depth_multiple`` to 0.33 in the loaded dict (the
graph kept, the compile small): the float32 forward at 128² (P7 at 256²)
within 1e-4 of the largest output; yolov5n6 and yolov5s-transformer
through ``make_predict_fn`` against the JAX predict, the same detections
in the same order; the loss at 2 and 5 levels; the train and val CLIs
on a P6 model with ``hyp_paper.yaml``; and every copied YAML (model and
data) parsing equal to the JAX package's.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from conftest import build_mini_dota
from test_torch_port_model import _assert_same_dets
from test_torch_port_model import _jax_model as _seeded_jax_model
from test_torch_port_train import _maps, _targets
from yolov5_obb_tpu.engine.evaluator import make_predict_fn as jax_predict_fn
from yolov5_obb_tpu.engine.loss import ComputeLoss as JaxLoss
from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import decode as jax_decode
from yolov5_obb_tpu.models.yolo import load_config as jax_load_config
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu_torch import train as port_train
from yolov5_obb_tpu_torch import val as port_val
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn, pack_images
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.yolo import (
    build_model,
    create_model,
    decode,
    probe_strides,
)
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "yolov5_obb_tpu_torch"
JAXP = ROOT / "yolov5_obb_tpu"
CONFIG_DIR = PORT / "models" / "configs"
ALL_CONFIGS = sorted(p.name for p in CONFIG_DIR.glob("*.yaml")
                     if p.name != "anchors.yaml")
NC = 15


def test_the_port_ships_every_config_and_data_yaml():
    for sub in ("models/configs", "data/configs"):
        assert sorted(p.name for p in (PORT / sub).glob("*.yaml")) == sorted(
            p.name for p in (JAXP / sub).glob("*.yaml")), sub
    assert len(ALL_CONFIGS) == 21


# ---------------------------------------------------------------------------
# the port alone, published widths, meta device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", ALL_CONFIGS)
def test_config_builds_and_probes(cfg):
    model, meta, _ = build_model(cfg, nc=NC)
    meta = probe_strides(model, meta, imgsz=256)
    assert meta.nl == meta.anchors_px.shape[0] == len(meta.strides)
    assert all(s > 0 for s in meta.strides)
    assert all(a < b for a, b in zip(meta.strides, meta.strides[1:]))
    sz = 128
    with torch.no_grad():
        outs = model.to("meta").eval()(torch.zeros(2, sz, sz, 3,
                                                   device="meta"))
    assert len(outs) == meta.nl
    for o, s in zip(outs, meta.strides):
        assert tuple(o.shape) == (2, (sz // int(s)) ** 2 * meta.na, meta.no)


def test_anchors_yaml_asset(tmp_path):
    """The anchor sets of ``anchors.yaml`` are well formed and drop into a
    model yaml's ``anchors`` key."""
    sets = yaml.safe_load((CONFIG_DIR / "anchors.yaml").read_text())
    assert set(sets) == {
        "anchors_p5_640", "anchors_p6_640", "anchors_p6_1280",
        "anchors_p6_1920", "anchors_p7_640", "anchors_p7_1280",
        "anchors_p7_1920"}
    for name, rows in sets.items():
        nl = int(name.split("_p")[1][0]) - 2  # p5 → 3, p6 → 4, p7 → 5
        assert len(rows) == nl
        assert all(len(r) == 6 and all(v > 0 for v in r) for r in rows)
    d = yaml.safe_load((CONFIG_DIR / "yolov5n6.yaml").read_text())
    d["anchors"] = sets["anchors_p6_640"]
    f = tmp_path / "with_asset_anchors.yaml"
    f.write_text(yaml.safe_dump(d))
    model, meta, _ = build_model(str(f), nc=NC)
    meta = probe_strides(model, meta)
    assert meta.nl == 4 and meta.na == 3
    np.testing.assert_array_equal(meta.anchors_px[0, 0], [9, 11])


@pytest.mark.parametrize("cfg", ["yolov5n.yaml", "yolov5-p7.yaml"])
def test_integer_anchor_spec(cfg):
    """``anchors: N`` gives N stride-scaled placeholder priors a level, as
    the JAX package synthesises them."""
    d = yaml.safe_load((CONFIG_DIR / cfg).read_text())
    d["anchors"] = 3
    model, meta, _ = build_model(d, nc=NC)
    meta = probe_strides(model, meta, imgsz=256)
    jm, jmeta, _ = jax_build_model(d, nc=NC)
    assert meta.na == jmeta.na == 3 and meta.nl == jmeta.nl
    np.testing.assert_array_equal(meta.anchors_px, jmeta.anchors_px)
    assert np.all(meta.anchors_px > 0)
    assert np.all(meta.anchors_px[1:] > meta.anchors_px[:-1])


@pytest.mark.parametrize("cfg", ["yolov3-tiny.yaml", "yolov5n6.yaml",
                                 "yolov5-p7.yaml"])
def test_anchor_order_follows_the_strides(cfg):
    """Anchors in stride order stay as the JAX package keeps them; listed
    largest-first they flip back into stride order (the reference's
    check_anchor_order), where the JAX probe's reorder by the strides'
    rank keeps them reversed (a fault of the reference: ROADMAP queue
    3)."""
    d = yaml.safe_load((CONFIG_DIR / cfg).read_text())
    for rev in (False, True):
        if rev:
            d["anchors"] = d["anchors"][::-1]
        model, meta, _ = build_model(d, nc=NC)
        meta = probe_strides(model, meta)
        jm, jmeta, _ = jax_build_model(d, nc=NC)
        jmeta = jax_probe_strides(jm, jmeta)
        want = jmeta.anchors_px[::-1] if rev else jmeta.anchors_px
        np.testing.assert_array_equal(meta.anchors_px, want)
        areas = meta.anchors_px.prod(-1).mean(-1)
        assert list(np.argsort(areas)) == list(range(meta.nl))


@pytest.mark.parametrize("cfg", ["yolov5-p2.yaml", "yolov5-p7.yaml"])
def test_decode_matches_jax_at_other_strides(cfg):
    """``decode`` at P2's stride 4 (four levels) and P7's stride 128 (five)
    on a non-square input: seeded 5-D maps through both decodes, within
    1e-6 relative or 1e-5 (a float32 ulp of the 384-pixel extent)."""
    H, W = 256, 384
    model, meta, _ = build_model(cfg, nc=NC)
    meta = probe_strides(model, meta)
    jm, jmeta, _ = jax_build_model(cfg, nc=NC)
    jmeta = jax_probe_strides(jm, jmeta)
    rng = np.random.default_rng(0)
    maps = [rng.normal(0, 2, (2, H // int(s), W // int(s), meta.na, meta.no)
                       ).astype(np.float32) for s in meta.strides]
    want = np.asarray(jax_decode([jnp.asarray(m) for m in maps], jmeta))
    got = decode([torch.from_numpy(m.reshape(2, -1, meta.no)) for m in maps],
                 meta, (H, W)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ["models", "data"])
def test_copied_yaml_parses_equal(kind):
    names = sorted(p.name for p in (PORT / kind / "configs").glob("*.yaml"))
    assert names
    for name in names:
        got = yaml.safe_load((PORT / kind / "configs" / name).read_text())
        want = yaml.safe_load((JAXP / kind / "configs" / name).read_text())
        assert got == want, name


def test_a_bundled_hyp_resolves_by_name():
    assert load_hyp("hyp_paper.yaml") == yaml.safe_load(
        (PORT / "data" / "configs" / "hyp_paper.yaml").read_text())
    assert load_hyp("hyp_paper.yaml")["mixup"] == 1.0


# ---------------------------------------------------------------------------
# against the JAX package, scaled widths
# ---------------------------------------------------------------------------


def _scaled(cfg):
    d = jax_load_config(cfg)
    d["width_multiple"], d["depth_multiple"] = 0.125, 0.33
    return d


def _fill(seed):
    rng = np.random.default_rng(seed)

    def fill_one(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = (sd.shape[0] if len(sd.shape) == 3
                      and path[-2].key != "out" else np.prod(sd.shape[:-1]))
            return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, sd.shape).astype(np.float32)
        return rng.normal(0, 0.1, sd.shape).astype(np.float32)
    return fill_one


_JAX_FORWARDS: dict = {}


def _jax_forward(d, S):
    """The JAX model, its meta and its jitted forward, once per graph: the
    P5 n-x and the P6 n6-x6 configs differ only in their multiples, so
    once scaled they share one compile."""
    key = json.dumps([d["backbone"], d["head"], d["anchors"], S])
    if key not in _JAX_FORWARDS:
        jm, jmeta, _ = jax_build_model(d, nc=NC)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, S, S, 3)))
        # LLVM's optimisation off: a third of the compile, the same maps
        fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False, flat=True)
                      ).lower(shapes, jnp.zeros((1, S, S, 3))).compile(
            compiler_options={"xla_backend_optimization_level": 0})
        _JAX_FORWARDS[key] = (jm, jmeta, shapes, fwd)
    return _JAX_FORWARDS[key]


@pytest.mark.parametrize("cfg", ALL_CONFIGS)
def test_config_forward_matches_jax(cfg):
    """The float32 Detect maps of the scaled config, same weights and
    image: every level within 1e-4 of its largest value, of the same
    shape (so the same stride: the JAX ``probe_strides`` reads it off
    these shapes); the anchors equal."""
    d = _scaled(cfg)
    S = 256 if "p7" in cfg else 128
    jm, jmeta, shapes, fwd = _jax_forward(d, S)
    v = jax.tree.map(np.asarray, dict(
        jax.tree_util.tree_map_with_path(_fill(0), shapes)))
    port, meta = create_model(d, nc=NC, device="cpu")
    np.testing.assert_array_equal(meta.anchors_px, jmeta.anchors_px)
    port.load_state_dict(from_jax_variables(v, port.specs))
    x = np.random.default_rng(1).uniform(0, 1, (1, S, S, 3)).astype(
        np.float32)
    with torch.no_grad():
        maps = port(torch.from_numpy(x))
    jmaps = fwd(v, jnp.asarray(x))
    assert len(maps) == len(jmaps) == jmeta.nl == meta.nl
    for a, b, s in zip(maps, jmaps, meta.strides):
        b = np.asarray(b)
        assert a.shape == b.shape == (1, (S // int(s)) ** 2 * meta.na,
                                      meta.no)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("cfg", ["yolov5n6.yaml", "yolov5s-transformer.yaml"])
def test_predict_matches_jax(cfg, monkeypatch):
    """The scaled config end to end through ``make_predict_fn`` (packed
    stem, every kernel gate lowered, so the kernels' plain versions run)
    against the JAX predict: the same counts, the same detections in the
    same order (near-tied scores as sets)."""
    monkeypatch.setattr(layers, "FUSED_C3_MIN_SPATIAL", 0)
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    S, B = 128, 2
    d = _scaled(cfg)
    jm, jmeta, v = _seeded_jax_model(d, seed=1)
    port, meta = create_model(d, nc=NC, device="cpu", packed_stem=True)
    assert port.packed_stem and meta.strides == jmeta.strides
    port.load_state_dict(from_jax_variables(v, port.specs))
    img = np.random.default_rng(0).integers(0, 256, (B, S, S, 3),
                                            dtype=np.uint8)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=1500,
              multi_label=False, max_candidates=2048)
    jd, jn = jax_predict_fn(jm, jmeta, **kw)(v, jnp.asarray(img))
    pd, pn = make_predict_fn(port, meta, **kw)(
        torch.from_numpy(pack_images(img)))
    jd, jn, pd, pn = np.asarray(jd), np.asarray(jn), pd.numpy(), pn.numpy()
    np.testing.assert_array_equal(pn, jn)
    assert pn.min() >= 5, "too few detections to test the NMS"
    for i in range(B):
        _assert_same_dets(pd[i, :jn[i]], jd[i, :jn[i]])
        assert not pd[i, jn[i]:].any()


@pytest.mark.parametrize("cfg", ["yolov3-tiny.yaml", "yolov5-p7.yaml"])
def test_loss_matches_jax_at_other_level_counts(cfg):
    """ComputeLoss at 2 and 5 levels (4: the P6 CLI run), with hyp_paper's
    gains: the total, its items and d(total)/d(maps) against the JAX
    loss."""
    S = 128
    d = _scaled(cfg)
    jm, jmeta, _ = jax_build_model(d, nc=NC)
    jmeta = jax_probe_strides(jm, jmeta, imgsz=256)
    pm, pmeta, _ = build_model(d, nc=NC)
    pmeta = probe_strides(pm, pmeta, imgsz=256)
    assert pmeta.strides == jmeta.strides
    rng = np.random.default_rng(2)
    maps = _maps(rng, pmeta, 2)
    tg, mask = _targets(rng, 2, 6, live=4)
    hyp = scale_hyp_gains(load_hyp("hyp_paper.yaml"), pmeta.nl, NC, S)
    (jt, ji), jg = jax.value_and_grad(
        lambda m: JaxLoss(jmeta, hyp)(m, jnp.asarray(tg), jnp.asarray(mask)),
        has_aux=True)([jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, items = ComputeLoss(pmeta, hyp)(tmaps, torch.from_numpy(tg),
                                           torch.from_numpy(mask))
    grads = torch.autograd.grad(total, tmaps)
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-5)
    np.testing.assert_allclose(items.detach().numpy(), np.asarray(ji),
                               rtol=1e-5)
    for g, want in zip(grads, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_train_and_val_cli_on_a_p6_model(tmp_path):
    """The port's train CLI on yolov5n6 with ``--hyp hyp_paper.yaml``
    (mosaic and mixup always on, the bundled set found by its name),
    autoanchor and val on, one epoch; then the val CLI on its ``best/``:
    four Detect levels through the loss, the checkpoint and evaluate."""
    root = build_mini_dota(tmp_path / "dota", n_images=2, n_boxes=5, seed=3)
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    port_train.main(
        ["--cfg", "yolov5n6.yaml", "--hyp", "hyp_paper.yaml", "--data",
         str(data), "--imgsz", "128", "--batch-size", "2",
         "--nominal-batch", "2", "--max-labels", "16", "--workers", "0",
         "--dtype", "float32", "--epochs", "1", "--device", "cpu",
         "--project", str(tmp_path / "runs"), "--name", "p6",
         "--exist-ok"])
    run = tmp_path / "runs" / "p6"
    meta = json.loads((run / "best" / "meta.json").read_text())
    assert np.asarray(meta["anchors"]).shape == (4, 3, 2)
    rows = (run / "results.csv").read_text().splitlines()
    assert len(rows) == 2 and "nan" not in rows[1]
    res = port_val.main(
        ["--weights", str(run / "best"), "--cfg", "yolov5n6.yaml", "--data",
         str(data), "--imgsz", "128", "--batch-size", "2", "--device", "cpu",
         "--project", str(tmp_path / "runs"), "--name", "val",
         "--exist-ok", "--no-plots"])
    assert all(np.isfinite(res[k]) for k in ("mp", "mr", "map50", "map"))
