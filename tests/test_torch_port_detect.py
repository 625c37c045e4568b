"""The port's detect surface against the JAX package's on the CPU: decode,
``non_max_suppression_obb``, test-time augmentation, the model ensemble,
the detect CLI and the val CLI's ``--augment`` and ensembles, on the same
numpy-seeded inputs and the same weights (the in-repo trained yolov5n with
its Detect biases raised, at 128 px, float32)."""

import json
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_mini_dota
from test_torch_port_val import (
    _jax_model,
    _read_rows,
    _same_json_rows,
    _same_rows,
)
from yolov5_obb_tpu.engine.evaluator import (
    make_ensemble_predict_fn as jax_ensemble,
)
from yolov5_obb_tpu.models import tta as jtta
from yolov5_obb_tpu.models.yolo import decode as jax_decode
from yolov5_obb_tpu.ops import rotated_nms as jnms
from yolov5_obb_tpu.utils.checkpoint import save_weights as jax_save_weights
from yolov5_obb_tpu.utils.fuse import fuse_conv_bn as jax_fuse
from yolov5_obb_tpu_torch import detect as port_detect
from yolov5_obb_tpu_torch import val as port_val
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.engine.evaluator import make_ensemble_predict_fn
from yolov5_obb_tpu_torch.models import tta as ptta
from yolov5_obb_tpu_torch.models.yolo import create_model, decode
from yolov5_obb_tpu_torch.ops import rotated_nms as pnms
from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S = 128
NC = 15


@pytest.fixture
def no_jax_init(monkeypatch):
    """The JAX CLIs build their model with a random init that the loaded
    weights then replace; skip that init (its first, eager run costs ~25 s
    on the CPU)."""
    import yolov5_obb_tpu.models.yolo as jyolo

    monkeypatch.setattr(jyolo, "init_model", lambda *a, **k: None)


def _port(v):
    m, meta = create_model("yolov5n.yaml", nc=NC, device="cpu")
    m.load_state_dict(from_jax_variables(v, m.specs))
    return fuse_conv_bn(m), meta


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    """The weights (a second, perturbed ensemble member too) as the JAX
    CLIs' orbax checkpoints and the port's state-dict .pt files; three
    seeded PNG images with filled rotated boxes; the mini DOTA data.yaml."""
    root = tmp_path_factory.mktemp("detect")
    jm, jmeta, v = _jax_model()
    rng = np.random.default_rng(4)
    v2 = jax.tree.map(
        lambda a: (a * rng.uniform(0.97, 1.03, a.shape)).astype(np.float32)
        if a.ndim == 4 else a, v)
    port, meta = _port(v)
    for name, vv in (("w", v), ("w2", v2)):
        jax_save_weights(root / name, vv["params"], vv["batch_stats"],
                         {"cfg": "yolov5n.yaml"})
        torch.save(from_jax_variables(vv, port.specs), root / f"{name}.pt")
    src = build_mini_dota(root / "dota", n_images=3, n_boxes=6,
                          hw=(120, 150), seed=11)
    (root / "data.yaml").write_text(
        f"path: {src}\ntrain: images\nval: images\nnc: {NC}\n"
        f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    return types.SimpleNamespace(root=root, jm=jm, jmeta=jmeta, v=v, v2=v2,
                                 port=port, meta=meta, src=src,
                                 data=root / "data.yaml")


def test_decode_matches_jax(det):
    """Seeded 5-D Detect maps of a non-square input (96 x 128), flattened as
    the port's Detect lays them out, through both decodes."""
    rng = np.random.default_rng(0)
    no = NC + 185
    maps = [rng.normal(0, 2, (2, 96 // s, 128 // s, 3, no)).astype(np.float32)
            for s in (8, 16, 32)]
    want = np.asarray(jax_decode([jnp.asarray(m) for m in maps], det.jmeta))
    flat = [torch.from_numpy(m.reshape(2, -1, no)) for m in maps]
    got = decode(flat, det.meta, (96, 128)).numpy()
    assert got.shape == want.shape == (2, 3 * (12 * 16 + 6 * 8 + 3 * 4), no)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="cells"):
        decode(flat, det.meta, (128, 128))


def _same_dets(pd, pn, jd, jn, tie=2e-6):
    """Equal counts; per image the same rows in score order, boxes within
    1e-3 px, θ within 1e-6 (its bin: XLA folds the bin's scaling in
    another order, one float32 ulp) and class equal, scores within 1e-6;
    where neighbouring
    scores differ by less than ``tie`` the two packages may rank them
    either way, so such runs compare as sets."""
    np.testing.assert_array_equal(pn, jn)
    for b in range(len(jn)):
        g, w = pd[b, :jn[b]], jd[b, :jn[b]]
        assert not pd[b, jn[b]:].any()
        np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-6)
        cuts = np.flatnonzero(np.abs(np.diff(w[:, 5])) > tie) + 1
        for a, e in zip(np.r_[0, cuts], np.r_[cuts, len(w)]):
            ga = g[a:e][np.lexsort((g[a:e, 1], g[a:e, 0], g[a:e, 6]))]
            wa = w[a:e][np.lexsort((w[a:e, 1], w[a:e, 0], w[a:e, 6]))]
            np.testing.assert_allclose(ga[:, 4], wa[:, 4], atol=1e-6)
            np.testing.assert_array_equal(ga[:, 6], wa[:, 6])
            np.testing.assert_allclose(ga[:, :4], wa[:, :4], atol=1e-3)


def _predictions(rng, B=2, N=700, nc=4):
    """Decoded rows in clusters (so that suppression bites), sigmoid-like
    scores, and θ bins saturated to 1.0 at several bins in a third of the
    rows (float32 ties: the first bin wins)."""
    centers = rng.uniform(40, 600, (B, 8, 2))
    pick = rng.integers(0, 8, (B, N))
    p = np.zeros((B, N, 5 + nc + 180), np.float32)
    p[..., :2] = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.normal(0, 2, (B, N, 2))
    p[..., 2] = rng.uniform(12, 60, (B, N))
    p[..., 3] = p[..., 2] * rng.uniform(0.3, 1.0, (B, N))
    p[..., 4:5 + nc] = rng.uniform(0, 1, (B, N, 1 + nc)) ** 0.5
    p[..., 5 + nc:] = rng.uniform(0, 1, (B, N, 180))
    sat = rng.random((B, N)) < 0.33
    for b, n in zip(*np.nonzero(sat)):
        p[b, n, 5 + nc + rng.choice(180, 3, replace=False)] = 1.0
    return p


@pytest.mark.parametrize("multi_label,agnostic,classes", [
    (False, False, None), (False, True, None), (True, False, (0, 2))])
def test_non_max_suppression_obb_matches_jax(multi_label, agnostic, classes):
    nc = 4
    p = _predictions(np.random.default_rng(1), nc=nc)
    kw = dict(num_classes=nc, conf_thres=0.3, iou_thres=0.45,
              max_candidates=1024, max_det=400, multi_label=multi_label,
              agnostic=agnostic, classes=classes)
    jd, jn = (np.asarray(a) for a in jnms.non_max_suppression_obb(
        jnp.asarray(p), **kw))
    pd, pn = (a.numpy() for a in pnms.non_max_suppression_obb(
        torch.from_numpy(p), **kw))
    assert jn.min() > 40 and (jn < 400).all()
    _same_dets(pd, pn, jd, jn)
    if classes is not None:
        assert set(np.unique(pd[:, :, 6][pd[:, :, 5] > 0])) <= set(classes)
    # the saturated rows' θ is their first 1.0 bin
    sat = (p[..., 5 + nc:] == 1.0).sum(-1) >= 2
    assert sat.any()


def test_flip_theta_lr_matches_jax():
    rng = np.random.default_rng(2)
    nc = 3
    pred = rng.random((2, 9, 5 + nc + 180)).astype(np.float32)
    got = ptta._flip_theta_lr(torch.from_numpy(pred), nc)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtta._flip_theta_lr(jnp.asarray(pred), nc)))
    np.testing.assert_array_equal(ptta._flip_theta_lr(got, nc).numpy(), pred)
    one = np.zeros((1, 1, 5 + nc + 180), np.float32)
    one[0, 0, 5 + nc + 120] = 1.0  # +30° → -30°
    assert ptta._flip_theta_lr(torch.from_numpy(one), nc)[
        0, 0, 5 + nc + 60] == 1.0
    assert ptta._scale_shape(128, 0.83) == jtta._scale_shape(128, 0.83) == 96


def test_predict_tta_matches_jax(det):
    """Three scales (128, 96, 64; the two smaller ones antialiased
    bilinear), one flipped, de-scaled and clipped: within 1e-4 relative."""
    x = np.random.default_rng(3).uniform(0, 1, (1, S, S, 3)).astype(
        np.float32)
    tta = jax.jit(lambda v, xx: jtta.predict_tta(det.jm, v, det.jmeta, xx))
    want = np.asarray(tta(jax_fuse(det.v), jnp.asarray(x)))
    with torch.inference_mode():
        got = ptta.predict_tta(det.port, det.meta, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_ensemble_matches_jax(det):
    """Two members, multi-label at conf 0.01 and IoU 0.4 on a batch of 2
    (the val CLI's settings below, so that JAX compiles this once): the
    same detections as the JAX ensemble; members of another nc raise."""
    port2, meta2 = _port(det.v2)
    x = cv2.resize(cv2.imread(str(det.src / "images" / "im0.png")),
                   (S, S))[None, ..., ::-1]
    x = np.ascontiguousarray(np.concatenate([x, x[:, ::-1]]))
    kw = dict(multi_label=True, agnostic=False)
    want = jax_ensemble([(det.jm, jax_fuse(det.v), det.jmeta),
                         (det.jm, jax_fuse(det.v2), det.jmeta)],
                        0.01, 0.4, 300, **kw)(None, jnp.asarray(x))
    got = make_ensemble_predict_fn([(det.port, det.meta), (port2, meta2)],
                                   0.01, 0.4, 300, **kw)(torch.from_numpy(x))
    jd, jn = (np.asarray(a) for a in want)
    assert jn.min() > 20
    _same_dets(got[0].numpy(), got[1].numpy(), jd, jn)
    other, ometa = create_model("yolov5n.yaml", nc=5, device="cpu")
    with pytest.raises(ValueError, match="share nc"):
        make_ensemble_predict_fn([(det.port, det.meta), (other, ometa)],
                                 0.1, 0.45, 10)


def _jax_detect_opt(det, project, name, **kw):
    opt = dict(weights=str(det.root / "w"), cfg="yolov5n.yaml",
               source=str(det.src / "images"), data=str(det.data), imgsz=S,
               conf_thres=0.03, iou_thres=0.45, max_det=300, batch_size=1,
               save_txt=True, save_conf=True, save_crop=False, nosave=True,
               classes=None, agnostic_nms=False, hide_labels=False,
               hide_conf=False, augment=False, line_thickness=2,
               no_fuse=False, visualize=False, dtype="float32",
               vid_stride=1, max_frames=None, project=str(project),
               name=name, exist_ok=True)
    opt.update(kw)
    return types.SimpleNamespace(**opt)


def _same_label_files(pdir, jdir, tie=2e-6):
    """The same files; in each the same lines in score order (classes
    equal, coordinates within 1e-3 px, conf within 1e-5), near-tied scores
    compared as sets."""
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in pdir.iterdir())
    n = 0
    for name in names:
        want = np.array(_read_rows(jdir / name), float).reshape(-1, 10)
        got = np.array(_read_rows(pdir / name), float).reshape(-1, 10)
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, 9], want[:, 9], atol=1e-5)
        cuts = np.flatnonzero(np.abs(np.diff(want[:, 9])) > tie) + 1
        for a, e in zip(np.r_[0, cuts], np.r_[cuts, len(want)]):
            ga = got[a:e][np.lexsort((got[a:e, 2], got[a:e, 1], got[a:e, 0]))]
            wa = want[a:e][np.lexsort((want[a:e, 2], want[a:e, 1],
                                       want[a:e, 0]))]
            np.testing.assert_array_equal(ga[:, 0], wa[:, 0])
            np.testing.assert_allclose(ga[:, 1:9], wa[:, 1:9],
                                       atol=1e-3 + 1e-9)
        n += len(want)
    return n


@pytest.mark.parametrize("case", ["crops_features_classes", "augment"])
def test_detect_cli_matches_jax(det, tmp_path, case, monkeypatch,
                                no_jax_init):
    """``python -m yolov5_obb_tpu_torch.detect --device cpu`` against the
    JAX root ``detect.run`` on 3 seeded PNGs: the same label files (with
    ``--augment``; with ``--classes`` and ``--agnostic-nms``), and with
    ``--save-crop`` the same crops (the same files and sizes; the
    polygons agree within 1e-3 px, so a warped pixel may round one step the
    other way), with ``--visualize`` the same layers' maps, of the same
    shapes, handed to ``feature_visualization`` (recorded here instead of
    drawn: ``test_torch_port_api.py`` holds the drawing to the JAX
    package's)."""
    import detect as jax_detect
    import yolov5_obb_tpu.utils.plots as jplots
    import yolov5_obb_tpu_torch.utils.plots as pplots

    shown = {"jax": [], "port": []}
    for key, mod in (("jax", jplots), ("port", pplots)):
        monkeypatch.setattr(
            mod, "feature_visualization",
            lambda x, name, d, key=key: shown[key].append(
                (name, tuple(x.shape), Path(d).parent.name)))

    keep = [0, 2, 5, 6, 9, 10, 12]
    flags = {"crops_features_classes": dict(
        save_crop=True, visualize=True, classes=keep, agnostic_nms=True),
        "augment": dict(augment=True)}[case]
    jax_detect.run(_jax_detect_opt(det, tmp_path, "jax", **flags))
    argv = ["--weights", str(det.root / "w.pt"), "--source",
            str(det.src / "images"), "--data", str(det.data), "--imgsz",
            str(S), "--conf-thres", "0.03", "--max-det", "300", "--save-txt",
            "--save-conf", "--nosave", "--device", "cpu", "--project",
            str(tmp_path), "--name", "port", "--exist-ok"]
    for k, val in flags.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] + ([str(c) for c in val] if isinstance(val, list)
                          else [])
    port_detect.main(argv)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    n = _same_label_files(pdir / "labels", jdir / "labels")
    assert n >= 10
    assert not list(pdir.glob("*.png"))
    if case == "crops_features_classes":
        cls = np.concatenate([np.array(_read_rows(f), float).reshape(-1, 10)
                              [:, 0] for f in (pdir / "labels").iterdir()])
        assert set(cls.astype(int)) <= set(keep)
        crops = sorted(p.relative_to(jdir / "crops")
                       for p in (jdir / "crops").rglob("*.png"))
        assert crops and crops == sorted(
            p.relative_to(pdir / "crops")
            for p in (pdir / "crops").rglob("*.png"))
        for c in crops:  # polys within 1e-3 px: a warp may round a pixel
            g = cv2.imread(str(pdir / "crops" / c)).astype(int)
            w = cv2.imread(str(jdir / "crops" / c)).astype(int)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1 and (g != w).mean() <= 1e-3
        assert [x[:2] for x in shown["port"]] == [x[:2] for x in shown["jax"]]
        assert [x[0] for x in shown["jax"]][:4] == ["m0", "m1", "m10", "m11"]
        assert len(shown["jax"]) == 8
        assert {x[2] for x in shown["jax"]} == {"jax"}
        assert {x[2] for x in shown["port"]} == {"port"}


@pytest.mark.parametrize("case", ["augment", "ensemble"])
def test_val_cli_augment_and_ensemble_match_jax(det, tmp_path, case,
                                                no_jax_init):
    """The val CLI with ``--augment``, and with ``--weights w.pt,w2.pt``,
    against the JAX val.py: the same metrics, JSON rows and label files;
    the port draws its default plots from the augmented and the ensemble
    runs too."""
    import val as jax_val

    weights = (str(det.root / "w") if case == "augment"
               else f"{det.root / 'w'},{det.root / 'w2'}")
    pweights = (str(det.root / "w.pt") if case == "augment"
                else f"{det.root / 'w.pt'},{det.root / 'w2.pt'}")
    want = jax_val.run(types.SimpleNamespace(
        cfg="yolov5n.yaml", data=str(det.data), task="val", imgsz=S,
        batch_size=2, conf_thres=0.01, iou_thres=0.4, max_det=300,
        max_images=None, save_json=True, save_txt=True, save_conf=True,
        save_task1=False, rect_pad=0.0, single_cls=False, dtype="float32",
        no_fuse=False, project=str(tmp_path), exist_ok=True, weights=weights,
        name="jax", augment=case == "augment", no_plots=True,
        coco_eval=False, mesh=0, hyp=None))
    got = port_val.main(
        ["--weights", pweights, "--data", str(det.data), "--imgsz", str(S),
         "--batch-size", "2", "--max-det", "300", "--save-json",
         "--save-txt", "--save-conf", "--device", "cpu", "--project",
         str(tmp_path), "--name", "port", "--exist-ok"]
        + (["--augment"] if case == "augment" else []))
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    rows = json.loads((jdir / "best_obb_predictions.json").read_text())
    assert len(rows) > 50
    _same_json_rows(
        json.loads((pdir / "best_obb_predictions.json").read_text()), rows)
    names = sorted(p.name for p in (jdir / "labels").iterdir())
    assert names == sorted(p.name for p in (pdir / "labels").iterdir())
    for name in names:
        _same_rows(_read_rows(pdir / "labels" / name),
                   _read_rows(jdir / "labels" / name), 1)
    assert sorted(p.name for p in pdir.glob("*.png")) == [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
        "confusion_matrix.png"]


def test_detect_cli_skips_an_empty_file(det, tmp_path, capsys):
    """A zero-byte ``.png`` in the source directory is skipped as
    unreadable (JAX detect.py:118-121) and the other images are read: one
    label file, for the image that decodes."""
    src = tmp_path / "src"
    src.mkdir()
    good = sorted((det.src / "images").glob("*.png"))[0]
    (src / good.name).write_bytes(good.read_bytes())
    (src / "empty.png").write_bytes(b"")
    port_detect.main(
        ["--weights", str(det.root / "w.pt"), "--source", str(src),
         "--data", str(det.data), "--imgsz", str(S), "--conf-thres",
         "0.03", "--save-txt", "--nosave", "--device", "cpu", "--project",
         str(tmp_path), "--name", "port", "--exist-ok"])
    assert f"skipping unreadable {src / 'empty.png'}" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "port" / "labels").iterdir()] == [
        good.with_suffix(".txt").name]
