"""The port's train CLI and checkpoints against the JAX package's on the
CPU: ``results.csv`` and the anchors of one epoch from the same weights,
resume against an uninterrupted run, the val CLI on a ``best/`` directory,
the golden checkpoint converter, and the flag the port refuses."""

import csv
import json
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_mini_dota
from test_torch_port_val import _jax_model, _same_detections, _same_json_rows
from yolov5_obb_tpu_torch import train as port_train
from yolov5_obb_tpu_torch import val as port_val
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.utils.checkpoint import (
    load_weights,
    restore_model_meta,
    save_weights,
)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "releases" / "golden_yolov5n_192"
S = 64  # train and val image size


def _convert(dst, src=GOLDEN):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "tools" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main([str(src), str(dst)])


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A mini DOTA set, the golden yolov5n converted for the port, and the
    argv both CLIs take: yolov5n, 64 px, batch 2 (one update a step),
    float32, in-process loading, autoanchor and val on."""
    tmp = tmp_path_factory.mktemp("train_cli")
    root = build_mini_dota(tmp / "dota", n_images=4, n_boxes=5, seed=3)
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    port_w = _convert(tmp / "golden_pt")
    argv = ["--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz", str(S),
            "--batch-size", "2", "--nominal-batch", "2", "--max-labels", "16",
            "--workers", "0", "--dtype", "float32", "--project",
            str(tmp / "runs"), "--exist-ok", "--log-interval", "1"]
    return types.SimpleNamespace(tmp=tmp, data=data, port_w=port_w,
                                 argv=argv)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(cli):
    """One epoch of each CLI from the golden weights, whose meta.json here
    holds other anchors than the config's (``--weights`` takes the weights
    alone: both CLIs start from the config's anchors), at nominal batch 4
    (two micro-steps an update: ``x/lr0`` is read at the micro-step
    count) → (JAX run, port run, the weights' anchors)."""
    import shutil

    import train as jax_train

    src = cli.tmp / "golden_other_anchors"
    shutil.copytree(GOLDEN, src)
    meta = json.loads((src / "meta.json").read_text())
    anchors = (np.asarray(meta["anchors"]) * 1.25).tolist()
    (src / "meta.json").write_text(json.dumps({**meta, "anchors": anchors}))
    port_w = _convert(cli.tmp / "golden_other_anchors_pt", src)
    argv = cli.argv + ["--epochs", "1", "--nominal-batch", "4"]
    jax_run = jax_train.run(jax_train.parse_opt(
        argv + ["--name", "jax", "--weights", str(src)]))
    port_run = port_train.main(
        argv + ["--name", "port", "--weights", str(port_w), "--device",
                "cpu"])
    return jax_run, port_run, anchors


def test_train_cli_matches_jax(runs):
    """results.csv row for row (loss items within 1e-4 relative, metrics
    and x/lr0 within 1e-6) and the same anchors in both meta.json files:
    autoanchor's from the config's, not the weights' own."""
    (jdir, _, jmet), (pdir, _, pmet), weights_anchors = runs
    want, got = _csv(jdir / "results.csv"), _csv(pdir / "results.csv")
    assert got[0] == want[0] and len(got) == len(want) == 2
    head = got[0]
    for g, w in zip(got[1:], want[1:]):
        row = {k: (float(a), float(b)) for k, a, b in zip(head, g, w)}
        assert row["epoch"][0] == row["epoch"][1]
        for k, (a, b) in row.items():
            if k.startswith("train/"):
                assert abs(a - b) <= 1e-4 * abs(b) + 2e-6, (k, a, b)
            elif k != "epoch":
                assert abs(a - b) <= 1e-6, (k, a, b)
    for k in ("mp", "mr", "map50", "map"):
        assert abs(pmet[k] - jmet[k]) <= 1e-6, k
    jm = json.loads((jdir / "last" / "meta.json").read_text())
    pm = json.loads((pdir / "last" / "meta.json").read_text())
    assert pm == jm  # epoch, best fitness, names, cfg, imgsz, anchors
    assert np.array(pm["anchors"]).shape == (3, 3, 2)
    assert not np.allclose(pm["anchors"], weights_anchors)
    # the label, first-batch and results plots, at the JAX CLI's sizes
    import cv2

    for name in ("labels.png", "train_batch0.png", "results.png"):
        g, w = (cv2.imread(str(d / name)) for d in (pdir, jdir))
        assert g is not None and w is not None and g.shape == w.shape, name


def test_val_cli_on_a_best_directory_matches_jax(cli, runs, monkeypatch):
    """The port's val CLI reads its train CLI's best/ directory (anchors
    from its meta.json) as the JAX val.py reads the JAX best/.  Unfused, as
    the train CLI evaluates (the JAX compile then hits the cache of the
    train run's evaluate)."""
    import val as jax_val

    (jdir, _, _), (pdir, _, _), _ = runs
    common = ["--cfg", "yolov5n.yaml", "--data", str(cli.data), "--imgsz",
              str(S), "--batch-size", "2", "--save-json", "--no-fuse",
              "--project", str(cli.tmp / "val"), "--exist-ok"]
    monkeypatch.setattr("sys.argv", ["val.py", *common, "--no-plots",
                                     "--weights", str(jdir / "best"),
                                     "--name", "jax"])
    want = jax_val.run(jax_val.parse_opt())
    got = port_val.main(common + ["--weights", str(pdir / "best"),
                                  "--name", "port", "--device", "cpu",
                                  "--no-plots"])
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    rows = [json.loads((cli.tmp / "val" / n / "best_obb_predictions.json")
                       .read_text()) for n in ("port", "jax")]
    if rows[1]:
        _same_json_rows(*rows)
    else:
        assert rows[0] == []


def test_resume_is_bit_exact(cli):
    """Two epochs straight against epoch 0's checkpoint resumed for epoch
    1: parameters, EMA, BatchNorm buffers and the optimizer state equal bit
    for bit, and results.csv's second row too."""
    base = cli.argv + ["--epochs", "2", "--weights", str(cli.port_w),
                       "--device", "cpu", "--noautoanchor"]
    straight, _, _ = port_train.main(base + ["--name", "straight",
                                             "--save-period", "1"])
    resumed, _, _ = port_train.main(base + [
        "--name", "resumed", "--resume", str(straight / "epoch0")])
    a = torch.load(straight / "last" / "state.pt", weights_only=True)
    b = torch.load(resumed / "last" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 4 and a["ema_updates"] == 4
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["ema"]:
        assert torch.equal(a["ema"][k], b["ema"][k]), k
    for k in ("trace", "acc"):
        for x, y in zip(a["opt_state"][k], b["opt_state"][k]):
            assert torch.equal(x, y), k
    assert _csv(straight / "results.csv")[2] == _csv(resumed / "results.csv")[1]
    assert _csv(resumed / "results.csv")[1][0] == "1"
    # best/ (epoch 0's: the fitness stays 0) holds the EMA with the live
    # BatchNorm buffers
    sd, meta = load_weights(straight / "best")
    assert meta["cfg"] == "yolov5n.yaml" and meta["epoch"] == 0
    e0 = torch.load(straight / "epoch0" / "state.pt", weights_only=True)
    for k, v in sd.items():
        assert torch.equal(v, e0["ema"].get(k, e0["model"][k])), k


def test_golden_converter_matches_jax(cli):
    """The converted golden yolov5n gives the JAX package's detections of
    the orbax original on two mini-DOTA images, in the train CLI's
    evaluate regime (conf 0.01, IoU 0.4, 64 px, batch 2), with the Detect
    obj and class biases raised alike on both sides as
    test_torch_port_val's model has them (so that ~50 boxes an image clear
    conf 0.01); test_torch_port_val's tolerances."""
    from yolov5_obb_tpu.engine.evaluator import make_predict_fn as jax_fn

    jm, jmeta, v = _jax_model()
    port, meta = create_model("yolov5n.yaml", nc=15, device="cpu")
    sd, ckpt_meta = load_weights(cli.port_w)
    port.load_state_dict(sd)
    assert ckpt_meta == json.loads((GOLDEN / "meta.json").read_text())
    with torch.no_grad():
        for li in range(meta.nl):
            b = port.model[-1].m[li].bias.view(meta.na, meta.no)
            b[:, 4] += 2.5
            b[:, 5:5 + meta.nc] += 1.5
    ds = DotaDataset(cli.data.parent / "images", DOTA_V1_NAMES, img_size=S)
    img = np.stack([ds.get_eval_sample(i)["image"] for i in range(2)])
    jd, jn = jax_fn(jm, jmeta, 0.01, 0.4, 1500)(v, jnp.asarray(img))
    pd, pn = make_predict_fn(port, meta, 0.01, 0.4, 1500)(
        torch.from_numpy(img))
    jd, jn = np.asarray(jd), np.asarray(jn)
    np.testing.assert_array_equal(pn.numpy(), jn)
    assert (jn > 10).all()

    def recs(d, n):
        return [{"path": str(i), "hw": (S, S), "conf": d[i, :n[i], 5],
                 "cls": d[i, :n[i], 6], "polys": d[i, :n[i], :5]}
                for i in range(len(n))]

    _same_detections(recs(pd.numpy(), jn), recs(jd, jn))


def test_a_save_cut_short_keeps_the_state_with_its_own_meta(tmp_path):
    """state.pt carries its metadata: a meta.json swapped in by a save that
    stopped before its state.pt does not reach the loaders, and numpy
    values are stored as plain JSON numbers (weights_only loads them)."""
    sd = {"w": torch.arange(3.0)}
    meta = {"epoch": 1, "best_fitness": np.float64(0.5),
            "anchors": np.ones((3, 3, 2)).tolist()}
    save_weights(tmp_path / "c", sd, meta)
    (tmp_path / "c" / "meta.json").write_text(json.dumps({"epoch": 2}))
    got, got_meta = load_weights(tmp_path / "c")
    assert got_meta == {**meta, "best_fitness": 0.5}
    assert torch.equal(got["w"], sd["w"])
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == [
        "meta.json", "state.pt"]


def test_restore_model_meta_refuses_anchors_of_another_shape():
    _, meta = create_model("yolov5n.yaml", nc=15, device="cpu")
    want = meta.anchors_px.copy()
    with pytest.raises(ValueError, match="wrong --cfg"):
        restore_model_meta(meta, {"anchors": np.ones((3, 2, 2)).tolist()})
    np.testing.assert_array_equal(meta.anchors_px, want)


def test_val_cli_names_a_missing_weights_path(cli):
    missing = cli.tmp / "no_such_weights.pt"
    with pytest.raises(FileNotFoundError, match="no_such_weights"):
        port_val.main(["--data", str(cli.data), "--device", "cpu",
                       "--weights", str(missing)])


@pytest.mark.parametrize("argv", [
    ["--weights", "wandb-artifact://e/p/m:best"]], ids=["wandb_artifact"])
def test_refused_flags_name_their_roadmap_item(cli, monkeypatch, argv):
    """A ``wandb-artifact://`` reference as ``--weights`` is downloaded
    through W&B (no longer refused); without ``wandb`` it raises
    ``ImportError``."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError, match="wandb"):
        port_train.main(cli.argv + ["--device", "cpu", "--name", "refused",
                                    "--epochs", "1", *argv])


@pytest.mark.parametrize("dtype, packed", [("float32", False),
                                           ("bfloat16", True)])
def test_train_cli_packs_the_stem_on_the_card_in_bfloat16_only(
        cli, monkeypatch, dtype, packed):
    """On the card the packed stem (whose kernels compute bf16) is the
    default in bfloat16; a float32 run keeps the stock stem, as the JAX
    package's float32 model takes XLA's conv."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_create_model(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(port_train, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(port_train, "create_model", fake_create_model)
    with pytest.raises(Stop):
        port_train.main(cli.argv + ["--name", "packed", "--epochs", "1",
                                    "--dtype", dtype])
    assert seen["packed_stem"] is packed and seen["device"].type == "cuda"


def test_train_cli_needs_the_card_unless_cpu_is_asked(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is allowed to run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(cli.argv + ["--name", "nocard", "--epochs", "1"])
