"""The port's golden accuracy harness (``yolov5_obb_tpu_torch/tools/
golden_e2e.py``) against the JAX package's ``tools/golden_e2e.py`` on the
CPU: the synthetic set and the configs byte for byte, a tiny flow from PNG
files through the port's CLIs, the converted golden yolov5n as committed
and its detections on golden tiles against the JAX package's; and, marked
``slow`` and ``nightly``, the JAX nightly's two convergence runs on the
port with the same floors."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import golden_e2e as jax_golden  # noqa: E402

from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset  # noqa: E402
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn  # noqa: E402
from yolov5_obb_tpu_torch.models.yolo import create_model  # noqa: E402
from yolov5_obb_tpu_torch.tools import golden_e2e as port_golden  # noqa: E402
from yolov5_obb_tpu_torch.utils.checkpoint import load_weights  # noqa: E402

GOLDEN = ROOT / "releases" / "golden_yolov5n_192"
GOLDEN_PT = ROOT / "releases" / "golden_yolov5n_192_torch"
KEYS = {"golden_obb_map", "hbb_map50", "maoe_deg", "maoe_classes", "tiles",
        "epochs", "imgsz", "classaps"}


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_generate_raw_and_configs_match_jax(tmp_path, hard):
    """The PNGs, label files, data.yaml and hyp.yaml byte for byte."""
    for tag, mod in (("jax", jax_golden), ("port", port_golden)):
        mod.generate_raw(tmp_path / tag / "raw", n_images=2, size=256,
                         grid=4, seed=5, hard=hard)
        mod.write_configs(tmp_path / tag, tmp_path / "split",
                          {"lr0": 0.025, "theta": 1.0})
    jax_files, port_files = (_files(tmp_path / t) for t in ("jax", "port"))
    assert sorted(port_files) == sorted(jax_files) == [
        "data.yaml", "hyp.yaml", "raw/images/G000.png",
        "raw/images/G001.png", "raw/labelTxt/G000.txt",
        "raw/labelTxt/G001.txt"]
    for name, data in jax_files.items():
        assert port_files[name] == data, name
    assert len(jax_files["raw/labelTxt/G000.txt"].splitlines()) > 10


def _rows(path: Path):
    """A Task1 file's rows → (stem, conf, 8 coordinates), each parsed."""
    out = []
    for line in path.read_text().splitlines():
        stem, conf, *poly = line.split()
        out.append((stem, float(conf), [float(v) for v in poly]))
        assert len(poly) == 8 and 0.0 < out[-1][1] <= 1.0
    return out


def test_tiny_flow_from_png_files(tmp_path):
    """run_flow on the CPU at a tiny size (2 images at 256², tiles of 128
    at gap 32, 64 px, 2 epochs, batch 2, autoanchor and the augmentation
    on): every key of the JAX harness, the train CLI's plots and raw
    weights; then the committed golden model through the same val, merge
    and eval on the flow's tiles (128 px), whose merged rows parse and
    score."""
    out = tmp_path / "flow"
    res = port_golden.run_flow(out, n_images=2, raw_size=256, subsize=128,
                               gap=32, imgsz=64, epochs=2, batch=2,
                               device="cpu")
    assert KEYS <= set(res)
    assert (res["tiles"], res["epochs"], res["imgsz"]) == (18, 2, 64)
    assert set(res["classaps"]) == set(DOTA_V1_NAMES)
    assert set(res["seconds"]) == {"split", "train", "val", "merge", "eval"}
    run = out / "train" / "run"
    for name in ("labels.png", "train_batch0.png", "results.png",
                 "raw/state.pt", "raw/meta.json"):
        assert (run / name).is_file(), name
    assert json.loads((run / "raw" / "meta.json").read_text())["anchors"]

    got = port_golden.val_merge_eval(
        out, out / "data.yaml", out / "raw", GOLDEN_PT, imgsz=128, batch=4,
        device="cpu", name="golden", val_argv=["--no-plots"])
    rows = [r for f in sorted(got["merged"].glob("Task1_*.txt"))
            for r in _rows(f)]
    assert len(rows) > 10
    assert {r[0] for r in rows} <= {"G000", "G001"}
    assert got["golden_obb_map"] > 0.3 and got["maoe_deg"] > 0


def test_committed_golden_equals_a_fresh_conversion(tmp_path):
    """releases/golden_yolov5n_192_torch is tools/jax_ckpt_to_torch.py's
    output for releases/golden_yolov5n_192, tensor for tensor, with the
    same meta.json."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "tools" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fresh = mod.convert(GOLDEN, tmp_path / "fresh")
    want, want_meta = load_weights(fresh)
    got, got_meta = load_weights(GOLDEN_PT)
    assert got_meta == want_meta == json.loads(
        (GOLDEN / "meta.json").read_text())
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert (GOLDEN_PT / "meta.json").read_text() == (
        fresh / "meta.json").read_text()


def test_golden_detections_match_jax_on_golden_tiles(tmp_path):
    """The committed conversion on 2 tiles of the set the golden model was
    trained on (the first raw image of generate_raw(10, 768, grid 4, seed
    3), split at 384 / gap 128), at 192 px in the golden flow's val regime
    (multi-label, conf 0.01, IoU 0.4, max_det 200): the JAX package's
    detections of the orbax original in the same order, class ids exact,
    boxes within 1e-3 px and scores within 1e-5 (test_torch_port_val's
    bars)."""
    from yolov5_obb_tpu.engine.evaluator import make_predict_fn as jax_fn
    from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
    from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe
    from yolov5_obb_tpu.utils.checkpoint import load_weights as jax_load
    from yolov5_obb_tpu_torch.devkit.img_split import split_dataset

    raw = port_golden.generate_raw(tmp_path / "raw", n_images=1, size=768,
                                   grid=4, seed=3)
    assert split_dataset(raw, tmp_path / "split", rate=1.0, subsize=384,
                         gap=128, num_workers=1) == 9
    ds = DotaDataset(tmp_path / "split" / "images", DOTA_V1_NAMES,
                     img_size=192)
    img = np.stack([ds.get_eval_sample(i)["image"] for i in (0, 4)])

    v, _ = jax_load(str(GOLDEN))
    v = jax.tree.map(lambda a: np.asarray(a, np.float32), v)
    jm, jmeta, _ = jax_build_model("yolov5n.yaml", nc=15, dtype=jnp.float32)
    jmeta = jax_probe(jm, jmeta)
    jd, jn = jax_fn(jm, jmeta, 0.01, 0.4, 200)(v, jnp.asarray(img))
    jd, jn = np.asarray(jd), np.asarray(jn)

    port, meta = create_model("yolov5n.yaml", nc=15, device="cpu")
    port.load_state_dict(load_weights(GOLDEN_PT)[0])
    pd, pn = make_predict_fn(port, meta, 0.01, 0.4, 200)(
        torch.from_numpy(img))
    pd, pn = pd.numpy(), pn.numpy()
    np.testing.assert_array_equal(pn, jn)
    assert (jn > 5).all()
    for i, n in enumerate(jn):
        np.testing.assert_array_equal(pd[i, :n, 6], jd[i, :n, 6])
        np.testing.assert_allclose(pd[i, :n, :4], jd[i, :n, :4], atol=1e-3)
        np.testing.assert_allclose(pd[i, :n, 4:6], jd[i, :n, 4:6],
                                   atol=1e-5)


# the JAX nightly's two golden runs (tests/test_golden_e2e.py) on the port


@pytest.mark.slow
@pytest.mark.nightly
def test_golden_hard_tier_learns(tmp_path):
    """The hard tier (distractors near the class hues, occlusion stripes,
    overlapping same-class pairs, smaller objects) at the JAX nightly's
    setting (6 images, 400 epochs at 160 px) and floors."""
    res = port_golden.run_flow(
        tmp_path / "hard", n_images=6, raw_size=640, grid=5, hard=True,
        imgsz=160, epochs=400, batch=8, subsize=384, gap=128,
        hyp_overrides={"lr0": 0.025, "theta": 1.0}, device="cpu")
    print(json.dumps(res))
    assert res["golden_obb_map"] >= 0.09, res
    assert res["hbb_map50"] >= 0.10, res
    assert 0.0 < res["maoe_deg"] <= 45.0, res
    assert max(res["maoe_classes"].values()) <= 60.0, res


@pytest.mark.slow
@pytest.mark.nightly
def test_golden_flow_learns(tmp_path):
    """The easy tier at the JAX nightly's setting (4 images at 640², tiles
    of 384 at gap 128, 128 px, 250 epochs, batch 8, lr0 0.025) and
    floors."""
    res = port_golden.run_flow(
        tmp_path / "golden", n_images=4, raw_size=640, subsize=384, gap=128,
        imgsz=128, epochs=250, batch=8, hyp_overrides={"lr0": 0.025},
        device="cpu")
    print(json.dumps(res))
    assert res["golden_obb_map"] >= 0.12, res
    assert res["hbb_map50"] >= 0.13, res
    assert 0.0 < res["maoe_deg"] <= 55.0, res
