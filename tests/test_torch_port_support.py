"""The port's support modules against the JAX package's on the CPU:
autobatch (and ``autobatch_cuda``'s fit through an injected memory reader),
``model_info``, the profiler, the data tools, ``auto_resume``, the port's
hubconf and the W&B paths (a stub ``wandb``, as tests/test_wandb_stub.py
builds one)."""

import json
import subprocess
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import yolov5_obb_tpu.data.tools as jtools
from conftest import build_mini_dota
from test_torch_port_remat import one_torch_thread  # noqa: F401 (a fixture)
from test_wandb_stub import fake_wandb  # noqa: F401 (a fixture)
from yolov5_obb_tpu.utils import autobatch as jab
from yolov5_obb_tpu.utils.fuse import model_info as jax_model_info
from yolov5_obb_tpu.utils.loggers import Loggers as JaxLoggers
from yolov5_obb_tpu_torch import api
from yolov5_obb_tpu_torch.data import tools as ptools
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.tools import auto_resume
from yolov5_obb_tpu_torch.utils import autobatch as pab
from yolov5_obb_tpu_torch.utils import profiler
from yolov5_obb_tpu_torch.utils.checkpoint import (
    load_model_weights,
    save_weights,
)
from yolov5_obb_tpu_torch.utils.fuse import model_info
from yolov5_obb_tpu_torch.utils.loggers import Loggers

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "yolov5_obb_tpu_torch"

# ---------------------------------------------------------------------------
# autobatch
# ---------------------------------------------------------------------------

# (params, width, depth): yolov5n, yolov5m, yolov5x
MODELS = [(1_900_000, 0.25, 0.33), (21_200_000, 0.75, 0.67),
          (86_700_000, 1.25, 1.33)]


@pytest.mark.parametrize("hbm", [16 << 30, 80 << 30, 1 << 27])
@pytest.mark.parametrize("train, remat", [(True, False), (True, True),
                                          (False, False)])
def test_autobatch_matches_jax(hbm, train, remat):
    """The copied analytic estimate gives the JAX package's batch for
    every model size, image size and memory size (1 where the state alone
    does not fit)."""
    for (n, w, d), imgsz in zip(MODELS * 3, [640] * 3 + [1024] * 3
                                + [1280] * 3):
        assert pab.estimate_activation_bytes_per_image(imgsz, w, d) == \
            jab.estimate_activation_bytes_per_image(imgsz, w, d)
        kw = dict(imgsz=imgsz, width_multiple=w, depth_multiple=d,
                  hbm_bytes=hbm, train=train, remat=remat)
        assert pab.autobatch(n, **kw) == jab.autobatch(n, **kw), kw


def test_autobatch_cuda_fits_a_line_through_the_probes():
    """``autobatch_cuda``'s fit and power-of-two rounding, through an
    injected memory reader (no card): peak = 2 GB + 1.5 GB an image under
    0.85 of 80 GB fits 44 images → 32; the reader is asked at the given
    batches; memory that does not grow raises; a train probe without the
    model's meta, and a model off the card with no reader, raise."""
    model = torch.nn.Linear(1, 1)
    asked = []

    def memory(b):
        asked.append(b)
        return 2e9 + 1.5e9 * b

    assert pab.autobatch_cuda(model, memory=memory,
                              total_memory=80e9) == 32
    assert asked == [1, 2, 4]
    assert pab.autobatch_cuda(model, memory=memory, total_memory=80e9,
                              fraction=0.5, batches=(2, 8)) == 16
    assert pab.autobatch_cuda(model, memory=memory, total_memory=1e9) == 1
    with pytest.raises(ValueError, match="does not grow"):
        pab.autobatch_cuda(model, memory=lambda b: 4e9, total_memory=80e9)
    with pytest.raises(ValueError, match="meta="):
        pab.autobatch_cuda(model)
    with pytest.raises(RuntimeError, match="probes the card"):
        pab.autobatch_cuda(model, train=False)


# ---------------------------------------------------------------------------
# model_info and the profiler
# ---------------------------------------------------------------------------


def test_model_info_counts_the_jax_parameters():
    """yolov5n at nc 15: the parameter count of the JAX package's
    ``model_info`` on the golden checkpoint's variables; with an example,
    the forward's GFLOPs (``flops_of``)."""
    from yolov5_obb_tpu.utils.checkpoint import load_weights

    v, _ = load_weights("releases/golden_yolov5n_192")
    model, _ = create_model("yolov5n.yaml", nc=15, device="cpu")
    x = torch.rand(1, 256, 256, 3,
                   generator=torch.Generator().manual_seed(0))
    info = model_info(model, imgsz=256, example=(x,))
    want = jax_model_info(v)
    assert info["params"] == want["params"] > 1_000_000
    assert info["params_M"] == want["params_M"]
    gflops = round(profiler.flops_of(model, x) / 1e9, 1)
    assert info["gflops"] == gflops > 0


def test_flops_of_a_conv_and_the_timers(tmp_path):
    """``flops_of`` on one conv is 2·B·Ho·Wo·Co·Ci·k² (None where the count
    fails); ``block_and_time`` a positive median; ``trace`` writes a Chrome
    trace of the block; ``profile`` its table."""
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False)
    x = torch.rand(2, 8, 20, 20, generator=torch.Generator().manual_seed(0))
    assert profiler.flops_of(conv, x) == 2 * 2 * 20 * 20 * 16 * 8 * 9

    def fails(_):
        raise RuntimeError("no count")

    assert profiler.flops_of(fails, x) is None
    assert profiler.block_and_time(conv, x, iters=3, warmup=1) > 0
    with profiler.trace(str(tmp_path / "tr")) as d:
        conv(x)
    traces = list(Path(d).glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert any("conv" in str(n) for n in names)
    out = profiler.profile([("conv", conv, (x,))], iters=2)
    assert set(out) == {"conv"} and out["conv"] > 0


# ---------------------------------------------------------------------------
# data tools
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dota(tmp_path_factory):
    """Six mini DOTA images with labels (one without a label file), a
    data.yaml with train and val."""
    root = build_mini_dota(tmp_path_factory.mktemp("tools") / "set",
                           n_images=6, n_boxes=5, hw=(120, 150), seed=5)
    (root / "labelTxt" / "im5.txt").unlink()
    (root / "data.yaml").write_text(
        f"path: {root}\ntrain: images\nval: images\ntest: none\nnc: 15\n"
        f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    return root


@pytest.mark.parametrize("annotated_only", [False, True])
def test_autosplit_writes_the_jax_lists(dota, annotated_only):
    texts = {}
    for name, tools in (("jax", jtools), ("port", ptools)):
        paths = tools.autosplit(dota / "images", weights=(0.5, 0.3, 0.2),
                                annotated_only=annotated_only, seed=3)
        texts[name] = [p.read_text() if p.exists() else None for p in paths]
    assert texts["port"] == texts["jax"]
    assert sum(len(t.splitlines()) for t in texts["port"] if t) == (
        5 if annotated_only else 6)


def test_dataset_stats_flatten_and_extract_boxes_match_jax(dota, tmp_path):
    """``dataset_stats`` returns the JAX dict; ``flatten_recursive`` the same
    files; ``extract_boxes`` the same count, names and pixels."""
    stats = ptools.dataset_stats(dota / "data.yaml")
    assert stats == jtools.dataset_stats(dota / "data.yaml")
    assert stats["val"]["image_count"] == 6 and stats["test"] is None

    flat = {name: tools.flatten_recursive(dota, tmp_path / f"{name}_flat")
            for name, tools in (("jax", jtools), ("port", ptools))}
    listing = {k: sorted(p.name for p in v.iterdir())
               for k, v in flat.items()}
    assert listing["port"] == listing["jax"] and len(listing["port"]) > 10

    crops = {}
    for name, tools in (("jax", jtools), ("port", ptools)):
        out, n = tools.extract_boxes(dota / "images", tmp_path / f"{name}_c")
        files = sorted(p.relative_to(out) for p in out.rglob("*.jpg"))
        crops[name] = (n, files, [cv2.imread(str(out / f)) for f in files])
    (n, files, pix), (jn, jfiles, jpix) = crops["port"], crops["jax"]
    assert n == jn == len(files) > 10 and files == jfiles
    assert all(np.array_equal(a, b) for a, b in zip(pix, jpix))


# ---------------------------------------------------------------------------
# auto_resume
# ---------------------------------------------------------------------------


def test_auto_resume_prints_the_jax_decisions(tmp_path, capsys):
    """A finished run and an unfinished one: the JAX tool's decisions, with
    the port's train module in the command (with and without --data)."""
    for name, epoch in (("done", 4), ("cut", 1)):
        last = tmp_path / "runs" / name / "last"
        last.mkdir(parents=True)
        (last / "meta.json").write_text(json.dumps(
            {"epoch": epoch, "cfg": "yolov5s.yaml", "imgsz": 640}))
    (tmp_path / "runs" / "empty" / "last").mkdir(parents=True)
    for data in (["--data", "d.yaml"], []):
        argv = ["--root", str(tmp_path / "runs"), "--epochs", "5",
                "--dry-run", *data]
        want = subprocess.run([sys.executable, "tools/auto_resume.py", *argv],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=60, check=True).stdout
        auto_resume.main(argv)
        got = capsys.readouterr().out
        assert got == want.replace(
            "train.py", "-m yolov5_obb_tpu_torch.train")
        assert "finished (5/5)" in got and got.count("resume:") == 1


# ---------------------------------------------------------------------------
# hubconf and W&B
# ---------------------------------------------------------------------------


def test_hubconf_loads_the_api_model(tmp_path):
    """``torch.hub.load`` of the port's hubconf (``source="local"``) gives
    ``api.load``'s detections on the CPU; it has the five sizes and
    declares its dependencies."""
    model, _ = create_model("yolov5n.yaml", nc=15, device="cpu", seed=2)
    with torch.no_grad():  # raise the objectness: random weights detect
        for conv in model.model[-1].m:
            conv.bias.add_(4.0)
    save_weights(tmp_path / "w", model.state_dict(),
                 {"names": DOTA_V1_NAMES})
    kw = dict(weights=str(tmp_path / "w"), imgsz=64, conf_thres=0.001,
              device="cpu")
    hub = torch.hub.load(str(PKG), "yolov5n_obb", source="local", **kw)
    ref = api.load("yolov5n.yaml", **kw)
    img = np.random.default_rng(0).integers(0, 255, (80, 96, 3), np.uint8)
    got, want = hub(img).rows(), ref(img).rows()
    assert got == want and len(want[0]) > 0
    from yolov5_obb_tpu_torch import hubconf

    assert hubconf.dependencies == ["torch", "numpy", "yaml"]
    assert all(callable(getattr(hubconf, f"yolov5{s}_obb")) for s in "nsmlx")


def _stub_image(data, **kw):
    return types.SimpleNamespace(data=np.array(data))


def test_wandb_val_predictions_and_artifact_weights(
        tmp_path, fake_wandb, monkeypatch):  # noqa: F811
    """With a stub ``wandb``: ``log_val_predictions`` builds the JAX
    table's rows (the same pixels; an unreadable image skipped), and a
    ``wandb-artifact://`` reference loads the directory W&B downloads."""
    wandb = sys.modules["wandb"]
    monkeypatch.setattr(wandb, "Image", _stub_image)
    img_path = tmp_path / "img0.png"
    cv2.imwrite(str(img_path), np.full((64, 64, 3), 40, np.uint8))
    dets = [{
        "path": str(img_path),
        "polys": np.array([[10, 10, 30, 10, 30, 25, 10, 25],
                           [5, 40, 25, 35, 28, 47, 8, 52]], np.float32),
        "conf": np.array([0.9, 0.6], np.float32),
        "cls": np.array([0, 3], np.float32), "hw": (64, 64),
    }, {"path": str(tmp_path / "missing.png"), "polys": np.zeros((0, 8)),
        "conf": np.zeros(0), "cls": np.zeros(0), "hw": (64, 64)}]
    names = ["plane", "b", "c", "ship"]
    JaxLoggers(tmp_path / "j", include=("wandb",)).log_val_predictions(
        3, dets, names)
    Loggers(tmp_path / "p", include=("wandb",)).log_val_predictions(
        3, dets, names)
    (js, jrow), (ps, prow) = fake_wandb.logged
    jt, pt = jrow["val/predictions"], prow["val/predictions"]
    assert ps == js == 3 and pt.columns == jt.columns
    assert len(pt.rows) == len(jt.rows) == 1
    for a, b in zip(pt.rows[0], jt.rows[0]):
        if isinstance(a, types.SimpleNamespace):
            assert np.array_equal(a.data, b.data) and a.data.any()
        else:
            assert a == b

    model, _ = create_model("yolov5n.yaml", nc=15, device="cpu", seed=4)
    save_weights(tmp_path / "art", model.state_dict(), {"names": names})
    asked = []

    class Api:
        def artifact(self, spec):
            asked.append(spec)
            return types.SimpleNamespace(download=lambda: str(tmp_path
                                                              / "art"))

    monkeypatch.setattr(wandb, "Api", Api)
    other, ometa = create_model("yolov5n.yaml", nc=15, device="cpu", seed=5)
    got = load_model_weights(other, ometa, "wandb-artifact://e/p/m:best")
    assert asked == ["e/p/m:best"] and got["names"] == names
    for k, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], t), k


def test_train_cli_logs_the_val_predictions_table(
        dota, tmp_path, fake_wandb, monkeypatch):  # noqa: F811
    """Under ``--wandb`` (a stub ``wandb``) the train CLI logs each epoch's
    table of validation predictions, a row an image (JAX
    train.py:421-422).  TensorBoard is left out (its import takes ~20 s
    here)."""
    from yolov5_obb_tpu_torch import train

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    train.main(["--cfg", "yolov5n.yaml", "--data", str(dota / "data.yaml"),
                "--imgsz", "64", "--batch-size", "2", "--nominal-batch", "2",
                "--max-labels", "16", "--epochs", "1", "--workers", "0",
                "--dtype", "float32", "--device", "cpu", "--noautoanchor",
                "--project", str(tmp_path), "--name", "w", "--wandb"])
    tables = [(step, row["val/predictions"]) for step, row in
              fake_wandb.logged if "val/predictions" in row]
    assert len(tables) == 1 and tables[0][0] == 0
    assert [r[1] for r in tables[0][1].rows] == [f"im{i}" for i in range(6)]
