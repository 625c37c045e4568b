"""The port stands alone: it imports neither JAX nor the JAX package (nor
OpenCV at import time: the card's machine has none), and its entry points
refuse to run on the CPU unless the caller asks for it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "yolov5_obb_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import yolov5_obb_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke._named_kernels()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "yolov5_obb_tpu"
             or m.startswith("yolov5_obb_tpu.") or m == "cv2")
print(len(names), bad)
"""


def test_port_imports_no_jax_in_a_fresh_process():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    # every module of the package but its root __init__ was imported
    assert int(n) == len(list(PKG.rglob("*.py"))) - 1, out.stdout
    assert bad == "[]", out.stdout


def test_no_jax_import_in_source():
    """Static check of every port source and chip_smoke.py, including the
    imports inside functions that the fresh-process test does not reach."""
    paths = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "yolov5_obb_tpu"), \
                    f"{path.relative_to(ROOT)}:{node.lineno} imports {m}"
    assert len(paths) >= 20


def test_entry_points_need_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is allowed to run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("yolov5n.yaml", nc=15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("yolov5n.yaml", nc=15, device="cuda")
    model, meta = create_model("yolov5n.yaml", nc=15, device="cpu",
                               packed_stem=True)
    assert next(model.parameters()).device.type == "cpu"
    predict = make_predict_fn(model, meta, 0.25, 0.45, 100, multi_label=False)
    dets, num = predict(torch.zeros(1, 64, 64 * 3, dtype=torch.uint8))
    assert dets.shape == (1, 100, 7) and num.shape == (1,)


def test_train_step_needs_the_card_unless_cpu_is_asked():
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import make_train_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is allowed to run")
    model, meta = create_model("yolov5n.yaml", nc=15, device="cpu",
                               packed_stem=True)
    opt, _ = build_optimizer(model, {}, 1, 1, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, ComputeLoss(meta), opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, ComputeLoss(meta), opt, device="cuda")
    make_train_step(model, ComputeLoss(meta), opt, device="cpu")
    for kw in ({"remat": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            make_train_step(model, ComputeLoss(meta), opt, device="cpu", **kw)


def test_fused_train_model_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is allowed to run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("yolov5n.yaml", nc=15, packed_stem=True, fused_train=True)
    model, _ = create_model("yolov5n.yaml", nc=15, device="cpu",
                            packed_stem=True, fused_train=True)
    assert model.fused_train and next(model.parameters()).device.type == "cpu"


def test_predict_defaults_to_multi_label_like_jax():
    """The JAX package's make_predict_fn defaults to multi-label; so does
    the port's: the default gives the multi-label detections, and
    single-label is asked for with ``multi_label=False``."""
    from yolov5_obb_tpu_torch.ops import rotated_nms

    model, meta = create_model("yolov5n.yaml", nc=15, device="cpu",
                               packed_stem=True)
    seen = []
    real = rotated_nms.exact_select_pairs
    try:
        rotated_nms.exact_select_pairs = lambda *a: seen.append(1) or real(*a)
        x = torch.zeros(1, 64, 64 * 3, dtype=torch.uint8)
        d, n = make_predict_fn(model, meta, 0.001, 0.45, 100)(x)
        dm, nm = make_predict_fn(model, meta, 0.001, 0.45, 100,
                                 multi_label=True)(x)
        assert len(seen) == 2
        make_predict_fn(model, meta, 0.001, 0.45, 100, multi_label=False)(x)
        assert len(seen) == 2
    finally:
        rotated_nms.exact_select_pairs = real
    assert torch.equal(d, dm) and torch.equal(n, nm)


def test_packed_stem_layer_refuses_eval_mode():
    """In eval mode the packed stem is the stem kernel (``fused_stem``;
    its plain version on the CPU) and refuses anything but the packed
    ``(B, H, 3W)`` uint8 image; a model whose layer 1 cannot join the stem
    (yolov5s-ghost) builds packed."""
    model, _ = create_model("yolov5n.yaml", nc=15, device="cpu",
                            packed_stem=True)
    y = model.model[0](torch.zeros(1, 64, 64 * 3, dtype=torch.uint8))
    assert y.shape == (1, 32, 32, model.model[0].conv.out_channels)
    with pytest.raises(ValueError, match="packed"):
        model.model[0](torch.zeros(1, 64, 64, 3))
    ghost, _ = create_model("yolov5s-ghost.yaml", nc=15, device="cpu",
                            packed_stem=True)
    assert ghost.packed_stem and not ghost.packed_l1


_IMPORT_GOLDEN = """
import sys
import yolov5_obb_tpu_torch.tools.golden_e2e
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yolov5_obb_tpu",
                                    "cv2", "matplotlib", "orbax"))
print(bad)
"""


def test_golden_harness_stands_alone(tmp_path):
    """tools/golden_e2e.py imports nothing of JAX or the JAX package (nor
    OpenCV or matplotlib before a call needs them), and its CLI stops
    before writing anything when no card is visible and the CPU was not
    asked for."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_GOLDEN], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    src = (PKG / "tools" / "golden_e2e.py").read_text()
    assert "yolov5_obb_tpu." not in src.replace("yolov5_obb_tpu_torch", "")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is allowed to run")
    from yolov5_obb_tpu_torch.tools import golden_e2e

    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden_e2e.main(["--out", str(tmp_path / "g"), "--quick"])
    assert not (tmp_path / "g").exists()
