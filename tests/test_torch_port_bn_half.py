"""``--bn-half`` (``YOLO_BN_HALF=1``) on the port's train path against the
JAX package's, on the CPU, with ``from_jax_variables`` weights.

Under the flag both packages cast the train-mode BatchNorm output to
bfloat16 (statistics, normalisation, scale and shift in float32) and run
SiLU in bfloat16, each op rounded; the fused train region's hand-off to
layer 4 casts its operands first (JAX yolo.py:427-429).  Eval mode and the
running statistics stay float32.  The JAX reference runs in a process of its
own, this file run as a script (:func:`_reference_main`), with XLA's excess
precision off: by default XLA on the CPU keeps an elementwise chain's
float32 intermediates and skips the bf16 roundings that
``BatchNorm(dtype=bfloat16)`` and the bf16 SiLU stand for, and that flag is
read once, when JAX starts its backend.  Inputs are made with numpy from a
seed; every comparison states its tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from yolov5_obb_tpu_torch import train as port_train
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.engine.optim import build_optimizer
from yolov5_obb_tpu_torch.engine.trainer import (
    create_train_state,
    make_train_step,
)
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
NC, B = 3, 2


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _fill(seed):
    """numpy-seeded variables of a model's tree (as tests/test_torch_port_
    train.py makes them)."""
    rng = np.random.default_rng(seed)

    def fill_one(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(sd.shape)
                    / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, sd.shape).astype(np.float32)
        return rng.normal(0, 0.1, sd.shape).astype(np.float32)
    return fill_one


def _batch(S, seed):
    """One seeded batch: the packed uint8 image, targets, mask."""
    rng = np.random.default_rng(seed + 10)
    img = rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8)
    tg = np.zeros((B, 8, 186), np.float32)
    tg[:, :3, 0] = rng.integers(0, NC, (B, 3))
    tg[:, :3, 1:3] = rng.uniform(S / 4, 3 * S / 4, (B, 3, 2))
    tg[:, :3, 3:5] = rng.uniform(S / 8, S / 3, (B, 3, 2))
    tg[:, :3, 5] = rng.uniform(-1.5, 1.5, (B, 3))
    tg[:, :3, 6:] = rng.uniform(0, 1, (B, 3, 180))
    mask = np.zeros((B, 8), bool)
    mask[:, :3] = True
    return img.reshape(B, S, 3 * S), tg, mask


def _jax_model(S, fused, seed):
    """The packed-stem bf16 yolov5n (``fused_train`` or stock), its meta
    and its numpy-seeded variables."""
    import jax
    import jax.numpy as jnp

    from yolov5_obb_tpu.models.yolo import build_model, probe_strides

    jm, jmeta, _ = build_model("yolov5n.yaml", nc=NC, dtype=jnp.bfloat16,
                               packed_stem=True, fused_train=fused)
    jmeta = probe_strides(jm, jmeta, imgsz=S)
    v = jax.tree.map(np.asarray, dict(jax.tree_util.tree_map_with_path(
        _fill(seed), jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, S, 3 * S), jnp.uint8)))))
    return jm, jmeta, v


def _reference_main(S, fused, seed, out):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from yolov5_obb_tpu.engine.loss import ComputeLoss
    from yolov5_obb_tpu.utils.general import load_hyp, scale_hyp_gains

    jm, jmeta, v = _jax_model(S, fused, seed)
    loss_fn = ComputeLoss(jmeta, scale_hyp_gains(load_hyp(), jmeta.nl, NC,
                                                 S))

    def fwd(v, x, tg, mask):
        outs, mut = jm.apply(v, x, train=True, flat=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True)
        return (outs, loss_fn(outs, tg, mask)[0], mut["batch_stats"],
                {k: t["__call__"][0] for k, t in mut["intermediates"].items()
                 if k.startswith("m") and not isinstance(
                     t["__call__"][0], (list, tuple))})

    outs, loss, stats, layers = jax.jit(fwd)(
        jax.tree.map(jnp.asarray, v), *map(jnp.asarray, _batch(S, seed)))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    np.savez(out, loss=float(loss),
             **{f"out{i}": f32(o) for i, o in enumerate(outs)},
             **{f"layer{k[1:]}": f32(t) for k, t in layers.items()},
             **{"stat/" + "/".join(k): np.asarray(t) for k, t in
                flatten_dict(jax.tree.map(np.asarray, stats)).items()})


def _reference(S, fused, seed, tmp):
    """The JAX bn-half forward (:func:`_reference_main` in a process of its
    own) and the port
    model with the same weights, its meta, the batch and the
    hyperparameters."""
    out = tmp / f"ref_{S}_{int(fused)}_{seed}.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])
    proc = subprocess.run(
        [sys.executable, __file__, str(S), str(int(fused)), str(seed),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(out))
    _, _, v = _jax_model(S, fused, seed)
    model, meta = create_model("yolov5n.yaml", nc=NC, dtype=torch.bfloat16,
                               device="cpu", packed_stem=True,
                               fused_train=fused)
    model.load_state_dict(from_jax_variables(v, model.specs))
    stats = unflatten_dict({tuple(k.split("/")[1:]): t for k, t in ref.items()
                            if k.startswith("stat/")})
    ref["stats"] = from_jax_variables({"params": v["params"],
                                       "batch_stats": stats}, model.specs)
    hyp = scale_hyp_gains(load_hyp(), meta.nl, NC, S)
    return ref, v, model, meta, _batch(S, seed), hyp


@pytest.fixture(autouse=True)
def _flag_restored():
    """Every test leaves YOLO_BN_HALF as it found it: a flag left set would
    put every later test in the process on the bf16 path."""
    before = os.environ.get("YOLO_BN_HALF")
    yield
    assert os.environ.get("YOLO_BN_HALF") == before


@pytest.fixture(scope="module")
def stock(tmp_path_factory):
    """yolov5n at 64², bf16, packed stem, stock train path."""
    return _reference(64, False, 3, tmp_path_factory.mktemp("bnh"))


def test_bn_dtype_reads_the_flag(monkeypatch):
    monkeypatch.delenv("YOLO_BN_HALF", raising=False)
    assert layers.bn_dtype() == torch.float32
    monkeypatch.setenv("YOLO_BN_HALF", "1")
    assert layers.bn_dtype() == torch.bfloat16
    monkeypatch.setenv("YOLO_BN_HALF", "0")
    assert layers.bn_dtype() == torch.float32


def test_bf16_silu_rounds_each_op():
    """In bf16 the port's SiLU is the JAX graph's ``x · (1 / (1 +
    exp(-x)))`` with every op rounded; in float32 it stays
    ``x · sigmoid(x)``."""
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 4096)
                         .astype(np.float32))
    xb = x.to(torch.bfloat16)
    want = xb * (1 / (1 + torch.exp(-xb)))
    assert torch.equal(layers.silu(xb), want)
    assert not torch.equal(want, xb * torch.sigmoid(xb))
    assert torch.equal(layers.silu(x), x * torch.sigmoid(x))


def _run_layers(model, x, ref):
    """Each layer of one train-mode forward, fed the JAX layers' outputs
    as its inputs: the outputs and the running statistics after it (the
    buffers are put back)."""
    saved = {k: b.clone() for k, b in model.named_buffers()}
    model.train()
    outs = []
    with torch.no_grad():
        for i, (spec, m) in enumerate(zip(model.specs, model.model)):
            def fetch(j, i=i):
                if i == 0:
                    return x
                k = i - 1 if j == -1 else j
                return torch.from_numpy(ref[f"layer{k}"]).to(torch.bfloat16)
            f = spec.frm
            h = fetch(f) if isinstance(f, int) else [fetch(j) for j in f]
            for r in (m if isinstance(m, torch.nn.Sequential) else [m]):
                h = r(h)
            outs.append(h)
    stats = {k: b.clone() for k, b in model.named_buffers()
             if "running" in k}
    model.eval()
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(saved[k])
    return outs, stats


def test_bn_half_forward_matches_jax(stock, monkeypatch):
    """One train-mode forward under YOLO_BN_HALF=1, layer by layer, each
    layer fed the JAX layers' outputs (one bf16 rounding apart anywhere
    compounds over 24 random-weight layers): every layer's output, the
    Detect maps last, within 2 bf16 ulps of its largest value; the running
    statistics within 1e-5 of their scale (measured up to 1.8e-6: a bf16
    conv output rounds differently where the two frameworks sum in another
    order), the stem's within 1e-4 (the JAX bf16 fallback rounds the stem
    taps to bf16, the port's plain version keeps them float32, as its
    kernel's split-weight products do: 7.3e-5 on this input, with or
    without the flag).  The stem, the stock convs and the down-train path
    all run.  The same forward without the flag misses the reference: the
    bars tell the two apart."""
    ref, _, model, _, (img, _, _), _ = stock
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    x = torch.from_numpy(img)
    wants = [ref[f"layer{i}"] for i in range(24)] + [
        [ref[f"out{k}"] for k in range(3)]]

    def errors(half):
        monkeypatch.setenv("YOLO_BN_HALF", "1" if half else "0")
        outs, stats = _run_layers(model, x, ref)
        assert len(outs) == len(wants) == 25
        ulps = []
        for i, (got, want) in enumerate(zip(outs, wants)):
            for g, w in (zip(got, want) if i == 24 else [(got, want)]):
                g = _np(g)
                assert g.shape == w.shape, i
                ulps.append(np.abs(g - w).max() / (np.abs(w).max() / 128))
        stat = max(np.abs(_np(t) - _np(ref["stats"][k])).max()
                   / max(np.abs(_np(ref["stats"][k])).max(), 1.0)
                   / (10.0 if k.startswith("model.0.") else 1.0)
                   for k, t in stats.items())
        assert stats.keys() == {k for k in ref["stats"] if "running" in k}
        return np.array(ulps), stat

    ulps, stat = errors(True)
    assert ulps.max() <= 2.0, ulps.round(2).tolist()
    assert stat <= 1e-5, stat
    ulps_f32, _ = errors(False)
    assert ulps_f32.max() > 2.0 or (ulps_f32 > 0).sum() > 2 * (ulps > 0).sum()


def _port_first_loss(model, meta, batch, hyp):
    opt, _ = build_optimizer(model, load_hyp(), 10, 100, B, B)
    step = make_train_step(model, ComputeLoss(meta, hyp), opt, device="cpu")
    m = step(create_train_state(opt), *map(torch.from_numpy, batch))
    return float(m["loss"])


def test_bn_half_stock_step_first_loss_matches_jax(stock, monkeypatch):
    """The port's stock train step (packed stem, down-train plain versions)
    under YOLO_BN_HALF=1: its first loss within 5e-3 relative of the JAX
    bn-half loss (tests/test_bn_half.py's bar)."""
    ref, v, _, meta, bt, hyp = stock
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    monkeypatch.setenv("YOLO_BN_HALF", "1")
    model, _ = create_model("yolov5n.yaml", nc=NC, dtype=torch.bfloat16,
                            device="cpu", packed_stem=True)
    model.load_state_dict(from_jax_variables(v, model.specs))
    loss, want = _port_first_loss(model, meta, bt, hyp), float(ref["loss"])
    assert abs(loss - want) <= 5e-3 * abs(want), (loss, want)


def test_bn_half_fused_step_first_loss_matches_jax(tmp_path, monkeypatch):
    """The fused train region under YOLO_BN_HALF=1 (its bf16 hand-off) at
    128², the smallest size the JAX region's TPU shape gate takes: the
    port's first loss within 5e-3 relative of the JAX fused bn-half loss,
    and the hand-off really computes in bf16 (its output differs from the
    float32 hand-off's)."""
    ref, _, model, meta, bt, hyp = _reference(128, True, 4, tmp_path)
    assert model.fused_train
    monkeypatch.setenv("YOLO_BN_HALF", "1")
    calls = []
    real = model._fused_train_region
    monkeypatch.setattr(model, "_fused_train_region", lambda *a: (
        calls.append(real(*a)), calls[-1])[1])
    loss, want = _port_first_loss(model, meta, bt, hyp), float(ref["loss"])
    assert len(calls) == 1
    assert abs(loss - want) <= 5e-3 * abs(want), (loss, want)
    monkeypatch.setenv("YOLO_BN_HALF", "0")
    model.train()
    with torch.no_grad():
        f32 = real(torch.from_numpy(bt[0]), False)
    model.eval()
    assert not torch.equal(f32, calls[0])


def test_train_cli_bn_half_sets_the_flag(tmp_path, monkeypatch):
    """``--bn-half`` sets YOLO_BN_HALF=1 before the model is built (the
    JAX CLI's train.py:234-238); without it the flag is left alone."""
    seen = []

    def stop(*a, **k):
        seen.append(layers.bn_dtype())
        raise RuntimeError("stop")

    data = tmp_path / "data.yaml"
    (tmp_path / "images").mkdir()
    data.write_text(f"path: {tmp_path}\ntrain: images\nval: images\n"
                    "nc: 1\nnames: [x]\n")
    monkeypatch.setattr(port_train, "create_model", stop)
    monkeypatch.setattr(port_train, "DotaDataset",
                        lambda *a, **k: type("D", (), {
                            "__len__": lambda self: 4})())
    argv = ["--data", str(data), "--device", "cpu", "--project",
            str(tmp_path), "--noval", "--exist-ok"]
    # setenv first, so that monkeypatch owns the variable and its teardown
    # undoes what the CLI writes to os.environ
    monkeypatch.setenv("YOLO_BN_HALF", "0")
    monkeypatch.delenv("YOLO_BN_HALF")
    for extra, want in (([], torch.float32), (["--bn-half"],
                                               torch.bfloat16)):
        with pytest.raises(RuntimeError, match="stop"):
            port_train.main(argv + extra)
        assert seen[-1] == want


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["YOLO_BN_HALF"] = "1"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false")
    # no persistent cache: an executable compiled with excess precision
    # must not be reused
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    _reference_main(int(sys.argv[1]), sys.argv[2] == "1", int(sys.argv[3]),
                    sys.argv[4])
