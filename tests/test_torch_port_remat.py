"""The port's rematerialised train step (``make_train_step(remat=...)``) on
the CPU: full and selective remat against the stock step, bit for bit over
three float32 yolov5n 64² steps (loss items, parameters, BatchNorm running
statistics, EMA), on the stock layers and on the fused train region's
plain versions; the forward's train-kernel calls per step (twice under
full remat, once under selective); and the port's remat steps against the
JAX package's ``make_train_step(remat=True)`` and ``(remat="selective")``
on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_dp_worker import CFG, NC, S, run_steps
from yolov5_obb_tpu.engine.loss import ComputeLoss as JaxLoss
from yolov5_obb_tpu.engine.optim import build_optimizer as jax_build_optimizer
from yolov5_obb_tpu.engine.trainer import create_train_state as jax_state
from yolov5_obb_tpu.engine.trainer import make_train_step as jax_train_step
from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu.ops.geometry import csl_gaussian_labels as jax_csl
from yolov5_obb_tpu_torch.models import layers, yolo
from yolov5_obb_tpu_torch.models.yolo import build_model
from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the suite runs several workers on
    the machine's cores, and torch's default pool over all of them spins on
    these small ops (three such processes ran a step ~40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_batches(B, steps=STEPS, seed=4):
    """``steps`` global batches ``(image (B, S, 3S) uint8, targets (B, 8,
    186), mask (B, 8))`` from numpy, three live targets an image."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        img = rng.integers(0, 255, (B, S, 3 * S), dtype=np.uint8)
        tg = np.zeros((B, 8, 186), np.float32)
        mask = np.zeros((B, 8), bool)
        for b in range(B):
            for i in range(3):
                t = rng.uniform(-np.pi / 2, np.pi / 2)
                length = rng.uniform(8, 30)
                tg[b, i, :6] = [rng.integers(0, NC), *rng.uniform(8, S - 8, 2),
                                length, length * rng.uniform(0.4, 1), t]
                tg[b, i, 6:] = jax_csl(np.array([t * 180 / np.pi + 90]),
                                       radius=2.0)[0]
                mask[b, i] = True
        out.append(tuple(torch.from_numpy(a) for a in (img, tg, mask)))
    return out


def jax_packed_model(seed=3):
    """The JAX package's float32 packed-stem yolov5n at S with numpy-seeded
    variables (random BN statistics) → (model, meta, variables, the same
    weights as the port's state dict)."""
    model, meta, _ = jax_build_model(CFG, nc=NC, dtype=jnp.float32,
                                     packed_stem=True)
    meta = jax_probe_strides(model, meta, imgsz=S)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, 3 * S), jnp.uint8))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(sd.shape[:-1])
            return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, sd.shape).astype(np.float32)
        return rng.normal(0, 0.1, sd.shape).astype(np.float32)

    v = jax.tree.map(np.asarray, dict(jax.tree_util.tree_map_with_path(
        fill, shapes)))
    specs = build_model(CFG, nc=NC)[0].specs
    return model, meta, v, from_jax_variables(v, specs)


def jax_steps(model, meta, v, batches, remat=False):
    """The JAX train step from ``v`` over ``batches`` → per-step items and
    the final state."""
    hyp = load_hyp()
    B = batches[0][0].shape[0]
    tx, _ = jax_build_optimizer(v["params"], hyp, epochs=10,
                                steps_per_epoch=100, batch_size=B,
                                nominal_batch=B)
    step = jax_train_step(model, JaxLoss(meta, scale_hyp_gains(hyp, 3, NC,
                                                               S)),
                          tx, remat=remat)
    state = jax_state(jax.tree.map(jnp.asarray, v), tx)
    items = []
    for b in batches:
        state, m = step(state, *(jnp.asarray(t.numpy()) for t in b))
        items.append(np.asarray(m["items"]))
    return items, jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def weights():
    return jax_packed_model()


def _counted(monkeypatch):
    """Count the calls of the train-kernel wrappers in the forward (their
    plain versions run here): the stem and downsample train convs, and the
    fused region's passes."""
    sites = {"stem_conv_train": (layers, yolo), "down_conv_train": (layers,),
             "pass_3x3s2": (TF,), "pass_1x1": (TF,), "pass_3x3s1": (TF,)}
    calls = dict.fromkeys(sites, 0)

    def count(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    for name, mods in sites.items():
        for mod in mods:
            count(mod, name)
    return calls


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
@pytest.mark.parametrize("remat", ["full", "selective"])
def test_remat_equals_the_stock_step(weights, monkeypatch, remat, fused):
    """Three steps: loss items, parameters, BN running statistics (once a
    step: a second update in the recompute would move them) and the EMA
    equal the stock step's bit for bit.  The forward's kernels run twice a
    step under full remat, once under selective."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    sd = weights[3]
    batches = seeded_batches(2)
    calls = _counted(monkeypatch)
    ref = run_steps(sd, batches, fused=fused)
    per_step = dict(calls)
    for k in calls:
        calls[k] = 0
    got = run_steps(sd, batches, remat=remat, fused=fused)
    twice = 2 if remat == "full" else 1
    assert {k: v for k, v in calls.items()} == {
        k: twice * v for k, v in per_step.items()}
    # a step: the stem, and with the down-train gate at 0 every stride-2
    # 3x3, layers 1, 3, 5, 7 and the head's two; fused, layers 1 and 3 are
    # the pass chain's two 3x3 s2 passes, with its three 1x1 passes (C3 cv1
    # and cv2 in one, the bottleneck's cv1, cv3) and one 3x3 s1
    assert per_step == {k: STEPS * v for k, v in (
        {"stem_conv_train": 1, "down_conv_train": 4, "pass_3x3s2": 2,
         "pass_1x1": 3, "pass_3x3s1": 1} if fused else
        {"stem_conv_train": 1, "down_conv_train": 6, "pass_3x3s2": 0,
         "pass_1x1": 0, "pass_3x3s1": 0}).items()}
    assert got["items"] == ref["items"] and got["loss"] == ref["loss"]
    for key in ("state", "ema"):
        assert got[key].keys() == ref[key].keys()
        for k, t in ref[key].items():
            assert torch.equal(got[key][k], t), (key, k)
    stats = [k for k in ref["state"] if "running" in k]
    assert stats and not all(torch.equal(ref["state"][k], sd[k])
                             for k in stats)


@pytest.mark.parametrize("remat", [True, "selective"],
                         ids=["full", "selective"])
def test_remat_matches_jax(weights, monkeypatch, remat):
    """The port's remat step against the JAX package's on the same weights
    and batches: loss items within 1e-4 (test_torch_port_train's bar), the
    BN running statistics within 1e-4 of their scale.  At 64² the deep
    layers' batch statistics come from 8 to 32 values a channel, which
    amplifies the two frameworks' float32 conv rounding: the stock steps
    (no remat) differ by up to 2.2e-5 of the scale after three steps
    (measured; 8.8e-6 after one)."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    model, meta, v, sd = weights
    batches = seeded_batches(2)
    jitems, jstate = jax_steps(model, meta, v, batches, remat=remat)
    got = run_steps(sd, batches, remat="full" if remat is True else remat)
    np.testing.assert_allclose(np.asarray(got["items"]), np.stack(jitems),
                               rtol=1e-4)
    jsd = from_jax_variables({"params": jstate.params,
                              "batch_stats": jstate.batch_stats},
                             build_model(CFG, nc=NC)[0].specs)
    for k, want in jsd.items():
        if "running" in k:
            err = float((got["state"][k] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (k, err)
