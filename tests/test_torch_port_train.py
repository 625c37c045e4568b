"""The train slice on the CPU: the port's train-kernel plain versions, loss,
optimizer and train step against the JAX package's, inputs made with numpy
and weights carried across with ``from_jax_variables``.

The JAX train kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode); the whole-model steps compare the port's plain
versions with the JAX stock path, which computes the same function.  TF32
plays no part here (CPU), and every comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov5_obb_tpu.engine.loss import ComputeLoss as JaxLoss
from yolov5_obb_tpu.engine.optim import build_optimizer as jax_build_optimizer
from yolov5_obb_tpu.engine.optim import make_schedules as jax_make_schedules
from yolov5_obb_tpu.engine.trainer import create_train_state as jax_state
from yolov5_obb_tpu.engine.trainer import make_train_step as jax_train_step
from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu.ops.geometry import csl_gaussian_labels as jax_csl
from yolov5_obb_tpu.ops.pallas.down_kernel import fused_down_train
from yolov5_obb_tpu.ops.pallas.stem_kernel import remap_w6, stem_conv_train
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.engine.optim import build_optimizer, make_schedules
from yolov5_obb_tpu_torch.engine.trainer import (
    create_train_state,
    make_train_step,
)
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.yolo import build_model, create_model, probe_strides
from yolov5_obb_tpu_torch.ops.geometry import csl_gaussian_labels
from yolov5_obb_tpu_torch.ops.kernels import down_kernel, stem_kernel
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables, grads_from_jax


def _np(t):
    """A jax array or a torch tensor as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _bf16_pair(a):
    """The same bf16 values as a jax array and a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


# ---------------------------------------------------------------------------
# (i) the train-kernel modules
# ---------------------------------------------------------------------------


def test_stem_train_matches_pallas():
    """Port plain version vs the JAX Pallas kernel (interpret mode) at
    B=2, 64², c2=16, with the JAX kernel test's non-uniform cotangent."""
    rng = np.random.default_rng(0)
    B, H, W, C2 = 2, 64, 64, 16
    img = rng.integers(0, 255, (B, H, W, 3)).astype(np.uint8)
    w6 = rng.normal(0, 0.05, (6, 6, 3, C2)).astype(np.float32)
    cot = rng.normal(0, 1.0, (B, H // 2, W // 2, C2)).astype(np.float32)
    xp = jnp.asarray(img.reshape(B, H, -1))

    def jloss(w6_):
        z = stem_conv_train(xp, remap_w6(w6_) / 255.0, H, W, use_pallas=True)
        return jnp.sum(z.astype(jnp.float32) * cot), z

    (_, jz), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w6))

    w = torch.from_numpy(w6).permute(3, 2, 0, 1).contiguous().requires_grad_()
    z = stem_kernel.stem_conv_train(torch.from_numpy(img).reshape(B, H, -1),
                                    w / 255.0)
    (g,) = torch.autograd.grad((z.float() * torch.from_numpy(cot)).sum(), w)
    assert z.dtype == torch.bfloat16 and z.shape == jz.shape
    # bf16 output from float32 sums taken in another order: one ulp
    want = _np(jz)
    assert np.abs(_np(z) - want).max() <= np.abs(want).max() / 128
    # dW: the same bf16 products (exact in float32), float32 sums in another
    # order
    want_g = _np(jg)
    got_g = _np(g.permute(2, 3, 1, 0))
    assert np.abs(got_g - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_down_train_matches_pallas():
    """Port plain version vs the JAX Pallas kernels (interpret mode) at
    (2, 64, 64, 16) → 32: forward, dW and dx."""
    rng = np.random.default_rng(1)
    B, H, W, ci, co = 2, 64, 64, 16, 32
    jx, tx = _bf16_pair(rng.standard_normal((B, H, W, ci)))
    w = (rng.standard_normal((9 * ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    cot = rng.normal(0, 1.0, (B, H // 2, W // 2, co)).astype(np.float32)

    def jloss(x_, w_):
        z = fused_down_train(x_, w_, use_pallas=True)
        return jnp.sum(z.astype(jnp.float32) * cot), z

    (_, jz), (jgx, jgw) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jx, jnp.asarray(w))

    tx = tx.requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    z = down_kernel.down_conv_train(tx, tw)
    gx, gw = torch.autograd.grad((z.float() * torch.from_numpy(cot)).sum(),
                                 (tx, tw))
    assert z.dtype == gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    want = _np(jz)
    assert np.abs(_np(z) - want).max() <= np.abs(want).max() / 128
    want_gw = _np(jgw)
    assert np.abs(_np(gw) - want_gw).max() <= 1e-4 * np.abs(want_gw).max()
    # dx: a float32 transposed conv rounded to bf16 on both sides
    want_gx = _np(jgx)
    assert (np.abs(_np(gx) - want_gx).max()
            <= np.abs(want_gx).max() / 128)


# ---------------------------------------------------------------------------
# (ii) the loss
# ---------------------------------------------------------------------------

S, NC = 128, 15


@pytest.fixture(scope="module")
def metas():
    jm, jmeta, _ = jax_build_model("yolov5n.yaml", nc=NC)
    jmeta = jax_probe_strides(jm, jmeta, imgsz=S)
    pm, pmeta, _ = build_model("yolov5n.yaml", nc=NC)
    pmeta = probe_strides(pm, pmeta, imgsz=S)
    np.testing.assert_array_equal(pmeta.anchors_grid, jmeta.anchors_grid)
    assert pmeta.strides == jmeta.strides
    return jmeta, pmeta


def _targets(rng, B, M, live, spread=True):
    """``(B, M, 186)`` targets with CSL rows and a ``(B, M)`` mask; with
    ``spread`` the live targets sit in the four corner quadrants, so no two
    claim one (cell, anchor) candidate at any level."""
    tg = np.zeros((B, M, 186), np.float32)
    mask = np.zeros((B, M), bool)
    corners = np.array([[20, 20], [108, 20], [20, 108], [108, 108]], np.float32)
    for b in range(B):
        for i in range(live):
            xy = (corners[i] + rng.uniform(-8, 8, 2) if spread
                  else rng.uniform(10, S - 10, 2))
            l = rng.uniform(8, 40)
            t = rng.uniform(-np.pi / 2, np.pi / 2)
            tg[b, i, :6] = [rng.integers(0, NC), *xy, l, l * rng.uniform(0.3, 1), t]
            tg[b, i, 6:] = jax_csl(np.array([t * 180 / np.pi + 90]), radius=2.0)[0]
            mask[b, i] = True
    return tg, mask


def _maps(rng, meta, B):
    return [(rng.standard_normal((B, int(S / s) ** 2 * meta.na, meta.no))
             * 1.5).astype(np.float32) for s in meta.strides]


@pytest.mark.parametrize("dense,extra", [
    (False, {}),
    (True, {}),
    (False, {"fl_gamma": 1.5, "label_smoothing": 0.1, "bce_blur": 0.05}),
    (True, {"qfl_gamma": 1.5}),
])
def test_loss_matches_jax(metas, dense, extra):
    """Total, items and d(total)/d(maps) of both formulations (and the
    focal, quality-focal and blur options) against the JAX ComputeLoss."""
    jmeta, pmeta = metas
    rng = np.random.default_rng(2)
    B, M = 2, 6
    maps = _maps(rng, pmeta, B)
    tg, mask = _targets(rng, B, M, live=4)
    hyp = {**scale_hyp_gains(load_hyp(), 3, NC, S), **extra}
    jl = JaxLoss(jmeta, hyp, dense=dense)
    (jt, ji), jg = jax.value_and_grad(
        lambda m: jl(m, jnp.asarray(tg), jnp.asarray(mask)), has_aux=True)(
        [jnp.asarray(m) for m in maps])

    tmaps = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, items = ComputeLoss(pmeta, hyp, dense=dense)(
        tmaps, torch.from_numpy(tg), torch.from_numpy(mask))
    grads = torch.autograd.grad(total, tmaps)
    np.testing.assert_allclose(_np(total), _np(jt), rtol=1e-5)
    np.testing.assert_allclose(_np(items), _np(ji), rtol=1e-5)
    assert (_np(items) > 0).all()
    for g, want in zip(grads, jg):
        np.testing.assert_allclose(_np(g), _np(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(_np(want)).max())


def test_angle_helpers_match_jax():
    """The target-building helpers the tests and chip_smoke.py use: CSL
    rows (truncating peak snap, wrapped window) and angle wrapping."""
    from yolov5_obb_tpu.ops.geometry import regular_theta as jax_regular
    from yolov5_obb_tpu_torch.ops.geometry import regular_theta

    rng = np.random.default_rng(5)
    theta = rng.uniform(-np.pi / 2, np.pi / 2, 64).astype(np.float32)
    deg = theta * 180 / np.pi + 90
    for radius in (2.0, 6.0):
        np.testing.assert_array_equal(csl_gaussian_labels(deg, radius=radius),
                                      jax_csl(deg, radius=radius))
    wide = rng.uniform(-10, 10, 64)
    np.testing.assert_array_equal(regular_theta(wide), jax_regular(wide))
    assert (regular_theta(wide) >= -np.pi / 2).all()
    assert (regular_theta(wide) < np.pi / 2).all()


def test_loss_targets_collide_only_when_close(metas):
    """The spread targets of the dense test claim distinct candidates (the
    dense formulation's winner on a collision is undefined); close ones do
    collide, so the guard is meaningful."""
    from yolov5_obb_tpu_torch.engine.loss import _assign_level

    _, pmeta = metas
    rng = np.random.default_rng(2)
    ag = torch.as_tensor(pmeta.anchors_grid, dtype=torch.float32)

    def collisions(tg, mask):
        n = 0
        for li, s in enumerate(pmeta.strides):
            a = _assign_level(torch.from_numpy(tg[..., 1:5]),
                              torch.from_numpy(mask), ag[li], s, int(S / s),
                              int(S / s), 4.0)
            idx = (a["cell"][:, :, None, :] * pmeta.na
                   + torch.arange(pmeta.na)[None, None, :, None])
            for b in range(tg.shape[0]):
                used = idx[b][a["mask"][b]]
                n += len(used) - len(torch.unique(used))
        return n

    assert collisions(*_targets(rng, 2, 6, live=4)) == 0
    tg, mask = _targets(rng, 2, 6, live=4)
    tg[:, 1, 1:5] = tg[:, 0, 1:5] + [1.0, 1.0, 0.0, 0.0]
    assert collisions(tg, mask) > 0


# ---------------------------------------------------------------------------
# (iii) the whole slice: one and two train steps
# ---------------------------------------------------------------------------

B = 2


@pytest.fixture(scope="module")
def jax_slice():
    """yolov5n packed-stem JAX model (float32) with numpy-seeded variables
    (random BN statistics, Detect priors as initialised) and two batches."""
    model, meta, _ = jax_build_model("yolov5n.yaml", nc=NC, dtype=jnp.float32,
                                     packed_stem=True)
    meta = jax_probe_strides(model, meta, imgsz=S)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, 3 * S), jnp.uint8))
    rng = np.random.default_rng(3)

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
    batches = []
    for _ in range(2):
        img = rng.integers(0, 255, (B, S, S, 3), dtype=np.uint8)
        tg, mask = _targets(rng, B, 6, live=4, spread=False)
        batches.append((img.reshape(B, S, -1), tg, mask))
    return model, meta, v, batches


def _jax_run(jax_slice, nominal, steps=2):
    """The JAX train step from the numpy variables: the state after each
    step and its metrics."""
    model, meta, v, batches = jax_slice
    hyp = load_hyp()
    tx, _ = jax_build_optimizer(v["params"], hyp, epochs=10,
                                steps_per_epoch=100, batch_size=B,
                                nominal_batch=nominal)
    step = jax_train_step(model, JaxLoss(meta, scale_hyp_gains(hyp, 3, NC, S)),
                          tx)
    state = jax_state(jax.tree.map(jnp.asarray, v), tx)
    out = []
    for i in range(steps):
        state, m = step(state, *map(jnp.asarray, batches[i]))
        out.append((jax.tree.map(np.asarray, state), _np(m["items"])))
    return out


def _port_run(jax_slice, nominal, monkeypatch, steps=2):
    """The port's train step, plain versions on the CPU, same weights and
    batches; the down-train gate is lowered so every stride-2 3x3 (layers 1
    and 3 among them) goes through the down-train plain versions."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    _, _, v, batches = jax_slice
    model, meta = create_model("yolov5n.yaml", nc=NC, device="cpu",
                               packed_stem=True)
    model.load_state_dict(from_jax_variables(v, model.specs))
    hyp = load_hyp()
    opt, info = build_optimizer(model, hyp, 10, 100, B, nominal)
    assert info["accumulate"] == nominal // B
    state = create_train_state(opt)
    step = make_train_step(model, ComputeLoss(meta, scale_hyp_gains(
        hyp, 3, NC, S)), opt, device="cpu")
    assert isinstance(model.model[0], layers.PackedStem)
    calls = []

    def counted(name, fn):
        def wrapper(x, *a, **k):
            calls.append((name, tuple(x.shape)))
            return fn(x, *a, **k)
        monkeypatch.setattr(layers, name, wrapper)

    counted("stem_conv_train", layers.stem_conv_train)
    counted("down_conv_train", layers.down_conv_train)
    out = []
    for i in range(steps):
        m = step(state, *map(torch.from_numpy, batches[i]))
        out.append(({k: t.clone() for k, t in model.state_dict().items()},
                    {k: t.clone() for k, t in state.ema.items()},
                    [a.clone() for a in state.opt_state.acc], _np(m["items"])))
    assert not model.training and state.step == steps
    # per step: the stem, and layers 1 (64² in) and 3 (32² in) among the
    # downsamples, on the train kernels' plain versions
    assert calls.count(("stem_conv_train", (B, S, 3 * S))) == steps
    assert calls.count(("down_conv_train", (B, 64, 64, 16))) == steps
    assert calls.count(("down_conv_train", (B, 32, 32, 32))) == steps
    return model, opt, out


def _close(got: dict, want: dict, rel: float, what: str, atol=None):
    """Every tensor within ``rel · max|want|`` (+ ``atol[k]``) of its JAX
    counterpart."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = _np(w)
        err = np.abs(_np(got[k]) - w).max()
        tol = rel * np.abs(w).max() + (atol[k] if atol else 0.0)
        assert err <= tol, (what, k, err, tol)


def _update_close(sd, jparams, before, what="update"):
    """The moves from ``before`` agree within 1e-3 of the largest; the new
    values carry one float32 rounding each (a few ulps of |p|)."""
    ulps = {k: 4 * np.finfo(np.float32).eps * np.abs(_np(t)).max()
            for k, t in before.items()}
    _close({k: sd[k] - before[k] for k in jparams},
           {k: jparams[k] - before[k] for k in jparams}, 1e-3, what, ulps)


def _params_stats(jstate, specs):
    sd = from_jax_variables({"params": jstate.params,
                             "batch_stats": jstate.batch_stats}, specs)
    return ({k: t for k, t in sd.items() if "running" not in k
             and "num_batches" not in k},
            {k: t for k, t in sd.items() if "running" in k})


def test_train_steps_match_jax(jax_slice, monkeypatch):
    """Two steps, an update each: loss items, BN running statistics
    (biased variance), parameters after the SGD update and the EMA."""
    jout = _jax_run(jax_slice, nominal=B)
    model, _, pout = _port_run(jax_slice, B, monkeypatch)
    before = from_jax_variables(jax_slice[2], model.specs)
    for (jstate, jitems), (sd, ema, _, items) in zip(jout, pout):
        np.testing.assert_allclose(items, jitems, rtol=1e-4)
        jparams, jstats = _params_stats(jstate, model.specs)
        _close({k: sd[k] for k in jstats}, jstats, 1e-5, "BN statistics")
        _update_close(sd, jparams, before)
        # the EMA moves toward the new parameters: the same bar
        _update_close(ema, grads_from_jax(jstate.ema_params, model.specs),
                      before)


def test_accumulated_step_matches_jax(jax_slice, monkeypatch):
    """nominal batch = 2·batch: the first step only accumulates (its
    gradients, every parameter's, compared with JAX's), the second applies
    the mean of both."""
    jout = _jax_run(jax_slice, nominal=2 * B)
    model, opt, pout = _port_run(jax_slice, 2 * B, monkeypatch)
    before = from_jax_variables(jax_slice[2], model.specs)
    (j1, jitems1), (j2, jitems2) = jout
    (sd1, ema1, acc1, items1), (sd2, ema2, _, items2) = pout
    np.testing.assert_allclose(items1, jitems1, rtol=1e-4)
    np.testing.assert_allclose(items2, jitems2, rtol=1e-4)
    # the gradients of step 1: the accumulator holds them after one step.
    # Float32 rounding differs between the two frameworks' convs; batch-stat
    # BN over few samples amplifies it with depth (activations differ by
    # ~3e-6 of their largest at the stem, ~7e-5 at the Detect maps; the
    # gradients by a median 8e-5 and at most 1.8e-4 of each tensor's
    # largest, measured), hence 3e-4
    jgrads = grads_from_jax(j1.opt_state.acc_grads, model.specs)
    _close(dict(zip(opt.names, acc1)), jgrads, 3e-4, "grad")
    assert all(torch.equal(sd1[k], before[k]) for k in jgrads)  # no update
    jparams, jstats = _params_stats(j2, model.specs)
    _close({k: sd2[k] for k in jstats}, jstats, 1e-5, "BN statistics")
    _update_close(sd2, jparams, before)
    _update_close(ema2, grads_from_jax(j2.ema_params, model.specs), before)


# ---------------------------------------------------------------------------
# (iv) the optimizer alone
# ---------------------------------------------------------------------------

# port parameter name → JAX tree path (HWIO kernels), one of each kind:
# a decayed conv kernel, a BN scale, a BN bias, a Detect kernel and bias
_TOY = {
    "model.0.conv.weight": ("m0", "Conv_0", "kernel", (3, 3, 2, 4)),
    "model.0.bn.weight": ("m0", "BatchNorm_0", "scale", (4,)),
    "model.0.bn.bias": ("m0", "BatchNorm_0", "bias", (4,)),
    "model.1.m.0.weight": ("m1", "conv0", "kernel", (1, 1, 4, 6)),
    "model.1.m.0.bias": ("m1", "conv0", "bias", (6,)),
}


def _oihw(a, shape):
    """A JAX leaf of ``shape`` in the port's layout (HWIO → OIHW)."""
    return a.transpose(3, 2, 0, 1) if len(shape) == 4 else a


def _toy_tree(arrays):
    tree = {}
    for name, (m, sub, leaf, _) in _TOY.items():
        tree.setdefault(m, {}).setdefault(sub, {})[leaf] = jnp.asarray(
            arrays[name])
    return tree


class _Toy(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.model = torch.nn.ModuleList([
            layers.ConvBnAct(2, 4, 3),
            torch.nn.ModuleDict({"m": torch.nn.ModuleList(
                [torch.nn.Conv2d(4, 6, 1)])})])
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(torch.from_numpy(_oihw(arrays[name], _TOY[name][3])))


@pytest.mark.parametrize("steps,nominal,use_adam,freeze", [
    (105, 4, False, 0),   # through the warmup (100 updates), epochs of 30
    (12, 8, False, 0),    # accumulation: an update every 2 steps
    (12, 4, True, 0),     # Adam
    (6, 4, False, 1),     # layer 0 frozen
])
def test_optimizer_matches_optax(steps, nominal, use_adam, freeze):
    rng = np.random.default_rng(4)
    hyp = {**load_hyp(), "lr0": 0.05}
    arrays = {k: rng.standard_normal(v[3]).astype(np.float32)
              for k, v in _TOY.items()}
    tx, jinfo = jax_build_optimizer(_toy_tree(arrays), hyp, epochs=5,
                                    steps_per_epoch=30, batch_size=4,
                                    nominal_batch=nominal, use_adam=use_adam,
                                    freeze=freeze)
    update = jax.jit(tx.update)
    jparams = _toy_tree(arrays)
    jstate = tx.init(jparams)

    toy = _Toy(arrays)
    opt, info = build_optimizer(toy, hyp, 5, 30, 4, nominal,
                                use_adam=use_adam, freeze=freeze)
    assert (info["accumulate"], info["weight_decay"]) == (
        jinfo["accumulate"], jinfo["weight_decay"])
    assert opt.decay == [True, False, False, True, False]
    assert opt.is_bias == [False, False, True, False, True]
    state = opt.init()
    for _ in range(steps):
        g = {k: rng.standard_normal(v[3]).astype(np.float32)
             for k, v in _TOY.items()}
        u, jstate = update(_toy_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, u)
        opt.apply(state, [torch.from_numpy(_oihw(g[n], _TOY[n][3]))
                          for n in opt.names])
    assert state.count == steps // info["accumulate"]
    for name, p in toy.named_parameters():
        m, sub, leaf, shape = _TOY[name]
        want = _oihw(np.asarray(jparams[m][sub][leaf]), shape)
        np.testing.assert_allclose(_np(p), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
        if freeze and name.startswith("model.0."):
            np.testing.assert_array_equal(_np(p), _oihw(arrays[name], shape))


def test_schedules_match_jax():
    """Warmup ramps (the bias group's falls from warmup_bias_lr), the
    momentum warmup and the per-epoch one-cycle steps, at steps 0, nw−1,
    nw and past the first epochs (nw = 100 updates here)."""
    hyp = load_hyp()
    for linear in (False, True):
        ours = make_schedules(hyp, 10, 30, linear)
        theirs = jax_make_schedules(hyp, 10, 30, linear)
        for step in (0, 1, 29, 30, 99, 100, 101, 150, 299, 300, 10_000):
            for f, jf in zip(ours, theirs):
                np.testing.assert_allclose(f(step), float(jf(jnp.int32(step))),
                                           rtol=1e-6)
    lr, bias_lr, mom = make_schedules(hyp, 10, 30)
    assert lr(0) == 0.0 and bias_lr(0) == pytest.approx(0.1)
    assert mom(0) == pytest.approx(0.8) and mom(100) == pytest.approx(0.937)
