"""The fused train region on the CPU: the port's stat-carrying passes (plain
versions) against the JAX package's Pallas passes (interpret mode, as
tests/test_train_fused.py runs them), a short pass chain through
``finalize_gb``, and the whole yolov5n region against JAX and against the
port's own stock train path.

Inputs are made with numpy from a seed and handed to both packages; every
comparison states its tolerance.  bf16 outputs agree to one ulp of the
largest value (the same bf16 roundings at the same places, float32 sums in
another order).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_obb_tpu.ops.pallas import train_fused as JTF
from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _pair(a, dtype=jnp.bfloat16):
    """The same values as a jax array and a torch tensor (bf16 or f32)."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, (t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t)


def _ulp_close(got, want):
    """bf16: within one ulp of the largest value."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= np.abs(want).max() / 128, (err, np.abs(want).max())


def _rel_close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err, rel,
                                                         np.abs(want).max())


def _gb(rng, c):
    return np.stack([rng.normal(1.0, 0.3, c), rng.normal(0, 0.2, c)]).astype(
        np.float32)


B, H, W, CI, CO = 2, 32, 32, 16, 24

# the three 1x1 structures of the region: (ns_flags, groups, outs, cos)
_STRUCTS = {
    # C3 cv1 + cv2: one group, two outputs
    "shared_two_outputs": ((True,), ((0,),), (((0, 0),), ((0, 1),)),
                           (CO, CO)),
    # bottleneck 1x1: the residual chain summed into one group
    "residual_group": ((True, True, True), ((0, 1, 2),), (((0, 0),),),
                       (CO,)),
    # C3 cv3: two groups, split weights into one output (and a plain input)
    "two_groups_split": ((True, True, False), ((0, 1), (2,)),
                         (((0, 0), (1, 1)),), (CO, CO)),
}


@pytest.mark.parametrize("name", sorted(_STRUCTS))
def test_pass_1x1_matches_jax(name):
    """Forward (outputs, stats) and the backward from seeded ``(dz,
    dstats)`` cotangents via ``jax.vjp``: dz_in one bf16 ulp, dW and
    (dg, db) within 1e-3 of their largest."""
    ns, groups, outs, cos = _STRUCTS[name]
    rng = np.random.default_rng(10)
    n_in = len(ns)
    zs = [_pair(rng.standard_normal((B, H, W, CI))) for _ in range(n_in)]
    gbs = [_pair(_gb(rng, CI), jnp.float32) for _ in range(n_in)]
    ws = [_pair((rng.standard_normal((CI, co)) / np.sqrt(CI)).astype(
        np.float32), jnp.float32) for co in cos]
    dz = [rng.standard_normal((B, H, W, cos[p[0][1]])) for p in outs]
    dst = [rng.normal(0, 1e-3, (2, cos[p[0][1]])).astype(np.float32)
           for p in outs]

    def jfn(z_, g_, w_):
        return JTF.pass_1x1(ns, groups, outs, tuple(z_), tuple(g_), tuple(w_))

    jargs = ([z[0] for z in zs], [g[0] for g in gbs], [w[0] for w in ws])
    (jz, jst), vjp = jax.vjp(jfn, *jargs)
    jdz, jdg, jdw = vjp((tuple(jnp.asarray(d, jnp.bfloat16) for d in dz),
                         tuple(jnp.asarray(s) for s in dst)))

    tz = [z[1].requires_grad_() for z in zs]
    tg = [g[1].requires_grad_() for g in gbs]
    tw = [w[1].requires_grad_() for w in ws]
    pz, pst = TF.pass_1x1(ns, groups, outs, tz, tg, tw)
    for a, b in zip(pz, jz):
        assert a.dtype == torch.bfloat16
        _ulp_close(a, b)
    for a, b in zip(pst, jst):
        _rel_close(a, b, 1e-4)
    cot = ([torch.from_numpy(np.array(jnp.asarray(d, jnp.bfloat16).astype(
        jnp.float32))).to(torch.bfloat16) for d in dz]
        + [torch.from_numpy(s) for s in dst])
    grads = torch.autograd.grad([*pz, *pst], [*tz, *tg, *tw], cot)
    gz, gg, gw = grads[:n_in], grads[n_in:2 * n_in], grads[2 * n_in:]
    for a, b in zip(gz, jdz):
        assert a.dtype == torch.bfloat16
        _ulp_close(a, b)
    for a, b, f in zip(gg, jdg, ns):
        if f:
            _rel_close(a, b, 1e-3)
        else:
            assert not _np(a).any() and not _np(b).any()
    for a, b in zip(gw, jdw):
        assert a.dtype == torch.float32
        _rel_close(a, b, 1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_pass_3x3_matches_jax(stride):
    """Forward and the library backward of the 3x3 passes."""
    rng = np.random.default_rng(11 + stride)
    jz, tz = _pair(rng.standard_normal((B, H, W, CI)))
    jg, tg = _pair(_gb(rng, CI), jnp.float32)
    jw, tw = _pair((rng.standard_normal((9 * CI, CO)) / np.sqrt(9 * CI))
                   .astype(np.float32), jnp.float32)
    jfn = JTF.pass_3x3s1 if stride == 1 else JTF.pass_3x3s2
    (jo, jst), vjp = jax.vjp(jfn, jz, jg, jw)
    Ho = H // stride
    dz = rng.standard_normal((B, Ho, Ho, CO))
    dst = rng.normal(0, 1e-3, (2, CO)).astype(np.float32)
    jd = vjp((jnp.asarray(dz, jnp.bfloat16), jnp.asarray(dst)))

    fn = TF.pass_3x3s1 if stride == 1 else TF.pass_3x3s2
    args = [t.requires_grad_() for t in (tz, tg, tw)]
    po, pst = fn(*args)
    _ulp_close(po, jo)
    _rel_close(pst, jst, 1e-4)
    dzt = _pair(dz)[1]
    pd = torch.autograd.grad([po, pst], args, [dzt, torch.from_numpy(dst)])
    assert pd[0].dtype == torch.bfloat16 and pd[2].dtype == torch.float32
    _ulp_close(pd[0], jd[0])
    _rel_close(pd[1], jd[1], 1e-3)
    _rel_close(pd[2], jd[2], 1e-3)


def test_finalize_gb_matches_jax():
    """mean and var (no clamp) exactly; g and b to the rounding of rsqrt,
    which XLA's CPU backend computes to within a few float32 ulps rather
    than correctly rounded (it differs from torch.rsqrt in ~36% of inputs,
    from float64 rounded in ~15%)."""
    rng = np.random.default_rng(13)
    s1 = rng.normal(0, 50, 24).astype(np.float32)
    s2 = (s1 ** 2 / 100 + rng.uniform(1, 50, 24)).astype(np.float32)
    s2[0] = s1[0] ** 2 / 100 - 1e-4  # a negative variance stays negative
    gamma, beta = _gb(rng, 24)
    jg, jb, jm, jv = map(_np, JTF.finalize_gb(
        *map(jnp.asarray, (s1, s2, gamma, beta)), 100))
    g, b, m, v = map(_np, TF.finalize_gb(
        *map(torch.from_numpy, (s1, s2, gamma, beta)), 100))
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(v, jv)
    assert v[0] < 0
    ulp = np.finfo(np.float32).eps
    assert (np.abs(g - jg) <= 4 * ulp * np.abs(jg)).all()
    assert (np.abs(b - jb) <= 4 * ulp * (np.abs(beta) + np.abs(m * jg))).all()


def test_chain_matches_jax():
    """s2 → 1x1 → 3x3 through ``finalize_gb`` (tests/test_train_fused.py's
    chain): the loss and the gradient of the input, every weight and every
    (γ, β), port against JAX, within 1e-2 of each one's largest."""
    rng = np.random.default_rng(14)
    Bc, Hc, c0, c1, c2 = 2, 32, 8, 16, 16
    arrays = [rng.standard_normal((Bc, Hc, Hc, c0)).astype(np.float32),
              rng.normal(0, 0.3, (9 * c0, c1)).astype(np.float32),
              rng.normal(0, 0.3, (c1, c2)).astype(np.float32),
              rng.normal(0, 0.3, (9 * c2, c2)).astype(np.float32)]
    for c, (g, b) in ((c0, (1.0, 0.0)), (c1, (1.1, 0.05)), (c2, (0.9, -0.05))):
        arrays += [np.full(c, g, np.float32), np.full(c, b, np.float32)]
    n0, n1 = Bc * Hc * Hc, Bc * (Hc // 2) ** 2

    def chain(lib, sums, stack, p3s2, p1, p3s1, params):
        z0, wd, wa, wt, g0, b0, g1, b1, g2, b2 = params
        z0f = z0.float() if isinstance(z0, torch.Tensor) else z0.astype(
            jnp.float32)
        gg, bb, _, _ = lib.finalize_gb(sums(z0f), sums(z0f * z0f), g0, b0, n0)
        zd, std = p3s2(z0, stack([gg, bb]), wd)
        gg1, bb1, _, _ = lib.finalize_gb(std[0], std[1], g1, b1, n1)
        (za,), (sta,) = p1((True,), ((0,),), (((0, 0),),), (zd,),
                           (stack([gg1, bb1]),), (wa,))
        gg2, bb2, _, _ = lib.finalize_gb(sta[0], sta[1], g2, b2, n1)
        zt, _ = p3s1(za, stack([gg2, bb2]), wt)
        return zt

    def jloss(params):
        params = (params[0].astype(jnp.bfloat16), *params[1:])
        zt = chain(JTF, lambda t: jnp.sum(t, (0, 1, 2)), jnp.stack,
                   JTF.pass_3x3s2, JTF.pass_1x1, JTF.pass_3x3s1, params)
        return jnp.sum(zt.astype(jnp.float32) ** 2)

    jl, jg = jax.value_and_grad(jloss)(tuple(map(jnp.asarray, arrays)))

    tp = [torch.from_numpy(a).requires_grad_() for a in arrays]
    zt = chain(TF, lambda t: t.sum((0, 1, 2)), torch.stack, TF.pass_3x3s2,
               TF.pass_1x1, TF.pass_3x3s1, (tp[0].to(torch.bfloat16), *tp[1:]))
    tl = (zt.float() ** 2).sum()
    tg = torch.autograd.grad(tl, tp)
    assert abs(tl.item() - float(jl)) <= 1e-2 * abs(float(jl))
    names = ["z0", "w_down", "w_1x1", "w_3x3", "g0", "b0", "g1", "b1",
             "g2", "b2"]
    for name, a, b in zip(names, tg, jg):
        err = np.abs(_np(a) - _np(b)).max()
        assert err <= 1e-2 * np.abs(_np(b)).max(), (name, err)


# ---------------------------------------------------------------------------
# the whole region: yolov5n, nc 3, 128², B=2, bf16
# ---------------------------------------------------------------------------

S, NC, BM = 128, 3, 2


def _targets(rng):
    tg = np.zeros((BM, 8, 186), np.float32)
    tg[:, :4, 0] = rng.integers(0, NC, (BM, 4))
    tg[:, :4, 1:3] = rng.uniform(20, 100, (BM, 4, 2))
    tg[:, :4, 3:5] = rng.uniform(8, 40, (BM, 4, 2))
    tg[:, :4, 5] = rng.uniform(-1.5, 1.5, (BM, 4))
    tg[:, :4, 6:] = rng.uniform(0, 1, (BM, 4, 180))
    mask = np.zeros((BM, 8), bool)
    mask[:, :4] = True
    return tg, mask


def _port_step(model, loss_fn, batch):
    """Loss, items, gradients by name and the BN running statistics after
    one train-mode forward/backward; the statistics are put back."""
    saved = {k: b.clone() for k, b in model.named_buffers()}
    model.train()
    x, tg, mask = (torch.from_numpy(a) for a in batch)
    total, items = loss_fn(model(x), tg, mask)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, params)))
    stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
    model.eval()
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(saved[k])
    return float(total.detach()), _np(items), grads, stats


def _cos(a, b):
    a = np.concatenate([_np(t).ravel() for t in a]).astype(np.float64)
    b = np.concatenate([_np(t).ravel() for t in b]).astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / n) if n else 1.0


def _agree(got, want, loss_rtol, stats_rel, det_cos, layer_cos):
    """``got``/``want``: (loss, items, grads, stats) of two runs of the same
    step; the bars of tests/test_fused_region.py."""
    assert abs(got[0] - want[0]) <= loss_rtol * abs(want[0]), (got[0],
                                                               want[0])
    for k, a in want[3].items():
        b = got[3][k]
        scale = max(float(a.abs().max()), 1.0)
        assert float((a - b).abs().max()) / scale < stats_rel, k
    det = f"model.{max(int(n.split('.')[1]) for n in want[2])}."
    groups = {"detect": det, **{f"m{i}": f"model.{i}." for i in range(5)}}
    for name, prefix in groups.items():
        keys = [n for n in want[2] if n.startswith(prefix)]
        c = _cos([got[2][n] for n in keys], [want[2][n] for n in keys])
        assert c > (det_cos if name == "detect" else layer_cos), (name, c)


@pytest.fixture(scope="module")
def region():
    """The JAX fused model (interpret-mode passes) and the port's fused
    model with its weights, one batch, and each package's step."""
    from yolov5_obb_tpu.engine.loss import ComputeLoss as JaxLoss
    from yolov5_obb_tpu.models.yolo import build_model as jax_build
    from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains
    from yolov5_obb_tpu_torch.utils.weights import (
        from_jax_variables,
        grads_from_jax,
    )

    jm, jmeta, _ = jax_build("yolov5n.yaml", nc=NC, dtype=jnp.bfloat16,
                             packed_stem=True, fused_train=True)
    assert jm.fused_train
    jmeta = jax_probe(jm, jmeta, imgsz=S)
    # numpy-seeded variables of the model's tree (running the JAX init
    # would trace the interpret-mode stem+L1 kernel)
    wrng = np.random.default_rng(1)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (wrng.standard_normal(sd.shape)
                    / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return wrng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        return wrng.normal(0, 0.1, sd.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, dict(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, S, 3 * S), jnp.uint8))))
    model, meta = create_model("yolov5n.yaml", nc=NC, dtype=torch.bfloat16,
                               device="cpu", packed_stem=True,
                               fused_train=True)
    sd = from_jax_variables(v, model.specs)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (BM, S, S, 3), dtype=np.uint8)
    batch = (img.reshape(BM, S, -1), *_targets(rng))

    hyp = scale_hyp_gains(load_hyp(), meta.nl, NC, S)
    jloss = JaxLoss(jmeta, hyp)

    def loss_of(p):
        outs, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                             jnp.asarray(batch[0]), train=True, flat=True,
                             mutable=["batch_stats"])
        total, items = jloss(outs, jnp.asarray(batch[1]),
                             jnp.asarray(batch[2]))
        return total, (items, mut)

    (jl, (ji, mut)), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        jax.tree.map(jnp.asarray, v["params"]))
    jstats = from_jax_variables({"params": v["params"], "batch_stats":
                                 jax.tree.map(np.asarray,
                                              mut["batch_stats"])},
                                model.specs)
    want = (float(jl), _np(ji),
            grads_from_jax(jax.tree.map(np.asarray, jg), model.specs),
            {k: t for k, t in jstats.items() if "running" in k})
    return model, ComputeLoss(meta, hyp), batch, want


def test_region_matches_jax(region, monkeypatch):
    """The port's fused step (plain passes) against the JAX fused step on
    the same weights and batch: loss within 3e-2, running statistics within
    2e-2 of their scale, gradient directions (tests/test_fused_region.py's
    bars).  The passes run once each per step, layer 1 and 3 as 3x3 s2."""
    model, loss_fn, batch, want = region
    calls = []
    for name in ("pass_1x1", "pass_3x3s1", "pass_3x3s2"):
        fn = getattr(TF, name)
        monkeypatch.setattr(TF, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    got = _port_step(model, loss_fn, batch)
    assert sorted(calls) == sorted(["pass_3x3s2"] * 2 + ["pass_1x1"] * 3
                                   + ["pass_3x3s1"])
    _agree(got, want, 3e-2, 2e-2, 0.9, 0.7)


def test_region_matches_stock_path(region):
    """The port's fused step against the port's stock train step (layer 0
    PackedStem, stock layers 1-3) from the same state, as
    tests/test_fused_region.py holds the JAX region to the JAX stock path."""
    model, loss_fn, batch, _ = region
    fused = _port_step(model, loss_fn, batch)
    model.fused_train = False
    try:
        stock = _port_step(model, loss_fn, batch)
    finally:
        model.fused_train = True
    _agree(fused, stock, 3e-2, 2e-2, 0.9, 0.7)


def test_region_takes_any_shape():
    """The port keeps the structural gate and drops the TPU's shape terms:
    a 96x96 batch (H/4 = W/4 = 24, no multiple of 16) runs the region
    and gives finite gradients for layers 0-3."""
    from yolov5_obb_tpu_torch.models.yolo import create_model

    model, _ = create_model("yolov5n.yaml", nc=NC, dtype=torch.bfloat16,
                            device="cpu", packed_stem=True, fused_train=True)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 255, (1, 96, 96 * 3),
                                      dtype=np.uint8))
    model.train()
    maps = model(x)
    sum(m.float().square().mean() for m in maps).backward()
    for i in range(4):
        for n, p in model.model[i].named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), (i, n)
    assert model.model[0].bn.running_mean.abs().sum() > 0


def test_specs_gate():
    from yolov5_obb_tpu_torch.models.yolo import (
        _fused_train_specs_ok,
        build_model,
    )

    for cfg in ("yolov5n.yaml", "yolov5m.yaml", "yolov5x.yaml"):
        model, _, _ = build_model(cfg, nc=NC)
        assert _fused_train_specs_ok(model.specs), cfg
    specs = list(model.specs)
    for j in (0, 1, 2):  # a later layer reading a layer the region skips
        bad = specs[:5] + [dataclasses.replace(specs[5], frm=(-1, j))] \
            + specs[6:]
        assert not _fused_train_specs_ok(bad), j
    assert _fused_train_specs_ok(
        specs[:5] + [dataclasses.replace(specs[5], frm=(-1, 3))] + specs[6:])
    no_shortcut = dataclasses.replace(specs[2], args=(*specs[2].args[:3],
                                                      False))
    assert not _fused_train_specs_ok(specs[:2] + [no_shortcut] + specs[3:])


def test_fused_train_needs_the_packed_stem(monkeypatch):
    """Without ``packed_stem`` the flag is off and the stock path runs."""
    from yolov5_obb_tpu_torch.models.yolo import build_model, create_model

    model, _, _ = build_model("yolov5n.yaml", nc=NC, packed_stem=True,
                              fused_train=True)
    assert model.fused_train
    model, _ = create_model("yolov5n.yaml", nc=NC, device="cpu",
                            fused_train=True)
    assert not model.fused_train
    calls = []
    monkeypatch.setattr(TF, "pass_1x1", lambda *a, **k: calls.append(a))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (1, 64, 64, 3), dtype=np.uint8)).float() / 255.0
    model.train()
    assert len(model(x)) == 3 and not calls


def test_weights_map_identically():
    """The fused model's parameters and statistics are the stock model's,
    key for key, so ``from_jax_variables`` needs nothing new."""
    from yolov5_obb_tpu_torch.models.yolo import build_model
    from yolov5_obb_tpu_torch.utils.weights import key_map

    fused, _, _ = build_model("yolov5m.yaml", nc=NC, packed_stem=True,
                              fused_train=True)
    stock, _, _ = build_model("yolov5m.yaml", nc=NC, packed_stem=True)
    assert fused.state_dict().keys() == stock.state_dict().keys()
    assert [k for k, _, _ in key_map(fused.specs)] == list(
        stock.state_dict().keys())


# ---------------------------------------------------------------------------
# the 3x3 pass wrappers against the CUDA sources' tile geometry
# ---------------------------------------------------------------------------


def _csrc(name):
    from pathlib import Path

    return Path(TF.__file__).resolve().parents[2] / "csrc" / name


def _constexpr(header, name):
    import re

    m = re.search(rf"constexpr int {name} = (\d+);", _csrc(header).read_text())
    assert m, f"no constexpr {name} in {header}"
    return int(m.group(1))


def _meta_pass(monkeypatch, ci, co, stride, B=2, H=17, W=33):
    """Call pass_3x3_fwd on meta tensors (the kernel branch, nothing
    allocated or run), recording what would be launched."""
    launched = []
    monkeypatch.setattr(TF, "check_cuda", lambda *a: None)
    monkeypatch.setattr(TF, "check_aligned", lambda **k: None)
    kern = TF.KERNEL_3X3S1 if stride == 1 else TF.KERNEL_3X3S2
    monkeypatch.setattr(kern, "launch", lambda *a: launched.append(a))
    z = torch.empty(B, H, W, ci, dtype=torch.bfloat16, device="meta")
    gb = torch.empty(2, ci, device="meta")
    w = torch.empty(9 * ci, co, device="meta")
    return launched, lambda: TF.pass_3x3_fwd(z, gb, w, stride)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("B,H,W", [(1, 1, 1), (2, 17, 33), (3, 33, 18),
                                   (16, 512, 512)])
def test_pass_3x3_partial_rows_follow_the_tiles(monkeypatch, stride, B, H, W):
    """The statistics partial handed to a 3x3 pass kernel has one row per
    output tile of the body both strides run on, conv3x3_mma.cuh's kTileY x
    kTileX (the kernel writes one row per tile; a shorter buffer is written
    past on the card)."""
    ty = _constexpr("conv3x3_mma.cuh", "kTileY")
    tx = _constexpr("conv3x3_mma.cuh", "kTileX")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    rows = B * -(-Ho // ty) * -(-Wo // tx)
    assert TF.pass_3x3_partial_rows(B, H, W, stride) == rows
    launched, call = _meta_pass(monkeypatch, 8, 16, stride, B, H, W)
    call()
    assert len(launched) == 1
    z_in, gb, w, z, partial, stats = launched[0][:6]
    assert partial.shape == (rows, 32) and stats.shape == (2, 16)
    assert z.shape == (B, Ho, Wo, 16) and w.dtype == torch.bfloat16
    assert launched[0][6:] == (B, H, W, 8, 16)


@pytest.mark.parametrize("source", ["down.cu", "down_train.cu",
                                    "train_fused_3x3.cu"])
def test_every_3x3_conv_runs_the_tensor_core_body(source):
    """Rows 3, 8a, 10 and 11 (the inference downsample, the train
    downsample forward, both 3x3 passes) include the tensor-core body and
    no other conv body; the scalar one is gone."""
    assert not _csrc("down_conv.cuh").exists()
    includes = re.findall(r'^#include "([^"]+)"', _csrc(source).read_text(),
                          re.M)
    assert "conv3x3_mma.cuh" in includes
    assert "down_conv.cuh" not in includes


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ci,co", [(3, 16), (8, 12), (5, 4)])
def test_pass_3x3_contract_raises_before_launch(monkeypatch, stride, ci, co):
    """ci % 2 and co % 8 are the kernels' contract: a pass that breaks it
    raises and launches nothing."""
    launched, call = _meta_pass(monkeypatch, ci, co, stride)
    with pytest.raises(ValueError, match="ci % 2 == 0, co % 8 == 0"):
        call()
    assert not launched


@pytest.mark.parametrize("ci,co,ok", [(2, 8, True), (6, 40, True),
                                      (96, 192, True), (3, 16, False),
                                      (8, 12, False)])
def test_down_contract_raises_before_launch(monkeypatch, ci, co, ok):
    """The inference downsample takes ci % 2 == 0 and co % 8 == 0 (ci % 8
    != 0 is staged through registers on the card) and checks alignment;
    anything else raises and launches nothing."""
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    launched, aligned = [], []
    monkeypatch.setattr(D, "check_cuda", lambda *a: None)
    monkeypatch.setattr(D, "check_aligned", lambda **k: aligned.append(k))
    monkeypatch.setattr(D.KERNEL, "launch", lambda *a: launched.append(a))
    x = torch.empty(2, 17, 33, ci, dtype=torch.bfloat16, device="meta")
    w = torch.empty(9 * ci, co, dtype=torch.bfloat16, device="meta")
    ss = torch.empty(2, co, device="meta")
    if ok:
        z = D.fused_down(x, w, ss)
        assert z.shape == (2, 9, 17, co) and len(launched) == 1
        assert launched[0][4:] == (2, 17, 33, ci, co)
        assert list(aligned[0]) == ["x", "w_taps"]
    else:
        with pytest.raises(ValueError, match="ci % 2 == 0, co % 8 == 0"):
            D.fused_down(x, w, ss)
        assert not launched


@pytest.mark.parametrize("ci,co,ok", [(8, 16, True), (6, 16, False),
                                      (8, 12, False)])
def test_down_train_contract_raises_before_launch(monkeypatch, ci, co, ok):
    """The downsample forward takes channels % 8 == 0 (its patch is staged
    16 bytes at a time); anything else raises and launches nothing."""
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    launched = []
    monkeypatch.setattr(D, "check_cuda", lambda *a: None)
    monkeypatch.setattr(D, "check_aligned", lambda **k: None)
    monkeypatch.setattr(D.TRAIN_FWD_KERNEL, "launch",
                        lambda *a: launched.append(a))
    x = torch.empty(2, 17, 33, ci, dtype=torch.bfloat16, device="meta")
    w = torch.empty(9 * ci, co, dtype=torch.bfloat16, device="meta")
    if ok:
        z = D.down_train_fwd(x, w)
        assert z.shape == (2, 9, 17, co) and len(launched) == 1
    else:
        with pytest.raises(ValueError, match="channels % 8 == 0"):
            D.down_train_fwd(x, w)
        assert not launched


@pytest.mark.parametrize("c2,ok", [(16, True), (48, True), (80, True),
                                   (88, False), (96, False), (12, False)])
def test_stem_l1_contract_raises_before_launch(monkeypatch, c2, ok):
    """The stem+L1 kernel takes c2 % 8 == 0 up to 80 (yolov5x's width: its
    shared memory holds the stem tile, the split weights and the layer-1
    patch) and checks w1's alignment; anything else raises and launches
    nothing."""
    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    launched, aligned = [], []
    monkeypatch.setattr(S, "check_cuda", lambda *a: None)
    monkeypatch.setattr(S, "check_aligned", lambda **k: aligned.append(k))
    monkeypatch.setattr(S.KERNEL, "launch", lambda *a: launched.append(a))
    c3 = 2 * c2
    meta = dict(device="meta")
    x = torch.empty(2, 37, 3 * 131, dtype=torch.uint8, **meta)
    ops = (torch.empty(108, c2, **meta), torch.empty(c2, **meta),
           torch.empty(9 * c2, c3, dtype=torch.bfloat16, **meta),
           torch.empty(c3, **meta))
    if ok:
        y = S.fused_stem_l1(x, *ops)
        assert y.shape == (2, 9, 33, c3) and len(launched) == 1
        assert launched[0][6:] == (2, 37, 131, c2, c3)
        assert list(aligned[0]) == ["w1"]
    else:
        with pytest.raises(ValueError, match="c2 <= 80"):
            S.fused_stem_l1(x, *ops)
        assert not launched


# ---------------------------------------------------------------------------
# the tensor-core 1x1 forward and downsample weight gradient: their wrappers
# against the CUDA sources' tiles, chunks and alignment contract
# ---------------------------------------------------------------------------


def _includes(source):
    """The headers ``source`` includes, directly or through another."""
    seen, todo = set(), [source]
    while todo:
        for inc in re.findall(r'^#include "([^"]+)"',
                              _csrc(todo.pop()).read_text(), re.M):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


@pytest.mark.parametrize("source", ["down_train.cu", "train_fused_1x1.cu",
                                    "conv3x3_mma.cuh", "stem_train.cu"])
def test_tensor_core_bodies_share_mma_header(source):
    """Rows 8b, 9a and 7b run on the tensor cores through mma.cuh, whose PTX
    helpers the 3x3 body no longer defines itself; the 1x1 forward has no
    scalar product loop (fma_pixel) and the weight gradients no fmaf."""
    text = _csrc(source).read_text()
    assert "mma.cuh" in _includes(source)
    assert "asm volatile" not in text  # the PTX lives in mma.cuh
    assert "mma16816(" in text
    if source == "train_fused_1x1.cu":
        fwd = text[text.index("p1x1_fwd_kernel("):
                   text.index("p1x1_bwd_kernel(")]
        assert "fma_pixel" not in fwd and "mma16816(" in fwd
    if source == "down_train.cu":
        assert "fmaf(" not in text and "mma16816(" in text
    if source == "stem_train.cu":
        wgrad = _section(text, "stem_wgrad_kernel(", "cudaError_t wgrad_parts(")
        assert "mma16816(" in wgrad and "ldsm_x4_trans(" in wgrad
        assert "fmaf(" not in text and "stem_conv::" not in text
        assert _includes(source) == {"stem_mma.cuh", "mma.cuh", "wgrad.cuh",
                                     "common.cuh"}


def test_pass_1x1_forward_bounds_its_staging():
    """The 1x1 forward stages by cp.async only as many inputs as the card's
    shared memory per block holds (yolov5x's 6-input cv3 does not fit
    whole) and reads the others from device memory where it activates them;
    the backward recomputes the group values with the forward's silu_fast,
    so both sides multiply the same bf16 values."""
    text = _csrc("train_fused_1x1.cu").read_text()
    launch = text[text.index("cudaError_t fwd_launch("):
                  text.index('extern "C" int pass1x1_fwd_launch(')]
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in launch
    assert "--nstage" in launch
    gv = text[text.index("void group_values("):
              text.index("void member_masks(")]
    assert "i < nstage" in gv and "d.z[i] + (p0 + p) * ci" in gv
    assert gv.count("silu_fast(") == 1 and "silu(" not in gv.replace(
        "silu_fast(", "")
    fwd = text[text.index("p1x1_fwd_kernel("):
               text.index("p1x1_bwd_kernel(")]
    bwd = text[text.index("p1x1_bwd_kernel("):
               text.index("cudaError_t bwd_plan(")]
    assert "group_values<" in fwd and "group_values<" in bwd


def _section(text, start, end):
    return text[text.index(start):text.index(end)]


def test_stem_l1_runs_the_tensor_core_bodies():
    """Row 1 (the stem+L1 kernel) runs its stem as mma.sync products of the
    uint8 image and three bf16 terms of each float32 weight (stem_mma.cuh's
    GEMM, which row 7a's forward shares), and its layer 1 on the 3x3 body's
    own main loop (conv_mainloop through patch_mainloop, no copy of it): no
    scalar product loop is left."""
    text = _csrc("stem_l1.cu").read_text()
    assert {"conv3x3_mma.cuh", "stem_mma.cuh", "mma.cuh"} <= _includes(
        "stem_l1.cu")
    kern = _section(text, "stem_l1_kernel(", "cudaError_t launch_cp(")
    assert "stem_mma::products<" in kern
    assert "conv3x3_mma::patch_mainloop<2," in kern
    assert "fmaf(" not in text and "fma_pixel" not in text
    # the split: hi, mid, lo, each rounded to bf16, into one accumulator
    stem = _csrc("stem_mma.cuh").read_text()
    assert stem.count("__float2bfloat16(") == 3
    assert "for (int s = 0; s < 3; ++s)" in stem and "mma16816(" in stem
    assert "fmaf(" not in stem
    body = _csrc("conv3x3_mma.cuh").read_text()
    assert body.count("mma16816(") == 2  # one main loop, in conv_mainloop
    assert "patch_mainloop<S, N, kMaxChunkK>(" in body
    patch = _section(body, "void patch_mainloop(", "// One CTA:")
    assert "conv_mainloop<" in patch and "mma16816(" not in patch


def test_c3_and_stem_train_forward_run_on_tensor_cores():
    """Row 2 (the C3 block) runs every conv as mma.sync GEMMs on the 3x3
    body's main loop (conv_mainloop, no copy of it) and stores through
    mma.cuh's epilogue, its scalar body and the helpers only it used gone;
    rows 7a (the train stem's forward) and 6 (the stem alone) run
    stem_mma.cuh's GEMM on its persistent rectangles (rects: products, then
    mma.cuh's stage_outputs), and the scalar stem_conv.cuh tile is gone."""
    c3 = _csrc("c3.cu").read_text()
    assert {"conv3x3_mma.cuh", "mma.cuh"} <= _includes("c3.cu")
    assert "conv3x3_mma::conv_mainloop<" in c3
    assert "mma16816(" not in c3 and "stage_outputs<" in c3
    assert "store_outputs<" in c3
    for scalar in ("conv1x1_region", "fma_pixel", "fmaf("):
        assert scalar not in c3
    common = _csrc("common.cuh").read_text()
    assert "fma_pixel" not in common and "smem_stride" not in common
    stem = _csrc("stem_mma.cuh").read_text()
    rects = _section(stem, "void rects(", "cudaError_t launch_rects(")
    assert "products<" in rects and "stage_outputs<" in rects
    assert "store_outputs<" in rects
    train = _csrc("stem_train.cu").read_text()
    fwd = _section(train, "stem_fwd_kernel(", "struct Wgrad {")
    assert "stem_mma::rects<CP>(x, w, Raw{}, z, g)" in fwd
    only = _csrc("stem.cu").read_text()
    assert "stem_mma::rects<CP>(x, w, BiasSilu{bias}, y, g)" in only
    assert _includes("stem.cu") == {"stem_mma.cuh", "mma.cuh", "common.cuh"}
    assert not _csrc("stem_conv.cuh").exists()
    for text in (train, only):
        assert "tile_conv" not in text and "fmaf(" not in text


def test_pass_1x1_backward_runs_on_tensor_cores():
    """Row 9b: dW = gvalᵀ·e_o and t = e_o·Wᵀ are mma.sync products (no
    scalar fmaf loop, no transposed weight copy), and the input gradients
    leave through the staged tiles in 16-byte stores."""
    text = _csrc("train_fused_1x1.cu").read_text()
    bwd = _section(text, "p1x1_bwd_kernel(", "cudaError_t bwd_plan(")
    assert bwd.count("mma16816(") == 3
    assert "ldsm_x4_trans(a, G +" in bwd and "ldsm_x2(bf, B +" in bwd
    assert "fmaf(" not in bwd and "ldg8_bf16" not in bwd
    assert "wt[" not in text
    assert "*reinterpret_cast<uint4*>(d.dz_in[ii]" in bwd
    assert all(f != "wt" for f, _ in TF._Desc._fields_)


def test_pass_1x1_backward_bounds_its_staging():
    """The backward stages by cp.async only as many inputs as the card's
    shared memory per block holds (yolov5x's 6-input cv3 does not fit
    whole) and reads the others, and writes their gradients, in device
    memory."""
    text = _csrc("train_fused_1x1.cu").read_text()
    plan = _section(text, "cudaError_t bwd_plan(", "cudaError_t bwd_launch(")
    assert "cudaDevAttrMaxSharedMemoryPerBlockOptin" in plan
    assert "--nstage" in plan
    bwd = _section(text, "p1x1_bwd_kernel(", "cudaError_t bwd_plan(")
    assert "ii < m.nstage" in bwd and "d.dz_in[ii] + (p0 + p) * ci" in bwd
    assert "d.z[ii] + (p0 + p) * ci" in bwd


def test_pass_1x1_backward_plans_its_partials_in_c():
    """The backward's CTA count is planned in C from the occupancy query
    (pass1x1_bwd_parts launches nothing), over its rounds of dW units; the
    wrapper asks it and mirrors none of the kernel's tiles or residency."""
    text = _csrc("train_fused_1x1.cu").read_text()
    plan = _section(text, "cudaError_t bwd_plan(", "cudaError_t bwd_launch(")
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in plan
    assert "m->rounds" in plan
    assert 'extern "C" int pass1x1_bwd_parts(' in text
    import inspect

    src = inspect.getsource(TF.pass_1x1_bwd)
    assert "pass_1x1_bwd_parts(d, N)" in src and "partial_count" not in src
    assert not hasattr(TF, "_TILE_1X1_BWD")


def _fake_sms(monkeypatch, sms=132):
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=sms))


def _meta_1x1(monkeypatch, B, H, W, ci=16, co=24, aligned=None):
    """The cv1+cv2 structure's forward and backward on meta tensors (the
    kernel branch, nothing run), recording launches and alignment checks;
    the backward's partial count (a C query, recorded in ``_meta_1x1.asked``)
    answers 7 + N % 5."""
    launched = {"fwd": [], "bwd": []}
    _meta_1x1.asked = []
    monkeypatch.setattr(TF, "query", lambda *a, **k: _meta_1x1.asked.append(
        (a, k)) or 7 + a[3] % 5)
    monkeypatch.setattr(TF, "check_cuda", lambda *a: None)
    monkeypatch.setattr(TF, "check_aligned",
                        aligned or (lambda **k: launched.setdefault(
                            "aligned", []).append(list(k))))
    monkeypatch.setattr(TF.KERNEL_1X1, "launch",
                        lambda *a: launched["fwd"].append(a))
    monkeypatch.setattr(TF.KERNEL_1X1_BWD, "launch",
                        lambda *a: launched["bwd"].append(a))
    _fake_sms(monkeypatch)
    meta = dict(device="meta")
    ns, groups, outs = (True,), ((0,),), (((0, 0),), ((0, 1),))
    z = (torch.empty(B, H, W, ci, dtype=torch.bfloat16, **meta),)
    gbs = (torch.empty(2, ci, **meta),)
    ws = (torch.empty(ci, co, **meta), torch.empty(ci, co, **meta))
    zo = tuple(torch.empty(B, H, W, co, dtype=torch.bfloat16, **meta)
               for _ in outs)
    ds = tuple(torch.empty(2, co, **meta) for _ in outs)
    args = (ns, groups, outs, z, gbs, ws)
    return (launched, lambda: TF.pass_1x1_fwd(*args),
            lambda: TF.pass_1x1_bwd(*args, zo, zo, ds))


@pytest.mark.parametrize("B,H,W", [(1, 1, 1), (2, 17, 33), (3, 33, 18),
                                   (16, 256, 256)])
def test_pass_1x1_partials_follow_the_tiles(monkeypatch, B, H, W):
    """The 1x1 forward's statistics partial has room for one row per
    kFwdTile pixels (train_fused_1x1.cu: at most one CTA per tile, each
    writing one row), the backward's one row of dW and (dg, db) per CTA,
    as many as train_fused_1x1.cu's own plan (pass1x1_bwd_parts, asked
    with the pass's descriptor) launches."""
    fwd_tile = _constexpr("train_fused_1x1.cu", "kFwdTile")
    assert TF._TILE_1X1_FWD == fwd_tile
    N, ci, co = B * H * W, 16, 24
    assert TF.pass_1x1_partial_rows(N) == -(-N // fwd_tile)
    launched, fwd, bwd = _meta_1x1(monkeypatch, B, H, W, ci, co)
    fwd()
    (_, partial, stats, n), = launched["fwd"]
    assert partial.shape == (-(-N // fwd_tile), 4 * co)
    assert stats.shape == (4 * co,) and n == N
    bwd()
    (desc, partial, sums, n, parts), = launched["bwd"]
    ((source, symbol, addr, n_px), kw), = _meta_1x1.asked
    assert (source, symbol, addr, n_px) == ("train_fused_1x1",
                                            "pass1x1_bwd_parts", desc, N)
    assert kw == {"argtypes": [TF.P, TF.I]}
    assert parts == 7 + N % 5
    R = 2 * ci * co + 2 * ci
    assert partial.shape == (parts, R) and sums.shape == (R,) and n == N


@pytest.mark.parametrize("ci,co,H,W", [
    (48, 96, 512, 512), (96, 192, 256, 256),   # yolov5m layers 1, 3
    (16, 32, 64, 64), (32, 64, 33, 18), (64, 128, 17, 33),  # yolov5n/s
    (24, 40, 1, 1), (40, 200, 17, 33), (8, 8, 2, 3)])
def test_down_wgrad_partial_follows_the_chunks(monkeypatch, ci, co, H, W):
    """The downsample weight gradient's partial is (parts, 9*ci, co), with
    parts planned by down_train.cu itself (down_train_wgrad_parts: the
    occupancy query, no residency assumed) and handed back to its launch;
    the wrapper mirrors none of the kernel's chunks or tiles."""
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    text = _csrc("down_train.cu").read_text()
    plan = text[text.index("cudaError_t wgrad_parts("):
                text.index("cudaError_t wgrad_launch(")]
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in plan
    assert "kWgradPerSm" not in text
    assert 'extern "C" int down_train_wgrad_parts(' in text
    launched, asked = [], []
    monkeypatch.setattr(D, "check_cuda", lambda *a: None)
    monkeypatch.setattr(D, "check_aligned", lambda **k: None)
    monkeypatch.setattr(D.TRAIN_WGRAD_KERNEL, "launch",
                        lambda *a: launched.append(a))
    parts = 5 + ci % 7
    monkeypatch.setattr(D, "query",
                        lambda *a: asked.append(a) or parts)
    B = 2
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    x = torch.empty(B, H, W, ci, dtype=torch.bfloat16, device="meta")
    dz = torch.empty(B, Ho, Wo, co, dtype=torch.bfloat16, device="meta")
    dw = D.down_train_wgrad(x, dz)
    assert asked == [("down_train", "down_train_wgrad_parts", B, H, W, ci,
                      co)]
    (_, _, partial, out, *dims, p), = launched
    assert partial.shape == (parts, 9 * ci, co) and p == parts
    assert out.shape == dw.shape == (9 * ci, co)
    assert dims == [B, H, W, ci, co]


@pytest.mark.parametrize("c2,H,W,ok", [
    (48, 1024, 1024, True),   # yolov5m at the train path's shape
    (16, 64, 64, True), (8, 2, 2, True), (96, 37, 131, True),
    (200, 19, 26, True),      # the cap: three column chunks
    (208, 19, 26, False), (44, 19, 26, False)])
def test_stem_wgrad_partial_follows_the_query(monkeypatch, c2, H, W, ok):
    """The stem weight gradient's partial is (parts, 108, c2), with parts
    planned by stem_train.cu itself (stem_train_wgrad_parts: the occupancy
    query, no residency assumed) and handed back to its launch; the wrapper
    mirrors none of the kernel's tiles, and refuses c2 % 8 != 0 or c2 > 200
    before asking or launching."""
    from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

    text = _csrc("stem_train.cu").read_text()
    plan = _section(text, "cudaError_t wgrad_parts(", "}  // namespace")
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in plan
    assert 'extern "C" int stem_train_wgrad_parts(' in text
    assert not hasattr(S, "_TRAIN_TILE")
    launched, asked = [], []
    monkeypatch.setattr(S, "check_cuda", lambda *a: None)
    monkeypatch.setattr(S, "check_aligned", lambda **k: None)
    monkeypatch.setattr(S.TRAIN_WGRAD_KERNEL, "launch",
                        lambda *a: launched.append(a))
    parts = 5 + c2 % 7
    monkeypatch.setattr(S, "query", lambda *a: asked.append(a) or parts)
    B = 2
    Hs, Ws = (H - 2) // 2 + 1, (W - 2) // 2 + 1
    x = torch.empty(B, H, 3 * W, dtype=torch.uint8, device="meta")
    dz = torch.empty(B, Hs, Ws, c2, dtype=torch.bfloat16, device="meta")
    if not ok:
        with pytest.raises(ValueError, match="c2 <= 200"):
            S.stem_train_wgrad(x, dz)
        assert not launched and not asked
        return
    dw = S.stem_train_wgrad(x, dz)
    assert asked == [("stem_train", "stem_train_wgrad_parts", B, H, W, c2)]
    (_, _, partial, out, *dims, p), = launched
    assert partial.shape == (parts, 108, c2) and p == parts
    assert out.shape == (108, c2) and dw.shape == (c2, 3, 6, 6)
    assert dims == [B, H, W, c2]


@pytest.mark.parametrize("kernel", ["down_wgrad", "pass_1x1_fwd",
                                    "pass_1x1_bwd", "stem_wgrad"])
@pytest.mark.parametrize("misaligned", [False, True])
def test_alignment_checked_before_launch(monkeypatch, kernel, misaligned):
    """The kernels that copy 16 bytes at a time check every such operand's
    alignment (inputs, bf16 weights; in the 1x1 backward the outputs and
    their cotangents too) and launch nothing when a check fails."""
    from yolov5_obb_tpu_torch.ops.kernels import down_kernel as D

    checked = []

    def aligned(**k):
        checked.append(list(k))
        if misaligned:
            raise ValueError(f"{next(iter(k))}: data pointer not 16-byte "
                             f"aligned")

    if kernel == "down_wgrad":
        launched = {"wgrad": []}
        monkeypatch.setattr(D, "check_cuda", lambda *a: None)
        monkeypatch.setattr(D, "check_aligned", aligned)
        monkeypatch.setattr(D.TRAIN_WGRAD_KERNEL, "launch",
                            lambda *a: launched["wgrad"].append(a))
        monkeypatch.setattr(D, "query", lambda *a: 3)
        x = torch.empty(2, 17, 33, 16, dtype=torch.bfloat16, device="meta")
        dz = torch.empty(2, 9, 17, 32, dtype=torch.bfloat16, device="meta")
        call, want = (lambda: D.down_train_wgrad(x, dz)), [["x", "dz"]]
    elif kernel == "stem_wgrad":
        from yolov5_obb_tpu_torch.ops.kernels import stem_kernel as S

        launched = {"wgrad": []}
        monkeypatch.setattr(S, "check_cuda", lambda *a: None)
        monkeypatch.setattr(S, "check_aligned", aligned)
        monkeypatch.setattr(S.TRAIN_WGRAD_KERNEL, "launch",
                            lambda *a: launched["wgrad"].append(a))
        monkeypatch.setattr(S, "query", lambda *a: 3)
        x = torch.empty(2, 37, 3 * 131, dtype=torch.uint8, device="meta")
        dz = torch.empty(2, 18, 65, 48, dtype=torch.bfloat16, device="meta")
        call, want = (lambda: S.stem_train_wgrad(x, dz)), [["dz"]]
    else:
        launched, fwd, bwd = _meta_1x1(monkeypatch, 2, 17, 33,
                                       aligned=aligned)
        call = fwd if kernel == "pass_1x1_fwd" else bwd
        want = [["z_in0", "w0", "w1"]] if call is fwd else [
            ["z_in0", "w0", "w1", "z_out0", "z_out1", "dz_out0", "dz_out1"]]
    if misaligned:
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
        assert not any(launched.values())
    else:
        call()
        assert sum(map(len, launched.values())) == 1
    assert checked == want
