"""The port's kernel modules (plain versions, CPU) against the JAX kernels as
the JAX package's own tests run them (Pallas interpret mode), on the same
numpy-seeded inputs."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5_obb_tpu.ops.pallas import c3_kernel as jc3
from yolov5_obb_tpu.ops.pallas import down_kernel as jdown
from yolov5_obb_tpu.ops.pallas import neighbor_kernel as jnbr
from yolov5_obb_tpu.ops.pallas import stem_kernel as jstem
from yolov5_obb_tpu.ops.pallas.iou_kernel import _pairs_iou_math
from yolov5_obb_tpu_torch.models.layers import C3
from yolov5_obb_tpu_torch.ops.kernels import c3_kernel, down_kernel, stem_kernel
from yolov5_obb_tpu_torch.ops.kernels.neighbor_kernel import fused_neighbor_iou
from yolov5_obb_tpu_torch.ops.rotated_iou import pairs_iou_math, rotated_iou


def _bn(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.2, c).astype(np.float32),
            rng.normal(0, 0.3, c).astype(np.float32),
            rng.uniform(0.5, 2.0, c).astype(np.float32))


def _kernel(rng, shape):  # HWIO, LeCun-scaled
    fan_in = np.prod(shape[:-1])
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def _bn_module(bn):
    t = [torch.from_numpy(a) for a in bn]
    return types.SimpleNamespace(weight=t[0], bias=t[1], running_mean=t[2],
                                 running_var=t[3])


def _oihw(k):
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())


def _bf16(a):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16))


def test_stem_l1_plain_matches_pallas():
    rng = np.random.default_rng(0)
    B, H, W, c2, c3 = 1, 64, 64, 16, 32
    img = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    k0, k1 = _kernel(rng, (6, 6, 3, c2)), _kernel(rng, (3, 3, c2, c3))
    bn0, bn1 = _bn(rng, c2), _bn(rng, c3)
    jops = jstem.fold_stem_l1_params(jnp.asarray(k0), tuple(map(jnp.asarray, bn0)),
                                     jnp.asarray(k1), tuple(map(jnp.asarray, bn1)))
    xp = img.reshape(B, H, -1)
    want = np.asarray(jstem.fused_stem_l1(jnp.asarray(xp), *jops, H, W,
                                          use_pallas=True), np.float32)
    ops = stem_kernel.fold_stem_l1_params(_oihw(k0), _bn_module(bn0),
                                          _oihw(k1), _bn_module(bn1))
    got = stem_kernel.fused_stem_l1(torch.from_numpy(xp), *ops)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H // 4, W // 4, c3)
    got = got.float().numpy()
    # bf16 tolerance of tests/test_stem_kernel.py
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    assert np.median(np.abs(got - want)) < 5e-3


@pytest.mark.parametrize("H,W", [(32, 32), (64, 48)])
def test_down_plain_matches_pallas(H, W):
    rng = np.random.default_rng(1)
    ci, co = 16, 32
    x = rng.standard_normal((2, H, W, ci)).astype(np.float32)
    k = _kernel(rng, (3, 3, ci, co))
    bn = _bn(rng, co)
    jw, ss = jc3.fold_conv_bn(k, *bn)
    jw = jnp.asarray(jw).reshape(9 * ci, co)
    jx, tx = _bf16(x)
    want = np.asarray(jdown.fused_down(jx, jw, jnp.asarray(ss),
                                       use_pallas=True), np.float32)
    conv = types.SimpleNamespace(weight=_oihw(k))
    w, tss = down_kernel.fold_down_params(conv, _bn_module(bn))
    got = down_kernel.fused_down(tx, w, tss)
    assert got.shape == (2, H // 2, W // 2, co)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 0.05, err.max()  # tests/test_down_kernel.py bar


def _c3_pair(rng, C, n, c2=None, shortcut=True):
    """Same random C3(C, c2) weights as a JAX (params, batch_stats) tree and
    a port C3 module."""
    c2 = C if c2 is None else c2
    c_ = c2 // 2
    port = C3(C, c2, n, shortcut)
    params, stats = {}, {}

    def cba(name, ci, co, k, port_cba, p=params, s=stats):
        kern, bn = _kernel(rng, (k, k, ci, co)), _bn(rng, co)
        p[name] = {"Conv_0": {"kernel": kern},
                   "BatchNorm_0": {"scale": bn[0], "bias": bn[1]}}
        s[name] = {"BatchNorm_0": {"mean": bn[2], "var": bn[3]}}
        with torch.no_grad():
            port_cba.conv.weight.copy_(_oihw(kern))
            for attr, a in zip(("weight", "bias", "running_mean",
                                "running_var"), bn):
                getattr(port_cba.bn, attr).copy_(torch.from_numpy(a))

    cba("ConvBnAct_0", C, c_, 1, port.cv1)
    cba("ConvBnAct_1", C, c_, 1, port.cv2)
    cba("ConvBnAct_2", 2 * c_, c2, 1, port.cv3)
    for j in range(n):
        params[f"Bottleneck_{j}"], stats[f"Bottleneck_{j}"] = {}, {}
        cba("ConvBnAct_0", c_, c_, 1, port.m[j].cv1,
            params[f"Bottleneck_{j}"], stats[f"Bottleneck_{j}"])
        cba("ConvBnAct_1", c_, c_, 3, port.m[j].cv2,
            params[f"Bottleneck_{j}"], stats[f"Bottleneck_{j}"])
    return params, stats, port


# C3(16, 16) with the shortcut; C3(16, 32) without it (c1 != c2, as the
# head's C3s; JAX fused_c3 takes both, c3_kernel.py:13-14)
@pytest.mark.parametrize("n,c2,shortcut", [
    pytest.param(1, 16, True, id="1"), pytest.param(2, 16, True, id="2"),
    pytest.param(2, 32, False, id="2-c2_32-no_shortcut")])
def test_c3_plain_matches_pallas(n, c2, shortcut):
    rng = np.random.default_rng(2 + n)
    C = 16
    params, stats, port = _c3_pair(rng, C, n, c2, shortcut)
    x = rng.standard_normal((2, 32, 40, C)).astype(np.float32)
    jx, tx = _bf16(x)
    p = jc3.fold_c3_params(params, stats, n=n)
    want = np.asarray(jc3.fused_c3(jx, p["w1"], p["s1"], p["bots"], p["w2"],
                                   p["s2"], p["w3a"], p["w3b"], p["s3"], n=n,
                                   shortcut=shortcut), np.float32)
    got = c3_kernel.fused_c3(tx, c3_kernel.fold_c3_params(port), shortcut)
    assert got.shape == want.shape
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 0.06, err.max()  # tests/test_c3_kernel.py bar
    assert err[:, :2].max() <= 0.06 and err[:, :, -2:].max() <= 0.06


def _candidates(rng, n, clustered):
    rb = np.zeros((n, 5), np.float32)
    if clustered:  # one tight cluster: early rows overflow M=64 neighbours
        rb[:, 0] = 200 + rng.normal(0, 3, n)
        rb[:, 1] = 200 + rng.normal(0, 3, n)
    else:
        rb[:, 0] = rng.uniform(0, 400, n)
        rb[:, 1] = rng.uniform(0, 400, n)
    rb[:, 2] = rng.uniform(20, 90, n)
    rb[:, 3] = rb[:, 2] * rng.uniform(0.3, 1.0, n)
    rb[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n)
    cls = rng.integers(0, 2 if clustered else 3, n).astype(np.int32)
    valid = np.ones(n, bool)
    valid[-7:] = False
    return rb, cls, valid


@pytest.mark.parametrize("n,clustered", [(128, False), (256, True)])
def test_neighbor_plain_matches_pallas(n, clustered):
    rng = np.random.default_rng(5)
    thr, M = 0.45, 64
    rb, cls, valid = _candidates(rng, n, clustered)
    jidx, jsup = jnbr.fused_neighbor_iou(jnp.asarray(rb), jnp.asarray(cls),
                                         jnp.asarray(valid), thr,
                                         max_neighbors=M)
    jidx, jsup = np.asarray(jidx), np.asarray(jsup)
    idx, sup = fused_neighbor_iou(torch.from_numpy(rb)[None],
                                  torch.from_numpy(cls)[None],
                                  torch.from_numpy(valid)[None], thr, M)
    idx, sup = idx[0].numpy(), sup[0].numpy()
    assert np.array_equal(idx, jidx)  # empty slots are 0 on both sides
    if clustered:
        assert (idx[:, -1] > 0).any(), "no row overflowed M"
    iou = pairs_iou_math(torch.from_numpy(rb)[:, None].expand(n, M, 5),
                         torch.from_numpy(rb)[torch.from_numpy(idx).long()])
    border = np.abs(iou.numpy() - thr) < 1e-6
    assert np.array_equal(sup[~border], jsup[~border])
    assert sup.any()


def test_pairs_iou_math_matches_jax():
    rng = np.random.default_rng(9)
    P = 600
    a, _, _ = _candidates(rng, P, False)
    b = a.copy()
    b[:, :2] += rng.normal(0, 15, (P, 2)).astype(np.float32)
    b[:, 4] += rng.normal(0, 0.4, P).astype(np.float32)
    b[:50] = a[:50]  # identical pairs
    b[50:100, :2] += 500  # disjoint pairs
    want = np.asarray(_pairs_iou_math(*(jnp.asarray(a[:, i]) for i in range(5)),
                                      *(jnp.asarray(b[:, i]) for i in range(5))))
    got = pairs_iou_math(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # and the 24-point atan2 formulation agrees with the pair formulation
    ref = rotated_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert (want[:50] > 0.999).all() and (want[50:100] == 0).all()
