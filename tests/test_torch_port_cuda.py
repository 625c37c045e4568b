"""The port's CUDA kernels against their plain versions on the card, at small
shapes (odd sizes and ragged tiles included), and the slice through the
kernels against the slice through the plain versions.

Needs an NVIDIA card with ``nvcc`` (sm_90a); marked ``cuda`` and skipped
without one.  Run on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_cuda.py`` (``tests/conftest.py`` sets up JAX, which
neither this file nor the port needs).
"""

import types

import numpy as np
import pytest
import torch

from riou_cases import CASES as RIOU_CASES
from riou_cases import hard_pairs
from yolov5_obb_tpu_torch.models import layers
from yolov5_obb_tpu_torch.models.layers import C3
from yolov5_obb_tpu_torch.ops.kernels import (
    c3_kernel,
    down_kernel,
    iou,
    neighbor_kernel,
    stem_kernel,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bn(gen, c, dev):
    r = lambda lo, hi: lo + (hi - lo) * torch.rand(c, generator=gen, device=dev)
    return types.SimpleNamespace(weight=r(0.5, 1.5), bias=r(-0.2, 0.2),
                                 running_mean=r(-0.3, 0.3),
                                 running_var=r(0.5, 2.0))


def _w(gen, co, ci, k, dev):
    return torch.randn(co, ci, k, k, generator=gen, device=dev) / (ci * k * k) ** 0.5


def _counted(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


# the yolov5n/s/m/l/x widths of the stem and layer 1
@pytest.mark.parametrize("c2,c3", [(16, 32), (32, 64), (48, 96), (64, 128),
                                   (80, 160)])
# ragged against the 8x16 output tile (and the 17x33 stem tile), odd sizes,
# a width whose packed rows are not 4-byte multiples
@pytest.mark.parametrize("H,W", [(64, 64), (70, 42), (2, 2), (37, 131)])
def test_stem_l1_kernel(dev, H, W, c2, c3):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (2, H, 3 * W), generator=gen, device=dev,
                      dtype=torch.uint8)
    ops = stem_kernel.fold_stem_l1_params(_w(gen, c2, 3, 6, dev), _bn(gen, c2, dev),
                                          _w(gen, c3, c2, 3, dev), _bn(gen, c3, dev))
    got = _counted(stem_kernel.KERNEL, lambda: stem_kernel.fused_stem_l1(x, *ops))
    want = stem_kernel.fused_stem_l1_plain(x, *ops)
    assert got.shape == want.shape
    assert (got.float() - want.float()).abs().max() <= 0.05  # bf16 output ulps
    # no atomics, a fixed order of sums: repeated runs agree bit for bit
    assert torch.equal(got, stem_kernel.fused_stem_l1(x, *ops))


# the yolov5n/s/m/l/x stem widths, c2 = 8 (K and N padded to 16) and c2 =
# 96 (two column chunks)
@pytest.mark.parametrize("c2", [16, 32, 48, 64, 80, 8, 96])
# ragged against the 8x32 rectangle, odd sizes, widths whose packed rows are
# not 4-byte multiples (byte-wise image staging)
@pytest.mark.parametrize("H,W", [(64, 64), (70, 42), (2, 2), (37, 131),
                                 (37, 51)])
def test_stem_kernel(dev, H, W, c2):
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randint(0, 256, (2, H, 3 * W), generator=gen, device=dev,
                      dtype=torch.uint8)
    w0, b0 = stem_kernel.fold_stem_params(_w(gen, c2, 3, 6, dev),
                                          _bn(gen, c2, dev))
    got = _counted(stem_kernel.STEM_KERNEL,
                   lambda: stem_kernel.fused_stem(x, w0, b0))
    want = stem_kernel.fused_stem_plain(x, w0, b0)
    assert got.shape == want.shape == (2, (H - 2) // 2 + 1, (W - 2) // 2 + 1,
                                       c2)
    assert got.dtype == torch.bfloat16
    # bf16 output: at most one ulp of the largest value
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 128
    # no atomics, a fixed order of sums: repeated runs agree bit for bit
    assert torch.equal(got, stem_kernel.fused_stem(x, w0, b0))


def _rboxes(rng, shape, spread):
    rb = np.zeros((*shape, 5), np.float32)
    rb[..., :2] = rng.uniform(-spread, spread, (*shape, 2))
    rb[..., 2] = rng.uniform(5, 80, shape)
    rb[..., 3] = rb[..., 2] * rng.uniform(0.2, 1.0, shape)
    rb[..., 4] = rng.uniform(-np.pi / 2, np.pi / 2, shape)
    return rb


@pytest.mark.parametrize("B,K,M", [(1, 1001, 1), (3, 77, 13)])
def test_pairs_iou_kernel(dev, B, K, M):
    rng = np.random.default_rng(10)
    a = torch.from_numpy(_rboxes(rng, (B * K,), 40.0)).to(dev)
    b = torch.from_numpy(_rboxes(rng, (B * K,), 40.0)).to(dev)
    got = _counted(iou.KERNEL, lambda: iou.pairs_rotated_iou(a, b))
    want = iou.pairs_rotated_iou_plain(a, b)
    assert got.shape == (B * K,) and (want > 0.1).any()
    assert (got - want).abs().max() <= 1e-5
    assert torch.equal(got > 0.45, want > 0.45)
    boxes = a.view(B, K, 5)
    idx = torch.from_numpy(rng.integers(0, K, (B, K, M)).astype(np.int32)).to(dev)
    got = _counted(iou.KERNEL, lambda: iou.sparse_rotated_iou(boxes, idx))
    want = iou.sparse_rotated_iou_plain(boxes, idx)
    assert got.shape == (B, K, M)
    assert (got - want).abs().max() <= 1e-5
    assert torch.equal(got > 0.45, want > 0.45)


@pytest.mark.parametrize("case", RIOU_CASES)
def test_hard_pairs_kernel(dev, case):
    """The pair-IoU kernel on tests/riou_cases.py's hard pairs, both forms,
    against the plain version; bit for bit on repeat and between forms."""
    a, b = (torch.from_numpy(x).to(dev) for x in hard_pairs(case))
    P = a.shape[0]
    got = _counted(iou.KERNEL, lambda: iou.pairs_rotated_iou(a, b))
    want = iou.pairs_rotated_iou_plain(a, b)
    assert (got - want).abs().max() <= 1e-5
    for thr in (0.1, 0.45, 0.9):
        assert torch.equal(got > thr, want > thr)
    assert torch.equal(got, iou.pairs_rotated_iou(a, b))
    # the sparse form: one image holding both sides, row k paired with P + k
    boxes = torch.cat([a, b])[None].contiguous()
    idx = (P + torch.arange(P, device=dev, dtype=torch.int32)).view(1, P, 1)
    idx = torch.cat([idx, torch.zeros(1, P, dtype=torch.int32, device=dev)
                     .view(1, P, 1)], 1).contiguous()
    sparse = iou.sparse_rotated_iou(boxes, idx)[0, :P, 0]
    assert torch.equal(sparse, got)


def test_box_records_kernel(dev):
    """The per-box records on the card against their plain version, bit for
    bit (the cover and area the neighbour kernel's plain edge test sees)."""
    from yolov5_obb_tpu_torch.ops.kernels.neighbor_kernel import _edge_inputs
    from yolov5_obb_tpu_torch.ops.rotated_iou import record_cover_area

    rng = np.random.default_rng(12)
    boxes = torch.from_numpy(_rboxes(rng, (3, 333), 300.0)).to(dev)
    cls = torch.from_numpy(rng.integers(0, 15, (3, 333)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((3, 333)) < 0.8).to(dev)
    rec = _counted(iou.BOXES_KERNEL, lambda: iou.box_records(boxes, cls, valid))
    assert rec.shape == (3, 333, 16)
    assert torch.equal(rec, iou.box_records_plain(boxes, cls, valid))
    assert torch.equal(record_cover_area(rec), _edge_inputs(boxes))
    assert torch.equal(iou.box_records(boxes), iou.box_records_plain(boxes))


@pytest.mark.parametrize("n,clustered", [(100, False), (300, True)])
def test_iou_order_nms(dev, n, clustered):
    """nms_rotated(neighbor_order="iou") through the pair-IoU kernel against
    its plain version, and against the score order."""
    from yolov5_obb_tpu_torch.ops.rotated_nms import nms_rotated

    rng = np.random.default_rng(11)
    B = 2
    rb = _rboxes(rng, (B, n), 200.0)
    if clustered:
        rb[..., :2] = 200 + rng.normal(0, 4, (B, n, 2))
    boxes = torch.from_numpy(rb).to(dev)
    scores = torch.from_numpy(rng.uniform(0.05, 1.0, (B, n)).astype(
        np.float32)).to(dev)
    cls = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.int32)).to(dev)
    keep = _counted(iou.KERNEL, lambda: nms_rotated(
        boxes, scores, 0.45, cls, neighbor_order="iou"))
    assert torch.equal(keep, nms_rotated(boxes, scores, 0.45, cls,
                                         neighbor_order="iou", plain=True))
    if not clustered:  # no row overflows M: both orders agree
        assert torch.equal(keep, nms_rotated(boxes, scores, 0.45, cls))


@pytest.mark.parametrize("H,W", [(32, 32), (33, 19)])
def test_down_kernel(dev, H, W):
    gen = torch.Generator(device=dev).manual_seed(1)
    conv = types.SimpleNamespace(weight=_w(gen, 32, 16, 3, dev))
    wt, ss = down_kernel.fold_down_params(conv, _bn(gen, 32, dev))
    x = torch.randn(2, H, W, 16, generator=gen, device=dev).to(torch.bfloat16)
    got = _counted(down_kernel.KERNEL, lambda: down_kernel.fused_down(x, wt, ss))
    want = down_kernel.fused_down_plain(x, wt, ss)
    assert got.shape == want.shape == (2, (H + 1) // 2, (W + 1) // 2, 32)
    assert (got.float() - want.float()).abs().max() <= 0.05


def _c3_module(gen, dev, c1, c2, n, shortcut=True):
    m = C3(c1, c2, n, shortcut).to(dev)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Conv2d):
                co, ci, k, _ = mod.weight.shape
                mod.weight.copy_(_w(gen, co, ci, k, dev))
            elif isinstance(mod, torch.nn.BatchNorm2d):
                st = _bn(gen, mod.num_features, dev)
                for a in ("weight", "bias", "running_mean", "running_var"):
                    getattr(mod, a).copy_(getattr(st, a))
    return c3_kernel.fold_c3_params(m)


# C3(16): c_ = 8, K and N padded to 16 with zeros; layer 2 of yolov5n/s/m/l/x
# (c1 = 32 .. 160, n = 1 .. 4) and yolov5m's layer 4 (C3(192, n = 4)) at an
# odd size, ragged against the 8x16 tile; c_ = 224, whose tiles do not fit a
# block at the full tile width
@pytest.mark.parametrize("c1,n,H,W", [
    (16, 1, 32, 40), (16, 2, 21, 13), (16, 4, 16, 16), (32, 1, 21, 37),
    (64, 1, 21, 37), (96, 2, 21, 37), (128, 3, 21, 37), (160, 4, 21, 37),
    (192, 4, 21, 37), (448, 1, 9, 11)])
def test_c3_kernel(dev, c1, n, H, W):
    gen = torch.Generator(device=dev).manual_seed(2)
    p = _c3_module(gen, dev, c1, c1, n)
    x = torch.randn(2, H, W, c1, generator=gen, device=dev).to(torch.bfloat16)
    got = _counted(c3_kernel.KERNEL, lambda: c3_kernel.fused_c3(x, p))
    want = c3_kernel.fused_c3_plain(x, p)
    assert got.shape == want.shape == (2, H, W, c1)
    assert (got.float() - want.float()).abs().max() <= 0.06
    # no atomics, a fixed order of sums: repeated runs agree bit for bit
    assert torch.equal(got, c3_kernel.fused_c3(x, p))


# shortcut off and c1 != c2 (the model's head C3s), through fused_c3 on
# folded operands; c1 % 8 != 0 stages x through registers
@pytest.mark.parametrize("c1,c2,n", [(24, 32, 2), (18, 16, 1), (96, 48, 3)])
def test_c3_kernel_no_shortcut(dev, c1, c2, n):
    gen = torch.Generator(device=dev).manual_seed(6)
    p = _c3_module(gen, dev, c1, c2, n, shortcut=False)
    x = torch.randn(2, 19, 27, c1, generator=gen, device=dev).to(torch.bfloat16)
    got = _counted(c3_kernel.KERNEL, lambda: c3_kernel.fused_c3(x, p, False))
    want = c3_kernel.fused_c3_plain(x, p, False)
    assert got.shape == want.shape == (2, 19, 27, c2)
    assert (got.float() - want.float()).abs().max() <= 0.06
    assert torch.equal(got, c3_kernel.fused_c3(x, p, False))


@pytest.mark.parametrize("n,clustered", [(100, False), (300, True)])
def test_neighbor_kernel(dev, n, clustered):
    rng = np.random.default_rng(5)
    B = 3
    rb = np.zeros((B, n, 5), np.float32)
    c = 200 + (rng.normal(0, 4, (B, n, 2)) if clustered
               else rng.uniform(-200, 200, (B, n, 2)))
    rb[..., :2] = c
    rb[..., 2] = rng.uniform(20, 90, (B, n))
    rb[..., 3] = rb[..., 2] * rng.uniform(0.3, 1.0, (B, n))
    rb[..., 4] = rng.uniform(-np.pi / 2, np.pi / 2, (B, n))
    boxes = torch.from_numpy(rb).to(dev)
    cls = torch.from_numpy(rng.integers(0, 2, (B, n)).astype(np.int32)).to(dev)
    valid = torch.arange(n, device=dev)[None].expand(B, n) < n - 5
    valid = valid.contiguous()
    idx, sup = _counted(neighbor_kernel.KERNEL, lambda: neighbor_kernel
                        .fused_neighbor_iou(boxes, cls, valid, 0.45, 64))
    pidx, psup = neighbor_kernel.fused_neighbor_iou_plain(boxes, cls, valid,
                                                          0.45, 64)
    assert torch.equal(idx, pidx) and torch.equal(sup, psup)
    assert psup.any()
    assert bool((pidx[..., -1] > 0).any()) == clustered  # rows overflowing M


# the stem widths of yolov5n/m/l/x and c2 = 8 (K, N padded to 16); c2 = 96
# runs in two column chunks, c2 = 200 (the weight gradient's cap) in three;
# widths whose packed rows are not 4-byte multiples (byte-wise staging)
@pytest.mark.parametrize("H,W,c2", [(64, 64, 16), (70, 42, 48), (34, 98, 8),
                                    (45, 67, 64), (66, 38, 80), (30, 50, 96),
                                    (37, 131, 48), (37, 131, 32),
                                    (19, 26, 200)])
def test_stem_train_kernels(dev, monkeypatch, H, W, c2):
    gen = torch.Generator(device=dev).manual_seed(4)
    B = 2
    # the weight gradient's partial count is csrc/stem_train.cu's own plan
    asked, query = [], stem_kernel.query
    monkeypatch.setattr(stem_kernel, "query",
                        lambda *a: asked.append(a) or query(*a))
    x = torch.randint(0, 256, (B, H, 3 * W), generator=gen, device=dev,
                      dtype=torch.uint8)
    w = (_w(gen, c2, 3, 6, dev) / 255.0).requires_grad_()
    z = _counted(stem_kernel.TRAIN_FWD_KERNEL,
                 lambda: stem_kernel.stem_conv_train(x, w))
    zp = stem_kernel.stem_conv_train(x, w, plain=True)
    assert z.shape == zp.shape == (B, (H - 2) // 2 + 1, (W - 2) // 2 + 1, c2)
    assert z.dtype == torch.bfloat16
    # bf16 output: at most one ulp of the largest value
    assert (z.float() - zp.float()).abs().max() <= zp.float().abs().max() / 128
    # a fixed order of sums: the forward repeats bit for bit
    assert torch.equal(z, stem_kernel.stem_train_fwd(x, w.detach()))
    cot = torch.randn(z.shape, generator=gen, device=dev)
    g = _counted(stem_kernel.TRAIN_WGRAD_KERNEL, lambda: torch.autograd.grad(
        (z.float() * cot).sum(), w)[0])
    gp = torch.autograd.grad((zp.float() * cot).sum(), w)[0]
    assert asked == [("stem_train", "stem_train_wgrad_parts", B, H, W, c2)]
    tiles = B * -(-z.shape[1] // 8) * -(-z.shape[2] // 32)  # 8x32 tiles
    assert 1 <= stem_kernel.wgrad_parts(B, H, W, c2) <= tiles
    assert g.shape == gp.shape == w.shape and g.dtype == torch.float32
    # the tolerance of tests/test_stem_kernel.py: bf16 products, f32 sums
    assert (g - gp).abs().max() <= 2e-2 * gp.abs().max()
    # two stages, no atomics: repeated runs agree bit for bit
    g2 = torch.autograd.grad((stem_kernel.stem_conv_train(x, w).float()
                              * cot).sum(), w)[0]
    assert torch.equal(g, g2)


@pytest.mark.parametrize("H,W,ci,co", [
    (32, 32, 16, 32), (33, 19, 48, 96), (18, 40, 40, 24),
    # ragged tiles, ci not a multiple of 16, co not a multiple of the
    # weight gradient's output chunk, the yolov5n/s channel pairs
    (1, 1, 24, 40), (17, 33, 40, 200), (33, 18, 24, 40), (17, 33, 32, 64),
    (33, 18, 64, 128), (1, 1, 96, 192), (33, 18, 96, 192)])
def test_down_train_kernels(dev, H, W, ci, co):
    gen = torch.Generator(device=dev).manual_seed(5)
    B = 2
    x = torch.randn(B, H, W, ci, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    w = _w(gen, co, ci, 3, dev).permute(2, 3, 1, 0).reshape(9 * ci, co)
    w = w.contiguous().requires_grad_()
    z = _counted(down_kernel.TRAIN_FWD_KERNEL,
                 lambda: down_kernel.down_conv_train(x, w))
    zp = down_kernel.down_conv_train(x, w, plain=True)
    assert z.shape == zp.shape == (B, (H + 1) // 2, (W + 1) // 2, co)
    assert (z.float() - zp.float()).abs().max() <= 0.05  # bf16 output ulps
    cot = torch.randn(z.shape, generator=gen, device=dev)
    gx, gw = _counted(down_kernel.TRAIN_WGRAD_KERNEL, lambda: torch.autograd
                      .grad((z.float() * cot).sum(), (x, w)))
    gxp, gwp = torch.autograd.grad((zp.float() * cot).sum(), (x, w))
    assert gw.dtype == torch.float32 and gx.dtype == torch.bfloat16
    assert (gw - gwp).abs().max() <= 2e-2 * gwp.abs().max()
    # the same transposed conv on both paths; cuDNN may sum in another order
    assert (gx.float() - gxp.float()).abs().max() <= gxp.float().abs().max() / 128
    gw2 = torch.autograd.grad((down_kernel.down_conv_train(x, w).float()
                               * cot).sum(), w)[0]
    assert torch.equal(gw, gw2)


_RAGGED = [(1, 1), (2, 3), (17, 33), (33, 18)]


@pytest.mark.parametrize("H,W", _RAGGED)
@pytest.mark.parametrize("ci,co", [(8, 8), (24, 40), (40, 96), (48, 200),
                                   (80, 320)])
def test_down_train_fwd_ragged(dev, H, W, ci, co):
    """The tensor-core forward at ragged tiles, ci not a multiple of 16 and
    co not a multiple of its 96-channel chunk; repeats bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(2, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
    w = _w(gen, co, ci, 3, dev).permute(2, 3, 1, 0).reshape(9 * ci, co)
    w = w.contiguous().to(torch.bfloat16)
    z = _counted(down_kernel.TRAIN_FWD_KERNEL,
                 lambda: down_kernel.down_train_fwd(x, w))
    zp = down_kernel.down_train_fwd_plain(x, w)
    assert z.shape == zp.shape == (2, (H + 1) // 2, (W + 1) // 2, co)
    assert (z.float() - zp.float()).abs().max() <= 0.05  # bf16 output ulps
    assert torch.equal(z, down_kernel.down_train_fwd(x, w))


@pytest.mark.parametrize("H,W", _RAGGED)
@pytest.mark.parametrize("ci,co", [(2, 8), (6, 16), (24, 40), (16, 48),
                                   (96, 192), (40, 200)])
def test_down_kernel_ragged(dev, H, W, ci, co):
    """The inference downsample on the tensor-core body at ragged tiles, ci
    not a multiple of 8 (register staging) or 16, co from one 8-channel
    group to more than two chunks: within one bf16 ulp of the largest
    output of the plain version, and bit for bit on repeat."""
    gen = torch.Generator(device=dev).manual_seed(15)
    conv = types.SimpleNamespace(weight=_w(gen, co, ci, 3, dev))
    wt, ss = down_kernel.fold_down_params(conv, _bn(gen, co, dev))
    x = torch.randn(2, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
    got = _counted(down_kernel.KERNEL,
                   lambda: down_kernel.fused_down(x, wt, ss))
    want = down_kernel.fused_down_plain(x, wt, ss)
    assert got.shape == want.shape == (2, (H + 1) // 2, (W + 1) // 2, co)
    assert _ulp(got, want)
    assert torch.equal(got, down_kernel.fused_down(x, wt, ss))


def test_slice_kernels_match_plain(dev, monkeypatch):
    from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
    from yolov5_obb_tpu_torch.models.yolo import create_model

    monkeypatch.setattr(layers, "FUSED_C3_MIN_SPATIAL", 0)
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    model, meta = create_model("yolov5n.yaml", nc=15, dtype=torch.bfloat16,
                               device="cuda", packed_stem=True)
    rng = np.random.default_rng(7)  # detections at conf 0.25
    with torch.no_grad():
        for conv in model.model[-1].m:
            b = conv.bias.view(meta.na, meta.no)
            b[:, 4] += 4.0
            b[:, 5:5 + meta.nc] += torch.as_tensor(
                rng.normal(0.0, 2.0, (meta.na, meta.nc)), device=dev,
                dtype=b.dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, 256, (2, 128, 384), generator=gen, device=dev,
                      dtype=torch.uint8)
    kinds = (stem_kernel.KERNEL, c3_kernel.KERNEL, down_kernel.KERNEL,
             neighbor_kernel.KERNEL)
    before = [k.launches for k in kinds]
    d, num = make_predict_fn(model, meta, 0.25, 0.45, 300,
                             multi_label=False)(x)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kinds, before))
    dp, nump = make_predict_fn(model, meta, 0.25, 0.45, 300,
                               multi_label=False, plain=True)(x)
    assert d.shape == dp.shape == (2, 300, 7) and torch.isfinite(d).all()
    assert int(nump.min()) > 0
    # bf16 rounding differs between kernel and plain convs: a score may
    # cross the threshold, so compare counts loosely
    assert (num - nump).abs().max() <= 2


# ---------------------------------------------------------------------------
# the fused train passes (ops/kernels/train_fused.py)
# ---------------------------------------------------------------------------

_PASS_STRUCTS = {
    "cv1_cv2": ((True,), ((0,),), (((0, 0),), ((0, 1),))),
    "b0_cv1": ((True,), ((0,),), (((0, 0),),)),
    "b1_cv1": ((True, True), ((0, 1),), (((0, 0),),)),
    "cv3": ((True, True, True, True), ((0, 1, 2), (3,)),
            (((0, 0), (1, 1)),)),
    # yolov5l's and yolov5x's cv3 (3 and 4 bottlenecks): more inputs than
    # the forward's shared memory may stage at their widths
    "cv3_l": ((True,) * 5, ((0, 1, 2, 3), (4,)), (((0, 0), (1, 1)),)),
    "cv3_x": ((True,) * 6, ((0, 1, 2, 3, 4), (5,)), (((0, 0), (1, 1)),)),
    "plain_input": ((True, False), ((0,), (1,)), (((0, 0), (1, 1)),)),
}


def _gbt(gen, c, dev):
    return torch.stack([1.0 + 0.3 * torch.randn(c, generator=gen, device=dev),
                        0.2 * torch.randn(c, generator=gen, device=dev)])


def _ulp(got, want):
    """bf16: within one ulp of the largest value."""
    return (got.float() - want.float()).abs().max() <= want.float().abs().max() / 128


def _rel(got, want, rel):
    return (got - want).abs().max() <= rel * want.abs().max()


@pytest.mark.parametrize("struct", sorted(_PASS_STRUCTS))
@pytest.mark.parametrize("H,W,ci,co", [
    (16, 16, 16, 32), (13, 21, 24, 40),
    # pixel counts not a multiple of the forward's 128-pixel tile, ci not a
    # multiple of 16, co not a multiple of its 48/96 chunk, the yolov5n/s
    # C3 widths
    (1, 1, 24, 40), (17, 33, 40, 200), (33, 18, 48, 96), (17, 33, 32, 16),
    (33, 18, 64, 32),
    # the yolov5l/x C3 widths: cv3 (64 → 128, 80 → 160), cv1+cv2's ci 160
    (33, 18, 64, 128), (17, 33, 80, 160), (17, 33, 160, 80)])
def test_pass_1x1_kernels(dev, struct, H, W, ci, co):
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    ns, groups, outs = _PASS_STRUCTS[struct]
    gen = torch.Generator(device=dev).manual_seed(6)
    B = 2
    zs = [torch.randn(B, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
          for _ in ns]
    gbs = [_gbt(gen, ci, dev) for _ in ns]
    nw = 1 + max(w for o in outs for _, w in o)
    ws = [torch.randn(ci, co, generator=gen, device=dev) / ci ** 0.5
          for _ in range(nw)]
    args = (ns, groups, outs, zs, gbs, ws)
    (zk, sk) = _counted(TF.KERNEL_1X1, lambda: TF.pass_1x1_fwd(*args))
    zp, sp = TF.pass_1x1_fwd_plain(*args)
    for a, b in zip(zk, zp):
        assert a.shape == b.shape and _ulp(a, b)
    for a, b in zip(sk, sp):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    dz = [torch.randn(z.shape, generator=gen, device=dev).to(torch.bfloat16)
          for z in zp]
    dst = [1e-3 * torch.randn(2, co, generator=gen, device=dev) for _ in zp]
    bargs = (*args, zp, dz, dst)
    gk = _counted(TF.KERNEL_1X1_BWD, lambda: TF.pass_1x1_bwd(*bargs))
    gp = TF.pass_1x1_bwd_plain(*bargs)
    for a, b in zip(gk[0], gp[0]):
        assert a.dtype == torch.bfloat16 and _ulp(a, b)
    for a, b, f in zip(gk[1], gp[1], ns):
        if f:
            assert _rel(a, b, 2e-2)
    for a, b in zip(gk[2], gp[2]):
        assert a.dtype == torch.float32 and _rel(a, b, 2e-2)
    # two stages, no atomics: repeated runs agree bit for bit
    sk2 = TF.pass_1x1_fwd(*args)[1]
    gk2 = TF.pass_1x1_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip(sk, sk2))
    assert all(torch.equal(a, b) for a, b in zip(gk[2], gk2[2]))
    assert all(torch.equal(a, b) for a, b in zip(gk[1], gk2[1]))


@pytest.mark.parametrize("struct,ci,co", [
    # yolov5x's cv3: 6 inputs at ci 80, more than the backward stages
    ("cv3_x", 80, 160),
    # 110 dW units of 16 x 16: more than one round of the backward's
    ("b0_cv1", 160, 176)])
def test_pass_1x1_backward_many_tiles(dev, struct, ci, co):
    """The 1x1 backward over many pixel tiles per CTA (2 x 64 x 64 pixels),
    with unstaged inputs and with dW in rounds: dz_in within one bf16 ulp,
    dW and (dg, db) within 2e-2 of the largest and bit for bit on repeat."""
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    ns, groups, outs = _PASS_STRUCTS[struct]
    gen = torch.Generator(device=dev).manual_seed(8)
    zs = [torch.randn(2, 64, 64, ci, generator=gen, device=dev).to(
        torch.bfloat16) for _ in ns]
    gbs = [_gbt(gen, ci, dev) for _ in ns]
    nw = 1 + max(w for o in outs for _, w in o)
    ws = [torch.randn(ci, co, generator=gen, device=dev) / ci ** 0.5
          for _ in range(nw)]
    args = (ns, groups, outs, zs, gbs, ws)
    zp, _ = TF.pass_1x1_fwd_plain(*args)
    dz = [torch.randn(z.shape, generator=gen, device=dev).to(torch.bfloat16)
          for z in zp]
    dst = [1e-3 * torch.randn(2, co, generator=gen, device=dev) for _ in zp]
    bargs = (*args, zp, dz, dst)
    gk = _counted(TF.KERNEL_1X1_BWD, lambda: TF.pass_1x1_bwd(*bargs))
    gp = TF.pass_1x1_bwd_plain(*bargs)
    for a, b in zip(gk[0], gp[0]):
        assert _ulp(a, b)
    for a, b in zip([*gk[1], *gk[2]], [*gp[1], *gp[2]]):
        assert _rel(a, b, 2e-2)
    gk2 = TF.pass_1x1_bwd(*bargs)
    assert all(torch.equal(a, b) for a, b in zip([*gk[0], *gk[1], *gk[2]],
                                                 [*gk2[0], *gk2[1], *gk2[2]]))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("H,W,ci,co", [(32, 32, 16, 32), (19, 27, 24, 40),
                                       (33, 18, 48, 96)])
def test_pass_3x3_kernels(dev, stride, H, W, ci, co):
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    gen = torch.Generator(device=dev).manual_seed(7)
    B = 2
    z = torch.randn(B, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
    gb = _gbt(gen, ci, dev)
    w = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    kern = TF.KERNEL_3X3S1 if stride == 1 else TF.KERNEL_3X3S2
    zk, sk = _counted(kern, lambda: TF.pass_3x3_fwd(z, gb, w, stride))
    zp, sp = TF.pass_3x3_fwd_plain(z, gb, w, stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    assert zk.shape == zp.shape == (B, Ho, Wo, co)
    assert _ulp(zk, zp)
    assert (sk - sp).abs().max() <= 1e-4 * sp.abs().max()
    assert torch.equal(sk, TF.pass_3x3_fwd(z, gb, w, stride)[1])


@pytest.mark.parametrize("cfg,n", [("yolov5n.yaml", 1), ("yolov5x.yaml", 4)])
def test_fused_region_kernels_match_plain(dev, cfg, n):
    """The fused train step through the kernels against the same step
    through the plain versions: launches per step and the loss.  yolov5x's
    C3 has 4 bottlenecks (a 6-input cv3 pass) at 80 channels."""
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    model, meta = create_model(cfg, nc=3, dtype=torch.bfloat16,
                               device="cuda", packed_stem=True,
                               fused_train=True)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (2, 96, 96 * 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    tg = torch.zeros(2, 4, 186, device=dev)
    tg[:, :2, 1:5] = torch.tensor([40.0, 50.0, 30.0, 20.0], device=dev)
    tg[:, :2, 6 + 90] = 1.0
    mask = torch.zeros(2, 4, dtype=torch.bool, device=dev)
    mask[:, :2] = True
    loss_fn = ComputeLoss(meta)
    kinds = (stem_kernel.TRAIN_FWD_KERNEL, stem_kernel.TRAIN_WGRAD_KERNEL,
             TF.KERNEL_3X3S2, TF.KERNEL_1X1, TF.KERNEL_1X1_BWD,
             TF.KERNEL_3X3S1, down_kernel.TRAIN_FWD_KERNEL)
    saved = {k: b.clone() for k, b in model.named_buffers()}
    losses = []
    for plain in (False, True):
        before = [k.launches for k in kinds]
        model.train()
        total, _ = loss_fn(model(x, plain=plain), tg, mask)
        total.backward()
        torch.cuda.synchronize()
        moved = [k.launches - b for k, b in zip(kinds, before)]
        want = [1, 1, 2, 2 + n, 2 + n, n, 0]
        assert moved == ([0] * 7 if plain else want), moved
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(saved[k])
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-2 * abs(losses[1])


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("H,W", _RAGGED)
@pytest.mark.parametrize("ci,co", [(2, 8), (6, 40), (8, 96), (24, 200),
                                   (40, 320), (48, 96), (80, 200), (48, 48),
                                   (16, 144)])
def test_pass_3x3_ragged(dev, stride, H, W, ci, co):
    """A 3x3 pass on the tensor-core body at ragged tiles, ci not a
    multiple of 16 (down to the contract's ci % 2), co not a multiple of
    its 48- or 96-channel chunk; z and the statistics repeat bit for
    bit."""
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    gen = torch.Generator(device=dev).manual_seed(13)
    z = torch.randn(2, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
    gb = _gbt(gen, ci, dev)
    w = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    kern = TF.KERNEL_3X3S1 if stride == 1 else TF.KERNEL_3X3S2
    zk, sk = _counted(kern, lambda: TF.pass_3x3_fwd(z, gb, w, stride))
    zp, sp = TF.pass_3x3_fwd_plain(z, gb, w, stride)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    assert zk.shape == zp.shape == (2, Ho, Wo, co)
    assert _ulp(zk, zp)
    assert (sk - sp).abs().max() <= 1e-4 * sp.abs().max()
    zk2, sk2 = TF.pass_3x3_fwd(z, gb, w, stride)
    assert torch.equal(zk, zk2) and torch.equal(sk, sk2)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("H,W,ci,co", [(2, 3, 8, 8), (17, 33, 24, 40),
                                       (33, 18, 48, 96), (19, 21, 6, 48)])
def test_pass_3x3_pads_after_the_activation(dev, stride, H, W, ci, co):
    """b = +3 on every channel: silu(b) is far from 0, so a kernel that
    padded the raw input (and activated the pad) fails the tolerance; the
    padding is of the activated input, as in the plain version."""
    from yolov5_obb_tpu_torch.ops.kernels import train_fused as TF

    gen = torch.Generator(device=dev).manual_seed(14)
    z = torch.randn(2, H, W, ci, generator=gen, device=dev).to(torch.bfloat16)
    gb = _gbt(gen, ci, dev)
    gb[1] = 3.0
    w = torch.randn(9 * ci, co, generator=gen, device=dev) / (9 * ci) ** 0.5
    zk, sk = TF.pass_3x3_fwd(z, gb, w, stride)
    zp, sp = TF.pass_3x3_fwd_plain(z, gb, w, stride)
    assert _ulp(zk, zp)
    assert (sk - sp).abs().max() <= 1e-4 * sp.abs().max()


def test_train_cli_shards_epoch(dev, tmp_path):
    """The train CLI on the card: one epoch of yolov5n at 256² from the
    ``--cache shards`` cache (written by the port's ``write_shards`` from
    chip_smoke's seeded set, no OpenCV), the stem train kernels launched
    once a step, finite loss items, ``last/`` and ``best/`` written."""
    import chip_smoke as C
    from yolov5_obb_tpu_torch import train
    from yolov5_obb_tpu_torch.data.shards import write_shards
    from yolov5_obb_tpu_torch.utils.general import load_hyp

    data, images = C.write_seeded_dota(tmp_path / "dota", 8, 256, 2,
                                       [f"c{i}" for i in range(15)],
                                       max_boxes=12)
    write_shards(C.seeded_train_set(data, images, 32, load_hyp()),
                 tmp_path / "runs" / "x" / "cache" / "shards", aug_epochs=1,
                 verbose=False)
    kernels = (stem_kernel.TRAIN_FWD_KERNEL, stem_kernel.TRAIN_WGRAD_KERNEL)
    before = [k.launches for k in kernels]
    run, _, _ = train.main([
        "--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz", "256",
        "--batch-size", "4", "--nominal-batch", "4", "--epochs", "1",
        "--max-labels", "32", "--cache", "shards", "--workers", "0",
        "--noval", "--noautoanchor", "--device", "cuda", "--project",
        str(tmp_path / "runs"), "--name", "x", "--exist-ok"])
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2]
    rows = (run / "results.csv").read_text().splitlines()
    assert len(rows) == 2
    assert np.isfinite([float(v) for v in rows[1].split(",")]).all()
    assert (run / "last" / "state.pt").is_file()
    assert (run / "best" / "state.pt").is_file()
