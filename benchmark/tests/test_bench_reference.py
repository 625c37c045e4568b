"""The plain reference against the port at small sizes on the CPU, in
float32, where the two must agree to rounding: the Detect maps (packed
stem and stock stem), the NMS keep sets on the same maps (single- and
multi-label), and a train step's loss, gradients and update.  This
catches faults in the reference itself."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark import weights as W
from benchmark.drivers import predict as P
from benchmark.reference import loss as RL
from benchmark.reference import nms as RN

from .conftest import BENCH


def _model_dict(width=0.25, depth=0.33, cfg="yolov5m-obb-1024"):
    md = json.loads((BENCH / "configs" / f"{cfg}.json").read_text())["model"]
    md.update(width_multiple=width, depth_multiple=depth)
    return md


def _port(md, packed, sd):
    from yolov5_obb_tpu_torch.models.yolo import create_model

    model, meta = create_model(md, nc=15, dtype=torch.float32, device="cpu",
                               packed_stem=packed)
    model.load_state_dict(sd)
    return model, meta


@pytest.mark.parametrize("cfg,size", [("yolov5m-obb-1024", 64),
                                      ("yolov5m6-obb-1280", 128)])
@pytest.mark.parametrize("packed", [True, False])
def test_maps_match_the_port(cfg, size, packed):
    md = _model_dict(cfg=cfg)
    sd = W.state_dict(md, 15, 11, "cpu")
    img = torch.randint(0, 256, (2, size, size, 3),
                        generator=torch.Generator().manual_seed(3),
                        dtype=torch.uint8)
    ref = W.reference_model(md, 15, sd, "cpu").eval()
    model, meta = _port(md, packed, sd)
    x = img.view(2, size, size * 3) if packed else img.float() / 255
    with torch.no_grad():
        got, want = model(x), ref(img)
    assert len(got) == len(want) == meta.nl
    assert np.allclose(meta.anchors_px, ref.anchors_px.numpy())
    assert tuple(meta.strides) == ref.strides
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert compare.rel_err(a, b) < 1e-5


@pytest.mark.parametrize("multi_label,conf,maxc", [(False, 0.25, 2048),
                                                   (True, 0.01, 4096)])
def test_nms_matches_the_port(multi_label, conf, maxc):
    """The same float32 maps through the port's post-processing and the
    reference's give the same detections."""
    from yolov5_obb_tpu_torch.ops.rotated_nms import (
        non_max_suppression_from_maps,
    )

    md = _model_dict()
    sd = W.state_dict(md, 15, 12, "cpu")
    img = torch.randint(0, 256, (2, 256, 256, 3),
                        generator=torch.Generator().manual_seed(4),
                        dtype=torch.uint8)
    W.settle_batchnorm(sd, md, 15, img)
    W.scale_head(sd, md, 15, img)
    W.shift_objectness(sd, md, 15, 3.0)
    ref = W.reference_model(md, 15, sd, "cpu").eval()
    _, meta = _port(md, False, sd)
    with torch.no_grad():
        maps = ref(img)
    tr = dict(conf=conf, iou=0.45, max_candidates=maxc, max_det=1500,
              multi_label=multi_label)
    dets, num = non_max_suppression_from_maps(
        maps, meta, conf, 0.45, maxc, 1500, multi_label=multi_label)
    got = P.program_dets(dets, num)
    want = P.reference_dets(ref, maps, 15, tr)
    assert sum(len(w) for w in want) > 20
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert np.allclose(g, w, atol=1e-4)
    assert compare.detections(got, want)["det_unmatched"] == 0


def test_rotated_iou():
    """Identical boxes 1, disjoint 0, axis-aligned boxes the closed form,
    a square turned 45 degrees over itself the octagon's area."""
    g = torch.Generator().manual_seed(0)
    n = 2000
    b = torch.stack([torch.rand(n, generator=g) * 500,
                     torch.rand(n, generator=g) * 500,
                     torch.rand(n, generator=g) * 100 + 1,
                     torch.rand(n, generator=g) * 100 + 1,
                     (torch.rand(n, generator=g) - 0.5) * math.pi], 1)
    assert torch.allclose(RN.rotated_iou_pairs(b, b),
                          torch.ones(n, dtype=torch.float64))
    far = b.clone()
    far[:, 0] += 1000
    assert RN.rotated_iou_pairs(b, far).abs().max() == 0
    a, c = b.clone(), b.clone()
    a[:, 4] = c[:, 4] = 0
    c[:, :2] += torch.rand(n, 2, generator=g) * 50
    a, c = a.double(), c.double()
    ix = (torch.minimum(a[:, 0] + a[:, 2] / 2, c[:, 0] + c[:, 2] / 2)
          - torch.maximum(a[:, 0] - a[:, 2] / 2, c[:, 0] - c[:, 2] / 2))
    iy = (torch.minimum(a[:, 1] + a[:, 3] / 2, c[:, 1] + c[:, 3] / 2)
          - torch.maximum(a[:, 1] - a[:, 3] / 2, c[:, 1] - c[:, 3] / 2))
    inter = ix.clamp(min=0) * iy.clamp(min=0)
    closed = inter / (a[:, 2] * a[:, 3] + c[:, 2] * c[:, 3] - inter)
    assert torch.allclose(RN.rotated_iou_pairs(a, c), closed, atol=1e-9)
    sq = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0]])
    turned = torch.tensor([[0.0, 0.0, 2.0, 2.0, math.pi / 4]])
    octagon = 8 * (math.sqrt(2) - 1)
    assert abs(float(RN.rotated_iou_pairs(sq, turned))
               - octagon / (8 - octagon)) < 1e-12


@pytest.mark.parametrize("nominal", [2, 4])
def test_loss_and_step_match_the_port(nominal):
    """One float32 train step: the loss items, every gradient and the
    optimizer's updates against the port's, one update a micro-batch
    (nominal batch 2) or one in two (4)."""
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.utils.general import scale_hyp_gains

    from benchmark.drivers.train_step import make_batches

    md = _model_dict()
    tr = json.loads((BENCH / "traffic" / "train_b16_dota.json").read_text())
    tr.update(batch=2, pool=1, max_labels=16, box_px=[4, 30],
              nominal_batch=nominal)
    tr["labels"]["gap"] = 16
    img, tg, mask = make_batches(tr, 64, 5, torch.device("cpu"))[0]
    assert 0 < int(mask.sum()) < mask.numel()
    sd = W.state_dict(md, 15, 13, "cpu")
    ref = W.reference_model(md, 15, sd, "cpu").train()
    model, meta = _port(md, True, sd)
    model.train()
    hyp = tr["hyp"]
    want_total, want_items = RL.loss(
        ref(img), tg, mask, ref.anchors_px, ref.strides, 15,
        RL.scaled_gains(hyp, ref.nl, 15, 64))
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, 15, 64))
    got_total, got_items = loss_fn(model(img.view(2, 64, 192)), tg, mask)
    assert torch.allclose(got_items, want_items, rtol=1e-5, atol=1e-7)
    names = [n for n, _ in ref.named_parameters()]
    gw = dict(zip(names, torch.autograd.grad(
        want_total, list(ref.parameters()))))
    pnames = [n for n, _ in model.named_parameters()]
    assert pnames == names
    gg = dict(zip(pnames, torch.autograd.grad(
        got_total, list(model.parameters()))))
    scale = float(np.median([float(g.norm()) for g in gw.values()]))
    for n in names:  # float32 sums in other orders
        assert float((gg[n] - gw[n]).norm()) <= 1e-4 * max(
            float(gw[n].norm()), scale), n
    opt, _ = build_optimizer(model, hyp, epochs=tr["epochs"],
                             steps_per_epoch=tr["steps_per_epoch"],
                             batch_size=2, nominal_batch=nominal)
    state = opt.init()
    sgd = RL.SGD(list(ref.named_parameters()), hyp, tr["epochs"],
                 tr["steps_per_epoch"], 2, nominal)
    assert sgd.accumulate == opt.accumulate == nominal // 2
    for _ in range(2 * sgd.accumulate):  # two updates
        assert opt.apply(state, [gg[n] for n in names]) == \
            sgd.apply([gg[n] for n in names])
    assert state.count == sgd.count == 2
    for (n, p), (_, q) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert torch.allclose(p, q, rtol=1e-6, atol=1e-9), n
