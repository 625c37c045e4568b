"""The port's spans and counters (``utils/profiler.span``, ``count``,
``counters``): off, ``span`` is one shared null context; under
``torch.profiler`` a predict call and a train step of yolov5m's graph at
width 0.25, 64², lay out their spans nested and in order; post-processing
counts its calls and each point where the host waits for the device, as
an independent count of those points predicts.  The ``cuda`` test holds
the count to ``torch.cuda.set_sync_debug_mode``'s warnings on the card;
run it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_port_tracing.py``.  The file imports no JAX."""

import contextlib
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolov5_obb_tpu_torch.engine import trainer
from yolov5_obb_tpu_torch.engine.evaluator import make_predict_fn
from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
from yolov5_obb_tpu_torch.engine.optim import build_optimizer
from yolov5_obb_tpu_torch.models.yolo import create_model, load_config
from yolov5_obb_tpu_torch.ops import rotated_nms as R
from yolov5_obb_tpu_torch.utils import profiler
from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains

S, B, NC = 64, 2, 15
CONF = 1e-6  # a fresh model's scores are ~1e-4: every anchor competes
PREDICT_SPANS = ["predict", "predict.forward", "postproc.decode",
                 "postproc.nms"]
TRAIN_SPANS = ["train.step", "train.h2d", "train.forward", "train.loss",
               "train.backward", "train.optimizer", "train.ema"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module, as the other port files: the suite
    runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_model(device="cpu"):
    cfg = load_config("yolov5m.yaml")
    cfg.update(width_multiple=0.25, depth_multiple=0.33)
    return create_model(cfg, nc=NC, device=device, seed=1)


def images(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, S, S, 3), generator=g,
                         dtype=torch.uint8).to(device)


def recorded(prof, names):
    """``[(name, t0, t1)]`` of the profiler's host events named in
    ``names``, by start."""
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in names and e.device_type()
           == torch.autograd.DeviceType.CPU]
    return sorted(evs, key=lambda e: e[1])


def assert_nested_in_order(evs, names):
    """One event a name; the first holds the rest, which follow one
    another without overlap in ``names``' order."""
    assert [n for n, _, _ in evs] == names
    (_, a, b), kids = evs[0], evs[1:]
    assert all(a <= k0 and k1 <= b for _, k0, k1 in kids)
    assert all(x[2] <= y[1] for x, y in zip(kids, kids[1:]))


def test_span_off_is_one_null_context():
    assert not torch._C._autograd._profiler_enabled()
    off = profiler.span("predict")
    assert off is profiler.span("train.step")
    assert isinstance(off, contextlib.nullcontext)
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("on"):
            pass
    # the span entered before the session left nothing in it
    assert [n for n, _, _ in recorded(prof, {"predict", "train.step",
                                             "on"})] == ["on"]


@pytest.fixture(scope="module")
def predict_model():
    return small_model()


def test_predict_spans(predict_model):
    model, meta = predict_model
    predict = make_predict_fn(model, meta, CONF, 0.45, 300,
                              multi_label=False, max_candidates=512)
    x = images()
    predict(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict(x)
    assert_nested_in_order(recorded(prof, set(PREDICT_SPANS)), PREDICT_SPANS)


def test_train_step_spans():
    model, meta = small_model()
    hyp = load_hyp()
    loss_fn = ComputeLoss(meta, scale_hyp_gains(hyp, meta.nl, meta.nc, S))
    opt, _ = build_optimizer(model, hyp, epochs=1, steps_per_epoch=10,
                             batch_size=B, nominal_batch=B)
    state = trainer.create_train_state(opt)
    step = trainer.make_train_step(model, loss_fn, opt, device="cpu")
    tg = torch.zeros(B, 4, 186)
    tg[:, 0, 1:6] = torch.tensor([32.0, 32.0, 20.0, 10.0, 0.3])
    mask = torch.zeros(B, 4, dtype=torch.bool)
    mask[:, 0] = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, images(), tg, mask)
    assert_nested_in_order(recorded(prof, set(TRAIN_SPANS)), TRAIN_SPANS)


def expected_syncs(spy, nl, classes):
    """The blocking points a post-processing call passes, counted apart
    from the port's counter: four grid and anchor copies a level, with
    ``classes`` the class filter's two a level (its index, then the value
    assigned through it: the card's sync debug mode warns of both), the
    tier's read, and the greedy loop's convergence reads, found by running
    its fixed point again on the arguments it was given."""
    sweeps = 0
    for sup_in, nbr_idx, valid in spy:
        b, n, m = nbr_idx.shape
        alive, prev = valid.cpu(), ~valid.cpu()
        sup_in, idx = sup_in.cpu(), nbr_idx.cpu().long().reshape(b, n * m)
        it = 0
        while it < n:
            sweeps += 1
            if torch.equal(alive, prev):
                break
            prev = alive
            hit = (torch.gather(alive, 1, idx).reshape(b, n, m)
                   & sup_in).any(-1)
            alive = valid.cpu() & ~hit
            it += 1
    return 4 * nl + (2 * nl if classes else 0) + 1 + sweeps


def counted_call(monkeypatch, maps, meta, **kw):
    """One ``non_max_suppression_from_maps`` call → (counter deltas, the
    arguments of each greedy resolution it made)."""
    spy, inner = [], R._resolve_greedy

    def resolve(sup_in, nbr_idx, valid):
        spy.append((sup_in.clone(), nbr_idx.clone(), valid.clone()))
        return inner(sup_in, nbr_idx, valid)

    monkeypatch.setattr(R, "_resolve_greedy", resolve)
    before = profiler.counters()
    R.non_max_suppression_from_maps(maps, meta, **kw)
    after = profiler.counters()
    monkeypatch.setattr(R, "_resolve_greedy", inner)
    delta = {k: after[k] - before[k] for k in ("postproc.calls",
                                               "postproc.host_syncs")}
    return delta, spy


@pytest.mark.parametrize("multi_label,classes", [(False, None),
                                                 (True, (0, 3, 7))])
def test_postproc_counts_its_host_syncs(predict_model, monkeypatch,
                                        multi_label, classes):
    model, meta = predict_model
    with torch.inference_mode():
        maps = model(images().float() / 255.0)
    kw = dict(conf_thres=CONF, iou_thres=0.45, max_candidates=512,
              max_det=300, multi_label=multi_label, classes=classes)
    delta, spy = counted_call(monkeypatch, maps, meta, **kw)
    assert delta["postproc.calls"] == 1
    assert len(spy) == 1 and spy[0][2].any()  # candidates reached the NMS
    assert delta["postproc.host_syncs"] == expected_syncs(spy, meta.nl,
                                                          classes)


@pytest.mark.cuda
@pytest.mark.parametrize("multi_label,classes", [(False, None),
                                                 (True, (0, 3, 7))])
def test_host_syncs_match_sync_debug_mode(monkeypatch, multi_label, classes):
    """On the card, the counter's delta over one post-processing call is
    the number of synchronising calls the sync debug mode warns of."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the sync debug mode is CUDA's)")
    model, meta = small_model("cuda")
    with torch.inference_mode():
        maps = model(images("cuda").float() / 255.0)
        kw = dict(conf_thres=CONF, iou_thres=0.45, max_candidates=512,
                  max_det=300, multi_label=multi_label, classes=classes)
        R.non_max_suppression_from_maps(maps, meta, **kw)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                delta, spy = counted_call(monkeypatch, maps, meta, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{w.filename}:{w.lineno}" for w in caught
             if "synchronizing" in str(w.message)]
    assert delta["postproc.calls"] == 1
    assert delta["postproc.host_syncs"] == expected_syncs(spy, meta.nl,
                                                          classes)
    assert delta["postproc.host_syncs"] == len(sites), np.unique(
        sites, return_counts=True)
