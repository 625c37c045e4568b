"""The per-layer metrics read from the port's own spans and counters, in a
traced run at test size: on the CPU the host ones come back positive and
the device-idle ones absent; on the card (``python -m pytest
benchmark/tests -m cuda``) all five come back.  Either way the port's
spans reach the trace's host intervals and never its device intervals
(kineto's device-side copies of annotations stay dropped, or ``busy_s``
would count them)."""

from __future__ import annotations

import io
import json

import pytest

from benchmark import trace
from benchmark.run import parse, run

SPANS = {"predict": {"predict", "predict.forward", "postproc.decode",
                     "postproc.nms"},
         "train_step": {"train.step", "train.h2d", "train.forward",
                        "train.loss", "train.backward", "train.optimizer",
                        "train.ema"}}
HOST = {"tiny.infer": {"host_syncs.infer"},
        "tiny.train": {"optimizer_ms.train", "loss_ms.train"}}
IDLE = {"tiny.infer": {"nms_idle_ms.infer"},
        "tiny.train": {"optimizer_idle_ms.train"}}


def traced_run(root, cell, monkeypatch):
    """One ``--trace 1`` run → (its last line, the traced slice)."""
    kept = []
    record = trace.record

    def keep(*a, **kw):
        kept.append(record(*a, **kw))
        return kept[-1]

    monkeypatch.setattr(trace, "record", keep)
    out = io.StringIO()
    rc = run(parse(["--workload", cell, "--seed", "3100000011",
                    "--seconds", "1", "--trace", "1"]), root=root,
             allow_cpu=True, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), kept[-1]


def check_spans(tr, cell):
    spans = SPANS["predict" if cell == "tiny.infer" else "train_step"]
    assert spans <= {n for n, _, _ in tr.host}
    assert not {n for n, _, _ in tr.device} & set().union(*SPANS.values())


@pytest.mark.parametrize("cell", ["tiny.infer", "tiny.train"])
def test_span_metrics_on_the_cpu(tiny_root, monkeypatch, cell):
    line, tr = traced_run(tiny_root, cell, monkeypatch)
    m = line["metrics"]
    for name in HOST[cell]:
        assert m[name]["value"] > 0, name
    assert not IDLE[cell] & set(m)
    check_spans(tr, cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.infer", "tiny.train"])
def test_span_metrics_on_the_card(tiny_root, monkeypatch, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")
    line, tr = traced_run(tiny_root, cell, monkeypatch)
    m = line["metrics"]
    for name in HOST[cell]:
        assert m[name]["value"] > 0, name
    for name in IDLE[cell]:
        assert m[name]["value"] >= 0, name
    assert tr.device
    check_spans(tr, cell)
