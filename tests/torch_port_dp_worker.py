"""Worker of the port's two-process data-parallel tests
(test_torch_port_distributed.py, test_torch_port_val_mesh.py).  Imports
nothing of JAX.

    python tests/torch_port_dp_worker.py step IN OUT
    python tests/torch_port_dp_worker.py cli OUT -- <train argv>
    python tests/torch_port_dp_worker.py val OUT -- <val argv>

Each process joins the group from torchrun's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) through
``engine/distributed.maybe_initialize``, gloo on the CPU, with one torch
thread and every stride-2 3x3 on the downsample train path's plain
versions.

- ``step``: the train step over a mesh on this rank's strided rows of the
  global batches in IN (a ``torch.save`` of the initial state dict, the
  batches, the remat mode and whether the model runs the fused train
  region); writes the
  loss, the items, the parameters, the statistics, the EMA and a
  ``broadcast_scalar`` of ``rank + 0.25`` to OUT.
- ``cli``: the train CLI (``train.main``, which joins and leaves the group
  itself, and evolves under ``--evolve``) on the argv after ``--``; writes
  the model's final state dict to ``OUT/rank{RANK}.pt`` and to
  ``OUT/record{RANK}.json`` the checkpoint writes this rank made, the
  steps it took and the hyps each of its runs trained with.
- ``val``: the val CLI (``val.main``, which joins and leaves the group
  itself under ``--mesh``) on the argv after ``--``; writes its result
  (metrics and per-image detections), the rows of each predict call and
  the images this rank loaded to ``OUT/val{RANK}.pt``.
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CFG, NC, S = "yolov5n.yaml", 15, 64


def run_steps(sd, batches, mesh=None, remat=False, fused=False):
    """The port's float32 packed-stem yolov5n step from ``sd`` over
    ``batches`` (global batches; a mesh takes its rows) on the CPU.
    Returns the per-step loss and items and the final tensors."""
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.engine.trainer import (
        create_train_state,
        make_train_step,
        put_batch,
    )
    from yolov5_obb_tpu_torch.models.yolo import create_model
    from yolov5_obb_tpu_torch.utils.general import load_hyp, scale_hyp_gains

    model, meta = create_model(CFG, nc=NC, device="cpu", packed_stem=True,
                               fused_train=fused)
    model.load_state_dict(sd)
    hyp = load_hyp()
    B = batches[0][0].shape[0]
    opt, _ = build_optimizer(model, hyp, 10, 100, B, B)
    state = create_train_state(opt)
    step = make_train_step(model, ComputeLoss(meta, scale_hyp_gains(
        hyp, meta.nl, NC, S)), opt, mesh=mesh, remat=remat, device="cpu")
    out = {"loss": [], "items": []}
    for b in batches:
        m = step(state, *put_batch(b, mesh))
        out["loss"].append(float(m["loss"]))
        out["items"].append(m["items"].tolist())
    out["state"] = {k: t.clone() for k, t in model.state_dict().items()}
    out["ema"] = {k: t.clone() for k, t in state.ema.items()}
    return out


def _step(src, dst):
    from yolov5_obb_tpu_torch.engine import distributed as D

    # the second call finds the group and joins nothing again
    assert D.maybe_initialize("cpu") and D.maybe_initialize("cpu")
    try:
        data = torch.load(src)
        out = run_steps(data["state"], data["batches"], mesh=D.make_mesh(),
                        remat=data["remat"], fused=data["fused"])
        out["broadcast"] = D.broadcast_scalar(D.process_index() + 0.25)
        out["world"] = D.process_count()
        torch.save(out, dst)
    finally:
        D.shutdown()


def _cli(out_dir, argv):
    import json

    from yolov5_obb_tpu_torch import train

    made, writes, steps, hyps = [], [], [0], []
    real_step, real_run = train.make_train_step, train.run

    def capture(model, *a, **k):
        made.append(model)
        step = real_step(model, *a, **k)

        def counted(*sa, **sk):
            steps[0] += 1
            return step(*sa, **sk)
        return counted

    def run(opt, hyp_override=None, callbacks=None):
        hyps.append(hyp_override)
        return real_run(opt, hyp_override=hyp_override, callbacks=callbacks)

    def recorded(name):
        fn = getattr(train, name)

        def wrapper(*a, **k):
            writes.append(name)
            return fn(*a, **k)
        return wrapper

    train.make_train_step, train.run = capture, run
    for name in ("save_checkpoint", "save_weights"):
        setattr(train, name, recorded(name))
    train.main(argv)
    rank = os.environ["RANK"]
    torch.save(made[-1].state_dict(), os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"record{rank}.json"), "w") as f:
        json.dump({"writes": writes, "steps": steps[0], "hyps": hyps}, f,
                  default=float)


def _val(out_dir, argv):
    from yolov5_obb_tpu_torch import val
    from yolov5_obb_tpu_torch.data.dota import DotaDataset
    from yolov5_obb_tpu_torch.engine import evaluator

    rows, real = [], evaluator.make_predict_fn

    def recorded(*a, **k):
        predict = real(*a, **k)

        def counted(images):
            rows.append(len(images))
            return predict(images)
        counted.packed_stem, counted.device = predict.packed_stem, \
            predict.device
        return counted

    loaded, sample = [], DotaDataset.get_eval_sample

    def load(self, i):
        loaded.append(i)
        return sample(self, i)

    evaluator.make_predict_fn = recorded
    DotaDataset.get_eval_sample = load
    res = val.main(argv)
    res["predict_rows"], res["loaded"] = rows, loaded
    torch.save(res, os.path.join(out_dir, f"val{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    from yolov5_obb_tpu_torch.models import layers

    torch.set_num_threads(1)
    # every stride-2 3x3 on the downsample train path, as the tests' own
    # runs of run_steps set it
    layers.FUSED_DOWN_MIN_SPATIAL = 0
    if sys.argv[1] == "step":
        _step(sys.argv[2], sys.argv[3])
    else:
        run = _val if sys.argv[1] == "val" else _cli
        run(sys.argv[2], sys.argv[sys.argv.index("--") + 1:])
