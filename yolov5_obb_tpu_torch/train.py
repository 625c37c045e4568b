"""Training CLI: DOTA tiles in, checkpoints and ``results.csv`` out.

    python -m yolov5_obb_tpu_torch.train --data data.yaml --cfg yolov5m.yaml \\
        --imgsz 1024 --batch-size 16 --epochs 300 --workers 8

Counterpart of the JAX package's ``train.py`` (:52-497), the same flags and
flow: the datasets (``--cache ram|disk|shards``), the model (``--weights``:
a checkpoint directory or a state-dict ``.pt``), autoanchor or the resumed
checkpoint's anchors, ``ComputeLoss`` (``--dense-loss``), the optimizer
(``--adam``, ``--linear-lr``, ``--freeze``, ``--nominal-batch``), the epoch
loop with the loss items kept on the device until a log point, evaluation
with the EMA weights at conf 0.01 / IoU 0.4 (unless ``--noval``),
``fitness``, ``results.csv``, the ``last``/``best``/``epoch{n}``
checkpoints (``utils/checkpoint.py``), ``--patience``, ``--save-period``
and the callbacks.

Runs on the card unless ``--device cpu``.  On the card the model takes the
packed uint8 image and its stem and downsample train kernels
(``--packed-stem``, default on there in bfloat16, the default dtype; off
in float32, whose stem the kernels cannot compute, and on the CPU);
``--fused-train`` (layers 0-3 as the fused pass chain) stays opt-in.  A
machine without OpenCV trains from the pre-augmented shard cache
(``--cache shards``, built once where OpenCV is, under
``<project>/<name>/cache/shards``).  As in the JAX CLI, ``labels.png`` (the
label distribution), ``train_batch0.png`` (the first batch with its
boxes) and ``results.png`` (the ``results.csv`` curves) are drawn where
matplotlib and OpenCV import; a plot that fails is reported and the run
goes on.

As in the JAX CLI, ``--weights`` gives the parameters and BatchNorm
buffers alone (the config's anchors stay until autoanchor runs; ``--resume``
restores a checkpoint's anchors), and the logged ``x/lr0`` is the learning
rate at the micro-step count.  ``--bn-half`` sets ``YOLO_BN_HALF=1``
(train-mode BN output and SiLU in bfloat16, ``models/layers.bn_dtype``);
the default is off, as in the JAX CLI off the TPU.  Not ported (each raises
``NotImplementedError``): ``--remat``, more than one process and
``--evolve`` (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from pathlib import Path

import numpy as np
import torch

from .data.dota import DotaDataset
from .data.loader import WorkerPool, create_dataloader
from .data.shards import ShardDataset, write_shards
from .data.tools import labels_to_class_weights, labels_to_image_weights
from .engine.evaluator import evaluate
from .engine.loss import ComputeLoss
from .engine.optim import build_optimizer
from .engine.trainer import create_train_state, make_train_step
from .models.yolo import create_model
from .utils.autoanchor import check_anchors
from .utils.callbacks import Callbacks
from .utils.checkpoint import (
    load_model_weights,
    restore_checkpoint,
    restore_model_meta,
    save_checkpoint,
    save_weights,
)
from .utils.device import resolve_device
from .utils.general import (
    increment_path,
    init_seeds,
    load_dataset_config,
    load_hyp,
    scale_hyp_gains,
)
from .utils.loggers import Loggers
from .utils.metrics import fitness

ZERO_METRICS = {"mp": 0.0, "mr": 0.0, "map50": 0.0, "map": 0.0}


def parse_opt(args=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.train")
    p.add_argument("--cfg", type=str, default="yolov5n.yaml")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--hyp", type=str, default=None)
    p.add_argument("--weights", type=str, default="",
                   help="initial weights: a checkpoint directory or a "
                        "state-dict .pt")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--nominal-batch", type=int, default=64,
                   help="gradient-accumulation target batch (reference "
                        "nbs=64)")
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--max-labels", type=int, default=500)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noval", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--noautoanchor", action="store_true",
                   help="skip the anchor-fit check and evolution")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="class BCE label smoothing epsilon (overrides hyp)")
    p.add_argument("--cache", type=str, default=None,
                   choices=["ram", "disk", "shards"],
                   help="ram/disk: cache the resized images; shards: replay "
                        "pre-augmented memory-mapped shards")
    p.add_argument("--aug-epochs", type=int, default=4,
                   help="--cache shards: pre-augmented variants per sample")
    p.add_argument("--packed-stem", dest="packed_stem", default=None,
                   action="store_true",
                   help="the packed uint8 image and the stem/downsample "
                        "train kernels (default: on for CUDA in "
                        "bfloat16)")
    p.add_argument("--no-packed-stem", dest="packed_stem",
                   action="store_false")
    p.add_argument("--fused-train", dest="fused_train", default=None,
                   action="store_true",
                   help="layers 0-3 as the stat-carrying fused pass chain "
                        "(needs the packed stem; default off)")
    p.add_argument("--no-fused-train", dest="fused_train",
                   action="store_false")
    p.add_argument("--dense-loss", action="store_true",
                   help="the scatter-free dense loss formulation")
    p.add_argument("--val-images", type=int, default=None,
                   help="cap the val set during training")
    p.add_argument("--save-period", type=int, default=-1)
    p.add_argument("--patience", type=int, default=100,
                   help="early-stop patience (epochs)")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--image-weights", action="store_true",
                   help="sample images by inverse class frequency")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--freeze", type=int, default=0,
                   help="freeze the first N graph layers")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint directory to resume from")
    p.add_argument("--wandb", action="store_true",
                   help="W&B logging (also on with WANDB_API_KEY set)")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--project", type=str, default="runs/train")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--bn-half", dest="bn_half", default=None,
                   action="store_true",
                   help="train-mode BN output and SiLU in bfloat16 "
                        "(YOLO_BN_HALF=1; statistics stay float32)")
    p.add_argument("--no-bn-half", dest="bn_half", action="store_false")
    # not ported: each raises NotImplementedError when asked for
    p.add_argument("--remat", nargs="?", const="full", default="",
                   choices=["", "full", "selective"])
    p.add_argument("--evolve", type=int, default=0)
    return p.parse_args(args)


def _refuse_unported(opt) -> None:
    for flag, what, item in (("remat", "--remat", 7),
                             ("evolve", "--evolve", 7)):
        if getattr(opt, flag):
            raise NotImplementedError(f"{what} is not ported "
                                      f"(ROADMAP.md queue 1 item {item})")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("training in more than one process is not "
                                  "ported (ROADMAP.md queue 1 item 7)")


def _to_device(batch, device, packed: bool):
    """A loader batch → (image, targets, mask) on ``device``; the image as
    the packed ``(B, H, 3W)`` view for a packed-stem model."""
    image, targets, mask = (torch.as_tensor(a) for a in (
        batch.image, batch.targets, batch.target_mask))
    if packed:
        image = image.reshape(image.shape[0], image.shape[1], -1)
    return tuple(t.to(device, non_blocking=True)
                 for t in (image, targets, mask))


def run(opt, callbacks=None):
    """Train as ``opt`` says → ``(save_dir, best_fitness, metrics of the
    best epoch)``."""
    _refuse_unported(opt)
    device = resolve_device(opt.device)
    callbacks = callbacks or Callbacks()
    callbacks.run("on_pretrain_routine_start")
    init_seeds(opt.seed)
    d = load_dataset_config(opt.data)
    hyp = load_hyp(opt.hyp)
    if opt.label_smoothing is not None:
        hyp["label_smoothing"] = float(opt.label_smoothing)
    # --single-cls: the annotations parse with the dataset's class names
    # (the dataset zeroes the ids); the model and metrics see one class
    single_cls = opt.single_cls
    nc = 1 if single_cls else d["nc"]
    names = ["item"] if single_cls and len(d["names"]) != 1 else d["names"]
    save_dir = increment_path(Path(opt.project) / opt.name,
                              exist_ok=opt.exist_ok)
    print(f"run dir: {save_dir}; device: {device}")

    # --- data ---------------------------------------------------------
    use_shards = opt.cache == "shards"
    cache_images = None if use_shards else opt.cache
    train_ds = DotaDataset(
        d["train"], d["names"], img_size=opt.imgsz, hyp=hyp, augment=True,
        max_labels=opt.max_labels, cache_dir=save_dir / "cache",
        single_cls=single_cls, cache_images=cache_images)
    shard_ds = None
    if use_shards:
        sdir = save_dir / "cache" / "shards"
        if not (sdir / "meta.json").exists():
            print(f"building pre-augmented shard cache ({opt.aug_epochs} "
                  "variants/sample)...")
            write_shards(train_ds, sdir, aug_epochs=opt.aug_epochs,
                         seed=opt.seed)
        shard_ds = ShardDataset(sdir)
    val_ds = None
    if not opt.noval and d.get("val"):
        val_ds = DotaDataset(
            d["val"], d["names"], img_size=opt.imgsz, hyp=hyp, augment=False,
            max_labels=1000, cache_dir=save_dir / "cache",
            single_cls=single_cls, cache_images=cache_images)
    steps_per_epoch = max(len(train_ds) // opt.batch_size, 1)

    # the label distribution at the start (JAX train.py:208-220)
    try:
        from .ops.geometry import poly2rbox
        from .utils.plots import plot_labels

        all_polys = [p for p in train_ds.polys if len(p)]
        if all_polys:
            rb = poly2rbox(np.concatenate(all_polys).astype(np.float64))
            plot_labels(rb, np.concatenate([c for c in train_ds.cls
                                            if len(c)]), names, save_dir)
    except Exception as e:
        print(f"plot_labels failed: {e}")

    # --- model / loss / optimizer -------------------------------------
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    packed = opt.packed_stem
    if packed is None:
        # the stem kernels compute bf16: a float32 run keeps the stock stem
        # (the JAX package's float32 model takes XLA's conv there too)
        packed = device.type == "cuda" and dtype == torch.bfloat16
    fused_train = bool(opt.fused_train) and packed
    # bf16 BN/SiLU on the train path (JAX train.py:234-238; off unless
    # asked, as the JAX CLI is off the TPU)
    if opt.bn_half:
        os.environ["YOLO_BN_HALF"] = "1"
    model, meta = create_model(opt.cfg, nc=nc, dtype=dtype, device=device,
                               seed=opt.seed, packed_stem=packed,
                               fused_train=fused_train)
    if opt.weights:
        load_model_weights(model, None, opt.weights)  # weights, no anchors

    # anchor-fit check and evolution (reference train.py:241); the anchors
    # live in meta, so an update reaches the loss and the decode.  A resumed
    # run takes the checkpoint's anchors instead, before the loss reads them.
    if not opt.resume and not opt.noautoanchor:
        meta.anchors_px = check_anchors(train_ds, meta,
                                        thr=hyp.get("anchor_t", 4.0),
                                        imgsz=opt.imgsz)
    optimizer, opt_info = build_optimizer(
        model, hyp, epochs=opt.epochs, steps_per_epoch=steps_per_epoch,
        batch_size=opt.batch_size, nominal_batch=opt.nominal_batch,
        linear_lr=opt.linear_lr, use_adam=opt.adam,
        freeze=opt.freeze)
    print(f"optimizer: {'adam' if opt.adam else 'sgd'} "
          f"accumulate={opt_info['accumulate']} "
          f"wd={opt_info['weight_decay']:.5f} steps/epoch={steps_per_epoch}")
    state = create_train_state(optimizer)
    start_epoch = 0
    best_fit = -1.0
    if opt.resume:
        state, ckpt_meta = restore_checkpoint(opt.resume, model, state)
        restore_model_meta(meta, ckpt_meta)
        start_epoch = int(ckpt_meta.get("epoch", 0)) + 1
        best_fit = float(ckpt_meta.get("best_fitness", -1.0))
        print(f"resumed from {opt.resume} at epoch {start_epoch}")
    hyp_scaled = scale_hyp_gains(hyp, meta.nl, meta.nc, opt.imgsz)
    # dense None: YOLO_DENSE_LOSS from the environment decides (off)
    loss_fn = ComputeLoss(meta, hyp_scaled, dense=opt.dense_loss or None)
    step_fn = make_train_step(model, loss_fn, optimizer, device=device)
    # evaluation runs a copy of the model with the EMA parameters
    eval_model = copy.deepcopy(model) if val_ds is not None else None

    # --- loop ----------------------------------------------------------
    class_weights = (labels_to_class_weights(train_ds.cls, meta.nc)
                     if opt.image_weights else None)
    iw_rng = np.random.default_rng(opt.seed + 99)

    patience_left = opt.patience
    final_metrics = None  # the metrics of the best-fitness epoch
    loader_ds = shard_ds if shard_ds is not None else train_ds
    use_wandb = opt.wandb or bool(os.environ.get("WANDB_API_KEY"))
    loggers = Loggers(save_dir, hyp=hyp, opt=opt,
                      include=("csv", "tb", "wandb") if use_wandb
                      else ("csv", "tb"))
    workers = WorkerPool(loader_ds, opt.workers) if opt.workers > 0 else None
    try:
        loggers.log_dataset_artifact(opt.data)
        callbacks.run("on_pretrain_routine_end")
        callbacks.run("on_train_start")
        for epoch in range(start_epoch, opt.epochs):
            callbacks.run("on_train_epoch_start")
            t0 = time.time()
            indices = None
            if opt.image_weights:
                iw = labels_to_image_weights(train_ds.cls, meta.nc,
                                             class_weights)
                indices = iw_rng.choice(len(train_ds), size=len(train_ds),
                                        p=iw)
            if shard_ds is not None:
                # an epoch: a fresh pre-augmented variant of each source
                indices = shard_ds.epoch_indices(epoch, seed=opt.seed,
                                                 source_indices=indices)
            loader = create_dataloader(
                loader_ds, opt.batch_size, shuffle=shard_ds is None,
                augment=True, seed=opt.seed + epoch, num_epochs=1,
                indices=indices, workers=workers)
            # the loss items add up on the device; reading them syncs, so
            # the host reads them only at log points
            mloss_dev = None
            nb = 0
            for batch in loader:
                if epoch == start_epoch and nb == 0:
                    try:  # the first batch with its boxes (JAX :378-387)
                        from .utils.plots import plot_images

                        plot_images(batch.image, batch.targets,
                                    batch.target_mask, names,
                                    save_dir / "train_batch0.png")
                    except Exception as e:
                        print(f"train-batch plot failed: {e}")
                callbacks.run("on_train_batch_start", epoch=epoch, step=nb)
                m = step_fn(state, *_to_device(batch, device,
                                               model.packed_stem))
                mloss_dev = m["items"] if mloss_dev is None else (
                    mloss_dev + m["items"])
                nb += 1
                callbacks.run("on_train_batch_end", epoch=epoch, step=nb)
                if nb % opt.log_interval == 0:
                    cur = mloss_dev.double().cpu().numpy() / nb
                    print(f"epoch {epoch} step {nb}/{steps_per_epoch} "
                          f"box {cur[0]:.4f} obj {cur[1]:.4f} "
                          f"cls {cur[2]:.4f} theta {cur[3]:.4f}")
            mloss = (mloss_dev.double().cpu().numpy() / nb
                     if mloss_dev is not None else np.zeros(4))
            callbacks.run("on_train_epoch_end", epoch=epoch)

            metrics = dict(ZERO_METRICS)
            if val_ds is not None:
                callbacks.run("on_val_start")
                eval_model.load_state_dict(state.ema_state_dict(model))
                metrics = evaluate(eval_model, meta, val_ds,
                                   batch_size=max(opt.batch_size, 2),
                                   conf_thres=0.01, iou_thres=0.4,
                                   verbose=True, max_images=opt.val_images)
                callbacks.run("on_val_end", metrics=metrics)
            fit = fitness(metrics["mp"], metrics["mr"], metrics["map50"],
                          metrics["map"])
            callbacks.run("on_fit_epoch_end", epoch=epoch, fitness=fit,
                          metrics=metrics)
            if fit >= best_fit or final_metrics is None:
                final_metrics = dict(metrics)

            lr_now = float(opt_info["lr_fn"](state.step))
            loggers.log_epoch(epoch, {
                "train/box_loss": mloss[0], "train/obj_loss": mloss[1],
                "train/cls_loss": mloss[2], "train/theta_loss": mloss[3],
                "metrics/precision": metrics["mp"],
                "metrics/recall": metrics["mr"],
                "metrics/HBBmAP.5": metrics["map50"],
                "metrics/HBBmAP.5:.95": metrics["map"],
                "fitness": fit, "x/lr0": lr_now,
            })
            print(f"epoch {epoch}/{opt.epochs - 1} done in "
                  f"{time.time() - t0:.1f}s  "
                  f"loss(box,obj,cls,theta)={np.round(mloss, 4).tolist()}  "
                  f"HBBmAP@.5={metrics['map50']:.4f} fitness={fit:.4f}")

            if not opt.nosave:
                ckpt_meta = {
                    "epoch": epoch, "best_fitness": max(best_fit, fit),
                    "names": names, "cfg": opt.cfg, "imgsz": opt.imgsz,
                    # evolved anchors travel with the weights
                    "anchors": np.asarray(meta.anchors_px).tolist(),
                }
                save_checkpoint(save_dir / "last", model, state, ckpt_meta)
                if fit > best_fit or (opt.save_period > 0
                                      and epoch % opt.save_period == 0):
                    loggers.log_model_artifact(save_dir / "last", epoch, fit,
                                               best=fit > best_fit)
                callbacks.run("on_model_save", epoch=epoch,
                              path=save_dir / "last")
                if fit > best_fit or val_ds is None:
                    best_fit = max(best_fit, fit)
                    patience_left = opt.patience
                    save_weights(save_dir / "best",
                                 state.ema_state_dict(model), ckpt_meta)
                else:
                    patience_left -= 1
                if opt.save_period > 0 and epoch % opt.save_period == 0:
                    save_checkpoint(save_dir / f"epoch{epoch}", model, state,
                                    ckpt_meta)
            if patience_left <= 0:
                print(f"early stopping at epoch {epoch} "
                      f"(patience {opt.patience})")
                break
        callbacks.run("on_train_end", best_fitness=best_fit,
                      save_dir=save_dir)
    finally:
        loggers.finish()
        if workers is not None:
            workers.close()
    try:  # the results.csv curves (JAX train.py:486-492)
        from .utils.plots import plot_results

        plot_results(save_dir / "results.csv")
    except Exception as e:
        print(f"plot_results failed: {e}")
    print(f"training complete; best fitness {best_fit:.4f}; results in "
          f"{save_dir}")
    return save_dir, best_fit, final_metrics or dict(ZERO_METRICS)


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
