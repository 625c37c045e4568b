"""Validation CLI: HBB metrics and DOTA-format outputs.

    python -m yolov5_obb_tpu_torch.val --data data.yaml --cfg yolov5m.yaml \\
        --weights yolov5m_sd.pt --imgsz 1024 --batch-size 8 --dtype bfloat16 \\
        --save-json --save-task1

Counterpart of the JAX package's ``val.py``.  Runs on the card unless
``--device cpu``; on the card in bfloat16 the model takes the packed uint8
image and its stem kernels (as ``val.py`` builds packed-stem models in bf16 on
the accelerator).  ``--weights`` is empty (random weights from ``--seed``), a
checkpoint directory of the port (``utils/checkpoint.py``: the train CLI's
``best``/``last``, or ``tools/jax_ckpt_to_torch.py``'s output; its anchors
come with it) or a state-dict ``.pt`` in the reference model's names (the
file ``tools/import_torch_weights.py --sd`` reads).  The default IoU threshold is
0.4, and 0.45 for ``--task speed`` (the reference's speed regime, with conf
0.25).  ``--coco-eval`` (with ``--save-json``) scores the saved predictions
with the COCO bbox metrics against the split's labels
(``devkit/coco_eval.py``).  ``--augment`` runs test-time augmentation
(three scales, one flipped; never on the packed path), and ``--weights
a,b`` a model ensemble: every member's decoded rows go through one NMS.
Not ported yet: ``--task study``, exported artifacts as ``--weights``,
``--mesh`` and the plots (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .data.dota import DotaDataset
from .devkit.coco_eval import coco_eval_bbox
from .devkit.converters import dota_to_coco
from .engine.evaluator import (
    evaluate,
    load_ensemble_members,
    make_ensemble_predict_fn,
    save_dota_task1,
)
from .models.yolo import create_model
from .ops.geometry import poly2hbb
from .utils.checkpoint import STATE, load_model_weights
from .utils.fuse import fuse_conv_bn
from .utils.general import increment_path, load_dataset_config


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.val")
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint directory or state-dict .pt (reference "
                        "names); empty: random weights from --seed")
    p.add_argument("--cfg", type=str, default="yolov5n.yaml")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--task", type=str, default="val",
                   choices=["train", "val", "test", "speed", "study"])
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--conf-thres", type=float, default=None,
                   help="default 0.01 (0.25 for --task speed)")
    p.add_argument("--iou-thres", type=float, default=None,
                   help="default 0.4 (0.45 for --task speed)")
    p.add_argument("--max-det", type=int, default=1500)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--save-json", action="store_true")
    p.add_argument("--save-txt", action="store_true",
                   help="per-image normalized HBB txts (labels/<stem>.txt)")
    p.add_argument("--save-conf", action="store_true",
                   help="append confidence to --save-txt rows")
    p.add_argument("--save-task1", action="store_true",
                   help="per-class Task1 txts for the devkit merge")
    p.add_argument("--rect-pad", type=float, default=0.0,
                   help="rect-val canvas pad (0.5: 1056 for 1024); 0 = square")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no-fuse", action="store_true",
                   help="skip the load-time Conv+BN folding")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--project", type=str, default="runs/val")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--coco-eval", action="store_true",
                   help="COCO bbox AP of the --save-json predictions")
    p.add_argument("--augment", action="store_true", help="TTA inference")
    # not ported: each raises NotImplementedError when asked for
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--plots", action="store_true")
    return p.parse_args(argv)


def _refuse_unported(opt) -> None:
    if opt.task == "study":
        raise NotImplementedError("--task study is not ported "
                                  "(ROADMAP.md queue 1 item 6)")
    for flag, what, item in (("mesh", "--mesh", 9), ("plots", "the plots", 6)):
        if getattr(opt, flag):
            raise NotImplementedError(f"{what} is not ported "
                                      f"(ROADMAP.md queue 1 item {item})")
    for w in filter(None, (w.strip() for w in opt.weights.split(","))):
        path = Path(w)
        if not path.exists():
            raise FileNotFoundError(f"--weights {w}: no such file or "
                                    "directory")
        if not ((path.suffix == ".pt" and path.is_file())
                or (path / STATE).is_file()):
            raise NotImplementedError(
                f"--weights {w}: not a checkpoint directory or state-dict "
                ".pt; exported artifacts are not ported (ROADMAP.md queue 1 "
                "item 9)")


def run(opt):
    _refuse_unported(opt)
    speed = opt.task == "speed"
    if opt.coco_eval and not (opt.save_json and not speed):
        raise ValueError("--coco-eval scores the --save-json predictions: "
                         "add --save-json (not with --task speed)")
    conf = opt.conf_thres if opt.conf_thres is not None else (
        0.25 if speed else 0.01)
    iou = opt.iou_thres if opt.iou_thres is not None else (
        0.45 if speed else 0.4)
    d = load_dataset_config(opt.data)
    nc = 1 if opt.single_cls else d["nc"]
    split = d.get("val" if speed else opt.task) or d["val"]
    dataset = DotaDataset(split, d["names"], img_size=opt.imgsz,
                          max_labels=1000, single_cls=opt.single_cls,
                          eval_pad=opt.rect_pad)

    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    device = torch.device(opt.device or "cuda")
    model = meta = predict_fn = None
    if "," in opt.weights:
        # a model ensemble: unpacked members, one NMS over their rows
        if opt.augment:
            raise ValueError("--augment with an ensemble is not supported")
        members, _ = load_ensemble_members(
            [w.strip() for w in opt.weights.split(",") if w.strip()],
            opt.cfg, nc, dtype=dtype, fuse=not opt.no_fuse, device=device)
        predict_fn = make_ensemble_predict_fn(members, conf, iou,
                                              opt.max_det, multi_label=True)
    else:
        # the stem kernels compute bf16: the packed path only for a bf16
        # run on the card, so a float32 run keeps its numerics (and never
        # with TTA, which transforms the unpacked image)
        packed = (device.type == "cuda" and dtype == torch.bfloat16
                  and not opt.augment)
        model, meta = create_model(opt.cfg, nc=nc, dtype=dtype,
                                   device=device, seed=opt.seed,
                                   packed_stem=packed)
        if opt.weights:
            load_model_weights(model, meta, opt.weights)
        if not opt.no_fuse:
            fuse_conv_bn(model)

    save_dir = increment_path(Path(opt.project) / opt.name,
                              exist_ok=opt.exist_ok)
    res = evaluate(
        model, meta, dataset, batch_size=opt.batch_size, conf_thres=conf,
        iou_thres=iou, max_det=opt.max_det, verbose=True,
        save_json=(str(save_dir / "best_obb_predictions.json")
                   if opt.save_json and not speed else None),
        max_images=(opt.max_images or 64) if speed else opt.max_images,
        tta=opt.augment, predict_fn=predict_fn)
    if speed:
        print(f"speed: {res['speed_ms_per_img']:.2f} ms/img "
              f"(bs={opt.batch_size}, conf={conf}, iou={iou})")
        return res

    print(f"{'Class':>22}{'P':>10}{'R':>10}{'HBBmAP@.5':>12}"
          f"{'HBBmAP@.5:.95':>15}")
    print(f"{'all':>22}{res['mp']:>10.3f}{res['mr']:>10.3f}"
          f"{res['map50']:>12.4f}{res['map']:>15.4f}")
    for name, m in res["per_class"].items():
        print(f"{name:>22}{m['p']:>10.3f}{m['r']:>10.3f}{m['ap50']:>12.4f}"
              f"{m['ap']:>15.4f}")
    print(f"Speed: {res['speed_pre_ms_per_img']:.1f}ms pre-process, "
          f"{res['speed_ms_per_img']:.1f}ms inference+NMS per image at shape "
          f"({opt.batch_size}, {opt.imgsz}, {opt.imgsz}, 3)")
    if opt.save_txt:
        # normalized HBB rows `cls cx cy w h [conf]` (reference save_one_txt)
        lab_dir = save_dir / "labels"
        lab_dir.mkdir(parents=True, exist_ok=True)
        for rec in res["detections"]:
            h0, w0 = rec["hw"]
            lines = []
            for poly, c, k in zip(rec["polys"], rec["conf"], rec["cls"]):
                cx, cy, w, h = poly2hbb(poly[None])[0]
                row = [int(k), cx / w0, cy / h0, w / w0, h / h0]
                if opt.save_conf:
                    row.append(float(c))
                lines.append(" ".join(f"{v:g}" for v in row))
            (lab_dir / f"{Path(rec['path']).stem}.txt").write_text(
                "\n".join(lines) + "\n" if lines else "")
        print(f"HBB txts saved to {lab_dir}")
    if opt.save_task1:
        save_dota_task1(res["detections"],
                        ["item"] if opt.single_cls else d["names"],
                        save_dir / "task1_raw")
        print(f"Task1 txts saved to {save_dir / 'task1_raw'}")
    if opt.coco_eval:
        # the JAX val.py:232-248 branch: the split's labels as a COCO GT
        # json, then the saved predictions against it
        gt_json = save_dir / "gt_coco.json"
        dota_to_coco(Path(split).parent, gt_json,
                     ["item"] if opt.single_cls else d["names"])
        res["coco"] = coco_eval_bbox(gt_json,
                                     save_dir / "best_obb_predictions.json")
        print(f"COCO bbox eval: AP@[.5:.95]={res['coco']['map']:.4f} "
              f"AP50={res['coco']['map50']:.4f} "
              f"AP75={res['coco']['map75']:.4f}")
    print(f"Results saved to {save_dir}")
    return res


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
