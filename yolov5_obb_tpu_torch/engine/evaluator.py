"""Inference and evaluation: image batch → rotated detections → HBB
metrics and DOTA-format outputs.

Counterpart of ``yolov5_obb_tpu/engine/evaluator.py``: ``make_predict_fn``
(evaluator.py:27, test-time augmentation too), the model ensemble
(``load_ensemble_members`` :89, ``make_ensemble_predict_fn`` :120),
``pack_images`` (:166), ``evaluate`` (:175) and ``save_dota_task1``
(:403); ``evaluate(mesh=)`` splits each batch over the processes of a
data mesh (:28-55, 188-250).  Decode + rotated NMS run on the model's
device; per image on the host: rbox → poly, rescale to the native
resolution, HBB-cover TP matching at 10 IoU thresholds, AP aggregation, and
the DOTA JSON rows for the devkit merge step.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models.tta import predict_tta
from ..models.yolo import create_model, decode
from ..ops.geometry import poly2hbb, rbox2poly, scale_polys, xywh2xyxy
from ..ops.rotated_nms import (
    non_max_suppression_from_maps,
    non_max_suppression_obb,
)
from ..utils.checkpoint import load_model_weights
from ..utils.fuse import fuse_conv_bn
from ..utils.metrics import ConfusionMatrix, ap_per_class, process_batch_hbb
from ..utils.profiler import span


def make_predict_fn(model, meta, conf_thres, iou_thres, max_det,
                    multi_label=True, max_candidates=4096,
                    agnostic: bool = False, classes=None,
                    plain: bool = False, tta: bool = False):
    """Image → detections function, shared by the command-line tools.

    If ``model.packed_stem`` is set, the returned function expects the image
    batch as the packed ``(B, H, W*3)`` uint8 view (see :func:`pack_images`)
    on the model's device — the /255 normalize is folded into the stem
    weights; otherwise an NHWC uint8 batch.  ``plain=True`` runs every
    kernel-bearing step as its plain PyTorch version (on any device), the
    reference the kernels are checked against.

    The returned ``predict(images) -> (dets (B, max_det, 7), num (B,))``
    runs under ``torch.inference_mode``; ``predict.device`` is the model's.
    In a ``torch.profiler`` trace a call is the span ``predict``, the
    model's forward (TTA's three) ``predict.forward`` within it.

    ``multi_label`` (the default, as in the JAX package) lets every (box,
    class) pair above ``conf_thres`` compete for the ``max_candidates``
    slots; ``False`` keeps the best class of each box.  ``tta`` runs
    :func:`~..models.tta.predict_tta` (three scales, one flipped) and one
    NMS over the merged rows; a packed-stem model refuses it (TTA
    transforms the unpacked image)."""
    classes = tuple(int(c) for c in classes) if classes is not None else None
    packed = bool(model.packed_stem)
    if packed and tta:
        raise ValueError("packed_stem and tta are mutually exclusive "
                         "(TTA transforms the unpacked image)")
    nms = dict(conf_thres=conf_thres, iou_thres=iou_thres,
               max_candidates=max_candidates, max_det=max_det,
               multi_label=multi_label, agnostic=agnostic, classes=classes,
               plain=plain)

    @torch.inference_mode()
    def predict(image_u8):
        with span("predict"):
            if tta:
                with span("predict.forward"):
                    pred = predict_tta(model, meta, image_u8.float() / 255.0,
                                       plain=plain)
                return non_max_suppression_obb(pred, num_classes=meta.nc,
                                               **nms)
            with span("predict.forward"):
                x = image_u8 if packed else image_u8.float() / 255.0
                maps = model(x, plain=plain)
            return non_max_suppression_from_maps(maps, meta, **nms)

    predict.packed_stem = packed
    predict.device = next(model.parameters()).device
    return predict


def load_ensemble_members(weights_list, cfg, nc, dtype=torch.float32,
                          fuse: bool = True, device=None):
    """N weights (checkpoint directories or state-dict ``.pt`` files, as the
    CLIs' ``--weights``) → ``([(model, meta), ...], names)``: unpacked
    models in ``dtype`` on ``device`` (the card unless ``"cpu"``), each with
    its own checkpoint's anchors, Conv+BN folded unless ``fuse`` is False
    (JAX evaluator.py:89; the reference's ``attempt_load`` of a weights
    list).  ``cfg``: one config for all, or a comma-separated list pairing
    each weight.  ``names``: the first checkpoint's that has them."""
    cfgs = [c.strip() for c in str(cfg).split(",")] if cfg else [
        "yolov5m.yaml"]
    if len(cfgs) == 1:
        cfgs = cfgs * len(weights_list)
    if len(cfgs) != len(weights_list):
        raise ValueError(f"{len(weights_list)} weights but {len(cfgs)} "
                         "configs")
    members, names = [], None
    for w, c in zip(weights_list, cfgs):
        model, meta = create_model(c, nc=nc, dtype=dtype, device=device)
        wnames = load_model_weights(model, meta, w).get("names")
        names = names or wnames
        if fuse:
            fuse_conv_bn(model)
        members.append((model, meta))
    return members, names


def make_ensemble_predict_fn(members, conf_thres, iou_thres, max_det,
                             multi_label=True, max_candidates=4096,
                             agnostic: bool = False, classes=None,
                             plain: bool = False):
    """Model-level ensemble (JAX evaluator.py:120; the reference's
    ``Ensemble``): every member's decoded rows are concatenated along the
    anchor axis and go through one rotated NMS.  ``members``: ``[(model,
    meta), ...]`` of unpacked models on one device; architectures may
    differ, ``nc`` must match.  Returns ``predict(images_u8)`` as
    :func:`make_predict_fn` does."""
    classes = tuple(int(c) for c in classes) if classes is not None else None
    if not members:
        raise ValueError("ensemble needs at least one member")
    nc = members[0][1].nc
    if any(meta.nc != nc for _, meta in members):
        raise ValueError("ensemble members must share nc")
    if any(m.packed_stem for m, _ in members):
        raise ValueError("ensemble members must be unpacked models")

    @torch.inference_mode()
    def predict(image_u8):
        with span("predict"):
            with span("predict.forward"):
                x = image_u8.float() / 255.0
                hw = tuple(x.shape[1:3])
                pred = torch.cat([decode(m(x, plain=plain), meta, hw)
                                  for m, meta in members], 1)
            return non_max_suppression_obb(
                pred, num_classes=nc, conf_thres=conf_thres,
                iou_thres=iou_thres, max_candidates=max_candidates,
                max_det=max_det, multi_label=multi_label, agnostic=agnostic,
                classes=classes, plain=plain)

    predict.packed_stem = False
    predict.device = next(members[0][0].parameters()).device
    return predict


def pack_images(batch_u8):
    """NHWC uint8 batch (numpy or tensor) → the packed ``(B, H, W*3)`` view
    a packed-stem predict function expects; no copy for contiguous input."""
    if isinstance(batch_u8, torch.Tensor):
        b = batch_u8.contiguous()
    else:
        b = np.ascontiguousarray(batch_u8)
    return b.reshape(b.shape[0], b.shape[1], -1)


def evaluate(model, meta, dataset, batch_size: int = 8,
             conf_thres: float = 0.01, iou_thres: float = 0.4,
             max_det: int = 1500, verbose: bool = False,
             save_json: str | None = None, max_images: int | None = None,
             tta: bool = False, mesh=None, plots_dir=None,
             plain: bool = False, predict_fn=None):
    """HBB-metric evaluation of ``model`` over ``dataset`` (anything with
    ``names``, ``img_files``, ``img_size``, ``__len__`` and
    ``get_eval_sample``, as :class:`~..data.dota.DotaDataset`).

    Multi-label decode + rotated NMS at ``conf_thres`` / ``iou_thres`` with
    4096 candidates on the model's device (``plain`` runs the kernels'
    plain versions; ``tta`` the augmented inference of
    :func:`make_predict_fn`).  ``predict_fn`` (``images_u8 -> (dets,
    num)`` with a ``device``, e.g. :func:`make_ensemble_predict_fn`'s)
    replaces the model's; ``model`` may then be None.  ``plots_dir``:
    the confusion matrix (fed from each image's HBB matches) drawn as
    ``confusion_matrix.png``, and ``PR_curve.png``, ``F1_curve.png``,
    ``P_curve.png``, ``R_curve.png`` there (flat curves without
    detections); a plot that fails is reported and the evaluation goes
    on.  ``mesh`` (an ``engine/distributed.DataMesh`` of N processes, one
    a card, the weights the same in each): rank r loads, predicts and
    matches only rows ``[r·b/N, (r+1)·b/N)`` of every padded batch of ``b
    = batch_size`` (which N must divide), and the per-image matches and
    detections are gathered once, in dataset order, on every rank, so
    every rank computes the one-process metrics; the caller lets one rank
    write ``save_json`` and the plots.  ``speed_ms_per_img`` is then the
    mesh's: a rank's wall time over all the images.

    Returns the JAX package's result dict: mp, mr, map50, map, per-class
    p/r/ap50/ap, ``speed_ms_per_img`` (the timed loop over the batches
    after one warm-up call), ``speed_pre_ms_per_img`` (host loading and
    letterboxing) and ``detections`` (native-resolution polys per image);
    ``save_json`` writes the DOTA JSON rows there."""
    local = batch_size
    rows = slice(0, batch_size)
    if mesh is not None:
        if batch_size % mesh.world:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"the mesh's {mesh.world} processes")
        local = batch_size // mesh.world
        rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
    names = dataset.names
    iouv = np.linspace(0.5, 0.95, 10)
    confusion = (ConfusionMatrix(nc=len(names)) if plots_dir is not None
                 else None)
    predict = predict_fn or make_predict_fn(
        model, meta, conf_thres, iou_thres, max_det, multi_label=True,
        plain=plain, tta=tta)
    device = predict.device

    n_img = len(dataset) if max_images is None else min(max_images, len(dataset))
    canvas = int(getattr(dataset, "eval_canvas", dataset.img_size))
    t_pre = [0.0]  # host pre-processing (decode + letterbox) seconds

    # one-deep pipeline: load and dispatch batch N+1 before bringing batch
    # N's detections to the host (the rotated NMS's host syncs bound how far
    # the card runs ahead).  A rank loads and predicts only its rows of the
    # padded batch (the batch's last image repeated): the rows of one
    # process at batch ``local``.
    def dispatch(start):
        idxs = list(range(start, min(start + batch_size, n_img)))[rows]
        if not idxs:  # this rank's rows are all padding
            return [], None, None
        t0 = time.perf_counter()
        samples = [dataset.get_eval_sample(i) for i in idxs]
        t_pre[0] += time.perf_counter() - t0
        pad = local - len(samples)
        imgs = np.stack([s["image"] for s in samples + [samples[-1]] * pad])
        if predict.packed_stem:
            imgs = pack_images(imgs)
        dets, num = predict(torch.from_numpy(imgs).to(device))
        return samples, dets, num

    if n_img:  # warm-up (kernel builds, cuDNN plans) outside the timed loop
        _, d0, n0 = dispatch(0)
        if d0 is not None:
            d0.cpu(), n0.cpu()
        t_pre[0] = 0.0

    records = []  # per image of this rank, in dataset order
    t_start = time.perf_counter()
    pending = dispatch(0) if n_img else None
    for start in range(0, n_img, batch_size):
        samples, dets_dev, num_dev = pending
        nxt = start + batch_size
        pending = dispatch(nxt) if nxt < n_img else None
        if not samples:
            continue
        dets, num = dets_dev.cpu().numpy(), num_dev.cpu().numpy()

        for bi, s in enumerate(samples):
            n = int(num[bi])
            d = dets[bi, :n]  # (n, [cx cy l s theta conf cls])
            h0, w0 = (int(v) for v in s["orig_hw"])
            rp = s.get("ratio_pad")
            rp = ((rp[0], rp[0]), (rp[1], rp[2])) if rp is not None else None

            # predictions → native-resolution polys and their HBB covers
            polys = rbox2poly(d[:, :5]) if n else np.zeros((0, 8))
            polys = (scale_polys((canvas, canvas), polys, (h0, w0), rp)
                     if n else polys)
            hbb = poly2hbb(polys) if n else np.zeros((0, 4))
            det_xyxy = xywh2xyxy(hbb)
            conf, cls = d[:, 5], d[:, 6]

            # ground truth → native-resolution HBBs
            gt = s["targets"][s["target_mask"]]
            gt_polys = rbox2poly(gt[:, 1:6]) if len(gt) else np.zeros((0, 8))
            gt_polys = (scale_polys((canvas, canvas), gt_polys, (h0, w0), rp)
                        if len(gt) else gt_polys)
            gt_xyxy = (xywh2xyxy(poly2hbb(gt_polys)) if len(gt)
                       else np.zeros((0, 4)))
            gt_cls = gt[:, 0]

            records.append({
                "index": int(s["index"]), "hbb": hbb, "gt_xyxy": gt_xyxy,
                "tp": process_batch_hbb(det_xyxy, conf, cls, gt_xyxy, gt_cls,
                                        iouv),
                "gt_cls": gt_cls,
                "det": {"path": dataset.img_files[s["index"]],
                        "polys": polys, "conf": conf, "cls": cls,
                        "hw": (h0, w0)}})

    if mesh is not None:  # every rank's images, in dataset order
        records = sorted((r for part in mesh.gather_objects(records)
                          for r in part), key=lambda r: r["index"])
    t_infer = time.perf_counter() - t_start if n_img else 0.0

    stats = []  # (tp, conf, cls, target_cls) per image
    json_out = []
    all_dets = []
    for rec in records:
        det = rec["det"]
        conf, cls = det["conf"], det["cls"]
        stats.append((rec["tp"], conf, cls, rec["gt_cls"]))
        if confusion is not None:
            confusion.process_batch(xywh2xyxy(rec["hbb"]), conf, cls,
                                    rec["gt_xyxy"], rec["gt_cls"])
        all_dets.append(det)
        if save_json is not None:
            stem = Path(det["path"]).stem
            for k in range(len(conf)):
                json_out.append({
                    "image_id": stem,
                    "category_id": int(cls[k]),
                    "bbox": [round(float(v), 1) for v in rec["hbb"][k]],
                    "score": round(float(conf[k]), 5),
                    "poly": [round(float(v), 1) for v in det["polys"][k]],
                    "file_name": stem,
                })


    if stats:
        tp = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        cls = np.concatenate([s[2] for s in stats])
        tcls = np.concatenate([s[3] for s in stats])
    else:  # empty dataset or max_images 0: zero metrics
        tp = np.zeros((0, 10), bool)
        conf = cls = tcls = np.zeros(0)

    curves = None
    if tp.size and tcls.size:
        p, r, ap, _, cls_idx, curves = ap_per_class(tp, conf, cls, tcls,
                                                    return_curves=True)
        ap50, ap_mean = ap[:, 0], ap.mean(1)
        mp, mr, map50, map_ = p.mean(), r.mean(), ap50.mean(), ap_mean.mean()
    else:
        p = r = ap50 = ap_mean = np.zeros(0)
        ap = np.zeros((0, 10))
        cls_idx = np.zeros(0, int)
        mp = mr = map50 = map_ = 0.0

    if plots_dir is not None:
        _plot_eval(Path(plots_dir), confusion.matrix, names, curves, ap,
                   cls_idx)

    if save_json is not None:
        Path(save_json).parent.mkdir(parents=True, exist_ok=True)
        with open(save_json, "w") as f:
            json.dump(json_out, f)

    result = {
        "mp": float(mp), "mr": float(mr), "map50": float(map50),
        "map": float(map_),
        "per_class": {
            names[int(c)]: {"p": float(p[i]), "r": float(r[i]),
                            "ap50": float(ap50[i]), "ap": float(ap_mean[i])}
            for i, c in enumerate(cls_idx)
        },
        "speed_ms_per_img": 1000.0 * t_infer / max(n_img, 1),
        "speed_pre_ms_per_img": 1000.0 * t_pre[0] / max(n_img, 1),
        "detections": all_dets,
    }
    if verbose:
        print(f"images={n_img}  P={mp:.3f} R={mr:.3f} HBBmAP@.5={map50:.4f} "
              f"HBBmAP@.5:.95={map_:.4f} "
              f"({result['speed_ms_per_img']:.1f} ms/img)")
    return result


def _plot_eval(pdir: Path, matrix, names, curves, ap, cls_idx) -> None:
    """``confusion_matrix.png`` and the PR, F1, P and R curves in ``pdir``
    (JAX evaluator.py:343-373); without detections (or labels) flat
    curves, so that a run always leaves the same files.  A plot that fails
    is printed: it never fails the evaluation."""
    from ..utils.plots import (
        plot_confusion_matrix,
        plot_mc_curve,
        plot_pr_curve,
    )

    pdir.mkdir(parents=True, exist_ok=True)
    try:
        plot_confusion_matrix(matrix, list(names),
                              pdir / "confusion_matrix.png")
        if curves is None:
            px = np.linspace(0, 1, 1000)
            z = np.zeros((1, px.size))
            curves = {"px": px, "pr_py": [z[0]], "f1": z, "p": z, "r": z}
            ap = np.zeros((1, 10))
        cnames = [names[int(c)] for c in cls_idx]
        plot_pr_curve(curves["px"], list(curves["pr_py"]), ap,
                      pdir / "PR_curve.png", cnames)
        for key, ylab, fname in (("f1", "F1", "F1_curve.png"),
                                 ("p", "Precision", "P_curve.png"),
                                 ("r", "Recall", "R_curve.png")):
            plot_mc_curve(curves["px"], curves[key], pdir / fname, cnames,
                          ylabel=ylab)
    except Exception as e:
        print(f"eval plots failed: {e}")


def save_dota_task1(detections, names, out_dir):
    """Per-class ``Task1_<name>.txt`` files for the devkit merge step: one
    line ``<image stem> <conf> <8 poly coords>`` per detection."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = {i: open(out / f"Task1_{n}.txt", "w") for i, n in enumerate(names)}
    try:
        for det in detections:
            stem = Path(det["path"]).stem
            for poly, conf, cls in zip(det["polys"], det["conf"], det["cls"]):
                row = " ".join(f"{v:.1f}" for v in poly)
                files[int(cls)].write(f"{stem} {conf:.5f} {row}\n")
    finally:
        for f in files.values():
            f.close()
