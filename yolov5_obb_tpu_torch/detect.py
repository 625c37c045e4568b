"""Inference CLI: oriented-box detection on images, videos and streams.

    python -m yolov5_obb_tpu_torch.detect --weights runs/train/exp/best \\
        --source path/to/images --cfg yolov5n.yaml --data data.yaml \\
        --imgsz 1024 --conf-thres 0.25 --save-txt [--dtype bfloat16] \\
        [--device cpu]

Counterpart of the JAX package's root ``detect.py`` (the reference
detect.py), with every flag and ``--device``.  Runs on the card unless
``--device cpu``; in bfloat16 on the card the model takes the packed uint8
image and its kernels (never with ``--augment`` or an ensemble, which
transform or decode the unpacked image).  ``--weights a,b`` is a model
ensemble: every member's decoded rows go through one NMS.  An exported
``.pt2`` as ``--weights`` (``python -m yolov5_obb_tpu_torch.export``) needs
``--data`` for its names; its NMS runs here, and ``--classes`` filters the
detections after it.

Writes annotated images (and, for videos, ``<stem>_annotated.mp4``) unless
``--nosave``, label files ``cls x1 y1 .. x4 y4 [conf]`` with ``--save-txt``,
rectified crops with ``--save-crop`` and feature-map grids of the first
frame with ``--visualize``.  PNG images are read without OpenCV
(``utils/image_io.py``); drawing, crops, video, streams and other image
formats need it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .data.augment import letterbox
from .data.dota import IMG_EXTS
from .data.streams import is_stream_source
from .engine.evaluator import (
    load_ensemble_members,
    make_ensemble_predict_fn,
    make_predict_fn,
    pack_images,
)
from .models.backend import (
    is_artifact,
    make_backend_predict_fn,
    refuse_jax_artifact,
)
from .models.yolo import create_model
from .ops.geometry import rbox2poly, scale_polys
from .utils import image_io
from .utils.checkpoint import load_model_weights
from .utils.device import resolve_device
from .utils.fuse import fuse_for_inference
from .utils.general import increment_path, load_dataset_config

VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm"}


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.detect")
    p.add_argument("--weights", type=str, default="",
                   help="checkpoint directory, state-dict .pt or exported "
                        ".pt2; a,b: an ensemble; empty: random weights from "
                        "--seed")
    p.add_argument("--cfg", type=str, default="yolov5n.yaml",
                   help="model config")
    p.add_argument("--source", type=str, required=True,
                   help="image or video file, directory, or stream")
    p.add_argument("--data", type=str, default=None,
                   help="dataset yaml (names)")
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-crop", action="store_true",
                   help="save rotation-rectified per-detection crops")
    p.add_argument("--nosave", action="store_true",
                   help="skip annotated images")
    p.add_argument("--classes", type=int, nargs="+", default=None,
                   help="keep only these class ids")
    p.add_argument("--agnostic-nms", action="store_true",
                   help="class-agnostic suppression")
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--augment", action="store_true", help="TTA inference")
    p.add_argument("--line-thickness", type=int, default=2)
    p.add_argument("--no-fuse", action="store_true",
                   help="skip load-time Conv+BN folding")
    p.add_argument("--visualize", action="store_true",
                   help="save feature-map grids for the first frame")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (bfloat16 ≈ the reference's --half)")
    p.add_argument("--vid-stride", type=int, default=1,
                   help="stream frame-rate stride")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop stream inference after N batches")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0,
                   help="random weights' seed when --weights is empty")
    p.add_argument("--project", type=str, default="runs/detect")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    return p.parse_args(argv)


def list_images(source):
    p = Path(source)
    if p.is_dir():
        files = [f for f in sorted(p.rglob("*"))
                 if f.suffix.lower() in (IMG_EXTS | VID_EXTS)]
        if not files:
            raise FileNotFoundError(f"no images found under {source}")
        return files
    if not p.exists():
        raise FileNotFoundError(f"source not found: {source}")
    return [p]


def iter_stream_frames(source, vid_stride=1, max_frames=None):
    """``(pseudo-path, frame index, BGR image, fps)`` from live streams
    (webcam index, URL, ``.streams`` list) through :class:`LoadStreams`."""
    from .data.streams import LoadStreams

    streams = LoadStreams(source, vid_stride=vid_stride,
                          max_frames=max_frames)
    for idx, (srcs, frames, fps) in enumerate(streams):
        for si, frame in enumerate(frames):
            name = Path(str(srcs[si]).replace("://", "_").replace("/", "_"))
            yield name, idx, frame, fps[si]


def iter_frames(files):
    """``(path, frame index or None, BGR image, fps or None)``."""
    for f in files:
        if f.suffix.lower() in VID_EXTS:
            import cv2

            cap = cv2.VideoCapture(str(f))
            fps = cap.get(cv2.CAP_PROP_FPS) or 30
            idx = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield f, idx, frame, fps
                idx += 1
            cap.release()
        else:
            im0 = image_io.imread(f)
            if im0 is None:
                print(f"skipping unreadable {f}")
                continue
            yield f, None, im0, None


def label_lines(polys, conf, cls, save_conf: bool) -> str:
    """A label file's text: ``cls x1 y1 .. x4 y4 [conf]`` a detection."""
    lines = []
    for k in range(len(polys)):
        row = [int(cls[k]), *polys[k].tolist()]
        if save_conf:
            row.append(float(conf[k]))
        lines.append(" ".join(f"{v:g}" for v in row))
    return "\n".join(lines) + "\n" if lines else ""


def capture_features(model, x) -> dict:
    """Each top-level layer's output of one forward, by the JAX package's
    module names ``m0``, ``m1``, ... (forward hooks; a layer the forward
    skips, such as those the stem+L1 kernel replaces, is absent)."""
    feats, hooks = {}, []
    for i, m in enumerate(model.model):
        target = m[-1] if isinstance(m, nn.Sequential) else m

        def hook(_mod, _inp, out, name=f"m{i}"):
            feats[name] = out

        hooks.append(target.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return feats


def _build_predict(opt, names, nc, device):
    """``(predict, model or None, names)`` for ``opt.weights``."""
    classes = opt.classes
    if opt.weights and "," in str(opt.weights):
        wlist = [w.strip() for w in str(opt.weights).split(",") if w.strip()]
        members, wnames = load_ensemble_members(
            wlist, opt.cfg, nc, fuse=not opt.no_fuse, device=device)
        names = names or wnames or [str(i) for i in
                                    range(members[0][1].nc)]
        if opt.augment:
            raise ValueError("--augment with an ensemble is not supported")
        predict = make_ensemble_predict_fn(
            members, opt.conf_thres, opt.iou_thres, opt.max_det,
            multi_label=True, agnostic=opt.agnostic_nms, classes=classes)
        return predict, None, names
    if opt.weights and is_artifact(opt.weights):
        refuse_jax_artifact(opt.weights)
        if names is None:
            raise ValueError("--data must provide the names for an exported "
                             "model")
        predict, _ = make_backend_predict_fn(
            opt.weights, opt.cfg, len(names), opt.imgsz, opt.conf_thres,
            opt.iou_thres, opt.max_det, tta=opt.augment, device=device)
        return predict, None, names
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    # the stem kernels compute bf16: the packed path only for a bf16 run on
    # the card, so a float32 run keeps its numerics
    packed = (device.type == "cuda" and dtype == torch.bfloat16
              and not opt.augment)
    model, meta = create_model(opt.cfg, nc=nc, dtype=dtype, device=device,
                               seed=opt.seed, packed_stem=packed)
    if opt.weights:
        wnames = load_model_weights(model, meta, opt.weights).get("names")
        names = names or wnames
    names = names or [str(i) for i in range(meta.nc)]
    fuse_for_inference(model, enable=not opt.no_fuse)
    predict = make_predict_fn(model, meta, opt.conf_thres, opt.iou_thres,
                              opt.max_det, multi_label=True, tta=opt.augment,
                              agnostic=opt.agnostic_nms, classes=classes)
    return predict, model, names


def run(opt):
    device = resolve_device(opt.device)
    names = nc = None
    if opt.data:
        d = load_dataset_config(opt.data)
        names, nc = d["names"], d["nc"]
    predict, model, names = _build_predict(opt, names, nc, device)
    artifact = bool(opt.weights) and is_artifact(opt.weights)

    save_dir = increment_path(Path(opt.project) / opt.name,
                              exist_ok=opt.exist_ok)
    if opt.save_txt:
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)
    if is_stream_source(opt.source):
        frame_iter = iter_stream_frames(opt.source, vid_stride=opt.vid_stride,
                                        max_frames=opt.max_frames)
    else:
        frame_iter = iter_frames(list_images(opt.source))
    t_pre = t_inf = 0.0
    n_det_total = n_frames = 0
    writers = {}
    for f, frame_idx, im0, fps in frame_iter:
        n_frames += 1
        t0 = time.perf_counter()
        img, _, _ = letterbox(im0, opt.imgsz, auto=False, scaleup=False)
        x = np.ascontiguousarray(img[:, :, ::-1])[None]  # BGR→RGB, batch
        if predict.packed_stem:
            x = pack_images(x)
        x = torch.from_numpy(x).to(device)
        t1 = time.perf_counter()
        if opt.visualize and model is not None and n_frames == 1:
            # reference --visualize (plots.py:162 feature_visualization)
            from .utils.plots import feature_visualization

            feats = capture_features(
                model, x if model.packed_stem else x.float() / 255.0)
            for mname in sorted(feats)[:8]:
                out = feats[mname]
                if isinstance(out, torch.Tensor):
                    feature_visualization(out, mname, save_dir / "features")
            print(f"feature maps saved to {save_dir / 'features'}")
        dets, num = predict(x)
        dets, n = dets.cpu().numpy(), int(num[0])
        t2 = time.perf_counter()
        t_pre += t1 - t0
        t_inf += t2 - t1

        d = dets[0, :n]
        if artifact and opt.classes:
            # an exported model's NMS is class-aware, so keeping the
            # classes after it keeps what filtering before it would
            d = d[np.isin(d[:, 6].astype(int), opt.classes)]
            n = len(d)
        polys = rbox2poly(d[:, :5]) if n else np.zeros((0, 8))
        if n:
            polys = scale_polys((opt.imgsz, opt.imgsz), polys, im0.shape[:2])
        conf, cls = d[:, 5], d[:, 6]
        n_det_total += n
        stem = f.stem if frame_idx is None else f"{f.stem}_{frame_idx}"
        if opt.save_txt:
            (save_dir / "labels" / f"{stem}.txt").write_text(
                label_lines(polys, conf, cls, opt.save_conf))
        if opt.save_crop and n:
            import cv2

            from .api import obb_crop

            for k in range(n):
                cname = (names[int(cls[k])] if int(cls[k]) < len(names)
                         else str(int(cls[k])))
                out = save_dir / "crops" / cname
                out.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(out / f"{stem}_{k}.png"),
                            obb_crop(im0, polys[k]))
        if not opt.nosave:
            import cv2

            from .utils.plots import annotate_detections

            annotate_detections(im0, polys, conf, cls, names,
                                line_width=opt.line_thickness,
                                hide_conf=opt.hide_conf,
                                hide_labels=opt.hide_labels)
            if frame_idx is None:
                cv2.imwrite(str(save_dir / f.name), im0)
            else:  # video: annotated frames to an mp4 writer
                if f not in writers:
                    writers[f] = cv2.VideoWriter(
                        str(save_dir / f"{f.stem}_annotated.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (im0.shape[1], im0.shape[0]))
                writers[f].write(im0)
        label = f.name if frame_idx is None else f"{f.name}#{frame_idx}"
        print(f"{label}: {n} detections ({(t2 - t1) * 1000:.1f} ms)")

    for w in writers.values():
        w.release()
    n = max(n_frames, 1)
    print(f"Speed: {t_pre / n * 1000:.1f}ms pre-process, "
          f"{t_inf / n * 1000:.1f}ms inference+NMS per image at shape "
          f"(1, {opt.imgsz}, {opt.imgsz}, 3)")
    print(f"Results saved to {save_dir} ({n_det_total} detections)")
    return save_dir


def main(argv=None):
    return run(parse_opt(argv))


if __name__ == "__main__":
    main()
