"""The port's validation path against the JAX package's on the CPU: the pair
IoU, the iou-ordered NMS, multi-label selection, the eval dataset, the HBB
metrics, ``evaluate`` and the val CLI, on the same numpy-seeded inputs and
weights (float32)."""

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_mini_dota
from yolov5_obb_tpu.data.dota import DotaDataset as JaxDataset
from yolov5_obb_tpu.devkit.poly_iou import poly_iou
from yolov5_obb_tpu.engine.evaluator import evaluate as jax_evaluate
from yolov5_obb_tpu.models.yolo import ModelMeta as JaxMeta
from yolov5_obb_tpu.models.yolo import build_model as jax_build_model
from yolov5_obb_tpu.models.yolo import probe_strides as jax_probe_strides
from yolov5_obb_tpu.ops import geometry as G
from yolov5_obb_tpu.ops import rotated_nms as jnms
from yolov5_obb_tpu.ops.pallas.iou_kernel import pairs_rotated_iou as jax_pairs
from yolov5_obb_tpu.ops.pallas.iou_kernel import sparse_rotated_iou as jax_sparse
from yolov5_obb_tpu.utils import metrics as jmetrics
from yolov5_obb_tpu.utils.fuse import fuse_conv_bn as jax_fuse
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
from yolov5_obb_tpu_torch.engine.evaluator import evaluate, make_predict_fn
from yolov5_obb_tpu_torch.models.yolo import ModelMeta, create_model
from yolov5_obb_tpu_torch.ops import geometry as PG
from yolov5_obb_tpu_torch.ops import rotated_nms as pnms
from yolov5_obb_tpu_torch.ops.kernels import iou as piou
from yolov5_obb_tpu_torch.utils import metrics as pmetrics
from yolov5_obb_tpu_torch.utils.fuse import fuse_conv_bn
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S = 128  # eval image size


def _rboxes(rng, n, spread):
    cx, cy = rng.uniform(-spread, spread, (2, n))
    l = rng.uniform(5, 120, n)
    s = l * rng.uniform(0.2, 1.0, n)
    t = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return np.stack([cx, cy, l, s, t], -1).astype(np.float32)


def _clipper(a, b):
    return poly_iou(G.rbox2poly(a[None].astype(np.float64))[0],
                    G.rbox2poly(b[None].astype(np.float64))[0])


def test_pair_iou_matches_pallas_and_clipper():
    """The plain versions of pairs_rotated_iou / sparse_rotated_iou against
    the Pallas kernel in interpret mode (block 256, as
    tests/test_pallas_iou.py runs it) and the float64 polygon clipper."""
    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, 300, 80.0), _rboxes(rng, 300, 80.0)
    got = piou.pairs_rotated_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jax_pairs(a, b, block=256))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (want > 0.1).sum() > 20

    boxes = _rboxes(rng, 64, 60.0)
    idx = rng.integers(0, 64, (64, 8)).astype(np.int32)
    got = piou.sparse_rotated_iou(torch.from_numpy(boxes)[None],
                                  torch.from_numpy(idx)[None])[0].numpy()
    want = np.asarray(jax_sparse(boxes, idx, block=256))
    np.testing.assert_allclose(got, want, atol=1e-5)
    exact = np.array([[_clipper(boxes[k], boxes[j]) for j in row]
                      for k, row in enumerate(idx)])
    np.testing.assert_allclose(got, exact, atol=1e-4)


def _cluster(rng, n, n_clusters, sd):
    centers = rng.uniform(100, 500, (n_clusters, 2))
    which = rng.integers(0, n_clusters, n)
    rb = np.zeros((n, 5), np.float32)
    rb[:, :2] = centers[which] + rng.normal(0, sd, (n, 2))
    rb[:, 2] = rng.uniform(20, 60, n)
    rb[:, 3] = rb[:, 2] * rng.uniform(0.3, 1.0, n)
    rb[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return rb


@pytest.mark.parametrize("overflow", [False, True])
def test_iou_order_nms_matches_jax(overflow):
    """nms_rotated(neighbor_order="iou") against the JAX package's, on
    boxes whose rows overflow the M = 64 cap (a tight cluster) or do not."""
    rng = np.random.default_rng(1)
    n = 160
    rb = _cluster(rng, n, 1 if overflow else 12, 3.0 if overflow else 15.0)
    sc = rng.uniform(0.05, 1.0, n).astype(np.float32)
    sc[-6:] = 0.0  # padding rows
    cls = rng.integers(0, 2 if overflow else 3, n).astype(np.int32)
    t = lambda a: torch.from_numpy(a)
    ub = pnms.riou_upper_bound(t(rb)[None])[0].numpy()
    order = np.argsort(-sc, kind="stable")
    rank = np.empty(n, int)
    rank[order] = np.arange(n)
    adm = ((ub > 0.4 * 0.98) & (rank[None, :] < rank[:, None])
           & (cls[:, None] == cls[None, :]) & (sc[None, :] > 0))
    assert (adm.sum(1) > 64).any() == overflow
    for c in (None, cls):
        got = pnms.nms_rotated(t(rb), t(sc), 0.4,
                               class_ids=None if c is None else t(c),
                               neighbor_order="iou").numpy()
        want = np.asarray(jnms.nms_rotated(
            rb, sc, 0.4, class_ids=None if c is None else jnp.asarray(c),
            neighbor_order="iou"))
        assert (got == want).all()
        if not overflow:  # no row overflows: both orders agree
            assert (got == pnms.nms_rotated(
                t(rb), t(sc), 0.4, class_ids=None if c is None else t(c))
                .numpy()).all()


def _random_maps(rng, B, sizes, nc, na=3):
    no = nc + 5 + 180
    maps = []
    for s in sizes:
        m = rng.normal(0, 1.5, (B, s * s * na, no)).astype(np.float32)
        m[..., 4] += 1.0
        m[..., 5:5 + nc] += 1.0
        maps.append(m)
    return maps


@pytest.mark.parametrize("k,conf,tier", [(256, 0.25, False),
                                         (2048, 0.7, True)])
def test_multilabel_nms_from_maps_matches_jax(k, conf, tier):
    """Multi-label decode + selection + NMS against the JAX package's: at
    k = 256 (more positive pairs than slots) and at a k whose candidates
    take the tier ladder."""
    rng = np.random.default_rng(3)
    nc, sizes = 4, (16, 8, 4)
    anchors = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]],
                       np.float32).reshape(3, 3, 2)
    strides = (8.0, 16.0, 32.0)
    maps = _random_maps(rng, 2, sizes, nc)
    kw = dict(conf_thres=conf, iou_thres=0.4, max_candidates=k, max_det=1500,
              multi_label=True)
    jd, jn = jnms.non_max_suppression_from_maps(
        [jnp.asarray(m) for m in maps],
        JaxMeta(nc=nc, nl=3, na=3, strides=strides, anchors_px=anchors), **kw)
    meta = ModelMeta(nc=nc, nl=3, na=3, strides=strides, anchors_px=anchors)
    tmaps = [torch.from_numpy(m) for m in maps]
    pd, pn = pnms.non_max_suppression_from_maps(tmaps, meta, **kw)
    jd, jn, pd, pn = np.asarray(jd), np.asarray(jn), pd.numpy(), pn.numpy()

    pl = pnms.decode_planes(tmaps, meta, multi_label=True)
    sc, _, _ = pnms.exact_select_pairs(pl["conf"], conf, k)
    count = int((sc > 0).sum(1).max())
    assert (pnms._tier(sc.shape[1], count) < sc.shape[1]) == tier
    assert (jn == pn).all() and jn.min() > 30
    for i in range(2):
        n = jn[i]
        np.testing.assert_array_equal(pd[i, :n, 6], jd[i, :n, 6])
        np.testing.assert_allclose(pd[i, :n, :4], jd[i, :n, :4], atol=1e-3)
        np.testing.assert_allclose(pd[i, :n, 4:6], jd[i, :n, 4:6], atol=1e-5)
        assert not pd[i, n:].any()
        # several classes of one box survive together (multi-label)
        assert len(np.unique(pd[i, :n, :2], axis=0)) < n


# ---------------------------------------------------------------------------
# the eval dataset, the metrics, evaluate and the CLI on a mini DOTA set
# ---------------------------------------------------------------------------


def _jax_model():
    """The in-repo trained yolov5n checkpoint with its Detect obj and class
    biases raised, so that ~75 detections per mini-DOTA image clear conf
    0.01 with scores spread apart (a random-weight model's outputs barely
    vary across the image: near-ties everywhere)."""
    from yolov5_obb_tpu.utils.checkpoint import load_weights

    v, _ = load_weights("releases/golden_yolov5n_192")
    v = jax.tree.map(lambda a: np.array(a, np.float32), v)
    model, meta, _ = jax_build_model("yolov5n.yaml", nc=15, dtype=jnp.float32)
    meta = jax_probe_strides(model, meta)
    det = v["params"][f"m{len(model.specs) - 1}"]
    for li in range(meta.nl):
        b = det[f"conv{li}"]["bias"].reshape(meta.na, meta.no)
        b[:, 4] += 2.5
        b[:, 5:5 + meta.nc] += 1.5
    return model, meta, v


@pytest.fixture(scope="module")
def val_setup(tmp_path_factory):
    """A mini DOTA set whose labels are the model's own 8 best single-label
    detections (so the metrics are not trivially zero), the JAX model and
    its weights, and the port model with the same (folded) weights."""
    root = build_mini_dota(tmp_path_factory.mktemp("val_dota"), n_images=4,
                           n_boxes=5)
    jm, jmeta, v = _jax_model()
    port, meta = create_model("yolov5n.yaml", nc=15, device="cpu")
    port.load_state_dict(from_jax_variables(v, port.specs))
    fuse_conv_bn(port)
    ds = DotaDataset(root / "images", DOTA_V1_NAMES, img_size=S)
    predict = make_predict_fn(port, meta, 0.02, 0.45, 8, multi_label=False)
    for i in range(len(ds)):
        s = ds.get_eval_sample(i)
        d, n = predict(torch.from_numpy(s["image"][None]))
        d = d[0, :int(n[0])].numpy()
        polys = PG.scale_polys((S, S), PG.rbox2poly(d[:, :5]),
                               tuple(s["orig_hw"]))
        Path(ds.label_files[i]).write_text("\n".join(
            " ".join(f"{c:.1f}" for c in p) + f" {DOTA_V1_NAMES[int(k)]} 0"
            for p, k in zip(polys, d[:, 6])))
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    return types.SimpleNamespace(root=root, data=data, jm=jm, jmeta=jmeta,
                                 v=v, port=port, meta=meta)


@pytest.mark.parametrize("eval_pad", [0.0, 0.5])
def test_eval_sample_and_metrics_match_jax(val_setup, eval_pad):
    """get_eval_sample, process_batch_hbb and ap_per_class against the JAX
    package's on the mini DOTA set."""
    jds = JaxDataset(val_setup.root / "images", DOTA_V1_NAMES, img_size=96,
                     max_labels=20, eval_pad=eval_pad)
    pds = DotaDataset(val_setup.root / "images", DOTA_V1_NAMES, img_size=96,
                      max_labels=20, eval_pad=eval_pad)
    assert pds.img_files == jds.img_files and pds.eval_canvas == jds.eval_canvas
    rng = np.random.default_rng(6)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    for i in range(len(jds)):
        js, ps = jds.get_eval_sample(i), pds.get_eval_sample(i)
        assert set(js) == set(ps)
        np.testing.assert_array_equal(ps["image"], js["image"])
        np.testing.assert_array_equal(ps["target_mask"], js["target_mask"])
        np.testing.assert_allclose(ps["targets"], js["targets"], atol=1e-5)
        np.testing.assert_array_equal(ps["orig_hw"], js["orig_hw"])
        if eval_pad:
            np.testing.assert_allclose(ps["ratio_pad"], js["ratio_pad"])
        # detections: the targets' covers jittered, plus random boxes
        gt = ps["targets"][ps["target_mask"]]
        assert len(gt)
        gt_xyxy = PG.xywh2xyxy(PG.poly2hbb(PG.rbox2poly(gt[:, 1:6])))
        det = np.concatenate([gt_xyxy + rng.normal(0, 3, gt_xyxy.shape),
                              rng.uniform(0, 90, (6, 4)).cumsum(-1) / 2])
        conf = rng.uniform(0.01, 1.0, len(det))
        dcls = np.concatenate([gt[:, 0], rng.integers(0, 15, 6)]).astype(float)
        args = (det, conf, dcls, gt_xyxy, gt[:, 0], iouv)
        tp = pmetrics.process_batch_hbb(*args)
        np.testing.assert_array_equal(tp, jmetrics.process_batch_hbb(*args))
        assert tp[:, 0].any()
        stats.append((tp, conf, dcls, gt[:, 0]))
    cat = [np.concatenate(x) for x in zip(*stats)]
    for got, want in zip(pmetrics.ap_per_class(*cat),
                         jmetrics.ap_per_class(*cat)):
        np.testing.assert_allclose(got, want, atol=1e-12)
    assert pmetrics.fitness(0, 0, 0.5, 0.3) == jmetrics.fitness(0, 0, 0.5, 0.3)


def _same_detections(got, want, tie=2e-6):
    """The same detections in the same order, polys within 1e-3 px and
    scores within 1e-5; where neighbouring scores differ by less than
    ``tie`` the two packages may rank them either way, so such runs
    compare as sets."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["path"] == w["path"] and tuple(g["hw"]) == tuple(w["hw"])
        gr = np.c_[g["conf"], g["cls"], g["polys"]]
        wr = np.c_[w["conf"], w["cls"], w["polys"]]
        assert gr.shape == wr.shape
        np.testing.assert_allclose(gr[:, 0], wr[:, 0], atol=1e-5)
        cuts = np.flatnonzero(np.abs(np.diff(wr[:, 0])) > tie) + 1
        for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(wr)]):
            ga = gr[a:b][np.lexsort((gr[a:b, 3], gr[a:b, 2], gr[a:b, 1]))]
            wa = wr[a:b][np.lexsort((wr[a:b, 3], wr[a:b, 2], wr[a:b, 1]))]
            np.testing.assert_array_equal(ga[:, 1], wa[:, 1])
            np.testing.assert_allclose(ga[:, 2:], wa[:, 2:], atol=1e-3)


def _same_json_rows(got, want):
    """Rows equal field for field (in a canonical order, for the near-ties
    of :func:`_same_detections`); the one-decimal rounding of a value near
    a rounding edge may differ by one step."""
    assert len(got) == len(want) > 0
    key = lambda r: (r["image_id"], -r["score"], r["category_id"], r["bbox"])
    for g, w in zip(sorted(got, key=key), sorted(want, key=key)):
        assert (g["image_id"], g["category_id"], g["file_name"]) == (
            w["image_id"], w["category_id"], w["file_name"])
        assert abs(g["score"] - w["score"]) <= 1e-5 + 1e-9
        for k in ("bbox", "poly"):
            np.testing.assert_allclose(g[k], w[k], atol=0.1 + 1e-4)


def test_evaluate_matches_jax(val_setup, tmp_path):
    """evaluate: multi-label, conf 0.01, IoU 0.4 on the CPU; the same
    metrics, detections and JSON rows as the JAX package's evaluate, and
    with ``plots_dir`` the same plot files of the same image sizes."""
    vs = val_setup
    jds = JaxDataset(vs.root / "images", DOTA_V1_NAMES, img_size=S,
                     max_labels=100)
    pds = DotaDataset(vs.root / "images", DOTA_V1_NAMES, img_size=S,
                      max_labels=100)
    want = jax_evaluate(vs.jm, jax_fuse(vs.v), vs.jmeta, jds, batch_size=3,
                        save_json=str(tmp_path / "jax.json"),
                        plots_dir=str(tmp_path / "jax_plots"))
    got = evaluate(vs.port, vs.meta, pds, batch_size=3,
                   save_json=str(tmp_path / "port.json"),
                   plots_dir=str(tmp_path / "port_plots"))
    assert set(got) == set(want)
    _same_pngs(tmp_path / "port_plots", tmp_path / "jax_plots", [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
        "confusion_matrix.png"])
    assert 0.05 < want["map50"] < 1.0
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["per_class"].keys() == want["per_class"].keys()
    # per-class AP to 1e-6; p and r are read off the curves against the
    # confidence at the max-F1 point, so they move with the scores' float32
    # noise (1e-7) times the curve's slope
    for name, m in want["per_class"].items():
        for k, x in m.items():
            assert abs(got["per_class"][name][k] - x) <= (
                1e-6 if k.startswith("ap") else 1e-5), (name, k)
    _same_detections(got["detections"], want["detections"])
    assert sum(len(d["conf"]) for d in got["detections"]) > 40
    _same_json_rows(json.loads((tmp_path / "port.json").read_text()),
                    json.loads((tmp_path / "jax.json").read_text()))


def _same_pngs(got_dir, want_dir, names):
    """The same PNG files in both directories, each of the same size."""
    import cv2

    assert sorted(p.name for p in Path(want_dir).glob("*.png")) == names
    assert sorted(p.name for p in Path(got_dir).glob("*.png")) == names
    for n in names:
        g = cv2.imread(str(Path(got_dir) / n))
        w = cv2.imread(str(Path(want_dir) / n))
        assert g is not None and g.shape == w.shape, n


def _seeded_batches(seed, n_img=6, nc=4):
    """Per image: detections (the ground truth jittered, some relabelled,
    plus strays) and ground truth, xyxy with confidences and classes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        ng = int(rng.integers(0, 7)) if i else 0  # an unlabelled image
        xy = rng.uniform(0, 200, (ng, 2))
        gt = np.c_[xy, xy + rng.uniform(10, 60, (ng, 2))]
        gcls = rng.integers(0, nc, ng).astype(float)
        det = np.concatenate([gt + rng.normal(0, 4, gt.shape),
                              np.c_[xy[:2], xy[:2] + 30]])
        dcls = np.concatenate([np.where(rng.uniform(size=ng) < 0.2,
                                        rng.integers(0, nc, ng), gcls),
                               rng.integers(0, nc, len(xy[:2]))])
        conf = rng.uniform(0.05, 1.0, len(det))
        if i == 1:  # an image without detections
            det, dcls, conf = det[:0], dcls[:0], conf[:0]
        out.append((det, conf, dcls.astype(float), gt, gcls))
    return out


@pytest.mark.parametrize("conf, iou", [(0.25, 0.45), (0.6, 0.2)])
def test_confusion_matrix_matches_jax(conf, iou):
    """ConfusionMatrix equals the JAX package's exactly on seeded
    detections (unlabelled images, images without detections, class
    swaps, strays)."""
    got = pmetrics.ConfusionMatrix(nc=4, conf=conf, iou_thres=iou)
    want = jmetrics.ConfusionMatrix(nc=4, conf=conf, iou_thres=iou)
    for b in _seeded_batches(11):
        got.process_batch(*b)
        want.process_batch(*b)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.matrix[:4, :4].trace() > 0 and got.matrix[4].sum() > 0
    assert got.matrix[:, 4].sum() > 0


def test_plot_functions_match_jax(tmp_path):
    """Each plot of utils/plots.py writes its file from the JAX package's
    inputs at the JAX image size: the PR and metric curves, the confusion
    matrix, the results curves, the label distribution, the train-batch
    mosaic and the evolve scatter."""
    import cv2

    from yolov5_obb_tpu.utils import plots as jplots
    from yolov5_obb_tpu_torch.utils import plots as pplots

    rng = np.random.default_rng(2)
    px = np.linspace(0, 1, 1000)
    py = [np.sort(rng.uniform(size=1000))[::-1] for _ in range(3)]
    ap = rng.uniform(size=(3, 10))
    curves = rng.uniform(size=(3, 1000))
    csv_text = "epoch,train/box_loss,metrics/recall,x/lr0\n" + "".join(
        f"{e},{0.1 / (e + 1)},{e / 10},{0.01}\n" for e in range(4))
    (tmp_path / "results.csv").write_text(csv_text)
    (tmp_path / "evolve.csv").write_text(
        "lr0,momentum,fitness\n0.01,0.9,0.2\n0.02,0.93,0.3\n0.015,0.95,0.25\n")
    rb = np.c_[rng.uniform(0, 100, (20, 2)), rng.uniform(10, 40, (20, 2)),
               rng.uniform(-1.5, 1.5, 20)]
    images = rng.integers(0, 255, (3, 64, 64, 3), dtype=np.uint8)
    targets = np.zeros((3, 4, 6), np.float32)
    targets[:, :2] = np.c_[rng.integers(0, 4, (6, 1)), rb[:6, :5]].reshape(
        3, 2, 6)
    mask = np.zeros((3, 4), bool)
    mask[:, :2] = True
    names = ["a", "b", "c", "d"]
    cm = rng.integers(0, 9, (5, 5))
    for tag, mod in (("jax", jplots), ("port", pplots)):
        d = tmp_path / tag
        d.mkdir()
        mod.plot_pr_curve(px, py, ap, d / "pr.png", names[:3])
        mod.plot_mc_curve(px, curves, d / "mc.png", names[:3], ylabel="F1")
        mod.plot_confusion_matrix(cm, names, d / "cm.png")
        mod.plot_results(tmp_path / "results.csv", d / "results.png")
        mod.plot_labels(rb, rng.integers(0, 4, 20).astype(float), names, d)
        mod.plot_images(images, targets, mask, names, d / "batch.png")
        mod.plot_evolve(tmp_path / "evolve.csv", d / "evolve.png")
    files = ["batch.png", "cm.png", "evolve.png", "labels.png", "mc.png",
             "pr.png", "results.png"]
    _same_pngs(tmp_path / "port", tmp_path / "jax", files)
    # the mosaic draws with OpenCV alone: the same pixels
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port/batch.png")),
                                  cv2.imread(str(tmp_path / "jax/batch.png")))


def _read_rows(path):
    return [line.split() for line in Path(path).read_text().splitlines()]


def _same_rows(got, want, num_from):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:num_from] == w[:num_from]
        np.testing.assert_allclose([float(v) for v in g[num_from:]],
                                   [float(v) for v in w[num_from:]],
                                   atol=0.1 + 1e-4)


def test_val_cli_writes_the_same_files_as_jax(val_setup, tmp_path):
    """``python -m yolov5_obb_tpu_torch.val`` on the CPU with a state-dict
    .pt against the JAX val.py with the same weights as an orbax
    checkpoint: the same JSON rows, HBB txts and Task1 files."""
    import val as jax_val
    from yolov5_obb_tpu.utils.checkpoint import save_weights
    from yolov5_obb_tpu_torch import val as port_val

    vs = val_setup
    save_weights(tmp_path / "w", vs.v["params"], vs.v["batch_stats"],
                 {"cfg": "yolov5n.yaml"})
    port, _ = create_model("yolov5n.yaml", nc=15, device="cpu")
    sd = from_jax_variables(vs.v, port.specs)
    torch.save(sd, tmp_path / "w.pt")
    common = dict(cfg="yolov5n.yaml", data=str(vs.data), task="val",
                  imgsz=S, batch_size=2, conf_thres=0.01, iou_thres=0.4,
                  max_det=300, max_images=None, save_json=True, save_txt=True,
                  save_conf=True, save_task1=True, rect_pad=0.0,
                  single_cls=False, dtype="float32", no_fuse=False,
                  project=str(tmp_path), exist_ok=True)
    want = jax_val.run(types.SimpleNamespace(
        **common, weights=str(tmp_path / "w"), name="jax", augment=False,
        no_plots=True, coco_eval=False, mesh=0, hyp=None))
    got = port_val.main([
        "--weights", str(tmp_path / "w.pt"), "--cfg", "yolov5n.yaml",
        "--data", str(vs.data), "--imgsz", str(S), "--batch-size", "2",
        "--max-det", "300", "--save-json", "--save-txt", "--save-conf",
        "--save-task1", "--device", "cpu", "--project", str(tmp_path),
        "--name", "port", "--exist-ok", "--no-plots"])
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    _same_json_rows(json.loads((pdir / "best_obb_predictions.json").read_text()),
                    json.loads((jdir / "best_obb_predictions.json").read_text()))
    for sub, num_from in (("labels", 1), ("task1_raw", 1)):
        names = sorted(p.name for p in (jdir / sub).iterdir())
        assert names == sorted(p.name for p in (pdir / sub).iterdir())
        for name in names:
            _same_rows(_read_rows(pdir / sub / name),
                       _read_rows(jdir / sub / name), num_from)
    assert not list(pdir.glob("*.png"))
    # without --no-plots the run directory gets the JAX val.py's plots
    port_val.main(["--data", str(vs.data), "--device", "cpu", "--imgsz",
                   "64", "--max-images", "2", "--project", str(tmp_path),
                   "--name", "plots"])
    assert sorted(p.name for p in (tmp_path / "plots").glob("*.png")) == [
        "F1_curve.png", "PR_curve.png", "P_curve.png", "R_curve.png",
        "confusion_matrix.png"]


def test_val_cli_study_writes_the_jax_study_file(val_setup, tmp_path,
                                                 monkeypatch):
    """``--task study``: the val task at each of ``--study-sizes`` into
    ``sz<size>/``, then ``study_<data>_<cfg>.txt``; the JAX val.py's study
    branch, fed the port's per-size results, writes the same bytes."""
    import val as jax_val
    from yolov5_obb_tpu_torch import val as port_val

    vs = val_setup
    port_run, subs = port_val.run, {}

    def spy(opt):
        r = port_run(opt)
        if opt.task == "val":
            subs[opt.imgsz] = r
        return r

    monkeypatch.setattr(port_val, "run", spy)
    rows = port_val.main([
        "--data", str(vs.data), "--task", "study", "--study-sizes", "64",
        "96", "--batch-size", "2", "--device", "cpu", "--no-plots",
        "--project", str(tmp_path), "--name", "port"])
    assert sorted(subs) == [64, 96] and [r[0] for r in rows] == [64, 96]
    assert {p.name for p in (tmp_path / "port").iterdir()} == {
        "sz64", "sz96", "study_data_yolov5n.txt"}
    jax_run = jax_val.run
    monkeypatch.setattr(jax_val, "run", lambda sub: subs[sub.imgsz])
    jax_run(types.SimpleNamespace(
        weights="", cfg="yolov5n.yaml", data=str(vs.data), task="study",
        study_sizes=[64, 96], hyp=None, conf_thres=None,
        project=str(tmp_path), name="jax", exist_ok=True))
    name = "study_data_yolov5n.txt"
    assert (tmp_path / "port" / name).read_bytes() == (
        tmp_path / "jax" / name).read_bytes()
    assert len((tmp_path / "port" / name).read_text().splitlines()) == 2


@pytest.mark.parametrize("argv, match", [
    (["--mesh", "2"], "needs 2 processes"),
    (["--weights", "m.onnx"], "not a checkpoint directory")],
    ids=["mesh", "artifact"])
def test_val_cli_refuses_what_item_9_ports(val_setup, tmp_path, argv,
                                           match):
    """What the val CLI still refuses now that ``--mesh`` and exported
    models are ported: a ``--mesh`` that is not the world's size (one
    process here), and a weights file in no format the port reads (ONNX
    is not offered)."""
    from yolov5_obb_tpu_torch import val as port_val

    (tmp_path / "m.onnx").write_bytes(b"")
    argv = [a.replace("m.onnx", str(tmp_path / "m.onnx")) for a in argv]
    with pytest.raises(ValueError, match=match):
        port_val.main(["--data", str(val_setup.data), "--device", "cpu",
                       *argv])


def test_val_cli_coco_eval_matches_jax(val_setup, tmp_path):
    """``--coco-eval`` (with ``--save-json``): the COCO bbox metrics of the
    saved predictions against the split's labels, the JAX val.py's
    ``res["coco"]`` on the same weights; without ``--save-json`` the port
    refuses the flag instead of skipping it."""
    import val as jax_val
    from yolov5_obb_tpu.utils.checkpoint import save_weights
    from yolov5_obb_tpu_torch import val as port_val

    vs = val_setup
    save_weights(tmp_path / "w", vs.v["params"], vs.v["batch_stats"],
                 {"cfg": "yolov5n.yaml"})
    port, _ = create_model("yolov5n.yaml", nc=15, device="cpu")
    torch.save(from_jax_variables(vs.v, port.specs), tmp_path / "w.pt")
    want = jax_val.run(types.SimpleNamespace(
        cfg="yolov5n.yaml", data=str(vs.data), task="val", imgsz=S,
        batch_size=2, conf_thres=0.01, iou_thres=0.4, max_det=300,
        max_images=None, save_json=True, save_txt=False, save_conf=False,
        save_task1=False, rect_pad=0.0, single_cls=False, dtype="float32",
        no_fuse=False, project=str(tmp_path), exist_ok=True,
        weights=str(tmp_path / "w"), name="jax", augment=False,
        no_plots=True, coco_eval=True, mesh=0, hyp=None))["coco"]
    argv = ["--weights", str(tmp_path / "w.pt"), "--data", str(vs.data),
            "--imgsz", str(S), "--batch-size", "2", "--max-det", "300",
            "--device", "cpu", "--project", str(tmp_path), "--name", "port",
            "--exist-ok", "--coco-eval", "--no-plots"]
    got = port_val.main(argv + ["--save-json"])["coco"]
    assert got.keys() == want.keys()
    for k in ("map", "map50", "map75"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["per_class"].keys() == want["per_class"].keys()
    for k, v in want["per_class"].items():
        assert abs(got["per_class"][k] - v) <= 1e-6, k
    assert got["map50"] > 0.1
    assert json.loads((tmp_path / "port" / "gt_coco.json").read_text()) == \
        json.loads((tmp_path / "jax" / "gt_coco.json").read_text())
    with pytest.raises(ValueError, match="--save-json"):
        port_val.main(argv)
