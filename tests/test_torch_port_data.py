"""The port's train data path against the JAX package's on the CPU: seeded
train samples (mosaics, mixup, copy-paste, the warps, HSV, flips, the
extras, the image caches), each transform alone, the in-process loader,
the shard cache, autoanchor and the image weights — bit for bit."""

import types

import numpy as np
import pytest
import torch

from conftest import build_mini_dota
from yolov5_obb_tpu.data import augment as JA
from yolov5_obb_tpu.data.dota import DotaDataset as JaxDataset
from yolov5_obb_tpu.data.loader import create_dataloader as jax_loader
from yolov5_obb_tpu.data.shards import ShardDataset as JaxShards
from yolov5_obb_tpu.data.shards import write_shards as jax_write_shards
from yolov5_obb_tpu.data.tools import (
    labels_to_class_weights as jax_class_weights,
    labels_to_image_weights as jax_image_weights,
)
from yolov5_obb_tpu.ops import geometry as JG
from yolov5_obb_tpu.utils import autoanchor as JAA
from yolov5_obb_tpu_torch.data import augment as PA
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
from yolov5_obb_tpu_torch.data.loader import WorkerPool, _stack, create_dataloader
from yolov5_obb_tpu_torch.data.shards import ShardDataset, write_shards
from yolov5_obb_tpu_torch.data.tools import (
    labels_to_class_weights,
    labels_to_image_weights,
)
from yolov5_obb_tpu_torch.ops import geometry as PG
from yolov5_obb_tpu_torch.utils import autoanchor as PAA
from yolov5_obb_tpu_torch.utils.general import load_hyp

S = 96  # sample size; the images are 120 x 160, resized on load
N_IMAGES = 5
BASE = {**load_hyp(), "mosaic": 0.0, "mixup": 0.0, "flipud": 0.0,
        "fliplr": 0.0, "degrees": 0.0, "hsv_h": 0.0, "hsv_s": 0.0,
        "hsv_v": 0.0}
CASES = {
    "mosaic4": {"mosaic": 1.0, "degrees": 30.0, "scale": 0.25},
    "mosaic9": {"mosaic": 1.0, "mosaic9": 1.0, "degrees": 30.0},
    "mixup": {"mosaic": 1.0, "mixup": 1.0},
    "copy_paste": {"mosaic": 1.0, "copy_paste": 0.8, "translate": 0.0,
                   "scale": 0.0},
    "perspective": {"degrees": 20.0, "shear": 5.0, "perspective": 0.0005,
                    "scale": 0.3},
    "affine": {"degrees": 180.0, "shear": 3.0, "translate": 0.2},
    "hsv_flips_extra": {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
                        "flipud": 0.5, "fliplr": 0.5, "extra_aug": 0.6},
    "default_hyp": None,
}


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return build_mini_dota(tmp_path_factory.mktemp("port_data"),
                           n_images=N_IMAGES, n_boxes=6, hw=(120, 160),
                           seed=5)


def _pair(root, hyp, **kw):
    kw = dict(img_size=S, hyp=hyp, augment=True, max_labels=24, **kw)
    return (JaxDataset(root / "images", DOTA_V1_NAMES, **kw),
            DotaDataset(root / "images", DOTA_V1_NAMES, **kw))


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_train_sample_matches_jax(mini, case):
    hyp = load_hyp() if CASES[case] is None else {**BASE, **CASES[case]}
    jds, pds = _pair(mini, hyp)
    jr, pr = np.random.default_rng(3), np.random.default_rng(3)
    live = 0
    for i in [0, 1, 2, 3, 4, 2, 0]:
        want, got = jds.get_train_sample(i, jr), pds.get_train_sample(i, pr)
        _same_sample(got, want)
        live += int(want["target_mask"].sum())
    assert live > 0  # the case kept some boxes


@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_cached_train_sample_matches_jax(mini, tmp_path, cache):
    """The image caches (each side its own directory): the first pass fills
    them, the second reads."""
    kw = dict(img_size=S, hyp={**BASE, **CASES["mosaic4"], "fliplr": 0.5},
              augment=True, max_labels=24, cache_images=cache)
    jds = JaxDataset(mini / "images", DOTA_V1_NAMES, cache_dir=tmp_path / "j",
                     **kw)
    pds = DotaDataset(mini / "images", DOTA_V1_NAMES,
                      cache_dir=tmp_path / "p", **kw)
    jr, pr = np.random.default_rng(8), np.random.default_rng(8)
    for i in [0, 1, 2, 3, 4] * 2:
        _same_sample(pds.get_train_sample(i, pr), jds.get_train_sample(i, jr))
    for side in "jp":
        assert len(list(tmp_path.glob(f"{side}/imgs_*/*.npz"))) == (
            N_IMAGES if cache == "disk" else 0)
        assert len(list(tmp_path.glob(f"{side}/labels_*.npz"))) == 1
    # the label cache is the JAX package's file: the port reads JAX's
    again = DotaDataset(mini / "images", DOTA_V1_NAMES, img_size=S,
                        cache_dir=tmp_path / "j")
    for a, b in zip(again.polys, jds.polys):
        np.testing.assert_array_equal(a, b)


def _img(seed, h=70, w=90):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _polys(seed, n=6, h=70, w=90):
    rng = np.random.default_rng(seed)
    rb = np.stack([rng.uniform(5, w - 5, n), rng.uniform(5, h - 5, n),
                   rng.uniform(8, 30, n), rng.uniform(4, 12, n),
                   rng.uniform(-1.5, 1.5, n)], 1)
    return (JG.rbox2poly(rb).astype(np.float32),
            rng.integers(0, 15, n).astype(np.float32))


TRANSFORMS = {
    "cutout": lambda m, img, p, c, r: m.cutout(img, p, c, r, p=1.0),
    "letterbox_auto": lambda m, img, p, c, r: m.letterbox(img, 96, auto=True),
    "letterbox_scale_fill": lambda m, img, p, c, r: m.letterbox(
        img, (64, 96), auto=False, scale_fill=True),
    "letterbox_color_noscaleup": lambda m, img, p, c, r: m.letterbox(
        img, 128, color=(0, 10, 200), scaleup=False),
    "hsv": lambda m, img, p, c, r: m.hsv_augment(img, r, 0.5, 0.5, 0.5),
    "extra": lambda m, img, p, c, r: m.extra_augment(img, r, p=1.0),
    "random_perspective": lambda m, img, p, c, r: m.random_perspective(
        img, p, c, r, degrees=45, translate=0.2, scale=0.3, shear=4,
        perspective=0.001),
    "copy_paste": lambda m, img, p, c, r: m.copy_paste(img, p, c, r, p=1.0),
    "mixup": lambda m, img, p, c, r: m.mixup(img, p, c, _img(9), p[:2],
                                             c[:2], r),
    "flips": lambda m, img, p, c, r: (m.flip_polys_ud(p, 70),
                                      m.flip_polys_lr(p, 90)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    fn = TRANSFORMS[name]
    polys, cls = _polys(1)
    outs = []
    for mod in (JA, PA):
        outs.append(fn(mod, _img(0), polys.copy(), cls.copy(),
                       np.random.default_rng(4)))
    want, got = outs
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_geometry_helpers_match_jax():
    polys, _ = _polys(2, n=40)
    polys[::3] -= 40  # some centres outside
    np.testing.assert_array_equal(PG.poly_filter(polys, 70, 90),
                                  JG.poly_filter(polys, 70, 90))
    xyxy = np.random.default_rng(0).uniform(0, 50, (7, 4))
    np.testing.assert_array_equal(PG.xyxy2xywh(xyxy), JG.xyxy2xywh(xyxy))


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("image", "targets", "target_mask", "index"):
            np.testing.assert_array_equal(np.asarray(getattr(g, k)),
                                          getattr(w, k), err_msg=k)


@pytest.mark.parametrize("kw", [
    {}, {"indices": [4, 4, 1, 0, 2, 3, 1]},
    {"shard_index": 0, "shard_count": 2},
    {"shard_index": 1, "shard_count": 2, "indices": [0, 1, 2, 3, 4, 0]},
    {"shuffle": False, "drop_remainder": False, "num_epochs": 2},
], ids=["plain", "indices", "shard0", "shard1_indices", "ordered_2epochs"])
def test_dataloader_matches_jax(mini, kw):
    jds, pds = _pair(mini, {**BASE, **CASES["mosaic4"], "fliplr": 0.5})
    kw = {"num_epochs": 1, **kw}
    _same_batches(create_dataloader(pds, 2, seed=7, **kw),
                  jax_loader(jds, 2, seed=7, **kw))


def test_dataloader_workers_match_their_seeds(mini):
    """The worker path: the same order as the in-process path, each record
    augmented with a generator seeded from (seed + epoch, position), so two
    runs give the same batches whatever worker takes which record; the
    pool's processes serve both epochs and both runs."""
    _, pds = _pair(mini, {**BASE, "fliplr": 0.5, "degrees": 30.0})
    pool = WorkerPool(pds, 2)
    try:
        runs = [list(create_dataloader(pds, 2, seed=3, num_epochs=2,
                                       drop_remainder=False, workers=pool))
                for _ in range(2)]
    finally:
        pool.close()
    _same_batches(runs[0], runs[1])
    assert all(isinstance(b.image, torch.Tensor) for b in runs[0])
    rng, want = np.random.default_rng(3), []
    for epoch in range(2):
        order = rng.permutation(np.arange(N_IMAGES))
        samples = [pds.get_train_sample(
            int(j), np.random.default_rng([3 + epoch, p]))
            for p, j in enumerate(order)]
        want += [_stack(samples[i:i + 2]) for i in range(0, N_IMAGES, 2)]
    _same_batches(runs[0], want)
    with pytest.raises(ValueError, match="another dataset"):
        next(create_dataloader(_pair(mini, BASE)[1], 2, workers=pool))


def test_shards_match_jax(mini, tmp_path):
    jds, pds = _pair(mini, {**BASE, **CASES["mosaic4"], "fliplr": 0.5})
    jax_write_shards(jds, tmp_path / "j", aug_epochs=2, seed=4, shard_size=3,
                     verbose=False)
    write_shards(pds, tmp_path / "p", aug_epochs=2, seed=4, shard_size=3,
                 verbose=False)
    jfiles = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert jfiles == sorted(f.name for f in (tmp_path / "p").iterdir())
    for f in jfiles:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "p" / f),
                                          np.load(tmp_path / "j" / f))
        else:
            assert (tmp_path / "p" / f).read_text() == \
                (tmp_path / "j" / f).read_text()
    js, ps = JaxShards(tmp_path / "j"), ShardDataset(tmp_path / "p")
    assert len(js) == len(ps) == 2 * N_IMAGES
    for i in range(len(ps)):
        _same_sample(ps.get_train_sample(i), js.get_train_sample(i))
    for epoch, src in ((0, None), (3, None), (1, [2, 2, 0, 4])):
        np.testing.assert_array_equal(
            ps.epoch_indices(epoch, seed=5, source_indices=src),
            js.epoch_indices(epoch, seed=5, source_indices=src))
    _same_batches(create_dataloader(ps, 3, shuffle=False, num_epochs=1,
                                    indices=ps.epoch_indices(1)),
                  jax_loader(js, 3, shuffle=False, num_epochs=1,
                             indices=js.epoch_indices(1)))


def test_autoanchor_matches_jax(mini):
    _, pds = _pair(mini, BASE)
    wh = PAA.dataset_wh(pds, 512)
    np.testing.assert_array_equal(wh, JAA.dataset_wh(pds, 512))
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119], [116, 90], [156, 198], [373, 326]],
                       np.float32)
    assert PAA.best_possible_recall(wh, anchors) == \
        JAA.best_possible_recall(wh, anchors)
    assert PAA.anchor_fitness(wh, anchors) == JAA.anchor_fitness(wh, anchors)
    for seed in (0, 3):
        np.testing.assert_array_equal(
            PAA.kmean_anchors(wh, n=9, gen=300, seed=seed),
            JAA.kmean_anchors(wh, n=9, gen=300, seed=seed))
    # at 4096 the boxes outgrow the config anchors: check_anchors evolves
    meta = types.SimpleNamespace(anchors_px=anchors.reshape(3, 3, 2))
    got = PAA.check_anchors(pds, meta, imgsz=4096, evolve_gen=300)
    want = JAA.check_anchors(pds, meta, imgsz=4096, evolve_gen=300)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 3, 2) and not np.array_equal(got, meta.anchors_px)


def test_image_weights_match_jax(mini):
    _, pds = _pair(mini, BASE)
    cls = pds.cls + [np.zeros(0, np.float32)]
    for nc in (15, 4):
        cw = labels_to_class_weights(cls, nc)
        np.testing.assert_array_equal(cw, jax_class_weights(cls, nc))
        np.testing.assert_array_equal(labels_to_image_weights(cls, nc, cw),
                                      jax_image_weights(cls, nc, cw))
    empty = [np.zeros(0, np.float32)] * 3
    np.testing.assert_array_equal(labels_to_image_weights(empty, 15),
                                  jax_image_weights(empty, 15))
