"""The port's DOTA devkit, native geometry and DOTA CLIs against the JAX
package's on the CPU: the same seeded inputs through both, every comparison
with its tolerance.

Bit for bit where both run the same float64 operations (polygon IoU and
clipping, polygon NMS in NumPy and in C++, merged Task1 text, the
converters).  A tile label whose clip keeps 3 or more than 5 points goes
through the port's minimum-area rectangle (OpenCV 5.0's steps in C++, and
in NumPy without a compiler) where the JAX package calls
``cv2.minAreaRect``: bit for bit cv2's corners on float32, so the tile
labels are the same text.
"""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import yolov5_obb_tpu.native as jnative
from yolov5_obb_tpu.devkit import coco_eval as jcoco
from yolov5_obb_tpu.devkit import converters as jconv
from yolov5_obb_tpu.devkit import dota_api as japi
from yolov5_obb_tpu.devkit import evaluate as jeval
from yolov5_obb_tpu.devkit import img_split as jsplit
from yolov5_obb_tpu.devkit import poly_iou as jpoly
from yolov5_obb_tpu.devkit import result_merge as jmerge
from yolov5_obb_tpu_torch import native as pnative
from yolov5_obb_tpu_torch.devkit import coco_eval as pcoco
from yolov5_obb_tpu_torch.devkit import converters as pconv
from yolov5_obb_tpu_torch.devkit import dota_api as papi
from yolov5_obb_tpu_torch.devkit import evaluate as peval
from yolov5_obb_tpu_torch.devkit import img_split as psplit
from yolov5_obb_tpu_torch.devkit import min_area_rect as pmar
from yolov5_obb_tpu_torch.devkit import poly_iou as ppoly
from yolov5_obb_tpu_torch.devkit import result_merge as pmerge
from yolov5_obb_tpu_torch.ops.geometry import rbox2poly
from yolov5_obb_tpu_torch.tools import dota_merge_eval as pmerge_cli
from yolov5_obb_tpu_torch.tools import dota_split as psplit_cli

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["plane", "ship", "harbor"]


def _polys(rng, n, spread=150.0, lo=20.0, hi=80.0):
    cx, cy = rng.uniform(50, spread, (2, n))
    l = rng.uniform(lo, hi, n)
    s = l * rng.uniform(0.3, 1.0, n)
    t = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return rbox2poly(np.stack([cx, cy, l, s, t], -1))


def _signed_area(p):
    return (np.dot(p[:, 0], np.roll(p[:, 1], -1))
            - np.dot(p[:, 1], np.roll(p[:, 0], -1)))


# ---------------------------------------------------------------------------
# geometry: NumPy and C++
# ---------------------------------------------------------------------------


def test_poly_iou_and_clip_are_bit_equal():
    rng = np.random.default_rng(0)
    p = _polys(rng, 60)
    for i in range(0, 60, 2):
        for j in range(1, 60, 3):
            a, b = p[i].reshape(4, 2), p[j].reshape(4, 2)
            np.testing.assert_array_equal(ppoly.clip_polygon(a, b),
                                          jpoly.clip_polygon(a, b))
            assert ppoly.poly_iou(p[i], p[j]) == jpoly.poly_iou(p[i], p[j])
            assert (ppoly.poly_intersection_area(a, b)
                    == jpoly.poly_intersection_area(a, b))
        assert ppoly.poly_area(p[i].reshape(4, 2)) == jpoly.poly_area(
            p[i].reshape(4, 2))


def test_native_library_is_bit_equal_to_jax():
    """The same source and flags: IoU, the overlap matrix and the NMS keep
    list equal to the JAX package's library, and to the NumPy path; the
    port's library lives under build/, keyed by a hash."""
    assert pnative.get_lib() is not None, pnative.BUILD_ERROR
    assert jnative.get_lib() is not None
    path = pnative.so_path()
    assert path.parent.name == "build" and path.exists()
    assert path.name.startswith("polyiou-") and path.suffix == ".so"
    assert not list((ROOT / "yolov5_obb_tpu_torch" / "native").glob("*.so"))
    rng = np.random.default_rng(1)
    a, b = _polys(rng, 40), _polys(rng, 30)
    np.testing.assert_array_equal(pnative.poly_overlaps_native(a, b),
                                  jnative.poly_overlaps_native(a, b))
    for i in range(0, 40, 3):
        got = pnative.iou_poly_native(a[i], b[i % 30])
        assert got == jnative.iou_poly_native(a[i], b[i % 30])
        assert abs(got - ppoly.poly_iou(a[i], b[i % 30])) < 1e-9
    for seed in range(4):
        r = np.random.default_rng(seed)
        p = _polys(r, 200)
        s = np.round(r.uniform(0.1, 1.0, 200), 2)  # ties in the scores
        want = jnative.poly_nms_native(p, s, 0.3)
        assert pnative.poly_nms_native(p, s, 0.3) == want
        assert pmerge.poly_nms_np(p, s, 0.3) == want
        assert pmerge.poly_nms_np(p, s, 0.3, use_native=False) == \
            jmerge.poly_nms_np(p, s, 0.3, use_native=False) == want


def test_tile_names_parse_alike():
    for name in ("P0001__1.0__824___0", "P12__0.5__0___1648", "P0001",
                 "a__b__1.0__0___0", "x__1.5__12___7"):
        assert pmerge.parse_tile_name(name) == jmerge.parse_tile_name(name)


def _clips(rng, n):
    """Seeded convex clips of 6-8 points: a rotated rectangle cut by a
    square window near its centre (a window corner inside the box, or a
    window smaller than the box)."""
    out = []
    while len(out) < n:
        cx, cy = rng.uniform(200, 3800, 2)
        l = rng.uniform(10, 180)
        s = l * rng.uniform(0.2, 1.0)
        t = rng.uniform(-np.pi / 2, np.pi / 2)
        quad = rbox2poly(np.array([[cx, cy, l, s, t]]))[0].reshape(4, 2)
        size = rng.uniform(0.4, 1.2) * l
        x0, y0 = np.array([cx, cy]) - rng.uniform(0, size, 2)
        win = np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size],
                        [x0, y0 + size]])
        inter = ppoly.clip_polygon(quad, win)
        if len(inter) >= 6:
            out.append((inter, quad))
    return out


def _cv2_box_points(pts):
    p = np.asarray(pts, np.float32)
    r = cv2.minAreaRect(p)
    return np.array([*r[0], *r[1], r[2]], np.float32), cv2.boxPoints(r)


def _window_triangles():
    """The 3-point clips of :func:`test_clip_poly_to_tile_matches_jax`'s
    rotated rectangles and general quads by its four tile windows."""
    rng = np.random.default_rng(3)
    rects = [rbox2poly(np.array([[*rng.uniform(700, 1200, 2),
                                   rng.uniform(20, 180), rng.uniform(10, 90),
                                   rng.uniform(-1.5, 1.5)]]))[0]
             for _ in range(400)]
    out = []
    for quad in [*rects, *_general_quads(rng, 800)]:
        for left, up in ((0, 0), (824, 0), (0, 824), (824, 824)):
            inter = ppoly.clip_polygon(quad.reshape(4, 2), _window(left, up))
            whole = (len(inter) >= 3 and ppoly.poly_area(inter)
                     / ppoly.poly_area(quad.reshape(4, 2)) >= 1 - 1e-6)
            if len(inter) == 3 and not whole:
                out.append(inter)
    return out


def _quad_triangles(n):
    """``n`` triangles clipped from seeded general quads by a window corner
    near them."""
    rng = np.random.default_rng(13)
    out = []
    while len(out) < n:
        for quad in _general_quads(rng, 500, 900.0, 1100.0):
            inter = ppoly.clip_polygon(quad.reshape(4, 2), _window(0, 0))
            if len(inter) == 3:
                out.append(inter)
    return out[:n]


@pytest.mark.parametrize("which", ["clips_6_8", "window_triangles",
                                   "quad_triangles"])
def test_min_area_rect_matches_cv2(which):
    """The minimum-area rectangle, C++ and NumPy, against
    ``cv2.minAreaRect`` + ``boxPoints`` (what the JAX package calls), bit for
    bit on float32 (centre, size, angle and corners): 240 seeded 6-8-point
    clips, the 383 triangles of the tile windows, 2000 triangles of random
    quads."""
    if which == "clips_6_8":
        pts = [c for c, _ in _clips(np.random.default_rng(2), 240)]
        assert {len(c) for c in pts} >= {6, 7, 8}
    elif which == "window_triangles":
        pts = _window_triangles()
        assert len(pts) == 383
    else:
        pts = _quad_triangles(2000)
    assert pnative.get_min_area_rect_lib() is not None, pnative.BUILD_ERRORS
    for inter in pts:
        want_box, want = _cv2_box_points(inter)
        for use_native in (True, False):
            box, corners = pmar.min_area_rect(inter, use_native=use_native)
            np.testing.assert_array_equal(box, want_box)
            np.testing.assert_array_equal(corners, want)
        np.testing.assert_array_equal(psplit._min_area_rect(inter),
                                      jsplit._min_area_rect(inter))


def _clip_points(poly8, left, up, size=1024):
    """The points of a GT polygon's clip by a tile window: 0 (outside), 4
    when it lies whole inside, else the clip's count."""
    win = np.array([[left, up], [left + size, up], [left + size, up + size],
                    [left, up + size]], np.float64)
    quad = np.asarray(poly8, np.float64).reshape(4, 2)
    inter = ppoly.clip_polygon(quad, win)
    if len(inter) < 3:
        return 0
    whole = ppoly.poly_area(inter) / ppoly.poly_area(quad) >= 1 - 1e-6
    return 4 if whole else len(inter)


def _general_quads(rng, n, lo=700.0, hi=1200.0):
    """Seeded convex quads of no particular shape: four points at sorted
    angles on the unit circle under a random linear map (skewed, long or
    near-triangular; DOTA labels are any convex quad)."""
    t = np.sort(rng.uniform(0, 2 * np.pi, (n, 4)), 1)
    m = rng.normal(0, 1, (n, 2, 2)) * rng.uniform(10, 90, (n, 1, 1))
    q = np.stack([np.cos(t), np.sin(t)], -1) @ m
    return (q + rng.uniform(lo, hi, (n, 1, 2))).reshape(n, 8)


def _window(left, up, size=1024):
    return np.array([[left, up], [left + size, up], [left + size, up + size],
                     [left, up + size]], np.float64)


def test_clip_poly_to_tile_matches_jax():
    """Rotated rectangles and general convex quads (:func:`_general_quads`)
    against four tile windows: the same flag and the same clipped label bit
    for bit, whether the clip keeps 4 or 5 points (or the polygon lies whole
    in the tile) or becomes its minimum-area rectangle (3 points, or 6 and
    more).  A rectangle's 3-point clips are right triangles covering at most
    half of it, so flagged '2'; a general quad's need not be."""
    rng = np.random.default_rng(3)
    rects = [rbox2poly(np.array([[*rng.uniform(700, 1200, 2),
                                   rng.uniform(20, 180), rng.uniform(10, 90),
                                   rng.uniform(-1.5, 1.5)]]))[0]
             for _ in range(400)]
    seen = {k: 0 for k in ("4", "5", "6+", "3 rect", "3 quad", "3 quad, not 2")}
    for kind, quads in (("rect", rects),
                        ("quad", _general_quads(rng, 800))):
        for quad in quads:
            for left, up in ((0, 0), (824, 0), (0, 824), (824, 824)):
                got, gf = psplit.clip_poly_to_tile(quad, left, up, 1024)
                want, wf = jsplit.clip_poly_to_tile(quad, left, up, 1024)
                assert gf == wf and (got is None) == (want is None)
                if got is None:
                    continue
                np.testing.assert_array_equal(got, want)
                n = _clip_points(quad, left, up)
                if n in (4, 5):
                    seen[str(n)] += 1
                elif n >= 6:
                    seen["6+"] += 1
                else:
                    seen[f"3 {kind}"] += 1
                    assert kind == "quad" or gf == "2"
                    seen["3 quad, not 2"] += kind == "quad" and gf != "2"
    assert min(seen.values()) > 0, seen
    assert seen["3 rect"] + seen["3 quad"] == 383, seen


# ---------------------------------------------------------------------------
# split → merge → evaluate on a seeded DOTA image pair
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def big_dota(tmp_path_factory):
    """A 1900x1500 image (tests/test_devkit.py's layout: 12 well-separated
    boxes) and a 1300x1100 one, 3 classes, difficult flags 0/1; beside a
    few tile corners a long box across the corner's diagonal, cut by both
    window edges into a 6-point clip, yet whole in another tile."""
    root = tmp_path_factory.mktemp("pdota")
    (root / "images").mkdir()
    (root / "labelTxt").mkdir()
    rng = np.random.default_rng(5)
    # (corner, side): a box along the diagonal through the corner of the
    # window whose bottom-right (-1) or top-left (+1) corner it is, its
    # centre l/(2√2) inside, so that each window edge cuts one box corner
    for stem, (h, w), corners in (
            ("P0001", (1500, 1900), [((1024, 1024), -1), ((1848, 1024), -1),
                                     ((824, 476), 1), ((876, 476), 1)]),
            ("P0002", (1100, 1300), [((1024, 1024), -1), ((276, 76), 1)])):
        img = np.full((h, w, 3), 70, np.uint8)
        boxes = []
        for k in range(12):
            boxes.append((120 + (k % 4) * (w - 240) / 3 + rng.uniform(-30, 30),
                          150 + (k // 4) * (h - 300) / 2 + rng.uniform(-30, 30),
                          rng.uniform(80, 140), rng.uniform(40, 60),
                          rng.uniform(-np.pi / 2, np.pi / 2)))
        for (x, y), side in corners:
            l = rng.uniform(140, 170)
            d = side * (l / 2 ** 1.5 + rng.uniform(-3, 3))
            boxes.append((x + d, y + d, l, rng.uniform(30, 40),
                          np.pi / 4 + rng.uniform(-0.05, 0.05)))
        lines = []
        for k, box in enumerate(boxes):
            poly = rbox2poly(np.array([box]))[0]
            cv2.fillPoly(img, [poly.reshape(4, 2).astype(np.int32)],
                         tuple(int(v) for v in rng.integers(120, 255, 3)))
            lines.append(" ".join(f"{v:.1f}" for v in poly)
                         + f" {NAMES[k % 3]} {int(k % 7 == 6)}")
        cv2.imwrite(str(root / "images" / f"{stem}.png"), img)
        (root / "labelTxt" / f"{stem}.txt").write_text("\n".join(lines))
    return root


@pytest.fixture(scope="module")
def split_pair(big_dota, tmp_path_factory):
    out = tmp_path_factory.mktemp("psplit")
    n_j = jsplit.split_dataset(big_dota, out / "jax", num_workers=1)
    n_p = psplit.split_dataset(big_dota, out / "port", num_workers=2)
    assert n_j == n_p == 6 + 4
    return out / "jax", out / "port"


@pytest.fixture(scope="module")
def quad_dota(tmp_path_factory):
    """A 1300x1100 image of general (not rectangular) quads, as DOTA labels
    may be: two seeded near-triangular quads whose long vertex a window
    edge cuts off with ~77% of the area (a 3-point clip that is not
    difficult '2'; the next tile holds them whole), and twelve
    :func:`_general_quads`."""
    root = tmp_path_factory.mktemp("pquads")
    (root / "images").mkdir()
    (root / "labelTxt").mkdir()
    rng = np.random.default_rng(6)
    img = np.full((1100, 1300, 3), 70, np.uint8)
    # vertex B inside the tile, A, D, C just past its edge x = 1024; then
    # the same quad transposed, across y = 1024
    quad = np.array([[1040, 660], [900, 700], [1040, 740], [1043, 700]]) \
        + rng.uniform(-4, 4, (4, 2))
    polys = [quad.reshape(-1), (quad[:, ::-1] - [300, 0]).reshape(-1),
             *_general_quads(rng, 12, 150, 1000)]
    lines = []
    for k, poly in enumerate(polys):
        cv2.fillPoly(img, [poly.reshape(4, 2).astype(np.int32)],
                     tuple(int(v) for v in rng.integers(120, 255, 3)))
        lines.append(" ".join(f"{v:.1f}" for v in poly)
                     + f" {NAMES[k % 3]} 0")
    cv2.imwrite(str(root / "images" / "Q0001.png"), img)
    (root / "labelTxt" / "Q0001.txt").write_text("\n".join(lines))
    out = root / "split"
    assert jsplit.split_dataset(root, out / "jax", num_workers=1) == \
        psplit.split_dataset(root, out / "port", num_workers=2) == 4
    return root, out / "jax", out / "port"


def _split_labels_agree(src, jdir, pdir):
    """Tile PNG bytes and label text equal, the lines of clips that become
    a minimum-area rectangle among them.  Returns the count of each kind of
    clip."""
    names = sorted(p.name for p in (jdir / "images").iterdir())
    assert names == sorted(p.name for p in (pdir / "images").iterdir())
    for name in names:
        assert (jdir / "images" / name).read_bytes() == \
            (pdir / "images" / name).read_bytes()
    seen = {"rect": 0, "3": 0, "3 not 2": 0}
    for lab in sorted((jdir / "labelTxt").iterdir()):
        stem, _, left, up = pmerge.parse_tile_name(lab.stem)
        objs = psplit.read_split_objects(src / "labelTxt" / f"{stem}.txt")
        clips = [n for o in objs if (n := _clip_points(o[0], left, up))]
        want = lab.read_text().splitlines()
        got = (pdir / "labelTxt" / lab.name).read_text().splitlines()
        assert got == want and len(got) == len(clips)
        for g, n in zip(got, clips):
            if n == 3:
                seen["3"] += 1
                seen["3 not 2"] += g.split()[9] != "2"
            elif n >= 6:
                seen["rect"] += 1
    return seen


def test_split_dataset_matches_jax(big_dota, split_pair, quad_dota):
    """:func:`_split_labels_agree` on the rotated boxes of ``big_dota``
    (6-8-point clips among them) and the general quads of ``quad_dota``
    (3-point clips that are not difficult '2' among them): the same text."""
    boxes = _split_labels_agree(big_dota, *split_pair)
    assert boxes["rect"] >= 4, boxes
    quads = _split_labels_agree(*quad_dota)
    assert quads["3 not 2"] >= 2, quads


def test_split_image_array_needs_no_files(big_dota, split_pair):
    """The array-level split gives the tiles and label lines that
    ``split_single_image`` writes."""
    _, pdir = split_pair
    img = cv2.imread(str(big_dota / "images" / "P0002.png"))
    objs = psplit.read_split_objects(big_dota / "labelTxt" / "P0002.txt")
    tiles = list(psplit.split_image_array(img, objs, "P0002"))
    assert sorted(t[0] for t in tiles) == sorted(
        p.stem for p in (pdir / "labelTxt").glob("P0002__*"))
    for name, tile, lines in tiles:
        assert tile.shape == (1024, 1024, 3)
        np.testing.assert_array_equal(
            tile, cv2.imread(str(pdir / "images" / f"{name}.png")))
        assert lines == (pdir / "labelTxt" / f"{name}.txt").read_text(
        ).splitlines()


def _detections(split_dir, rng):
    """Seeded per-tile detections in Task1 rows: each tile label twice
    (jittered, the second at a tied score half the time) and a few
    strays."""
    rows = {n: [] for n in NAMES}
    for lab in sorted((split_dir / "labelTxt").glob("*.txt")):
        for line in lab.read_text().splitlines():
            parts = line.split()
            poly = np.array([float(v) for v in parts[:8]])
            score = rng.uniform(0.05, 1.0)
            for k in range(2):
                jit = poly + rng.normal(0, 1.5 * k, 8)
                sc = score if rng.uniform() < 0.5 else rng.uniform(0.05, 1)
                rows[parts[8]].append(
                    f"{lab.stem} {sc:.5f} "
                    + " ".join(f"{v:.1f}" for v in jit))
        for _ in range(2):
            stray = rbox2poly(np.array([[*rng.uniform(50, 950, 2), 60, 30,
                                         rng.uniform(-1.5, 1.5)]]))[0]
            rows[NAMES[int(rng.integers(0, 3))]].append(
                f"{lab.stem} {rng.uniform(0.01, 0.5):.5f} "
                + " ".join(f"{v:.1f}" for v in stray))
    return rows


@pytest.fixture(scope="module")
def merged_pair(split_pair, tmp_path_factory):
    """The seeded detections merged by both packages (the port with 1 and
    2 workers)."""
    jdir, _ = split_pair
    out = tmp_path_factory.mktemp("pmerge")
    raw = out / "raw"
    raw.mkdir()
    for name, rows in _detections(jdir, np.random.default_rng(7)).items():
        (raw / f"Task1_{name}.txt").write_text("\n".join(rows) + "\n")
    jmerge.merge_by_poly_nms(raw, out / "jax", nms_thresh=0.2, num_workers=1)
    for w in (1, 2):
        pmerge.merge_by_poly_nms(raw, out / f"port{w}", nms_thresh=0.2,
                                 num_workers=w)
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_merge_writes_the_same_text(merged_pair, workers):
    names = sorted(p.name for p in (merged_pair / "jax").iterdir())
    assert names == [f"Task1_{n}.txt" for n in sorted(NAMES)]
    for name in names:
        want = (merged_pair / "jax" / name).read_text()
        assert (merged_pair / f"port{workers}" / name).read_text() == want
        assert want.count("\n") > 5


def test_merge_helpers_match_jax(merged_pair, tmp_path):
    """``results_obb2hbb`` and ``merge_ensemble`` write the same text."""
    jmerge.results_obb2hbb(merged_pair / "jax", tmp_path / "j2")
    pmerge.results_obb2hbb(merged_pair / "port1", tmp_path / "p2")
    srcs = [merged_pair / "raw", merged_pair / "jax"]
    jmerge.merge_ensemble(srcs, tmp_path / "je", num_workers=1)
    pmerge.merge_ensemble(srcs, tmp_path / "pe", num_workers=2)
    for a, b in (("j2", "p2"), ("je", "pe")):
        names = sorted(p.name for p in (tmp_path / a).iterdir())
        assert names and names == sorted(p.name
                                         for p in (tmp_path / b).iterdir())
        for n in names:
            assert (tmp_path / a / n).read_text() == \
                (tmp_path / b / n).read_text()


@pytest.mark.parametrize("use_07", [True, False])
def test_evaluate_matches_jax(big_dota, merged_pair, use_07):
    """Task1 APs to 1e-12 and mAOE to 1e-9 (at conf 0.3 and the golden
    flow's 0.1), on the merged detections and on the oracle round trip
    (tile labels → Task1 → merge → mAP > 0.95, mAOE < 5°)."""
    anno = big_dota / "labelTxt"
    ids = ["P0001", "P0002"]
    det = merged_pair / "port1"
    got = peval.evaluate_task1(det, anno, ids, NAMES, use_07_metric=use_07)
    want = jeval.evaluate_task1(det, anno, ids, NAMES, use_07_metric=use_07)
    assert abs(got[0] - want[0]) <= 1e-12 and 0.05 < got[0] < 1
    for k in NAMES:
        assert abs(got[1][k] - want[1][k]) <= 1e-12
    for conf in (0.3, 0.1):
        g = peval.evaluate_maoe(det, anno, ids, NAMES, conf_thresh=conf)
        w = jeval.evaluate_maoe(det, anno, ids, NAMES, conf_thresh=conf)
        assert abs(g[0] - w[0]) <= 1e-9 and g[0] > 0
        assert g[1].keys() == w[1].keys()
        for k in w[1]:
            assert abs(g[1][k] - w[1][k]) <= 1e-9


def test_oracle_round_trip(big_dota, split_pair, tmp_path):
    """tests/test_devkit.py's round trip on the port: the tile labels as
    detections, merged, against the unsplit labels; and the same numbers
    from the JAX functions."""
    _, pdir = split_pair
    raw = pconv.groundtruth_to_task1(pdir / "labelTxt", tmp_path / "raw",
                                     NAMES, skip_difficult2=True)
    pmerge.merge_by_poly_nms(raw, tmp_path / "merged", num_workers=1)
    ids = ["P0001", "P0002"]
    m, _ = peval.evaluate_task1(tmp_path / "merged", big_dota / "labelTxt",
                                ids, NAMES)
    a, _ = peval.evaluate_maoe(tmp_path / "merged", big_dota / "labelTxt",
                               ids, NAMES)
    assert m > 0.95 and a < 5.0, (m, a)
    assert m == jeval.evaluate_task1(tmp_path / "merged",
                                     big_dota / "labelTxt", ids, NAMES)[0]


def test_voc_ap_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        rec = np.sort(rng.uniform(0, 1, 30))
        prec = rng.uniform(0, 1, 30)
        for m07 in (True, False):
            assert peval.voc_ap(rec, prec, m07) == jeval.voc_ap(rec, prec,
                                                                m07)


# ---------------------------------------------------------------------------
# converters, the DOTA API, COCO eval
# ---------------------------------------------------------------------------


def test_converters_match_jax(big_dota, split_pair, tmp_path):
    """json_to_task1, groundtruth_to_task1, dota_to_coco,
    dota_to_mmdet_json and voc_xml_to_dota: equal text and JSON."""
    rng = np.random.default_rng(8)
    dets = [{"image_id": f"P0001__1.0__{int(rng.integers(0, 900))}___0",
             "category_id": int(rng.integers(0, 4)),
             "score": float(rng.uniform()),
             "poly": rng.uniform(0, 1024, 8).tolist()} for _ in range(50)]
    (tmp_path / "d.json").write_text(json.dumps(dets))
    xml = tmp_path / "xml"
    xml.mkdir()
    (xml / "a.xml").write_text(
        "<annotation><object><name>car</name><difficult>1</difficult>"
        "<polygon><x1>1</x1><y1>2</y1><x2>30</x2><y2>2</y2><x3>30</x3>"
        "<y3>20</y3><x4>1</x4><y4>20</y4></polygon></object><object>"
        "<name>big truck</name><bndbox><xmin>5</xmin><ymin>6</ymin>"
        "<xmax>50</xmax><ymax>60</ymax></bndbox></object></annotation>")
    _, pdir = split_pair
    for mod, tag in ((jconv, "j"), (pconv, "p")):
        mod.json_to_task1(tmp_path / "d.json", tmp_path / tag / "t1", NAMES)
        mod.groundtruth_to_task1(pdir / "labelTxt", tmp_path / tag / "gt",
                                 NAMES, skip_difficult2=True)
        mod.dota_to_coco(big_dota, tmp_path / tag / "coco.json", NAMES)
        mod.dota_to_mmdet_json(big_dota, tmp_path / tag / "mm.json")
        mod.voc_xml_to_dota(xml, tmp_path / tag / "voc",
                            name_map={"car": "small-vehicle"})
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 3 + 3 + 3 and files == sorted(
        p.relative_to(tmp_path / "p")
        for p in (tmp_path / "p").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "p" / f).read_text() == \
            (tmp_path / "j" / f).read_text(), f


def test_dota_api_matches_jax(big_dota):
    j, p = japi.DOTA(big_dota), papi.DOTA(big_dota)
    assert p.get_img_ids() == j.get_img_ids()
    for cats in ((), ("plane",), ("plane", "ship")):
        assert p.get_img_ids(cats) == j.get_img_ids(cats)
        for diff in (None, 0, 1):
            a, b = p.load_anns(cats, difficult=diff), j.load_anns(
                cats, difficult=diff)
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                np.testing.assert_array_equal(x.pop("poly"), y.pop("poly"))
                assert x == {k: v for k, v in y.items() if k != "poly"}
    lab = big_dota / "labelTxt" / "P0001.txt"
    assert [o["bndbox"] for o in papi.parse_dota_rec(lab)] == \
        [o["bndbox"] for o in japi.parse_dota_rec(lab)]
    np.testing.assert_array_equal(p.load_imgs("P0002")[0],
                                  j.load_imgs("P0002")[0])


def test_coco_eval_matches_jax():
    """Seeded GT and predictions (jittered, missed, false, other-class):
    every number equal to 1e-12."""
    rng = np.random.default_rng(9)
    images = [{"id": i + 1, "file_name": f"im{i}.png", "height": 500,
               "width": 500} for i in range(4)]
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(NAMES)]
    anns, preds = [], []
    for i in range(40):
        img = int(rng.integers(1, 5))
        c = int(rng.integers(1, 4))
        x, y = rng.uniform(0, 400, 2)
        w, h = rng.uniform(10, 80, 2)
        anns.append({"id": i + 1, "image_id": img, "category_id": c,
                     "bbox": [x, y, w, h], "iscrowd": int(i == 7)})
        if rng.uniform() < 0.8:
            j = rng.normal(0, 3, 4)
            preds.append({"image_id": f"im{img - 1}",
                          "category_id": c - 1 if rng.uniform() < 0.9
                          else int(rng.integers(0, 3)),
                          "bbox": [x + w / 2 + j[0], y + h / 2 + j[1],
                                   w + j[2], h + j[3]],
                          "score": float(rng.uniform())})
    gt = {"images": images, "categories": cats, "annotations": anns}
    for max_dets in (100, 5):
        got = pcoco.coco_eval_bbox(gt, [dict(p) for p in preds],
                                   max_dets=max_dets)
        want = jcoco.coco_eval_bbox(gt, [dict(p) for p in preds],
                                    max_dets=max_dets)
        assert got.keys() == want.keys()
        for k in ("map", "map50", "map75"):
            assert abs(got[k] - want[k]) <= 1e-12
        assert got["per_class"].keys() == want["per_class"].keys()
        for k in want["per_class"]:
            assert abs(got["per_class"][k] - want["per_class"][k]) <= 1e-12
        assert 0.1 < got["map"] < 0.9


# ---------------------------------------------------------------------------
# the CLIs against the JAX tools
# ---------------------------------------------------------------------------


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_split_cli_matches_jax(big_dota, tmp_path, monkeypatch, capsys):
    """``python -m yolov5_obb_tpu_torch.tools.dota_split`` against
    tools/dota_split.py: the same tiles and printed lines (two rates, so
    the tile names carry 0.5 and 1.0)."""
    args = ["--src", str(big_dota), "--subsize", "1024", "--gap", "200",
            "--rates", "0.5", "1.0", "--workers", "2"]
    monkeypatch.setattr(sys, "argv", ["dota_split.py", *args, "--dst",
                                      str(tmp_path / "j")])
    _jax_tool("dota_split").main()
    want = capsys.readouterr().out
    psplit_cli.main([*args, "--dst", str(tmp_path / "p")])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "p"), "D") == \
        want.replace(str(tmp_path / "j"), "D")
    assert "rate 0.5: 2 tiles" in got
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "p")
                           for p in (tmp_path / "p").rglob("*")
                           if p.is_file())
    for f in files:
        if f.suffix == ".png":
            assert (tmp_path / "p" / f).read_bytes() == \
                (tmp_path / "j" / f).read_bytes()


def test_merge_eval_cli_matches_jax(big_dota, split_pair, tmp_path,
                                    monkeypatch, capsys):
    """``python -m yolov5_obb_tpu_torch.tools.dota_merge_eval`` against
    tools/dota_merge_eval.py on one val JSON: the same merged files and
    printed lines (classaps, map, mAOE)."""
    jdir, _ = split_pair
    rows = _detections(jdir, np.random.default_rng(11))
    dets = []
    for c, name in enumerate(NAMES):
        for r in rows[name]:
            parts = r.split()
            dets.append({"image_id": parts[0], "category_id": c,
                         "score": float(parts[1]),
                         "poly": [float(v) for v in parts[2:]]})
    (tmp_path / "pred.json").write_text(json.dumps(dets))
    (tmp_path / "data.yaml").write_text(
        f"path: {big_dota}\nval: images\nnc: 3\nnames: {NAMES}\n")
    args = ["--json", str(tmp_path / "pred.json"), "--data",
            str(tmp_path / "data.yaml"), "--anno",
            str(big_dota / "labelTxt"), "--maoe", "--obb2hbb",
            "--workers", "2"]
    monkeypatch.setattr(sys, "argv", ["dota_merge_eval.py", *args, "--out",
                                      str(tmp_path / "j")])
    _jax_tool("dota_merge_eval").main()
    want = capsys.readouterr().out
    res = pmerge_cli.main([*args, "--out", str(tmp_path / "p")])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "p"), "D") == \
        want.replace(str(tmp_path / "j"), "D")
    assert f"map: {res['map']:.4f}" in got and res["map"] > 0.3
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.txt"))
    assert len(files) == 3 * 3
    for f in files:
        assert (tmp_path / "p" / f).read_text() == \
            (tmp_path / "j" / f).read_text(), f
