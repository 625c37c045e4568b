"""The port's Python API, REST server, image reader, streams and drawing
against the JAX package's (and OpenCV's) on the CPU: PNG decoding bit for
bit against ``cv2``, ``OBBModel`` on every input form and its
``pandas()``, a serve round trip, ``LoadStreams`` on a small video and the
annotation pixels — the same numpy-seeded inputs and weights (the in-repo
trained yolov5n with its Detect biases raised, at 128 px, float32)."""

import io
import json
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from test_torch_port_val import _jax_model
from yolov5_obb_tpu.utils.checkpoint import save_weights as jax_save_weights
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.models.yolo import create_model
from yolov5_obb_tpu_torch.utils import image_io
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S = 128


# ---------------------------------------------------------------------------
# image_io
# ---------------------------------------------------------------------------


def _image(h=37, w=53):
    img = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    img[5:20, 10:30] = (200, 30, 90)  # a flat patch: runs for the filters
    return img


def _pil_png(mode, **kw):
    from PIL import Image

    im = Image.fromarray(_image()[..., ::-1])
    im = im.convert(mode) if mode else im
    b = io.BytesIO()
    im.save(b, format="PNG", **kw)
    return b.getvalue()


def _png(kind):
    img = _image()
    if kind.startswith("cv2"):
        arr = {"cv2_rgb": img, "cv2_gray": img[..., 0],
               "cv2_16bit": img.astype(np.uint16) * 257 + 7,
               "cv2_bgra": np.dstack([img, img[..., :1]])}[kind]
        return cv2.imencode(".png", arr)[1].tobytes()
    if kind.startswith("port"):
        arr, filters = {
            "port_filters": (img[..., ::-1], (0, 1, 2, 3, 4)),
            "port_paeth": (img[..., ::-1], (4,)),
            "port_gray_alpha": (img[..., :2], (4, 3, 1)),
            "port_rgba16": (np.dstack([img, img[..., :1]]).astype(np.uint16)
                            * 251, (4, 3, 1, 2, 0)),
            "port_gray16": (img[..., 0].astype(np.uint16) * 251, (3,))}[kind]
        return image_io.encode_png(arr, filters)
    mode = kind[len("pil_"):]
    if mode == "P_trns":
        return _pil_png("P", transparency=3)
    if mode == "P4":  # a 2-bit palette
        from PIL import Image

        im = Image.fromarray(_image()[..., ::-1]).convert(
            "P", palette=Image.ADAPTIVE, colors=4)
        b = io.BytesIO()
        im.save(b, format="PNG")
        return b.getvalue()
    return _pil_png(mode)


@pytest.mark.parametrize("kind", [
    "cv2_rgb", "cv2_gray", "cv2_16bit", "cv2_bgra", "port_filters",
    "port_paeth", "port_gray_alpha", "port_rgba16", "port_gray16", "pil_L",
    "pil_LA", "pil_RGBA", "pil_P", "pil_P_trns", "pil_P4", "pil_1",
    "pil_I;16"])
def test_png_decode_matches_cv2(kind, monkeypatch):
    """``image_io`` reads PNG from cv2, PIL and its own writer (all five
    filters; 1-, 2-, 8- and 16-bit; gray, gray+alpha, RGB, RGBA, palette)
    as ``cv2.imdecode(..., IMREAD_COLOR)`` does, bit for bit, through the
    native unfilter and the NumPy one — and never through cv2."""
    data = _png(kind)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert want is not None and want.shape == (37, 53, 3)
    monkeypatch.setitem(sys.modules, "cv2", None)  # no OpenCV from here on
    for use_native in (True, False):
        np.testing.assert_array_equal(
            image_io.decode_png(data, use_native=use_native), want)
    np.testing.assert_array_equal(image_io.imdecode(data), want)


def test_png_paths_and_other_formats(tmp_path, monkeypatch):
    """Files and bytes; the native unfilter is built; a truncated PNG gives
    None; JPEG and interlaced PNG go to cv2, and without OpenCV raise an
    error that names it."""
    from yolov5_obb_tpu_torch import native

    assert native.get_png_lib() is not None, native.BUILD_ERRORS
    img = _image()
    image_io.write_png(tmp_path / "a.png", img[..., ::-1], (4, 1))
    np.testing.assert_array_equal(image_io.imread(tmp_path / "a.png"), img)
    assert image_io.imread(tmp_path / "missing.png") is None
    data = image_io.encode_png(img[..., ::-1])
    assert image_io.imdecode(data[:-30]) is None
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    np.testing.assert_array_equal(
        image_io.imdecode(jpg),
        cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR))
    # an interlaced PNG (the IHDR flag set) is handed to cv2
    seen = []
    monkeypatch.setattr(image_io, "_cv2_decode",
                        lambda d: seen.append(d) or img)
    ihdr = bytearray(data)
    ihdr[28] = 1  # the interlace byte
    ihdr[29:33] = (image_io.zlib.crc32(bytes(ihdr[12:29])) & 0xFFFFFFFF
                   ).to_bytes(4, "big")
    assert image_io.imdecode(bytes(ihdr)) is img and len(seen) == 1
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(image_io.OpenCVUnavailable, match="OpenCV"):
        image_io.imdecode(jpg)
    np.testing.assert_array_equal(image_io.imdecode(data), img)


def test_empty_data_is_undecodable(tmp_path, monkeypatch):
    """Empty bytes and a zero-byte file read as undecodable (None, as
    ``cv2.imread`` gives for an empty file) before any OpenCV call."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert image_io.imdecode(b"") is None
    assert image_io.imdecode(bytearray()) is None
    (tmp_path / "empty.png").write_bytes(b"")
    assert image_io.imread(tmp_path / "empty.png") is None


# ---------------------------------------------------------------------------
# the API and the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX ``OBBModel`` and the port's on the same weights (a JAX
    orbax checkpoint, and the port's state-dict .pt), single-label at conf
    0.01."""
    import yolov5_obb_tpu.models.yolo as jyolo
    from yolov5_obb_tpu.api import OBBModel as JaxOBBModel
    from yolov5_obb_tpu_torch.api import OBBModel

    root = tmp_path_factory.mktemp("api")
    _, _, v = _jax_model()
    jax_save_weights(root / "w", v["params"], v["batch_stats"],
                     {"cfg": "yolov5n.yaml"})
    m, _ = create_model("yolov5n.yaml", nc=15, device="cpu")
    torch.save(from_jax_variables(v, m.specs), root / "w.pt")
    kw = dict(cfg="yolov5n.yaml", names=DOTA_V1_NAMES, imgsz=S,
              conf_thres=0.01)
    # the JAX constructor's random init, replaced by the weights, is skipped
    # (its first, eager run costs ~25 s on the CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jyolo, "init_model", lambda *a, **k: None)
        jax_model = JaxOBBModel(weights=str(root / "w"), **kw)
    return types.SimpleNamespace(
        jax=jax_model, port=OBBModel(weights=str(root / "w.pt"),
                                     device="cpu", **kw), root=root)


def test_api_raises_file_not_found_on_an_empty_file(models, tmp_path):
    """A zero-byte image file raises ``FileNotFoundError``, as the JAX
    API does."""
    (tmp_path / "empty.png").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="empty.png"):
        models.port(str(tmp_path / "empty.png"))
    with pytest.raises(FileNotFoundError):
        models.jax(str(tmp_path / "empty.png"))


def test_serve_answers_400_to_an_empty_body(models):
    """An empty POST body gets 400 and the server goes on answering."""
    from yolov5_obb_tpu_torch.serve import _Worker, make_handler

    worker = _Worker(models.port, max_batch=1)
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/obb-detection"
    try:
        for _ in range(2):
            req = urllib.request.Request(url, data=b"", method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == 400
            assert "not a decodable image" in e.value.read().decode()
    finally:
        srv.shutdown()


def _scene(seed, h=120, w=160):
    """A seeded BGR image of filled rotated boxes on a blocky background."""
    rng = np.random.default_rng(seed)
    img = np.repeat(np.repeat(rng.integers(40, 120, (h // 8, w // 8, 3),
                                           dtype=np.uint8), 8, 0), 8, 1)
    for _ in range(6):
        c = rng.uniform(20, [w - 20, h - 20])
        box = cv2.boxPoints(((*c,), tuple(rng.uniform(12, 40, 2)),
                             float(rng.uniform(-90, 0))))
        cv2.fillPoly(img, [box.astype(np.int32)],
                     tuple(int(x) for x in rng.integers(120, 255, 3)))
    return img


def _same_results(got, want, tie=2e-6):
    """Per image the same detections: classes equal, polygons within 1e-3
    px, scores within 1e-5 (near-tied scores compared as sets)."""
    assert len(got.polys) == len(want.polys)
    n = 0
    for gp, gc, gk, wp, wc, wk in zip(got.polys, got.confs, got.clses,
                                      want.polys, want.confs, want.clses):
        g = np.c_[gc, gk, np.asarray(gp).reshape(-1, 8)]
        w = np.c_[wc, wk, np.asarray(wp).reshape(-1, 8)]
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, 0], w[:, 0], atol=1e-5)
        cuts = np.flatnonzero(np.abs(np.diff(w[:, 0])) > tie) + 1
        for a, e in zip(np.r_[0, cuts], np.r_[cuts, len(w)]):
            ga = g[a:e][np.lexsort((g[a:e, 3], g[a:e, 2], g[a:e, 1]))]
            wa = w[a:e][np.lexsort((w[a:e, 3], w[a:e, 2], w[a:e, 1]))]
            np.testing.assert_array_equal(ga[:, 1], wa[:, 1])
            np.testing.assert_allclose(ga[:, 2:], wa[:, 2:], atol=1e-3)
        n += len(w)
    return n


def test_api_matches_jax_on_every_input_form(models, tmp_path, monkeypatch):
    """The input forms of the JAX package's ``test_api_input_breadth`` (a
    path, a URL, PIL, torch HWC uint8 and CHW float, gray) and a batch of
    three sizes: the same detections as the JAX ``OBBModel``, and
    ``pandas()`` equal."""
    from PIL import Image

    bgr = _scene(1)
    want = models.jax(bgr)
    assert sum(len(p) for p in want.polys) >= 10
    _same_results(models.port(bgr), want)

    p = tmp_path / "img.png"
    cv2.imwrite(str(p), bgr)
    png = p.read_bytes()

    class _Resp:
        def read(self):
            return png

    monkeypatch.setattr(urllib.request, "urlopen", lambda url: _Resp())
    chw = torch.from_numpy(bgr.transpose(2, 0, 1).astype(np.float32) / 255.0)
    for form in (str(p), p, "https://example.com/img.png?raw=1",
                 Image.fromarray(bgr[..., ::-1]), torch.from_numpy(bgr.copy()),
                 chw, bgr[..., 0]):
        got, ref = models.port(form), models.jax(form)
        _same_results(got, ref)
        assert got.paths == ref.paths
    batch = [_scene(2, 100, 150), _scene(3), _scene(4, 128, 96)]
    got, ref = models.port(batch), models.jax(batch)
    assert _same_results(got, ref) >= 10
    for g, w in zip(got.pandas(), ref.pandas()):
        assert list(g.columns) == list(w.columns)
        key = ["confidence", "class", "x1", "y1"]
        g = g.sort_values(key).reset_index(drop=True)
        w = w.sort_values(key).reset_index(drop=True)
        assert (g["class"] == w["class"]).all() and (g["name"] == w["name"]).all()
        np.testing.assert_allclose(g.drop(columns=["class", "name"]).values,
                                   w.drop(columns=["class", "name"]).values,
                                   atol=1e-3)
    assert got.rows()[0] == got.pandas()[0].to_dict(orient="records")


def test_serve_round_trip(models, monkeypatch):
    """Concurrent PNG POSTs: 200 and the API's rows for each image, batched
    by the worker; junk and a JPEG without OpenCV get 400."""
    from yolov5_obb_tpu_torch.serve import _Worker, make_handler

    worker = _Worker(models.port, max_batch=4)
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/obb-detection"

    def post(data):
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        imgs = [_scene(10 + k) for k in range(4)]
        bodies = [image_io.encode_png(im[..., ::-1], (k % 5,))
                  for k, im in enumerate(imgs)]
        replies = [None] * 8
        ts = [threading.Thread(target=lambda i=i: replies.__setitem__(
            i, post(bodies[i % 4]))) for i in range(8)]
        for x in ts:
            x.start()
        for x in ts:
            x.join(timeout=180)
        want = models.port(imgs).rows()
        for i, (status, rows) in enumerate(replies):
            assert status == 200 and len(rows) == len(want[i % 4])
            for g, w in zip(rows, want[i % 4]):
                assert g.keys() == w.keys()
                assert (g["class"], g["name"]) == (w["class"], w["name"])
                np.testing.assert_allclose(
                    [g[k] for k in g if k not in ("class", "name")],
                    [w[k] for k in w if k not in ("class", "name")],
                    atol=1e-3)
        assert sum(worker.batch_sizes) == 8 and max(worker.batch_sizes) <= 4
        with pytest.raises(urllib.error.HTTPError) as e:
            post(b"not an image")
        assert e.value.code == 400
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(urllib.error.HTTPError) as e:
            post(b"\xff\xd8\xff\xe0 a jpeg header")
        assert e.value.code == 400 and "OpenCV" in e.value.read().decode()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# streams and drawing
# ---------------------------------------------------------------------------


def test_load_streams_matches_jax(tmp_path):
    """A 6-frame video as a stream source (a stride longer than the video,
    so that the frame served stays the first): the same batches as the JAX
    ``LoadStreams``; ``is_stream_source`` agrees."""
    from yolov5_obb_tpu.data import streams as jstreams
    from yolov5_obb_tpu_torch.data import streams as pstreams

    path = tmp_path / "v.avi"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (64, 48))
    for k in range(6):
        vw.write(_scene(20 + k, 48, 64))
    vw.release()
    (tmp_path / "list.streams").write_text(f"{path}\n{path}\n")
    for src in (str(path), str(tmp_path / "list.streams")):
        got = list(pstreams.LoadStreams(src, vid_stride=100, max_frames=2))
        want = list(jstreams.LoadStreams(src, vid_stride=100, max_frames=2))
        assert len(got) == len(want) >= 1
        for (gn, gf, gfps), (wn, wf, wfps) in zip(got, want):
            assert gn == wn and gfps == wfps and len(gf) == len(wf)
            for a, b in zip(gf, wf):
                np.testing.assert_array_equal(a, b)
    for s in ("0", "rtsp://x/y", "HTTP://cam", "a.streams", "img.png", "dir"):
        assert pstreams.is_stream_source(s) == jstreams.is_stream_source(s)


def test_annotation_matches_jax(tmp_path):
    """``annotate_detections`` (labels, hidden confidences, hidden labels,
    thick lines) and ``feature_visualization`` against the JAX package's:
    the same pixels."""
    from yolov5_obb_tpu.utils import plots as jplots
    from yolov5_obb_tpu_torch.utils import plots as pplots

    rng = np.random.default_rng(5)
    polys = cv2.boxPoints(((60.0, 50.0), (50.0, 20.0), -30.0)).reshape(1, 8)
    polys = np.concatenate([polys, polys + rng.uniform(-30, 30, (5, 8))])
    confs, clses = rng.uniform(0, 1, 6), rng.integers(0, 20, 6)
    for kw in ({}, {"hide_conf": True}, {"hide_labels": True},
               {"line_width": 4}):
        a, b = _scene(30), _scene(30)
        pplots.annotate_detections(a, polys, confs, clses, DOTA_V1_NAMES,
                                   **kw)
        jplots.annotate_detections(b, polys, confs, clses, DOTA_V1_NAMES,
                                   **kw)
        np.testing.assert_array_equal(a, b)
        assert (a != _scene(30)).any()
    x = rng.normal(0, 1, (1, 12, 16, 10)).astype(np.float32)
    got = pplots.feature_visualization(torch.from_numpy(x), "m3",
                                       tmp_path / "p")
    want = jplots.feature_visualization(x, "m3", tmp_path / "j")
    assert got.name == want.name == "m3_features.png"
    np.testing.assert_array_equal(cv2.imread(str(got)), cv2.imread(str(want)))
    assert pplots.feature_visualization(x[:, :1], "m4", tmp_path) is None
