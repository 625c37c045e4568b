"""The port's export (``.pt2``) and exported-model backend against the JAX
package's export and backend on the CPU, and the val and detect CLIs run
from a ``.pt2``: the in-repo trained yolov5n (Detect biases raised) at
128², nc 15, float32, the same weights carried across by
``from_jax_variables``, inputs from a numpy seed."""

import types

import jax
import numpy as np
import pytest
import torch
from jax import export as jexport

import export as jax_export
from test_torch_port_remat import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_port_val import val_setup  # noqa: F401 (a fixture)
from yolov5_obb_tpu.models import yolo as jyolo
from yolov5_obb_tpu.models.backend import (
    make_backend_predict_fn as jax_backend_predict_fn,
)
from yolov5_obb_tpu.utils.checkpoint import save_weights as jax_save_weights
from yolov5_obb_tpu_torch import detect as port_detect
from yolov5_obb_tpu_torch import export as port_export
from yolov5_obb_tpu_torch import val as port_val
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
from yolov5_obb_tpu_torch.models.backend import (
    MultiBackend,
    is_artifact,
    make_backend_predict_fn,
)
from yolov5_obb_tpu_torch.utils.checkpoint import save_weights
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S, NC = 128, 15
CONF, IOU, MAX_DET = 0.01, 0.4, 300


@pytest.fixture(scope="module")
def exp(tmp_path_factory, val_setup):  # noqa: F811
    """The same weights as a JAX orbax checkpoint and a port checkpoint
    directory; the port's ``.pt2`` of them and the JAX StableHLO export;
    each package's forward (the port's eager, its ``.pt2``; JAX's ``fwd``
    and its StableHLO round trip) on seeded batches of 1 and 3."""
    vs = val_setup
    root = tmp_path_factory.mktemp("export")
    jax_save_weights(root / "jw", vs.v["params"], vs.v["batch_stats"],
                     {"cfg": "yolov5n.yaml"})
    save_weights(root / "pw", from_jax_variables(vs.v, vs.port.specs),
                 {"cfg": "yolov5n.yaml", "names": DOTA_V1_NAMES})
    popt = port_export.parse_opt([
        "--weights", str(root / "pw"), "--cfg", "yolov5n.yaml", "--nc",
        str(NC), "--imgsz", str(S), "--device", "cpu", "--out",
        str(root / "out")])
    (root / "out").mkdir()
    fwd, _, _ = port_export.build_forward(popt)
    pt2 = port_export.export_pt2(fwd, popt, root / "out")

    jopt = types.SimpleNamespace(weights=str(root / "jw"), cfg="yolov5n.yaml",
                                 imgsz=S, batch_size=1, nc=NC,
                                 include=["stablehlo"], out=str(root))
    with pytest.MonkeyPatch.context() as mp:
        # the loaded weights replace the random init: skip it
        mp.setattr(jyolo, "init_model", lambda *a, **k: None)
        jfwd, _, _ = jax_export.build_forward(jopt)
    hlo = jax_export.export_stablehlo(jfwd, jopt, root)
    rehydrated = jexport.deserialize(hlo.read_bytes())

    rng = np.random.default_rng(0)
    xs = {b: rng.random((b, S, S, 3), np.float32) for b in (1, 3)}
    backend = MultiBackend(pt2, imgsz=S, device="cpu")
    out = {}
    for b, x in xs.items():
        with torch.no_grad():
            eager = fwd(torch.from_numpy(x))
        out[b] = {"pt2": backend(torch.from_numpy(x)), "eager": eager,
                  "jax": np.asarray(jax.jit(jfwd)(x)),
                  "hlo": np.asarray(rehydrated.call(x))}
    return types.SimpleNamespace(root=root, pt2=pt2, hlo=hlo, out=out,
                                 backend=backend, vs=vs)


@pytest.mark.parametrize("batch", [1, 3])
def test_pt2_matches_the_jax_export(exp, batch):
    """The ``.pt2`` at batch 1 and 3 (traced at 2: the batch is symbolic)
    against JAX ``export.build_forward``'s ``fwd`` and its StableHLO round
    trip (rtol 1e-4, atol 1e-4; measured max |Δ| 1.8e-4 on outputs up to
    473, the box sizes), and bit for bit the port's eager forward."""
    o = exp.out[batch]
    got = o["pt2"].numpy()
    assert got.shape == (batch, 3 * (16 * 16 + 8 * 8 + 4 * 4), NC + 185)
    np.testing.assert_allclose(got, o["jax"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, o["hlo"], rtol=1e-4, atol=1e-4)
    assert torch.equal(o["pt2"], o["eager"])


def _eval_batch(vs):
    ds = DotaDataset(vs.root / "images", DOTA_V1_NAMES, img_size=S)
    return np.stack([ds.get_eval_sample(i)["image"] for i in range(len(ds))])


def test_backend_detections_match_jax(exp):
    """``make_backend_predict_fn`` on the ``.pt2`` against the JAX one on
    its StableHLO export, on the mini DOTA images (multi-label, conf 0.01,
    IoU 0.4): the same count, order and class ids per image, boxes within
    1e-3 px (measured 2.3e-5), scores within 1e-5 (measured 6.3e-7);
    ``MultiBackend`` on the ``.pt2`` equals
    ``MultiBackend`` on the checkpoint directory it was exported from."""
    imgs = _eval_batch(exp.vs)
    predict, names = make_backend_predict_fn(exp.pt2, "yolov5n.yaml", NC, S,
                                             CONF, IOU, MAX_DET, device="cpu")
    assert names == DOTA_V1_NAMES and not predict.packed_stem
    dets, num = (t.numpy() for t in predict(torch.from_numpy(imgs)))
    jpredict, _ = jax_backend_predict_fn(exp.hlo, "yolov5n.yaml", NC, S, CONF,
                                         IOU, MAX_DET)
    jd, jn = (np.asarray(t) for t in jpredict(None, imgs))
    np.testing.assert_array_equal(num, jn)
    assert jn.min() > 20
    for b in range(len(imgs)):
        g, w = dets[b, :jn[b]], jd[b, :jn[b]]
        np.testing.assert_array_equal(g[:, 6], w[:, 6])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3)
        np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-5)
        assert not dets[b, jn[b]:].any()

    ckpt = MultiBackend(exp.root / "pw", cfg="yolov5n.yaml", nc=NC, imgsz=S,
                        device="cpu")
    assert ckpt.kind == "weights" and exp.backend.kind == "pt2"
    x = torch.from_numpy(imgs).float() / 255.0
    assert torch.equal(ckpt(x), exp.backend(x))


def _val(vs, tmp_path, weights, *extra):
    return port_val.run(port_val.parse_opt([
        "--weights", str(weights), "--cfg", "yolov5n.yaml", "--data",
        str(vs.data), "--imgsz", str(S), "--batch-size", "2", "--device",
        "cpu", "--max-det", str(MAX_DET), "--no-plots", "--project",
        str(tmp_path), "--exist-ok", *extra]))


def test_val_speed_task_with_artifact(exp, tmp_path):
    """``val --task speed`` from a ``.pt2`` with ``--conf-thres`` left
    unset: the threshold is resolved before the exported model's predict
    is built (JAX tests/test_export.py:154-190)."""
    res = _val(exp.vs, tmp_path, exp.pt2, "--task", "speed", "--name", "s")
    assert res["speed_ms_per_img"] > 0


def test_val_from_pt2_matches_the_checkpoint(exp, tmp_path):
    """The val CLI from the ``.pt2`` gives the checkpoint directory's
    metrics (within 1e-4) and the same JSON rows."""
    import json

    got = _val(exp.vs, tmp_path, exp.pt2, "--name", "a", "--save-json")
    want = _val(exp.vs, tmp_path, exp.root / "pw", "--name", "b",
                "--save-json")
    assert want["map50"] > 0.3
    for k in ("mp", "mr", "map50", "map"):
        assert abs(got[k] - want[k]) <= 1e-4, k
    rows = [json.loads((tmp_path / n / "best_obb_predictions.json")
                       .read_text()) for n in "ab"]
    assert rows[0] == rows[1] and len(rows[0]) > 50


def test_detect_from_pt2_writes_the_checkpoint_labels(exp, tmp_path):
    """The detect CLI from the ``.pt2`` with ``--classes`` (kept on the host
    after the NMS) writes the checkpoint run's label files."""
    common = ["--cfg", "yolov5n.yaml", "--data", str(exp.vs.data),
              "--source", str(exp.vs.root / "images"), "--imgsz", str(S),
              "--conf-thres", "0.05", "--classes", "0", "4", "9",
              "--save-txt", "--save-conf", "--nosave", "--device", "cpu",
              "--project", str(tmp_path), "--exist-ok"]
    a = port_detect.main(["--weights", str(exp.pt2), "--name", "a", *common])
    b = port_detect.main(["--weights", str(exp.root / "pw"), "--name", "b",
                          *common])
    files = sorted(p.name for p in (b / "labels").iterdir())
    assert files == sorted(p.name for p in (a / "labels").iterdir())
    texts = [(b / "labels" / f).read_text() for f in files]
    assert texts == [(a / "labels" / f).read_text() for f in files]
    classes = {line.split()[0] for t in texts for line in t.splitlines()}
    assert classes and classes <= {"0", "4", "9"}


def test_exported_models_refused_where_they_cannot_serve(exp, tmp_path):
    """``--rect-pad`` and ``--augment`` with a ``.pt2``, a ``.pt2`` in an
    ensemble, another image size, and the JAX package's formats (as
    ``--weights``, in ``MultiBackend`` and in ``--include``) raise."""
    vs = exp.vs
    with pytest.raises(ValueError, match="rect-pad"):
        _val(vs, tmp_path, exp.pt2, "--rect-pad", "0.5")
    with pytest.raises(ValueError, match="TTA"):
        _val(vs, tmp_path, exp.pt2, "--augment")
    with pytest.raises(ValueError, match="ensemble"):
        _val(vs, tmp_path, f"{exp.pt2},{exp.root / 'pw'}")
    with pytest.raises(ValueError, match="TTA"):
        port_detect.main(["--weights", str(exp.pt2), "--data", str(vs.data),
                          "--source", str(vs.root / "images"), "--imgsz",
                          str(S), "--augment", "--device", "cpu",
                          "--project", str(tmp_path)])
    with pytest.raises(ValueError, match="exported at 128"):
        MultiBackend(exp.pt2, imgsz=256, device="cpu")
    assert is_artifact(exp.hlo) and is_artifact(exp.pt2)
    with pytest.raises(ValueError, match="JAX package"):
        _val(vs, tmp_path, exp.hlo)
    with pytest.raises(ValueError, match="JAX package"):
        port_detect.main(["--weights", str(exp.hlo), "--data", str(vs.data),
                          "--source", str(vs.root / "images"), "--device",
                          "cpu", "--project", str(tmp_path)])
    with pytest.raises(ValueError, match="JAX package"):
        MultiBackend(exp.hlo, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        port_export.main(["--include", "pt2", "stablehlo", "--device", "cpu",
                          "--out", str(tmp_path / "x")])
