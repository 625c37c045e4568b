"""``evaluate(mesh=)`` and the val CLI's ``--mesh`` on the CPU: two gloo
processes (tests/torch_port_dp_worker.py under torchrun's environment) at
global batch 4 against one process at batch 2, a world of one against no
mesh, and the batches a mesh cannot split.  The in-repo trained yolov5n
(Detect biases raised) at 128², float32, on the mini DOTA set labelled by
its own detections."""

import json
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_port_distributed import _launch
from test_torch_port_remat import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_port_val import val_setup  # noqa: F401 (a fixture)
from yolov5_obb_tpu_torch import val as port_val
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES, DotaDataset
from yolov5_obb_tpu_torch.engine.evaluator import evaluate
from yolov5_obb_tpu_torch.utils.checkpoint import save_weights
from yolov5_obb_tpu_torch.utils.weights import from_jax_variables

S = 128
METRICS = ("mp", "mr", "map50", "map")


@pytest.fixture(scope="module")
def mesh_setup(tmp_path_factory, val_setup):  # noqa: F811
    vs = val_setup
    root = tmp_path_factory.mktemp("val_mesh")
    save_weights(root / "w", from_jax_variables(vs.v, vs.port.specs),
                 {"cfg": "yolov5n.yaml", "names": DOTA_V1_NAMES})
    return types.SimpleNamespace(root=root, vs=vs)


def _argv(ms, out, name, batch, *extra):
    return ["--weights", str(ms.root / "w"), "--cfg", "yolov5n.yaml",
            "--data", str(ms.vs.data), "--imgsz", str(S), "--batch-size",
            str(batch), "--device", "cpu", "--save-json", "--save-task1",
            "--no-plots", "--project", str(out), "--name", name,
            "--exist-ok", *extra]


def _same_result(got, want):
    """The same metrics and per-image detections, bit for bit."""
    for k in METRICS:
        assert got[k] == want[k], k
    assert len(got["detections"]) == len(want["detections"]) == 4
    for g, w in zip(got["detections"], want["detections"]):
        assert g["path"] == w["path"] and g["hw"] == w["hw"]
        for k in ("polys", "conf", "cls"):
            assert np.array_equal(g[k], w[k]), k


def test_two_processes_equal_one_process(mesh_setup, tmp_path):
    """``--mesh 2`` in two gloo processes at global batch 4 (rank r
    loads, predicts and matches rows [2r, 2r + 2)) against one process at
    batch 2: the same per-image detections and metrics on both ranks, bit
    for bit; rank 0 alone writes the JSON rows (equal to the one
    process's) and the Task1 files."""
    ms = mesh_setup
    want = port_val.run(port_val.parse_opt(_argv(ms, tmp_path, "one", 2)))
    assert want["map50"] > 0.3
    argv = _argv(ms, tmp_path, "mesh", 4, "--mesh", "2")
    _launch(lambda rank: ["val", str(tmp_path), "--", *argv])
    for rank in range(2):
        got = torch.load(tmp_path / f"val{rank}.pt", weights_only=False)
        assert got["predict_rows"] == [2, 2]  # the warm-up, the batch
        # a rank loads (and matches) only its own images
        assert got["loaded"] == [2 * rank, 2 * rank + 1] * 2
        _same_result(got, want)
    rows = [json.loads((tmp_path / n / "best_obb_predictions.json")
                       .read_text()) for n in ("mesh", "one")]
    assert rows[0] == rows[1] and len(rows[0]) > 50
    task1 = {n: {f.name: f.read_text() for f in
                 (tmp_path / n / "task1_raw").iterdir()}
             for n in ("mesh", "one")}
    assert task1["mesh"] == task1["one"] and len(task1["one"]) == 15


def test_mesh_of_one_equals_no_mesh(mesh_setup, tmp_path):
    """``--mesh 1`` in a gloo world of one (the group made here, as
    torchrun's would be) and in one process without a group: the run
    without a mesh, bit for bit."""
    ms = mesh_setup
    want = port_val.run(port_val.parse_opt(_argv(ms, tmp_path, "a", 2)))
    _same_result(port_val.run(port_val.parse_opt(
        _argv(ms, tmp_path, "b", 2, "--mesh", "1"))), want)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        got = port_val.run(port_val.parse_opt(
            _argv(ms, tmp_path, "c", 2, "--mesh", "1")))
    finally:
        dist.destroy_process_group()
    _same_result(got, want)


def test_mesh_refuses_what_it_cannot_split(mesh_setup, tmp_path):
    """A batch the mesh's processes do not divide, and a ``--mesh`` that is
    not the world's size, raise before any prediction."""
    ms = mesh_setup
    ds = DotaDataset(ms.vs.root / "images", DOTA_V1_NAMES, img_size=S)
    with pytest.raises(ValueError, match="not divisible"):
        evaluate(ms.vs.port, ms.vs.meta, ds, batch_size=3,
                 mesh=types.SimpleNamespace(world=2, rank=0))
    with pytest.raises(ValueError, match="needs 2 processes"):
        port_val.run(port_val.parse_opt(
            _argv(ms, tmp_path, "x", 4, "--mesh", "2")))
