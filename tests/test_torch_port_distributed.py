"""The port's data-parallel training (``engine/distributed.py``,
``make_train_step(mesh=...)``, the train CLI under torchrun's environment)
on the CPU through gloo:

- the single-process helpers;
- a world of one: the mesh step equals the step without one bit for bit;
- a real two-process run of the step (tests/torch_port_dp_worker.py, which
  imports nothing of JAX): three steps, each rank on its strided half of
  a seeded global batch, against the one-process step on the whole batch
  and against the JAX package's single-device step (rtol/atol 2e-4, the
  JAX multi-host test's bar); parameters identical across the ranks;
- a two-process run of the train CLI on an image count that leaves a
  remainder: only rank 0 writes, both ranks take the one-process step
  count and end with the same parameters (and the loader's shards take
  equal steps); ``--evolve 2`` in two processes: one evolve directory,
  the same hyps and parameters on both ranks.  Their losses are not
  compared with a one-process run: the in-process loader augments with
  one generator in order, so a rank's samples differ from the
  one-process run's (as in the JAX package).
"""

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import build_mini_dota
from test_torch_port_remat import (  # noqa: F401 (a fixture)
    jax_packed_model,
    jax_steps,
    one_torch_thread,
    seeded_batches,
)
from torch_port_dp_worker import run_steps
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.engine import distributed as D
from yolov5_obb_tpu_torch.engine.trainer import make_train_step, put_batch
from yolov5_obb_tpu_torch.models import layers, step_context

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_port_dp_worker.py"
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, world=2):
    """``world`` workers under torchrun's environment, one torch thread
    each; waits (with a limit) and returns their logs."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "WORLD_SIZE": str(world), "RANK": str(rank),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), *args(rank)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return logs


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def test_single_process_helpers(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not D.maybe_initialize("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not D.maybe_initialize("cpu") and not dist.is_initialized()
    assert D.is_main() and D.process_count() == 1 and D.process_index() == 0
    assert D.local_batch_size(16) == 16
    assert D.broadcast_scalar(np.float32(0.5)) == 0.5
    box = object()
    assert D.broadcast_object(box) is box
    D.barrier()
    with D.main_first():
        pass
    D.shutdown()
    cpu = torch.device("cpu")
    assert D.local_device(cpu) == cpu
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert D.local_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert D.local_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    assert step_context.mesh() is None and step_context.remat() is None
    batch = (torch.arange(6), torch.arange(12).reshape(6, 2))
    assert all(a is b for a, b in zip(put_batch(batch), batch))


def test_local_batch_must_divide(monkeypatch):
    monkeypatch.setattr(D, "process_count", lambda: 4)
    assert D.local_batch_size(16) == 4
    with pytest.raises(ValueError, match="not divisible by 4"):
        D.local_batch_size(18)


def test_mesh_needs_a_process_group():
    from yolov5_obb_tpu_torch.engine.loss import ComputeLoss
    from yolov5_obb_tpu_torch.engine.optim import build_optimizer
    from yolov5_obb_tpu_torch.models.yolo import create_model

    with pytest.raises(RuntimeError, match="needs a process group"):
        D.make_mesh()
    model, meta = create_model("yolov5n.yaml", nc=15, device="cpu")
    opt, _ = build_optimizer(model, {}, 1, 1, 2, 2)
    with pytest.raises(TypeError, match="DataMesh"):
        make_train_step(model, ComputeLoss(meta), opt, device="cpu",
                        mesh=object())
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, ComputeLoss(meta), opt, device="cpu",
                        remat="some")


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one, left when the test ends."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield D.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fused, remat", [
    (False, False), (True, False), (False, "full"), (True, "selective")],
    ids=["stock", "fused", "full_remat", "fused_selective"])
def test_world_of_one_is_the_step_bit_for_bit(world_of_one, monkeypatch,
                                              fused, remat):
    """Every collective of the mesh step is the identity on one rank; so is
    the step: losses, items, parameters, statistics and EMA bit for bit."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    sd = jax_weights()[3]
    batches = seeded_batches(4)
    assert D.maybe_initialize("cpu") is False  # joined: world_size 1
    got = run_steps(sd, batches, mesh=world_of_one, remat=remat, fused=fused)
    ref = run_steps(sd, batches, remat=remat, fused=fused)
    assert got["items"] == ref["items"] and got["loss"] == ref["loss"]
    for key in ("state", "ema"):
        for k, t in ref[key].items():
            assert torch.equal(got[key][k], t), (key, k)
    assert put_batch(batches[0], world_of_one)[0].shape[0] == 4


# ---------------------------------------------------------------------------
# two processes: the step
# ---------------------------------------------------------------------------

_WEIGHTS = []


def jax_weights():
    """The JAX model and its seeded weights (built once a process)."""
    if not _WEIGHTS:
        _WEIGHTS.append(jax_packed_model())
    return _WEIGHTS[0]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Three steps of the 2-process gloo run (global batch 4, 2 rows a
    rank): stock, fused, and stock under full remat (whose recompute runs
    the statistics' all-reduces again inside the backward) → ({name:
    per-rank outputs}, batches)."""
    tmp = tmp_path_factory.mktemp("dp_step")
    sd = jax_weights()[3]
    batches = seeded_batches(4)
    out = {}
    for name, fused, remat in (("stock", False, False),
                               ("fused", True, False),
                               ("full_remat", False, "full")):
        src = tmp / f"{name}_in.pt"
        torch.save({"state": sd, "batches": batches, "fused": fused,
                    "remat": remat}, src)
        _launch(lambda r: ["step", str(src), str(tmp / f"{name}{r}.pt")])
        out[name] = [torch.load(tmp / f"{name}{r}.pt") for r in range(2)]
    return out, batches


@pytest.mark.parametrize("name", ["stock", "full_remat"])
def test_two_ranks_equal_one_process(two_ranks, monkeypatch, name):
    """Each rank's loss and items are the global batch's; the parameters,
    statistics and EMA after three steps are the one-process step's on the
    whole batch (rtol/atol 2e-4); under full remat too."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    ranks, batches = two_ranks
    one = run_steps(jax_weights()[3], batches)
    for r in ranks[name]:
        assert r["world"] == 2
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["items"], one["items"], rtol=2e-4,
                                   atol=2e-4)
        for key in ("state", "ema"):
            for k, t in one[key].items():
                np.testing.assert_allclose(
                    r[key][k].double().numpy(), t.double().numpy(),
                    rtol=2e-4, atol=2e-4, err_msg=f"{key} {k}")


def _cos(a, b) -> float:
    a, b = a.double(), b.double()
    return float(a @ b / (a.norm() * b.norm()))


def test_two_ranks_fused_region_within_its_noise(two_ranks, monkeypatch):
    """The fused train region's passes carry bf16 activations, whose
    rounding the summed statistics move: after an update the run is held,
    as phase (d) of chip_smoke.py holds a bf16 step, to a control — the
    one-process step with the stem weights scaled by 1 + 2^-8, one bf16 ulp.
    The first step's items (no update yet) within 2e-4 of the one-process
    step's; then the loss items no further from it than the control's and
    the three steps' parameter moves no less aligned with its moves."""
    monkeypatch.setattr(layers, "FUSED_DOWN_MIN_SPATIAL", 0)
    ranks, batches = two_ranks
    sd = jax_weights()[3]
    one = run_steps(sd, batches, fused=True)
    stem = "model.0.conv.weight"
    ctl = run_steps({**sd, stem: sd[stem] * (1 + 2.0**-8)}, batches,
                    fused=True)
    names = [k for k in sd if "running" not in k and "num_batches" not in k]

    def moves(out):
        return torch.cat([(out["state"][k] - sd[k]).flatten()
                          for k in names])

    def items_err(out):
        return np.abs(np.asarray(out["items"]) / np.asarray(one["items"])
                      - 1).max()

    for r in ranks["fused"]:
        np.testing.assert_allclose(r["items"][0], one["items"][0],
                                   rtol=2e-4, atol=2e-4)
        assert items_err(r) <= items_err(ctl)
        assert _cos(moves(r), moves(one)) >= _cos(moves(ctl), moves(one))


def test_two_ranks_match_the_jax_step(two_ranks):
    """The 2-process run against the JAX package's single-device step on
    the same global batches and weights: loss items (rtol/atol 2e-4)."""
    ranks, batches = two_ranks
    model, meta, v, _ = jax_weights()
    jitems, _ = jax_steps(model, meta, v, batches)
    for r in ranks["stock"]:
        np.testing.assert_allclose(r["items"], np.stack(jitems), rtol=2e-4,
                                   atol=2e-4)


def test_two_ranks_hold_the_same_parameters(two_ranks):
    """Gradients, statistics and updates are the same on both ranks: the
    parameters, statistics and EMA bit for bit; ``broadcast_scalar`` gives
    rank 0's value on both."""
    ranks, _ = two_ranks
    for a, b in ranks.values():
        for key in ("state", "ema"):
            assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
        assert a["items"] == b["items"] and a["loss"] == b["loss"]
        assert a["broadcast"] == b["broadcast"] == 0.25


# ---------------------------------------------------------------------------
# two processes: the train CLI
# ---------------------------------------------------------------------------


def _mini_data(root, n_images):
    root = build_mini_dota(root, n_images=n_images, n_boxes=5, seed=5)
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    return data


def _cli_argv(data, project, name, batch):
    return ["--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz", "64",
            "--batch-size", str(batch), "--nominal-batch", str(batch),
            "--max-labels", "16", "--workers", "0", "--dtype", "float32",
            "--device", "cpu", "--epochs", "1", "--noautoanchor",
            "--project", str(project), "--name", name]


def _records(tmp):
    return [json.loads((tmp / f"record{r}.json").read_text())
            for r in range(2)]


# an odd image count: 15 // 8 = 1 step for one process; a shard of 8 rows
# would make rank 0 take a second step that rank 1 never matches
CLI_IMAGES, CLI_BATCH = 15, 8


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One epoch of the train CLI in two processes (gloo, from torchrun's
    environment): yolov5n 64², global batch 8 (4 rows a rank), 15 images,
    val on rank 0."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    argv = _cli_argv(_mini_data(tmp / "dota", CLI_IMAGES), tmp / "runs",
                     "dp", CLI_BATCH) + ["--val-images", "2"]
    logs = _launch(lambda r: ["cli", str(tmp), "--", *argv])
    return types.SimpleNamespace(tmp=tmp, logs=logs)


def test_two_process_cli_writes_on_rank_0_only(cli_run):
    runs = sorted(p.name for p in (cli_run.tmp / "runs").iterdir())
    assert runs == ["dp"]  # rank 1 took rank 0's run directory
    run = cli_run.tmp / "runs" / "dp"
    rows = (run / "results.csv").read_text().strip().splitlines()
    assert len(rows) == 2  # the header and the epoch's row, once
    assert (run / "last" / "meta.json").exists()
    assert (run / "best" / "meta.json").exists()
    writes = [r["writes"] for r in _records(cli_run.tmp)]
    assert writes[1] == [] and sorted(set(writes[0])) == [
        "save_checkpoint", "save_weights"]
    assert all("rank 1 of 2" in log or "rank 0 of 2" in log
               for log in cli_run.logs)


def test_two_process_cli_ranks_end_equal(cli_run):
    a, b = (torch.load(cli_run.tmp / f"rank{r}.pt") for r in range(2))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_two_process_cli_takes_the_one_process_step_count(cli_run):
    """Both ranks take the one-process run's ``images // batch`` steps on
    an image count that leaves a remainder."""
    assert [r["steps"] for r in _records(cli_run.tmp)] == [
        CLI_IMAGES // CLI_BATCH] * 2


class _Indexed:
    """A dataset whose samples carry their index alone."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get_eval_sample(self, i):
        z = np.zeros(1, np.float32)
        return {"image": z, "targets": z, "target_mask": z,
                "index": np.int64(i)}


@pytest.mark.parametrize("n, batch, world", [
    (15, 4, 2), (17, 2, 4), (8, 2, 2), (5, 4, 2)])
def test_loader_shards_take_the_same_steps(n, batch, world):
    """Every shard yields ``n // (batch * world)`` batches (the
    one-process run's steps), and the shards' samples are distinct."""
    from yolov5_obb_tpu_torch.data.loader import create_dataloader

    shards = [[b.index.tolist() for b in create_dataloader(
        _Indexed(n), batch, augment=False, seed=3, num_epochs=1,
        shard_index=r, shard_count=world)] for r in range(world)]
    steps = n // (batch * world)
    assert [len(s) for s in shards] == [steps] * world
    seen = [i for s in shards for b in s for i in b]
    assert len(seen) == len(set(seen)) == steps * batch * world


@pytest.fixture(scope="module")
def evolve_run(tmp_path_factory):
    """``--evolve 2`` of the train CLI in two processes: yolov5n 64², global
    batch 4, 8 images, one epoch a generation, no val."""
    tmp = tmp_path_factory.mktemp("dp_evolve")
    argv = _cli_argv(_mini_data(tmp / "dota", 8), tmp / "runs", "ev",
                     4) + ["--noval", "--evolve", "2", "--seed", "3"]
    _launch(lambda r: ["cli", str(tmp), "--", *argv])
    return tmp


def test_two_process_evolve_shares_its_hyps(evolve_run):
    """Rank 0 names the evolve directory and draws each generation's hyps;
    both ranks train with them, end with the same parameters, and rank 0
    alone logs a row a generation."""
    assert sorted(p.name for p in (evolve_run / "runs").iterdir()) == [
        "ev_evolve"]
    rows = (evolve_run / "runs" / "ev_evolve" / "evolve.csv").read_text(
        ).strip().splitlines()
    assert len(rows) == 3
    a, b = _records(evolve_run)
    assert len(a["hyps"]) == 2 and a["hyps"] == b["hyps"]
    assert a["hyps"][0] != a["hyps"][1]
    sa, sb = (torch.load(evolve_run / f"rank{r}.pt") for r in range(2))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
