"""The port's hyp evolution (``engine/evolve.py``, ``train --evolve``) and
W&B sweep entry point (``tools/sweep.py``) against the JAX package's: the
GA draw for draw, ``evolve`` with ``run`` replaced (the same
``evolve.csv``, byte for byte), a real ``--evolve 2`` run of the port's
CLI, and the sweep's split of ``wandb.config`` with a stub ``wandb``."""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from conftest import build_mini_dota
from test_torch_port_remat import one_torch_thread  # noqa: F401 (a fixture)
from yolov5_obb_tpu.engine import evolve as jax_evolve
from yolov5_obb_tpu_torch import train as port_train
from yolov5_obb_tpu_torch.data.dota import DOTA_V1_NAMES
from yolov5_obb_tpu_torch.engine import evolve
from yolov5_obb_tpu_torch.utils.general import load_hyp

ROOT = Path(__file__).resolve().parents[1]


def _rows(rng, n):
    """``n`` parent rows (hyp dict, fitness) over every evolved key."""
    return [({k: float(rng.uniform(lo, hi))
              for k, (_, lo, hi) in evolve.EVOLVE_META.items()},
             float(rng.uniform(0, 1))) for _ in range(n)]


@pytest.mark.parametrize("seed, n_parents", [(0, 0), (1, 1), (7, 5)])
def test_ga_matches_jax(tmp_path, seed, n_parents):
    """``mutate`` from the same generator and parents gives the same hyps,
    and the generator stands at the same draw after it; ``log_generation``
    writes the same file; ``read_population`` reads the same top rows."""
    assert evolve.EVOLVE_META == jax_evolve.EVOLVE_META
    hyp = load_hyp()
    parents = _rows(np.random.default_rng(100 + seed), n_parents) or None
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        got = evolve.mutate(hyp, rng, parents)
        want = jax_evolve.mutate(hyp, jrng, parents)
        assert got == want
        assert rng.random() == jrng.random()
    metrics = {"map50": 0.25, "map": 0.125, "mp": 0.5}
    for mod, name in ((evolve, "port"), (jax_evolve, "jax")):
        for h, fit in _rows(np.random.default_rng(seed), 7):
            mod.log_generation(tmp_path / f"{name}.csv", {**hyp, **h},
                               metrics, fit)
    text = (tmp_path / "port.csv").read_text()
    assert text == (tmp_path / "jax.csv").read_text()
    assert len(text.splitlines()) == 8
    assert (evolve.read_population(tmp_path / "port.csv", top_n=3)
            == jax_evolve.read_population(tmp_path / "jax.csv", top_n=3))
    assert evolve.read_population(tmp_path / "missing.csv") == []


def test_evolve_with_run_replaced_matches_jax(tmp_path, monkeypatch):
    """``evolve(opt)`` with ``run`` replaced by one returning fixed metrics
    (JAX tests/test_e2e.py:191-214): two generations, their metrics in the
    CSV, and the CSV the JAX package's ``evolve`` writes, byte for byte."""
    import train as jax_train

    calls = []

    def fake_run(opt, hyp_override=None, callbacks=None):
        calls.append((opt.name, opt.project, opt.nosave, hyp_override))
        return tmp_path / "fake", 0.4321, {"mp": 0.5, "mr": 0.6,
                                           "map50": 0.123, "map": 0.077}

    csvs = []
    for mod, name in ((port_train, "port"), (jax_train, "jax")):
        monkeypatch.setattr(mod, "run", fake_run)
        opt = types.SimpleNamespace(
            hyp=None, evolve=2, seed=0, exist_ok=True, nosave=False,
            project=str(tmp_path / name), name="ev", device="cpu")
        mod.evolve(opt)
        csvs.append(list((tmp_path / name).rglob("evolve.csv")))
    (port_csv,), (jax_csv,) = csvs
    assert port_csv.relative_to(tmp_path / "port") == Path("ev_evolve",
                                                           "evolve.csv")
    assert port_csv.read_text() == jax_csv.read_text()
    lines = port_csv.read_text().strip().splitlines()
    assert len(lines) == 3
    header = lines[0].split(",")
    for line in lines[1:]:
        rec = dict(zip(header, line.split(",")))
        assert float(rec["fitness"]) == pytest.approx(0.4321, abs=1e-4)
        assert float(rec["map50"]) == pytest.approx(0.123, abs=1e-4)
    port_calls, jax_calls = calls[:2], calls[2:]
    assert [c[:3] for c in port_calls] == [
        ("gen0", str(port_csv.parent), True),
        ("gen1", str(port_csv.parent), True)]
    assert [c[3] for c in port_calls] == [c[3] for c in jax_calls]


def test_evolve_two_generations_on_the_cli(tmp_path):
    """``--evolve 2`` of the port's CLI (one epoch each, ``--noval``):
    ``evolve.csv`` with a header and two rows, generation 0's hyps the
    mutation of the default hyps by the seed's generator."""
    root = build_mini_dota(tmp_path / "dota", n_images=4, n_boxes=4, seed=2)
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    port_train.main([
        "--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz", "64",
        "--batch-size", "2", "--nominal-batch", "2", "--max-labels", "16",
        "--workers", "0", "--dtype", "float32", "--device", "cpu",
        "--epochs", "1", "--noval", "--noautoanchor", "--seed", "3",
        "--project", str(tmp_path / "runs"), "--name", "ev",
        "--evolve", "2"])
    out = tmp_path / "runs" / "ev_evolve"
    lines = (out / "evolve.csv").read_text().strip().splitlines()
    assert len(lines) == 3
    header = lines[0].split(",")
    gen0 = dict(zip(header, lines[1].split(",")))
    want = evolve.mutate(load_hyp(), np.random.default_rng(3), None)
    for k in header[3:]:
        assert gen0[k] == f"{want[k]:.6g}", k
    # each generation's run reports its fitness (0 without val), not the
    # -1 the JAX CLI's --nosave leaves (ROADMAP.md queue 3)
    assert [ln.split(",")[0] for ln in lines[1:]] == ["0.00000"] * 2
    assert sorted(p.name for p in out.iterdir() if p.is_dir()) == [
        "gen0", "gen1"]
    assert not (out / "gen0" / "last").exists()  # the generations keep no
    # checkpoints


def test_nosave_keeps_the_best_fitness_and_the_patience(tmp_path):
    """``--nosave`` writes no checkpoint, yet the run's best fitness is its
    epochs' best and ``--patience`` stops it (the reference's behaviour;
    the JAX CLI returns -1 and never stops under ``--nosave``)."""
    root = build_mini_dota(tmp_path / "dota", n_images=4, n_boxes=4, seed=2)
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images\nval: images\nnc: 15\n"
                    f"names: {json.dumps(DOTA_V1_NAMES)}\n")
    from yolov5_obb_tpu_torch.utils.callbacks import Callbacks

    cb, ended = Callbacks(), []
    cb.register_action("on_train_end", "test",
                       lambda **k: ended.append(k["best_fitness"]))
    save_dir, best, _ = port_train.run(port_train.parse_opt([
        "--cfg", "yolov5n.yaml", "--data", str(data), "--imgsz", "64",
        "--batch-size", "2", "--nominal-batch", "2", "--max-labels", "16",
        "--workers", "0", "--dtype", "float32", "--device", "cpu",
        "--epochs", "4", "--patience", "1", "--nosave", "--noautoanchor",
        "--val-images", "2", "--project", str(tmp_path / "runs"),
        "--name", "ns"]), callbacks=cb)
    assert ended == [best]
    fits = [float(r.split(",")[-2]) for r in (
        save_dir / "results.csv").read_text().strip().splitlines()[1:]]
    assert best == pytest.approx(max(fits), abs=1e-6) and best >= 0.0
    # the epochs the patience allows: it stops at the first epoch that
    # does not beat the best before it
    stop = next((i for i in range(1, 4) if fits[i] <= max(fits[:i])), 3)
    assert len(fits) == stop + 1
    assert not (save_dir / "last").exists()


class _Config(dict):
    """``wandb.config`` without the private ``_items``."""


@pytest.mark.parametrize("private", [True, False],
                         ids=["_items", "mapping"])
def test_sweep_maps_wandb_config_as_jax(monkeypatch, private):
    """The port's sweep entry point and the JAX one on the same
    ``wandb.config``: the same train options (``--data``, batch size,
    epochs, image size, config, weights; ``nosave`` and ``wandb`` on) and
    the same hyp override for ``train.run``."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import sweep as jax_sweep
    import train as jax_train

    from yolov5_obb_tpu_torch.tools import sweep as port_sweep

    items = {"data": "/tmp/ds/data.yaml", "batch_size": 4, "epochs": 2,
             "imgsz": 128, "cfg": "yolov5s.yaml", "lr0": 0.02, "theta": 1.5,
             "csl_radius": 1}
    mod = types.ModuleType("wandb")
    mod.init = lambda **kw: None
    mod.config = (types.SimpleNamespace(_items=dict(items)) if private
                  else _Config(items))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    calls = []

    def fake_run(opt, hyp_override=None, callbacks=None):
        calls.append((vars(opt), hyp_override))
        return None

    monkeypatch.setattr(port_train, "run", fake_run)
    monkeypatch.setattr(jax_train, "run", fake_run)
    port_sweep.sweep()
    jax_sweep.sweep()
    (popt, phyp), (jopt, jhyp) = calls
    assert phyp == jhyp == {"lr0": 0.02, "theta": 1.5, "csl_radius": 1}
    for k in ("data", "batch_size", "epochs", "imgsz", "cfg", "weights",
              "nosave", "wandb"):
        assert popt[k] == jopt[k], k
    assert (popt["data"], popt["batch_size"], popt["epochs"], popt["imgsz"],
            popt["cfg"], popt["nosave"], popt["wandb"]) == (
        "/tmp/ds/data.yaml", 4, 2, 128, "yolov5s.yaml", True, True)
