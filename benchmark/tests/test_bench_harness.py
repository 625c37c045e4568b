"""The harness on the CPU at test sizes: it finds every cell, configuration,
traffic, limit and reader by name; a cell added as files runs with no code
edit; the last line has the contract's keys; planted faults turn
``correct`` false and the fp8 control fails the limits."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import pytest

from benchmark import faults
from benchmark.run import parse, run
from benchmark.spec import Spec

from .conftest import REPO, write_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace=0, seed=3000000007, seconds=1.0):
    out = io.StringIO()
    rc = run(parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)]), root=root,
             allow_cpu=True, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_every_name_resolves():
    spec = Spec(REPO)
    for cell in spec.bench["workloads"]:
        config = spec.config(cell["config"])
        traffic = spec.traffic(cell["traffic"])
        assert set(spec.limits(cell["name"]))
        assert hasattr(spec.driver(traffic["driver"]), "window")
        assert config["model"]["nc"] == config["nc"]
        e2e = {m["name"] for m in spec.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.per_layer(cell["name"])
        assert layer
        for m in layer:
            assert callable(spec.reader(m["name"]))
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell,trace", [("tiny.infer", 0), ("tiny.infer", 1),
                                        ("tiny.train", 0), ("tiny.train", 1)])
def test_last_line(tiny_root, cell, trace):
    line = _run(tiny_root, cell, trace)
    keys = list(line)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert set(keys) - set(KEYS) - {"checks"} == (
        {"breakdown"} if trace else set())
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "cpu"
    spec = Spec(tiny_root)
    if trace:
        # a CPU run gives no device metric: only the host spans
        assert set(line["metrics"]) <= {"forward_ms.infer",
                                        "postproc_ms.infer"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in
                                        spec.end_to_end(cell)}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell,fault", [
    ("tiny.infer", "half_batch"), ("tiny.infer", "altered_answer"),
    ("tiny.train", "half_batch"), ("tiny.train", "unchanged_state")])
def test_fault_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        line = _run(tiny_root, cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["tiny.infer", "tiny.train"])
def test_control_fails_the_limits(tiny_root, cell):
    """The reference in fp8 in the program's place comes out not correct
    by the cell's limits."""
    import types

    import torch

    from benchmark.device import Device
    from benchmark.reference.lowp import Rounding
    from benchmark.run import judge

    spec = Spec(tiny_root)
    c = spec.cell(cell)
    traffic = spec.traffic(c["traffic"])
    driver = spec.driver(traffic["driver"])
    ctx = types.SimpleNamespace(seed=3000000009, config=spec.config(
        c["config"]), traffic=traffic, cell=c,
        device=Device(torch.device("cpu")))
    st = driver.setup(ctx)
    driver.window(st, 0.5)
    driver.release(st)
    assert judge(driver.check(st), spec.limits(cell))[0]
    assert not judge(driver.check(st, control=Rounding()),
                     spec.limits(cell))[0]


def test_added_cell_runs_without_code_edit(tiny_root):
    """A configuration, traffic and cell added as files alone run in a
    fresh process from the copy."""
    cfg = json.loads((tiny_root / "benchmark/configs/tiny-256.json")
                     .read_text())
    cfg.update(name="tiny-192", imgsz=192)
    traffic = json.loads((tiny_root / "benchmark/traffic/tiny.infer.json")
                         .read_text())
    traffic.update(conf=0.2, density=10)
    write_cell(tiny_root, "tiny.added", cfg, traffic,
               {"maps_rel_err": 0.2, "det_unmatched": 0.02,
                "missing_batches": 0})
    code = ("import sys, io; from benchmark.run import run, parse; "
            "sys.exit(run(parse(['--workload', 'tiny.added', '--seed', "
            "'5', '--seconds', '1']), allow_cpu=True))")
    res = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": str(tiny_root) + ":" + str(REPO),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0


def test_refuses_without_a_card(tiny_root):
    """Without a CUDA device a run exits non-zero and prints nothing."""
    out = io.StringIO()
    rc = run(parse(["--workload", "tiny.infer", "--seed", "1",
                    "--seconds", "1"]), root=tiny_root, out=out)
    assert rc != 0 and out.getvalue() == ""


def test_refuses_in_a_bare_checkout(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files (no program), a run fails and prints no result."""
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "m.infer.b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_idle_gaps_named_by_innermost_host_operation():
    """Each idle gap goes to the shortest host operation covering its
    middle, the same as a search of every operation for every gap."""
    import random

    from benchmark.trace import Trace

    def by_search(tr):
        out = {}
        for a, b in tr.gaps():
            mid = (a + b) / 2
            cover = [h for h in tr.host if h[1] <= mid <= h[2]]
            name = min(cover, key=lambda h: h[2] - h[1])[0] if cover \
                else "(host outside any recorded operation)"
            out[name] = out.get(name, 0.0) + b - a
        return out

    tr = Trace([("k", 1.0, 2.0), ("k", 3.0, 4.0)],
               [("step", 0.0, 5.0), ("sync", 2.2, 2.9), ("late", 4.8, 4.9)],
               5.0, 1)
    # gaps 0-1, 2-3, 4-5: middles 0.5 (step), 2.5 (sync), 4.5 (step)
    assert tr.idle_by_host_op() == {"step": 2.0, "sync": 1.0}
    for seed in range(20):
        r = random.Random(seed)
        dev = sorted((("k", t, t + r.random() * 0.01) for t in
                      (r.random() * 3 for _ in range(200))),
                     key=lambda e: e[1])
        host = [(f"h{r.randrange(20)}", t, t + r.random() * 0.3)
                for t in (r.random() * 3 for _ in range(300))]
        tr = Trace(dev, host, 3.2, 1)
        want, got = by_search(tr), tr.idle_by_host_op()
        assert want.keys() == got.keys()
        assert all(abs(want[k] - got[k]) < 1e-12 for k in want)
