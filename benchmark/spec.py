"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the limits of its correctness numbers
(``limits/<cell>.json``), the timed loop of the traffic's kind
(``drivers/<kind>.py``) and the reader of each per-layer metric
(``metrics/<metric>.py``).  Adding a configuration, a cell or a metric adds
files; no code here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root else HERE.parent
        self.here = self.root / HERE.name
        with open(self.root / "BENCHMARK.json") as f:
            self.bench = json.load(f)

    def _json(self, *parts) -> dict:
        path = self.here.joinpath(*parts)
        with open(path) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def driver(self, kind: str):
        return importlib.import_module(f"{HERE.name}.drivers.{kind}")

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metrics: those whose ``workloads`` list it,
        or that have none."""
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The cell's per-layer metrics: those whose ``workloads`` list it,
        or, without the key, those whose ``moves`` metric the cell
        reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The ``read(obs)`` function of ``metrics/<metric>.py``."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{HERE.name}.metrics.{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
