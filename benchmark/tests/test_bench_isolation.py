"""What the benchmark may import: nothing under ``benchmark/`` imports JAX,
jaxlib, flax or the JAX package (``yolov5_obb_tpu``), compared by whole
top-level names, so ``yolov5_obb_tpu_torch`` (the port, which the harness
drives) does not match; nothing under ``benchmark/reference/`` imports the
port or any other module of the benchmark but the reference's own."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from .conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "yolov5_obb_tpu"}


def _imports(path):
    """``(top-level name, level)`` of every import in ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    names = {n for n, level in _imports(path) if level == 0}
    assert not names & FORBIDDEN, names & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        if level:  # relative: the reference's own modules only
            assert level == 1, name
        else:
            assert name in {"__future__", "math", "numpy", "torch"}, name


def test_whole_names():
    assert "yolov5_obb_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax(tiny_root):
    """A whole run at test size, in a fresh process, leaves no JAX module
    loaded (the harness refuses to print a result otherwise)."""
    code = ("import io, sys; from benchmark.run import run, parse, "
            "forbidden_modules; out = io.StringIO(); rc = run(parse(["
            "'--workload', 'tiny.infer', '--seed', '3', '--seconds', '1']),"
            " allow_cpu=True, out=out); print(rc, forbidden_modules(), "
            "sorted(m for m in sys.modules if m.split('.')[0] == "
            "'yolov5_obb_tpu_torch')[:1])")
    res = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{tiny_root}:{REPO}",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == \
        "0 [] ['yolov5_obb_tpu_torch']"
