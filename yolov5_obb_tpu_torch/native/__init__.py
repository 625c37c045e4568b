"""Exact polygon geometry in C++ (``polyiou.cpp``), built with ``g++`` at
first use and bound with ``ctypes``.

Counterpart of the JAX package's ``native/__init__.py`` (:25-107): the same
source and flags, so the same bits.  The library builds into
``yolov5_obb_tpu_torch/build/polyiou-<hash>.so``, the hash covering the
source and the flags (as ``ops/kernels/_build.py`` keys the CUDA kernels), so
an edited source is rebuilt and a stale library is never loaded.

``get_lib()`` returns the loaded library, or None when no ``g++`` is present
or the build fails (``BUILD_ERROR`` then says why); the callers
(``devkit/evaluate.py``, ``devkit/result_merge.py``) fall back to NumPy, as
the JAX package does.  A caller that must not fall back checks ``get_lib()``
itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "polyiou.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False
BUILD_ERROR: str | None = None


def so_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"polyiou-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr}")
    os.replace(tmp, out)


def get_lib():
    """The loaded library (built first if needed), or None."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = so_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            BUILD_ERROR = str(e)
            return None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        lib.iou_poly.restype = ctypes.c_double
        lib.iou_poly.argtypes = [f64, f64]
        lib.poly_overlaps.restype = None
        lib.poly_overlaps.argtypes = [f64, ctypes.c_int64, f64,
                                      ctypes.c_int64, f64]
        lib.poly_nms.restype = ctypes.c_int64
        lib.poly_nms.argtypes = [
            f64, f64, np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_int64, ctypes.c_double,
            np.ctypeslib.ndpointer(np.uint8, flags="C")]
        _lib = lib
        return _lib


def iou_poly_native(p1, p2) -> float | None:
    """IoU of two flat ``[x1 y1 ... y4]`` quads, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    return float(lib.iou_poly(
        np.ascontiguousarray(p1, np.float64).reshape(8),
        np.ascontiguousarray(p2, np.float64).reshape(8)))


def poly_overlaps_native(polys1, polys2):
    """``(n, 8) x (m, 8)`` → the ``(n, m)`` float64 IoU matrix, or None."""
    lib = get_lib()
    if lib is None:
        return None
    p1 = np.ascontiguousarray(polys1, np.float64).reshape(-1, 8)
    p2 = np.ascontiguousarray(polys2, np.float64).reshape(-1, 8)
    out = np.empty((len(p1), len(p2)), np.float64)
    lib.poly_overlaps(p1, len(p1), p2, len(p2), out)
    return out


def poly_nms_native(polys, scores, thresh: float):
    """Greedy polygon NMS: the kept indices in score order, or None.  The
    order is ``np.argsort(-scores)`` (quicksort), whose tie-breaking the
    merged files depend on."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(polys, np.float64).reshape(-1, 8)
    s = np.ascontiguousarray(scores, np.float64)
    order = np.argsort(-s).astype(np.int64)
    keep = np.zeros(len(p), np.uint8)
    lib.poly_nms(p, s, order, len(p), float(thresh), keep)
    return [int(i) for i in order if keep[i]]
