"""Native C++ helpers, each built with ``g++`` at first use and bound with
``ctypes``:

* ``polyiou.cpp``: exact polygon geometry, the counterpart of the JAX
  package's ``native/__init__.py`` (:25-107): the same source and flags, so
  the same bits;
* ``min_area_rect.cpp``: ``cv2.boxPoints(cv2.minAreaRect(points))`` as
  OpenCV 5.0 computes it, float32 for float32 (``-ffp-contract=off``);
* ``png_filter.cpp``: PNG scanline unfiltering for ``utils/image_io.py``.

Each library builds into ``yolov5_obb_tpu_torch/build/<name>-<hash>.so``,
the hash covering the source and the flags (as ``ops/kernels/_build.py``
keys the CUDA kernels), so an edited source is rebuilt and a stale library
is never loaded.

``get_lib()`` returns the loaded polygon library, or None when no ``g++``
is present or the build fails (``BUILD_ERROR`` then says why); the callers
(``devkit/evaluate.py``, ``devkit/result_merge.py``) fall back to NumPy, as
the JAX package does.  A caller that must not fall back checks ``get_lib()``
itself.  ``get_min_area_rect_lib()`` and ``get_png_lib()`` do the same for
the other two (their errors in ``BUILD_ERRORS``); their callers keep a NumPy
version held equal to them.
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

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "polyiou.cpp"
BUILD_DIR = _DIR.parent / "build"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# no -ffast-math, and no fused multiply-adds: each float32 operation rounds
# on its own, as in OpenCV's compiled code
MIN_AREA_RECT_FLAGS = FLAGS[1:] + ["-O2", "-ffp-contract=off"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_ERRORS: dict = {}
BUILD_ERROR: str | None = None  # the polygon library's


def so_path(src: Path = _SRC, flags=FLAGS) -> Path:
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _build(src: Path, flags, out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *flags, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr}")
    os.replace(tmp, out)


def _load(src: Path, flags, bind):
    """The library of ``src`` (built first if needed) with ``bind`` applied
    to it, or None; one attempt per process."""
    with _lock:
        if src.name in _libs:
            return _libs[src.name]
        lib = None
        out = so_path(src, flags)
        try:
            if not out.exists():
                _build(src, flags, out)
            lib = ctypes.CDLL(str(out))
            bind(lib)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            BUILD_ERRORS[src.name] = str(e)
            lib = None
        _libs[src.name] = lib
        return lib


def _bind_polyiou(lib) -> None:
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.iou_poly.restype = ctypes.c_double
    lib.iou_poly.argtypes = [f64, f64]
    lib.poly_overlaps.restype = None
    lib.poly_overlaps.argtypes = [f64, ctypes.c_int64, f64, ctypes.c_int64,
                                  f64]
    lib.poly_nms.restype = ctypes.c_int64
    lib.poly_nms.argtypes = [
        f64, f64, np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64, ctypes.c_double,
        np.ctypeslib.ndpointer(np.uint8, flags="C")]


def _bind_min_area_rect(lib) -> None:
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.min_area_rect.restype = ctypes.c_int
    lib.min_area_rect.argtypes = [f32, ctypes.c_int, f32, f32]


def _bind_png(lib) -> None:
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [u8, u8, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64]


def get_lib():
    """The loaded polygon library (built first if needed), or None."""
    global BUILD_ERROR
    lib = _load(_SRC, FLAGS, _bind_polyiou)
    BUILD_ERROR = BUILD_ERRORS.get(_SRC.name)
    return lib


def get_min_area_rect_lib():
    return _load(_DIR / "min_area_rect.cpp", MIN_AREA_RECT_FLAGS,
                 _bind_min_area_rect)


def get_png_lib():
    return _load(_DIR / "png_filter.cpp", FLAGS, _bind_png)


def min_area_rect_native(pts):
    """``(box (5,) [cx cy w h angle°], corners (4, 2))`` float32 of the
    point set ``pts`` ``(m, 2)`` (cast to float32), as
    ``cv2.minAreaRect`` / ``cv2.boxPoints`` give them; None without the
    library."""
    lib = get_min_area_rect_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pts, np.float32).reshape(-1, 2)
    box, corners = np.zeros(5, np.float32), np.zeros(8, np.float32)
    lib.min_area_rect(p, len(p), box, corners)
    return box, corners.reshape(4, 2)


def png_unfilter_native(raw, height: int, stride: int, bpp: int):
    """The unfiltered ``(height, stride)`` uint8 rows of an inflated PNG
    image stream ``raw`` (``height`` rows of a filter byte + ``stride``
    bytes), or None without the library.  Raises on a bad filter type."""
    lib = get_png_lib()
    if lib is None:
        return None
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    if lib.png_unfilter(src, out, height, stride, bpp):
        raise ValueError("PNG: bad scanline filter type")
    return out


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
