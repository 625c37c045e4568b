"""Build the hand-written CUDA kernels with ``nvcc`` at first use and bind
them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``build/<name>-<hash>.so``
(one ``nvcc`` per source, all started together), for ``sm_90a``.  The
sources expose plain C entry points — no PyTorch headers — so a build takes
seconds.  The hash covers the source, every shared header and the flags, so
an edited kernel is rebuilt and a stale library is never loaded.

Every entry point launches on the stream it is handed and returns
``cudaGetLastError()``; :class:`Kernel` raises on a non-zero code and
counts the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]
# the rotated-IoU kernels (the per-box records, the neighbour kernel's edge
# test and IoU, the pair IoU) keep the plain version's operation-by-operation
# rounding (no fused multiply-adds), so their results match the plain
# PyTorch version bit for bit on all but borderline pairs
_EXTRA_FLAGS = {"neighbor": ["-fmad=false"], "pairs_iou": ["-fmad=false"],
                "riou_boxes": ["-fmad=false"]}

SOURCES = ("neighbor", "stem_l1", "down", "c3", "stem_train", "down_train",
           "train_fused_1x1", "train_fused_3x3", "stem", "pairs_iou",
           "riou_boxes", "bn_act_train")

_LIBS: dict[str, ctypes.CDLL] = {}
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _flags(name: str) -> list[str]:
    return _ARCH + _FLAGS + _EXTRA_FLAGS.get(name, [])


def so_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every library in ``names`` that is not built yet; returns the
    wall seconds of each compile (0.0 for a library already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    secs = {}
    for name in names:
        out = so_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_flags(name), "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = log
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(so_path(name)))
    return _LIBS[name]


class Kernel:
    """One CUDA entry point: its ctypes binding and its launch count.

    ``argtypes`` lists the entry point's arguments except the trailing
    stream, which :meth:`launch` appends (PyTorch's current stream).
    :meth:`launch` passes a tensor argument as its data pointer."""

    def __init__(self, source: str, symbol: str, argtypes, replaces: str):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def path(self) -> str:
        return str((CSRC_DIR / f"{self.source}.cu").relative_to(
            PKG_DIR.parent))

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L = ctypes.c_longlong


def query(source: str, symbol: str, *args: int, argtypes=None) -> int:
    """Call a host entry point of ``source`` that launches nothing (a
    launch plan) with int arguments (or of ``argtypes``); returns its
    non-negative result, and raises on the minus-CUDA-error it returns on
    failure."""
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes or [I] * len(args))
    fn.restype = ctypes.c_int
    out = fn(*args)
    if out < 0:
        raise RuntimeError(f"{symbol}: CUDA error {-out}")
    return out


def check_cuda(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Validate a kernel operand: on the card, of ``dtype``, ``ndim``-D and
    contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(**tensors) -> None:
    """Validate that each operand starts on a 16-byte boundary (the
    tensor-core kernels copy 16 bytes at a time)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")

