"""Profiling helpers (reference utils/torch_utils.py:86-142).

Counterpart of ``yolov5_obb_tpu/utils/profiler.py`` (:16-63):
``block_and_time`` (the reference's ``time_sync``), ``flops_of`` (FLOPs
from ``torch.utils.flop_counter`` where the JAX package reads XLA's cost
analysis), ``profile`` (the same printed table) and ``trace`` (a
``torch.profiler`` trace for Chrome or TensorBoard where the JAX package
writes a ``jax.profiler`` one).

The port's own spans and counters live here too: :func:`span` names a
stretch of the predict call or the train step in a ``torch.profiler``
trace (``trace`` shows them), and :func:`count` / :func:`counters` keep
process-wide tallies (post-processing's calls and host syncs).
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch


_OFF = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A context manager that names the block ``name`` in the host timeline
    of a ``torch.profiler`` session recording on this thread (``trace``,
    the benchmark's traced run, or an operator's own), where it nests in
    the enclosing span.  With no session recording it is one shared
    ``nullcontext`` after one check: under a microsecond a span."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide counter ``name`` (always on: an
    integer add, as the kernels' ``launches``)."""
    _COUNTS[name] += n


def counters() -> collections.Counter:
    """A snapshot of every counter; a name never counted reads 0."""
    return collections.Counter(_COUNTS)


def _synchronize() -> None:
    """Wait for the card, if this process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def block_and_time(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds of ``fn(*args)``, each call synchronised with the
    card (after ``warmup`` untimed calls)."""
    for _ in range(warmup):
        fn(*args)
    _synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def flops_of(fn, *args) -> float | None:
    """FLOPs of one ``fn(*args)`` as ``FlopCounterMode`` counts them (2 a
    multiply-add of the convolutions and matrix products; the hand-written
    kernels, called through ``ctypes``, are not seen); None where the
    count fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    except RuntimeError:
        return None
    return float(counter.get_total_flops())


def profile(fns_and_args, iters: int = 10, label_width: int = 32) -> dict:
    """Time a list of ``(name, fn, args)`` and print a table like the
    reference's ``torch_utils.profile`` (:93-142) → ``{name: seconds}``."""
    out = {}
    print(f"{'op':<{label_width}}{'median ms':>12}{'GFLOPs':>10}"
          f"{'TFLOP/s':>10}")
    for name, fn, args in fns_and_args:
        t = block_and_time(fn, *args, iters=iters)
        fl = flops_of(fn, *args)
        gf = fl / 1e9 if fl else float("nan")
        tput = fl / t / 1e12 if fl else float("nan")
        print(f"{name:<{label_width}}{t * 1000:>12.2f}{gf:>10.1f}"
              f"{tput:>10.2f}")
        out[name] = t
    return out


@contextlib.contextmanager
def trace(log_dir: str = "runs/trace"):
    """``torch.profiler`` over the block (the CPU, and the card when one is
    visible), written to ``log_dir`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``) that TensorBoard's profiler
    plugin also reads; the port's spans (:func:`span`) appear in it as
    user annotations.  Yields ``log_dir``."""
    from torch.profiler import (
        ProfilerActivity,
        profile as torch_profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
