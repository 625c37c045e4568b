"""Arithmetic the per-layer readers (``metrics/*.py``) share."""

from __future__ import annotations

from . import bounds

_ROWS = {"predict": (bounds.INFER_KERNELS, bounds.INFER_LAUNCHES),
         "train_step": (bounds.TRAIN_KERNELS, bounds.TRAIN_LAUNCHES)}


def roofline(obs, kind: str):
    """Σ least time of the rows / Σ their traced device time, a call, in
    percent; None when the trace holds none of them or their launches a
    call are not the ones the bounds count."""
    if not _on_device(obs, kind):
        return None
    names, launches = _ROWS[kind]
    if any(obs["launches"].get(k) != n for k, n in launches.items()):
        return None
    t = obs["trace"].kernel_s(names) / obs["trace"].calls
    if t <= 0:
        return None
    return 100.0 * sum(obs["bounds_s"].values()) / t


def _on_device(obs, kind: str) -> bool:
    """The observation is of ``kind`` and its trace saw the device (a run
    on the CPU gives no device metric)."""
    return obs["kind"] == kind and bool(obs["trace"].device)


def mfu(obs, kind: str):
    if not _on_device(obs, kind) or not obs["window_s"]:
        return None
    return (100.0 * obs["flops_per_call"] * obs["calls"]
            / obs["window_s"] / bounds.PEAK_BF16)


def idle(obs, kind: str):
    if not _on_device(obs, kind):
        return None
    tr = obs["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
