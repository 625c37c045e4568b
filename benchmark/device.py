"""The card the run uses, and what a run reads of it.  On the CPU (the
harness's tests only: a run never falls back to it) synchronising,
events and memory statistics are no-ops."""

from __future__ import annotations

import contextlib
import subprocess
import time

import torch


class Device:
    def __init__(self, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def free(self):
        if self.cuda:
            torch.cuda.empty_cache()

    def timer(self):
        """``(start, stop)``: ``stop()`` returns the seconds since
        ``start()``, by CUDA events on the card (read after a
        synchronize), by the host clock on the CPU."""
        if not self.cuda:
            t = {}
            return (lambda: t.__setitem__(0, time.perf_counter()),
                    lambda: time.perf_counter() - t[0])
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def stop():
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        return a.record, stop

    def describe(self, count: int) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": count}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count, "power_limit_w": power_limit()}


def power_limit():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or
    None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
