"""The device trace of a short steady slice of a run, and what the
per-layer readers take from it.

:func:`record` runs a callable twice under ``torch.profiler`` and keeps the
second run: CUPTI can lose the first kernels of a profile and of a
recording begun straight after its warm-up, so the first run is an
unrecorded warm-up followed by a pause (the port's ``chip_smoke.py``
``profile_cycle`` does the same).  From the recorded run it keeps every
device operation's interval (kernels, copies, sets) and the host's
operations, and derives:

- ``busy_s``: the length of the union of the device intervals, so
  operations that overlap count once;
- ``window_s``: the slice's length, from the recorded call's first host
  operation to the end of its last operation, host or device;
- device time by kernel name and by group (``GROUPS``);
- idle gaps: the stretches inside the slice where no device operation
  ran, each named by the innermost host operation that covers its middle.
"""

from __future__ import annotations

import heapq
import time
import warnings
from collections import defaultdict

PAUSE_S = 0.05

# kernel-name substrings → group, first match wins (``chip_smoke._GROUPS``)
GROUPS = (("port kernels", ("stem_l1_kernel", "stem_kernel",
                            "stem_fwd_kernel", "stem_wgrad_kernel",
                            "down_wgrad_kernel", "sum_partials",
                            "sum_rows", "conv3x3_mma", "p1x1_fwd_kernel",
                            "p1x1_bwd_kernel", "c3_kernel",
                            "neighbor_scan", "neighbor_iou",
                            "riou_boxes", "riou_pairs")),
          ("convolutions (cuDNN/CUTLASS)", ("conv", "cudnn", "xmma",
                                            "cutlass", "implicit", "wgrad",
                                            "dgrad", "gemm", "sm90")),
          ("reductions", ("reduce",)),
          ("elementwise", ("elementwise", "vectorized", "unrolled")),
          ("copies", ("memcpy", "memset")))


def group(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)),
                "other")


class Trace:
    """Device and host intervals (seconds from the slice's start) of one
    recorded slice, and the slice's wall time."""

    def __init__(self, device, host, window_s: float, calls: int):
        self.device = sorted(device, key=lambda e: e[1])  # (name, t0, t1)
        self.host = host  # (name, t0, t1)
        self.window_s = window_s
        self.calls = calls

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, a, b in self.device:
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total

    def by_name(self) -> dict:
        out: dict = defaultdict(float)
        for n, a, b in self.device:
            out[n] += b - a
        return dict(out)

    def by_group(self) -> dict:
        out: dict = defaultdict(float)
        for n, a, b in self.device:
            out[group(n)] += b - a
        return dict(out)

    def kernel_s(self, substrings) -> float:
        """Device seconds of the operations whose names hold any of
        ``substrings``."""
        return sum(b - a for n, a, b in self.device
                   if any(s in n for s in substrings))

    def gaps(self):
        """``(t0, t1)`` stretches of the slice with no device operation."""
        out, end = [], 0.0
        for _, a, b in self.device:
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.window_s > end:
            out.append((end, self.window_s))
        return out

    def idle_by_host_op(self) -> dict:
        """Idle seconds by the shortest host operation covering each gap's
        middle, in one sweep: the gaps come in time order, so a host
        operation that ended before one gap's middle covers no later one."""
        out: dict = defaultdict(float)
        order = sorted(range(len(self.host)), key=lambda i: self.host[i][1])
        active, k = [], 0  # heap of (length, index) begun by the middle
        for a, b in self.gaps():
            mid = (a + b) / 2
            while k < len(order) and self.host[order[k]][1] <= mid:
                i = order[k]
                heapq.heappush(active, (self.host[i][2] - self.host[i][1], i))
                k += 1
            while active and self.host[active[0][1]][2] < mid:
                heapq.heappop(active)
            name = self.host[active[0][1]][0] if active \
                else "(host outside any recorded operation)"
            out[name] += b - a
        return dict(out)

    def breakdown(self) -> dict:
        top = lambda d: [[n[:120], s] for n, s in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name()),
                "idle_gaps": top(self.idle_by_host_op())}


def _events(prof):
    """``(device, host)``: the raw intervals ``(name, t0_ns, t1_ns)`` of a
    finished profiler cycle, the profiler's own step ranges and the
    device-side copies of host annotations left out."""
    import torch

    res = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in res.events():
        name = e.name()
        if name.startswith("ProfilerStep"):
            continue
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == cuda:
            if annotation or name.startswith("bench."):
                continue
            device.append((name, t0, t1))
        else:
            host.append((name, t0, t1))
    return device, host


def record(run, dev, calls: int = 1) -> Trace:
    """Trace the second of two calls of ``run`` (each ending in a
    synchronize of ``dev``, a :class:`~benchmark.device.Device`);
    ``calls`` is how many units of work (predicts, steps) one call of
    ``run`` makes.  On the CPU (the harness's tests) the trace holds host
    operations only."""
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}

    def ready(p):
        out["events"] = _events(p)

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.cuda else [])
    dev.sync()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for i in range(2):
                if i:
                    time.sleep(PAUSE_S)
                run()
                dev.sync()
                prof.step()
    device, host = out["events"]
    # the slice runs from the recorded call's first host operation to the
    # end of its last operation, host or device (its synchronize)
    if not host or (dev.cuda and not device):
        raise RuntimeError("the profiler recorded no device operation")
    origin = min(t for _, t, _ in host)
    end = max(t for _, _, t in host + device)
    to_s = lambda evs: [(n, (a - origin) / 1e9, (b - origin) / 1e9)
                        for n, a, b in evs]
    return Trace(to_s(device), to_s(host), (end - origin) / 1e9, calls)
