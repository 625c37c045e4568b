"""What the per-layer readers take from the port's own spans
(``yolov5_obb_tpu_torch/utils/profiler.span``, ``torch.profiler`` user
annotations in the trace's host intervals): host time inside the spans of
some names, and the device-idle time whose gap's middle lies inside them,
each a call.  None where the trace holds no such span: a program without
them, or another kind of cell."""

from __future__ import annotations


def _spans(obs, kind: str, names) -> list:
    if obs["kind"] != kind:
        return []
    return [(a, b) for n, a, b in obs["trace"].host if n in names]


def host_ms(obs, kind: str, names):
    """Host ms a call inside the spans ``names``."""
    spans = _spans(obs, kind, names)
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / obs["trace"].calls


def idle_ms(obs, kind: str, names):
    """Device-idle ms a call in the gaps whose middle lies inside one of
    the spans ``names``; None on the CPU (no device)."""
    tr = obs["trace"]
    spans = _spans(obs, kind, names)
    if not spans or not tr.device:
        return None
    idle = sum(b - a for a, b in tr.gaps()
               if any(s <= (a + b) / 2 <= e for s, e in spans))
    return 1e3 * idle / tr.calls
