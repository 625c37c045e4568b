"""Faults planted underneath the timed path, to show that the comparison
catches them (``calibrate.py --fault`` on the card, the harness's tests on
the CPU).  Each is a patch of the port that :func:`planted` applies and
takes back:

- ``half_batch``: half of the batch left out.  A predict call returns no
  detections for the second half of its images; a train step's loss takes
  the first half of the batch (the mean over the rest);
- ``unchanged_state``: the train step's optimizer leaves the parameters
  as they are (its state moves, the parameters do not);
- ``altered_answer``: a predict call's detections come back with every
  class id moved by one.
"""

from __future__ import annotations

import contextlib

FAULTS = ("half_batch", "unchanged_state", "altered_answer")


def _nms_wrapper(fn, fault):
    def wrapped(*a, **k):
        dets, num = fn(*a, **k)
        if fault == "half_batch":
            h = num.shape[0] // 2
            dets, num = dets.clone(), num.clone()
            dets[h:] = 0
            num[h:] = 0
        else:
            dets = dets.clone()
            nc = a[1].nc
            dets[..., 6] = (dets[..., 6] + 1) % nc
        return dets, num
    return wrapped


@contextlib.contextmanager
def planted(fault):
    """Apply ``fault`` (one of ``FAULTS``, or None) for the ``with``
    block."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    from yolov5_obb_tpu_torch.engine import evaluator, loss, optim

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault in ("half_batch", "altered_answer"):
        patch(evaluator, "non_max_suppression_from_maps",
              _nms_wrapper(evaluator.non_max_suppression_from_maps, fault))
    if fault == "half_batch":
        call = loss.ComputeLoss.__call__

        def half(self, maps, targets, t_mask):
            h = targets.shape[0] // 2
            return call(self, [m[:h] for m in maps], targets[:h], t_mask[:h])
        patch(loss.ComputeLoss, "__call__", half)
    if fault == "unchanged_state":
        apply = optim.Optimizer.apply

        def frozen(self, state, grads):
            params, self.params = self.params, tuple(
                p.detach().clone() for p in self.params)
            try:
                return apply(self, state, grads)
            finally:
                self.params = params
        patch(optim.Optimizer, "apply", frozen)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
