"""The numbers that decide ``correct``: how far what the timed path
produced lies from the plain reference.

Predict cells:

- ``maps_rel_err``: the largest, over Detect levels and compared batches,
  of ``‖program − reference‖ / ‖reference‖`` of the raw maps (every
  channel: box, objectness, class and angle logits);
- ``det_unmatched``: the share of detections, the program's and the
  reference's together, that find no partner in the other set: the same
  image and class and a rotated IoU of at least 0.8, paired greedily in
  the program's score order.  The drivers compare two pairs of sets: the
  program's detections against the reference's post-processing of the
  program's own maps (``det_unmatched``: the stage alone), and against the
  reference's detections from its own float32 maps
  (``det_unmatched_vs_reference_maps``: the whole predict).

Train cells, each by the worst leaf: a leaf's gap is
``|‖program‖ - ‖reference‖|``, over ``max(‖reference‖, median leaf's
‖reference‖)``:

- ``loss_gap``: the largest relative gap of the checked steps' total
  loss (three steps, or two whole updates where the optimizer accumulates
  micro-batches: ``drivers/train_step.checked_steps``);
- ``grad_gap``: the first step's gradient as the optimizer got it;
- ``update_gap``: the parameters' change over the checked steps;
- ``ema_gap``: the EMA's change over the checked steps;
- ``bn_gap``: the BatchNorm running statistics' change over the checked
  steps.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's are left out of ``grad_gap``, ``update_gap`` and ``ema_gap``:
their gradient is nought to rounding (a bias under a following
BatchNorm), and the optimizer moves them by round-off alone.  Beside each
worst-leaf gap the median leaf's relative gap (``*_median_gap``) is
reported; which numbers are held to a limit, and the limit, is each cell's
``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np

MATCH_IOU = 0.8
TINY_LEAF = 1e-3


def rel_err(got, want) -> float:
    """``‖got - want‖ / ‖want‖`` in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _pairs(a, b, device):
    """Greedy partners of ``a``'s rows (in order: the program's score
    order) among ``b``'s: the same class and rotated IoU at least
    ``MATCH_IOU`` (or the same row), the best free partner first.
    ``[(i, j)]``."""
    import torch

    from .reference.nms import rotated_iou_pairs

    if len(a) == 0 or len(b) == 0:
        return []
    ta = torch.as_tensor(a, dtype=torch.float64, device=device)
    tb = torch.as_tensor(b, dtype=torch.float64, device=device)
    ii, jj = (ta[:, None, 6] == tb[None, :, 6]).nonzero(as_tuple=True)
    iou = rotated_iou_pairs(ta[ii, :5], tb[jj, :5])
    # a box of no area overlaps nothing, itself included: equal rows pair
    same = ((ta[ii, :5] - tb[jj, :5]).abs()
            <= 1e-6 * (1 + ta[ii, :5].abs())).all(-1)
    iou = torch.where(same, 1.0, iou)
    ok = iou >= MATCH_IOU
    ii, jj, iou = ii[ok].cpu().numpy(), jj[ok].cpu().numpy(), \
        iou[ok].cpu().numpy()
    order = np.lexsort((-iou, ii))
    used_a, used_b, out = set(), set(), []
    for i, j in zip(ii[order], jj[order]):
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    return out


def detections(got: list, want: list, device="cpu") -> dict:
    """``got`` and ``want``: per image ``(n, 7)`` arrays ``[cx cy l s theta
    conf cls]``.  Returns the unmatched share and the counts."""
    paired = total = 0
    for a, b in zip(got, want):
        paired += len(_pairs(a, b, device))
        total += len(a) + len(b)
    unmatched = total - 2 * paired
    return {"det_unmatched": unmatched / max(total, 1),
            "unmatched": unmatched, "total": total,
            "dets_program": sum(len(a) for a in got),
            "dets_reference": sum(len(b) for b in want)}


def leaf_gap(got: dict, want: dict, keep=None) -> tuple:
    """Worst leaf ``(gap, name)`` of two ``{name: norm}`` dicts; ``keep``
    the names counted (all of ``want``'s by default)."""
    names = [n for n in want if keep is None or n in keep]
    ref = np.array([want[n] for n in names], np.float64)
    med = float(np.median(ref)) if len(ref) else 0.0
    worst, at = 0.0, None
    for n, r in zip(names, ref):
        g = abs(got[n] - r) / max(r, med, 1e-30)
        if g > worst or at is None:
            worst, at = g, n
    return worst, at


def counted_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient is more than rounding."""
    med = float(np.median(list(grad_norms.values())))
    return {n for n, v in grad_norms.items() if v >= TINY_LEAF * med}


def median_gap(got: dict, want: dict, keep=None) -> float:
    """The median leaf's relative gap ``|‖program‖ - ‖reference‖| /
    ‖reference‖``."""
    names = [n for n in want if keep is None or n in keep]
    return float(np.median([abs(got[n] - want[n]) / max(want[n], 1e-30)
                            for n in names]))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The train cells' numbers from two records of the checked steps
    (``losses``, ``grad``, ``update``, ``ema``, ``bn``: norms by leaf)."""
    keep = counted_leaves(ref["grad"])
    out = {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                           for p, r in zip(prog["losses"], ref["losses"]))}
    for key in ("grad", "update", "ema", "bn"):
        k = None if key == "bn" else keep
        out[f"{key}_gap"], out[f"{key}_worst_leaf"] = leaf_gap(
            prog[key], ref[key], k)
        out[f"{key}_median_gap"] = median_gap(prog[key], ref[key], k)
    out["leaves_left_out"] = len(ref["grad"]) - len(keep)
    out["losses_program"], out["losses_reference"] = prog["losses"], \
        ref["losses"]
    return out
