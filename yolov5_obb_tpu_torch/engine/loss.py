"""OBB training loss: static-shape target assignment + the 4-term loss.

Counterpart of ``yolov5_obb_tpu/engine/loss.py`` (``ComputeLoss`` :402,
``_compute_loss_impl`` :179).  Targets arrive padded per image as
``(B, M, 6+180)`` ``[cls cx cy l s theta csl...]`` (pixels) with a ``(B, M)``
validity mask; the candidates of each level are the dense lattice
``(B, M, na, 5)`` = targets x anchors x {centre, left, up, right, down} with
the anchor-ratio filter and the ±0.5-offset cell rule as masks.

Terms: CIoU box loss, IoU-valued objectness BCE with per-level balance,
label-smoothed class BCE and the CSL theta BCE; focal, quality-focal and
BCE-blur modulations as options.  Two formulations:

- gather (default): predictions at the matched cells are gathered per
  candidate, the objectness target is a scatter-max over the grid;
- dense (opt-in): the target data is scattered onto the grid and every term
  is computed at every cell under a mask.  The same loss unless two targets
  claim one (cell, anchor) candidate: then one of them wins, and which one is
  undefined, as in the JAX package.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F

from ..models import step_context

THETA_BINS = 180

DEFAULT_HYP = {
    # data/configs/hyp_finetune_dota.yaml
    "box": 0.05,
    "cls": 0.5,
    "cls_pw": 1.0,
    "obj": 1.0,
    "obj_pw": 1.0,
    "theta": 0.5,
    "theta_pw": 1.0,
    "anchor_t": 4.0,
    "fl_gamma": 0.0,
    "qfl_gamma": 0.0,  # >0: quality-focal modulation (overrides fl_gamma)
    "bce_blur": 0.0,  # >0: BCE-blur missing-label alleviation
    "label_smoothing": 0.0,
    # CSL window sigma for the dense path's analytic theta targets; it must
    # match the data pipeline's radius (every shipped hyp yaml sets 2.0)
    "csl_radius": 6.0,
}

# centre, left, up, right, down (g = 0.5)
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def smooth_bce(eps: float = 0.1):
    """Positive/negative label-smoothing targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE-with-logits with ``pos_weight``."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_modulation(logits, targets, gamma: float, alpha: float = 0.25):
    """Focal-loss modulation factor."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_f * (1.0 - p_t) ** gamma


def qfocal_modulation(logits, targets, gamma: float, alpha: float = 0.25):
    """Quality-focal modulation: weight by ``|target − σ(logit)|^γ``."""
    p = torch.sigmoid(logits)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_f * (targets - p).abs() ** gamma


def ciou_xywh(box1, box2, eps: float = 1e-7):
    """CIoU of two xywh boxes over the trailing dim."""
    b1x1, b1x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
    b1y1, b1y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
    b2y1, b2y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = (torch.clamp(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1),
                         min=0)
             * torch.clamp(torch.minimum(b1y2, b2y2)
                           - torch.maximum(b1y1, b2y1), min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _assign_level(t_xyls, t_mask, anchors_ft, stride, ny, nx, anchor_t):
    """Dense assignment for one pyramid level.

    ``t_xyls (B, M, 4)`` targets ``[cx cy l s]`` in input pixels, ``t_mask
    (B, M)`` bool, ``anchors_ft (na, 2)`` anchors in feature units.  Returns
    ``mask (B, M, na, 5)``, ``cell (B, M, 5)`` (``gj*nx + gi``), ``txy (B, M,
    5, 2)`` and ``twh (B, M, 2)``."""
    g = 0.5
    xyls = t_xyls / stride
    gxy, gwh = xyls[..., 0:2], xyls[..., 2:4]

    r = gwh[..., None, :] / anchors_ft  # (B, M, na, 2)
    afilt = torch.maximum(r, 1.0 / torch.clamp(r, min=1e-9)).amax(-1) < anchor_t

    fx, fy = torch.remainder(gxy[..., 0], 1.0), torch.remainder(gxy[..., 1], 1.0)
    inv_x, inv_y = nx - gxy[..., 0], ny - gxy[..., 1]
    off_mask = torch.stack([
        torch.ones_like(fx, dtype=torch.bool),
        (fx < g) & (gxy[..., 0] > 1),
        (fy < g) & (gxy[..., 1] > 1),
        (torch.remainder(inv_x, 1.0) < g) & (inv_x > 1),
        (torch.remainder(inv_y, 1.0) < g) & (inv_y > 1),
    ], -1)  # (B, M, 5)

    off = torch.tensor(_OFFSETS, dtype=gxy.dtype, device=gxy.device)
    gij = torch.floor(gxy[..., None, :] - off)  # (B, M, 5, 2)
    gi = torch.clamp(gij[..., 0], 0, nx - 1)
    gj = torch.clamp(gij[..., 1], 0, ny - 1)
    txy = gxy[..., None, :] - torch.stack([gi, gj], -1)

    mask = t_mask[..., None, None] & afilt[..., :, None] & off_mask[..., None, :]
    return {"mask": mask, "cell": (gj * nx + gi).long(), "txy": txy,
            "twh": gwh}


def _masked_mean(x, mask, mesh=None):
    """Mean of ``x`` where ``mask``; under a data-parallel step (``mesh``)
    this rank's sum over the global count."""
    m = mask.to(x.dtype)
    if mesh is None:
        return (x * m).sum() / torch.clamp(m.sum(), min=1.0)
    return (x * m).sum() / torch.clamp(mesh.sum_(m.sum()), min=1.0)


def _cell_mean(x, mesh=None):
    """Mean of ``x`` over every element; under a data-parallel step this
    rank's share of the global batch's mean (the ranks hold equal
    slices)."""
    return x.mean() if mesh is None else x.mean() / mesh.world


def compute_loss(maps, targets, t_mask, anchors_grid, nc: int, strides,
                 hyp: dict, dense: bool = False):
    """Counterpart of ``_compute_loss_impl`` (loss.py:179).

    ``maps``: per level ``(B, ny*nx*na, no)`` flat float32 logits (square
    levels) or ``(B, ny, nx, na, no)``; ``targets (B, M, 186)``; ``t_mask
    (B, M)`` bool; ``anchors_grid (nl, na, 2)`` anchors in feature units.
    Returns ``(total, items)``: ``total = Σ items · B`` and the ``(4,)``
    tensor ``[lbox lobj lcls ltheta]``.

    Under a data-parallel step (``models/step_context.mesh``) the
    loss is the JAX step's over the global batch: each rank takes its own
    numerators over the global counts (the masked means' counts summed
    over the ranks, the objectness mean over every cell of the global
    batch, the global ``B``), so the ranks' ``total`` and ``items`` add up
    to the one-process values and the summed gradients are its
    gradients."""
    mesh = step_context.mesh()
    world = 1 if mesh is None else mesh.world
    cp, cn = smooth_bce(hyp.get("label_smoothing", 0.0))
    gamma = hyp.get("fl_gamma", 0.0)
    qgamma = hyp.get("qfl_gamma", 0.0)
    blur = hyp.get("bce_blur", 0.0)

    def modulate(loss, logit, target):
        if qgamma > 0:
            return loss * qfocal_modulation(logit, target, qgamma)
        if gamma > 0:
            return loss * focal_modulation(logit, target, gamma)
        return loss

    def blurred(loss, logit, target):
        if blur <= 0:
            return loss
        dx = torch.sigmoid(logit) - target
        return loss * (1.0 - torch.exp((dx - 1.0) / (blur + 1e-4)))

    def bce(logit, target, pos_weight):
        return blurred(modulate(bce_with_logits(logit, target, pos_weight),
                                logit, target), logit, target)

    nl = len(maps)
    balance = {3: (4.0, 1.0, 0.4)}.get(nl, (4.0, 1.0, 0.25, 0.06, 0.02))
    t_cls = targets[..., 0].long()
    t_xyls = targets[..., 1:5]
    t_csl = targets[..., 6:6 + THETA_BINS]
    B = maps[0].shape[0]
    na = anchors_grid.shape[1]
    dev = targets.device
    zero = targets.new_zeros(())
    lbox = lobj = lcls = ltheta = zero

    for li in range(nl):
        p = maps[li]
        if p.dim() == 5:
            _, ny, nx, _, no = p.shape
            pf = p.reshape(B, ny * nx * na, no)
        else:
            _, n_lvl, no = p.shape
            ny = nx = int(round((n_lvl // na) ** 0.5))
            if ny * nx * na != n_lvl:
                raise ValueError(
                    f"flat loss path requires square feature maps: level {li} "
                    f"has {n_lvl} cells with na={na}; pass 5-D maps for "
                    f"non-square inputs")
            pf = p
        asn = _assign_level(t_xyls, t_mask, anchors_grid[li], strides[li],
                            ny, nx, hyp["anchor_t"])
        mask = asn["mask"]  # (B, M, na, 5)
        M = mask.shape[1]
        K = M * na * 5
        a_idx = torch.arange(na, device=dev)[None, None, :, None]
        flat_idx = (asn["cell"][:, :, None, :] * na + a_idx).reshape(B, K)
        mflat = mask.reshape(B, K)
        txy = asn["txy"][:, :, None].expand(B, M, na, 5, 2).reshape(B, K, 2)
        twh = asn["twh"][:, :, None, None].expand(B, M, na, 5, 2).reshape(
            B, K, 2)
        tcls = t_cls[:, :, None, None].expand(B, M, na, 5).reshape(B, K)

        if dense:
            n_rows = ny * nx * na
            tthdeg = targets[..., 5] * (180.0 / math.pi) + 90.0
            tcat = torch.cat([
                txy, twh, tcls[..., None].float(),
                tthdeg[:, :, None, None].expand(B, M, na, 5).reshape(B, K, 1),
                torch.ones(B, K, 1, device=dev),
            ], -1)  # (B, K, 7)
            bidx = torch.arange(B, device=dev)[:, None].expand(B, K)
            idx_eff = torch.where(mflat, flat_idx, n_rows)  # row n_rows: dropped
            dense_t = torch.zeros(B, n_rows + 1, 7, device=dev)
            dense_t = dense_t.index_put((bidx, idx_eff), tcat)[:, :n_rows]
            d_mask = dense_t[..., 6] > 0
            dm = d_mask.float()

            anch_rows = anchors_grid[li].repeat(ny * nx, 1)  # (n, 2)
            pxy = torch.sigmoid(pf[..., 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(pf[..., 2:4]) * 2.0) ** 2 * anch_rows
            iou = ciou_xywh(torch.cat([pxy, pwh], -1), dense_t[..., 0:4])
            lbox = lbox + _masked_mean(1.0 - iou, d_mask, mesh)

            tobj = torch.clamp(iou.detach(), min=0.0) * dm
            lobj = lobj + _cell_mean(bce(pf[..., 4], tobj, hyp["obj_pw"]),
                                     mesh) * balance[li]

            if nc > 1:
                t_onehot = torch.where(
                    F.one_hot(dense_t[..., 4].long(), nc) > 0, cp, cn)
                cls_l = bce(pf[..., 5:5 + nc], t_onehot, hyp["cls_pw"])
                lcls = lcls + _masked_mean(
                    cls_l, d_mask[..., None].expand_as(cls_l), mesh)

            # CSL targets regenerated analytically on the grid
            # (ops/geometry.csl_gaussian_labels, truncating peak snap)
            idx = torch.trunc(90.0 - dense_t[..., 5])
            jbins = torch.arange(THETA_BINS, dtype=torch.float32, device=dev)
            dist = torch.remainder(jbins + idx[..., None], THETA_BINS) - 90.0
            tth = torch.exp(-(dist**2) / (2.0 * float(hyp["csl_radius"]) ** 2))
            th_l = modulate(bce_with_logits(pf[..., 5 + nc:], tth,
                                            hyp["theta_pw"]),
                            pf[..., 5 + nc:], tth)
            ltheta = ltheta + _masked_mean(
                th_l, d_mask[..., None].expand_as(th_l), mesh)
            continue

        ps = torch.gather(pf, 1, flat_idx[..., None].expand(B, K, no))

        # box: CIoU in feature units
        anch = anchors_grid[li][None, None, :, None].expand(
            B, M, na, 5, 2).reshape(B, K, 2)
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * anch
        iou = ciou_xywh(torch.cat([pxy, pwh], -1), torch.cat([txy, twh], -1))
        lbox = lbox + _masked_mean(1.0 - iou, mflat, mesh)

        # objectness target grid: scatter-max of the matched IoUs
        score = torch.where(mflat, torch.clamp(iou.detach(), min=0.0), 0.0)
        tobj = torch.zeros(B, ny * nx * na, device=dev).scatter_reduce(
            1, flat_idx, score, "amax")
        lobj = lobj + _cell_mean(bce(pf[..., 4], tobj, hyp["obj_pw"]),
                                     mesh) * balance[li]

        if nc > 1:
            t_onehot = torch.where(F.one_hot(tcls, nc) > 0, cp, cn)
            cls_l = bce(ps[..., 5:5 + nc], t_onehot, hyp["cls_pw"])
            lcls = lcls + _masked_mean(
                cls_l, mflat[..., None].expand_as(cls_l), mesh)

        tth = t_csl[:, :, None, None].expand(
            B, M, na, 5, THETA_BINS).reshape(B, K, THETA_BINS)
        th_logit = ps[..., 5 + nc:]
        th_l = modulate(bce_with_logits(th_logit, tth, hyp["theta_pw"]),
                        th_logit, tth)
        ltheta = ltheta + _masked_mean(
            th_l, mflat[..., None].expand_as(th_l), mesh)

    lbox = lbox * hyp["box"]
    lobj = lobj * hyp["obj"]
    lcls = lcls * hyp["cls"]
    ltheta = ltheta * hyp["theta"]
    # the reference scales by the batch size (the global one)
    total = (lbox + lobj + lcls + ltheta) * (B * world)
    return total, torch.stack([lbox, lobj, lcls, ltheta])


class ComputeLoss:
    """Callable loss bound to the model meta and a hyp dict (JAX
    ``ComputeLoss``, loss.py:402).  ``dense=True`` selects the dense
    formulation; ``dense=None`` takes it from the environment
    (``YOLO_DENSE_LOSS=1``), as the JAX package does."""

    def __init__(self, meta, hyp: dict | None = None,
                 dense: bool | None = None):
        h = dict(DEFAULT_HYP)
        if hyp:
            h.update({k: v for k, v in hyp.items() if k in DEFAULT_HYP})
        self.hyp = h
        self.nc = meta.nc
        self.strides = tuple(meta.strides)
        self.anchors_grid = torch.as_tensor(meta.anchors_grid,
                                            dtype=torch.float32)
        if dense is None:
            dense = os.environ.get("YOLO_DENSE_LOSS", "0") == "1"
        self.dense = bool(dense)

    def __call__(self, maps: Sequence[torch.Tensor], targets, t_mask):
        """``maps``: flat ``(B, n, no)`` or ``(B, ny, nx, na, no)`` float32
        logits; ``targets (B, M, 186)``; ``t_mask (B, M)`` bool.  Returns
        ``(total_loss, [lbox lobj lcls ltheta])``."""
        if self.anchors_grid.device != targets.device:
            self.anchors_grid = self.anchors_grid.to(targets.device)
        return compute_loss(tuple(maps), targets, t_mask, self.anchors_grid,
                            self.nc, self.strides, self.hyp, dense=self.dense)
