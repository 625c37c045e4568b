"""Plain YOLOv5-OBB training loss and optimizer, float32.

Loss (the gather formulation of YOLOv5-OBB's ``ComputeLoss``): each
target is offered to every anchor of every level whose shape ratio is
under ``anchor_t``, at its own cell and at the up to two neighbour cells
its centre leans toward (offset 0.5); the terms are the CIoU box loss in
feature units, the objectness BCE against the detached CIoU (clamped at 0,
the largest over the candidates of a cell) with per-level balance (4.0,
1.0, 0.4 for three levels; 4.0, 1.0, 0.25, 0.06 for four), the class BCE
and the CSL theta BCE (the targets' own CSL rows), each a mean over the
matched candidates, times the gains; ``total = Σ terms · B``.

Optimizer: SGD with Nesterov momentum on the mean gradient of
``accumulate = round(nominal / batch)`` micro-batches, weight decay on conv
kernels scaled by ``batch · accumulate / nominal``, biases on their own
warmup, one-cycle cosine learning rate and momentum warmup over applied
updates, and the EMA of the parameters with decay ``0.9999 · (1 -
exp(-n / 2000))``, stepped after every micro-batch (``n`` counts them), as
the recipe the port follows does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


def scaled_gains(hyp: dict, nl: int, nc: int, imgsz: int) -> dict:
    h = dict(hyp)
    h["box"] = hyp["box"] * 3.0 / nl
    h["cls"] = hyp["cls"] * nc / 80.0 * 3.0 / nl
    h["obj"] = hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl
    h["theta"] = hyp["theta"] * 3.0 / nl
    return h


def bce(logit, target, pos_weight=1.0):
    return -(pos_weight * target * F.logsigmoid(logit)
             + (1.0 - target) * F.logsigmoid(-logit))


def ciou(b1, b2, eps=1e-7):
    (x1, y1, w1, h1), (x2, y2, w2, h2) = b1.unbind(-1), b2.unbind(-1)
    l1, r1, t1, d1 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
    l2, r2, t2, d2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    inter = ((torch.minimum(r1, r2) - torch.maximum(l1, l2)).clamp(min=0)
             * (torch.minimum(d1, d2) - torch.maximum(t1, t2)).clamp(min=0))
    w1, h1 = r1 - l1, d1 - t1 + eps
    w2, h2 = r2 - l2, d2 - t2 + eps
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(r1, r2) - torch.minimum(l1, l2)
    ch = torch.maximum(d1, d2) - torch.minimum(t1, t2)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((l2 + r2 - l1 - r1) ** 2 + (t2 + d2 - t1 - d1) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def loss(maps, targets, t_mask, anchors_px, strides, nc: int, hyp: dict):
    """``maps``: per level ``(B, ny*nx*na, no)`` float32 logits;
    ``targets (B, M, 186)`` ``[cls cx cy l s theta csl*180]`` in pixels;
    ``t_mask (B, M)``.  Returns ``(total, items [box obj cls theta])``."""
    nl = len(maps)
    balance = (4.0, 1.0, 0.4) if nl == 3 else (4.0, 1.0, 0.25, 0.06, 0.02)
    B, M = t_mask.shape
    na = anchors_px.shape[1]
    terms = torch.zeros(4, device=targets.device)
    for li, p in enumerate(maps):
        n = p.shape[1]
        side = int(round((n // na) ** 0.5))
        stride = strides[li]
        anchors = anchors_px[li].to(p.device) / stride  # (na, 2)
        g = targets[..., 1:5] / stride  # (B, M, 4) feature units
        gxy, gwh = g[..., :2], g[..., 2:]
        r = gwh[:, :, None, :] / anchors  # (B, M, na, 2)
        ok_anchor = torch.maximum(r, 1 / r.clamp(min=1e-9)).amax(-1) < \
            hyp["anchor_t"]
        fx, fy = gxy[..., 0] % 1.0, gxy[..., 1] % 1.0
        ix, iy = side - gxy[..., 0], side - gxy[..., 1]
        leans = [torch.ones_like(fx, dtype=torch.bool),
                 (fx < 0.5) & (gxy[..., 0] > 1),
                 (fy < 0.5) & (gxy[..., 1] > 1),
                 (ix % 1.0 < 0.5) & (ix > 1),
                 (iy % 1.0 < 0.5) & (iy > 1)]
        bi, mi, ai, gi, gj, txy = [], [], [], [], [], []
        for lean, (ox, oy) in zip(leans, OFFSETS):
            cx = torch.floor(gxy[..., 0] - ox).clamp(0, side - 1)
            cy = torch.floor(gxy[..., 1] - oy).clamp(0, side - 1)
            sel = t_mask[:, :, None] & ok_anchor & lean[:, :, None]
            b, m, a = sel.nonzero(as_tuple=True)
            bi.append(b), mi.append(m), ai.append(a)
            gi.append(cx[b, m].long()), gj.append(cy[b, m].long())
            txy.append(gxy[b, m] - torch.stack([cx[b, m], cy[b, m]], -1))
        b, m, a = torch.cat(bi), torch.cat(mi), torch.cat(ai)
        gi, gj, txy = torch.cat(gi), torch.cat(gj), torch.cat(txy)
        row = (gj * side + gi) * na + a
        ps = p[b, row]  # (K, no)
        pxy = torch.sigmoid(ps[:, 0:2]) * 2 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2) ** 2 * anchors[a]
        iou = ciou(torch.cat([pxy, pwh], -1),
                   torch.cat([txy, gwh[b, m]], -1))
        k = max(b.numel(), 1)
        terms[0] = terms[0] + (1.0 - iou).sum() / k
        # a cell's target: the largest IoU of the candidates it is offered
        tobj = torch.zeros(B * n, device=p.device).scatter_reduce(
            0, b * n + row, iou.detach().clamp(min=0), "amax").view(B, n)
        terms[1] = terms[1] + bce(p[..., 4], tobj, hyp["obj_pw"]).mean() * \
            balance[li]
        if nc > 1:
            tc = F.one_hot(targets[b, m, 0].long(), nc).float()
            terms[2] = terms[2] + bce(ps[:, 5:5 + nc], tc,
                                      hyp["cls_pw"]).sum() / (k * nc)
        tth = targets[b, m, 6:]
        terms[3] = terms[3] + bce(ps[:, 5 + nc:], tth,
                                  hyp["theta_pw"]).sum() / (k * tth.shape[-1])
    items = terms * torch.tensor([hyp["box"], hyp["obj"], hyp["cls"],
                                  hyp["theta"]], device=terms.device)
    return items.sum() * B, items


class SGD:
    """The optimizer state and update of the training recipe: the mean
    gradient of ``round(nominal / batch)`` micro-batches, one update each
    time that many have come."""

    def __init__(self, named_params, hyp: dict, epochs: int,
                 steps_per_epoch: int, batch: int, nominal: int):
        self.names, self.params = zip(*named_params)
        self.accumulate = max(round(nominal / batch), 1)
        self.h = hyp
        self.wd = hyp["weight_decay"] * batch * self.accumulate / nominal
        self.nw = max(round(hyp["warmup_epochs"] * steps_per_epoch), 100)
        self.steps_per_epoch, self.epochs = steps_per_epoch, epochs
        self.decay = [n.endswith(".weight") and p.dim() > 1
                      for n, p in zip(self.names, self.params)]
        self.bias = [n.endswith(".bias") for n in self.names]
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.sums = [torch.zeros_like(p) for p in self.params]
        self.micro = 0
        self.count = 0

    def _lrs(self):
        h, c = self.h, self.count
        e = min(c // self.steps_per_epoch, self.epochs)
        f = ((1 - math.cos(e * math.pi / self.epochs)) / 2) * \
            (h["lrf"] - 1) + 1
        target = np.float32(h["lr0"]) * np.float32(f)
        warm = np.float32(min(max(c / self.nw, 0.0), 1.0))
        if c >= self.nw:
            return float(target), float(target), h["momentum"]
        b0 = np.float32(h["warmup_bias_lr"])
        mom = h["warmup_momentum"] + warm * (h["momentum"] -
                                             h["warmup_momentum"])
        return float(warm * target), float(b0 + warm * (target - b0)), \
            float(mom)

    @torch.no_grad()
    def apply(self, grads) -> bool:
        """Add one micro-batch's gradients; update the parameters when the
        last of an update's micro-batches has come.  Returns whether they
        were updated."""
        for s, g in zip(self.sums, grads):
            s.add_(g)
        self.micro += 1
        if self.micro < self.accumulate:
            return False
        lr, blr, mom = self._lrs()
        for i, (p, s) in enumerate(zip(self.params, self.sums)):
            g = s / self.accumulate
            if self.decay[i]:
                g = g + self.wd * p
            tr = self.trace[i]
            tr.mul_(mom).add_(g)
            p.add_(g + mom * tr, alpha=-(blr if self.bias[i] else lr))
            s.zero_()
        self.micro = 0
        self.count += 1
        return True


@torch.no_grad()
def ema_update(ema: dict, named_params, updates: int):
    d = 0.9999 * (1.0 - math.exp(-updates / 2000.0))
    for n, p in named_params:
        ema[n].mul_(d).add_(p * (1.0 - d))
