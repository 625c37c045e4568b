"""Exact rotated-box IoU in plain PyTorch.

Two formulations of the same quantity, each mirroring its JAX counterpart:

* :func:`rotated_iou` — the 24-candidate-point clipper with ``atan2``
  ordering (JAX ``ops/rotated_iou.py``), elementwise over broadcast boxes;
* :func:`pairs_iou_math` — the pair formulation of the JAX IoU kernel
  (``ops/pallas/iou_kernel._pairs_iou_math``): crossings compacted to two per
  edge, a pseudo-angle ordering and the shoelace area.  It is
  :func:`pairs_iou_records` on the per-box :func:`box_records_plain`: the
  plain version of ``riou_pair`` and ``riou_record`` in
  ``csrc/rotated_iou.cuh``, which the neighbour and pair-IoU kernels call,
  operation for operation.

Boxes are ``(..., 5)`` float32 ``[cx cy l s theta]``.
"""

from __future__ import annotations

import torch

from .geometry import hbb_cover

_EPS = 1e-8
# the fields of a box record (csrc/rotated_iou.cuh, riou_record and its
# kRec* offsets): the pair IoU reads the first six and the area, the
# neighbour scan the cover, the area and the class and valid bits
RECORD_FIELDS = ("cx", "cy", "a1x", "a1y", "b1x", "b1y", "-", "-",
                 "x1", "y1", "x2", "y2", "area", "cls", "valid", "-")
REC_HALVES, REC_COVER = slice(2, 6), slice(8, 12)
REC_AREA, REC_CLS, REC_VALID = 12, 13, 14


def _halves(l, s, t):
    """Half vectors ``a = l/2·(cos t, -sin t)`` (long edge) and ``b =
    s/2·(-sin t, -cos t)`` (short edge)."""
    ct, st = torch.cos(t), torch.sin(t)
    return l * 0.5 * ct, -l * 0.5 * st, -s * 0.5 * st, -s * 0.5 * ct


def _corners(cx, cy, a1x, a1y, b1x, b1y):
    """Corners ``c+a+b, c+a-b, c-a-b, c-a+b`` → x, y each ``(..., 4)``."""
    vx = torch.stack([cx + a1x + b1x, cx + a1x - b1x, cx - a1x - b1x,
                      cx - a1x + b1x], -1)
    vy = torch.stack([cy + a1y + b1y, cy + a1y - b1y, cy - a1y - b1y,
                      cy - a1y + b1y], -1)
    return vx, vy


def _vertices(cx, cy, l, s, t):
    return _corners(cx, cy, *_halves(l, s, t))


def box_records_plain(boxes, class_ids=None, valid=None):
    """The records of boxes ``(..., 5)`` (``RECORD_FIELDS``; class 0 and
    all valid where not given): the work of a box that does not depend on
    its partner, the plain version of ``riou_record``."""
    boxes = boxes.float()
    cx, cy, l, s, t = boxes.unbind(-1)
    cls = (torch.zeros_like(cx, dtype=torch.int32) if class_ids is None
           else class_ids.to(torch.int32))
    ok = (torch.ones_like(cx, dtype=torch.int32) if valid is None
          else valid.to(torch.int32))
    zero = torch.zeros_like(cx)
    return torch.cat([torch.stack([cx, cy, *_halves(l, s, t), zero, zero],
                                  -1), hbb_cover(boxes), torch.stack(
        [l * s, cls.view(torch.float32), ok.view(torch.float32), zero], -1)],
        -1)


def record_cover_area(rec: torch.Tensor) -> torch.Tensor:
    """The neighbour scan's edge inputs of box records: ``(..., 16)`` →
    ``(..., 5)`` cover x1 y1 x2 y2 and area."""
    return torch.cat([rec[..., REC_COVER], rec[..., REC_AREA, None]], -1)


def _nxt(v):
    return torch.roll(v, -1, dims=-1)


def _crossings(pax, pay, pbx, pby):
    """Edge-edge crossings of quads A and B: ``t``, ``hit`` and the points,
    each ``(..., 4 A-edges, 4 B-edges)``."""
    rx = (_nxt(pax) - pax)[..., :, None]
    ry = (_nxt(pay) - pay)[..., :, None]
    sx = (_nxt(pbx) - pbx)[..., None, :]
    sy = (_nxt(pby) - pby)[..., None, :]
    qpx = pbx[..., None, :] - pax[..., :, None]
    qpy = pby[..., None, :] - pay[..., :, None]
    denom = rx * sy - ry * sx
    ok = denom.abs() > _EPS
    safe = torch.where(ok, denom, torch.ones_like(denom))
    t = (qpx * sy - qpy * sx) / safe
    u = (qpx * ry - qpy * rx) / safe
    hit = ok & (t >= -_EPS) & (t <= 1 + _EPS) & (u >= -_EPS) & (u <= 1 + _EPS)
    crx = pax[..., :, None] + t * rx
    cry = pay[..., :, None] + t * ry
    return t, hit, crx, cry


def _inside(px, py, qx, qy):
    """``(..., 4)`` mask: each point of p inside convex quad q, either
    winding (all edge cross products share a sign, 1e-5 slack)."""
    ex = (_nxt(qx) - qx)[..., :, None]  # (..., edges, 1)
    ey = (_nxt(qy) - qy)[..., :, None]
    dx = px[..., None, :] - qx[..., :, None]  # (..., edges, points)
    dy = py[..., None, :] - qy[..., :, None]
    c = ex * dy - ey * dx
    return (c.amin(-2) >= -1e-5) | (c.amax(-2) <= 1e-5)


def _shoelace(ptx, pty, order, n):
    """Area of the ring ``pt[order]`` whose first ``n`` entries are valid;
    the tail repeats the first point (zero-length edges)."""
    rx = torch.gather(ptx, -1, order)
    ry = torch.gather(pty, -1, order)
    k = torch.arange(ptx.shape[-1], device=ptx.device)
    valid_k = k < n[..., None]
    rx = torch.where(valid_k, rx, rx[..., :1])
    ry = torch.where(valid_k, ry, ry[..., :1])
    area2 = torch.sum(rx * _nxt(ry) - ry * _nxt(rx), -1)
    return torch.where(n >= 3, 0.5 * area2.abs(), torch.zeros_like(area2))


def rotated_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise exact IoU of broadcast-compatible rboxes (24 candidate
    points, ``atan2`` order)."""
    boxes1, boxes2 = torch.broadcast_tensors(boxes1, boxes2)
    mid = (boxes1[..., :2] + boxes2[..., :2]) / 2
    a = torch.cat([boxes1[..., :2] - mid, boxes1[..., 2:]], -1)
    b = torch.cat([boxes2[..., :2] - mid, boxes2[..., 2:]], -1)
    pax, pay = _vertices(*a.unbind(-1))
    pbx, pby = _vertices(*b.unbind(-1))
    _, hit, crx, cry = _crossings(pax, pay, pbx, pby)
    lead = hit.shape[:-2]
    ptx = torch.cat([crx.reshape(lead + (16,)), pax, pbx], -1)
    pty = torch.cat([cry.reshape(lead + (16,)), pay, pby], -1)
    mask = torch.cat([hit.reshape(lead + (16,)), _inside(pax, pay, pbx, pby),
                      _inside(pbx, pby, pax, pay)], -1)
    n = mask.sum(-1)
    w = mask.to(ptx.dtype)
    denom = n.clamp(min=1).to(ptx.dtype)
    cx = (ptx * w).sum(-1) / denom
    cy = (pty * w).sum(-1) / denom
    ang = torch.atan2(pty - cy[..., None], ptx - cx[..., None])
    ang = torch.where(mask, ang, torch.full_like(ang, 10.0))
    order = torch.sort(ang, dim=-1, stable=True).indices
    inter = _shoelace(ptx, pty, order, n)
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / torch.clamp(area1 + area2 - inter, min=_EPS)


def pairs_iou_math(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact IoU of box pairs ``a[..., :], b[..., :]`` (``(..., 5)`` each,
    same shape) — the mirror of the JAX kernel's math."""
    return pairs_iou_records(box_records_plain(a), box_records_plain(b))


def pairs_iou_records(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """Exact IoU of the boxes whose records (``(..., 16)``, the fields of
    :func:`box_records_plain`) are ``ra`` and ``rb`` — the plain version of
    ``riou_pair`` in ``csrc/rotated_iou.cuh``."""
    ptx, pty, mask = candidate_points(ra, rb)
    n = mask.sum(-1)
    w = mask.to(ptx.dtype)
    inv_n = 1.0 / n.clamp(min=1).to(ptx.dtype)
    cx = (ptx * w).sum(-1) * inv_n
    cy = (pty * w).sum(-1) * inv_n
    # pseudo-angle, monotone in the true angle around (cx, cy)
    dx = ptx - cx[..., None]
    dy = pty - cy[..., None]
    tt = dy / torch.clamp(dx.abs() + dy.abs(), min=_EPS)
    ang = torch.where(dx >= 0, tt, 2.0 - tt)
    ang = torch.where(mask, ang, torch.full_like(ang, 10.0))
    order = torch.sort(ang, dim=-1, stable=True).indices
    inter = _shoelace(ptx, pty, order, n)
    return inter / torch.clamp(ra[..., REC_AREA] + rb[..., REC_AREA] - inter,
                               min=_EPS)


def candidate_points(ra: torch.Tensor, rb: torch.Tensor):
    """The 16 candidate points of the intersection of the boxes whose
    records are ``ra`` and ``rb``: x, y and a mask of the points in the
    ring, each ``(..., 16)`` (two crossings per edge of A, A's vertices,
    B's vertices)."""
    ax, ay, aax, aay, abx, aby = ra[..., :6].unbind(-1)
    bx, by, bax, bay, bbx, bby = rb[..., :6].unbind(-1)
    mx = (ax + bx) * 0.5
    my = (ay + by) * 0.5
    pax, pay = _corners(ax - mx, ay - my, aax, aay, abx, aby)
    pbx, pby = _corners(bx - mx, by - my, bax, bay, bbx, bby)
    t, hit, crx, cry = _crossings(pax, pay, pbx, pby)

    # at most two crossings per A-edge: the min-t and max-t hits (averaged
    # over exact ties, which only identical points produce)
    big = torch.full_like(t, 1e30)
    tv = torch.where(hit, t, big)
    tw = torch.where(hit, t, -big)
    oh0 = (tv == tv.amin(-1, keepdim=True)) & hit
    oh1 = (tw == tw.amax(-1, keepdim=True)) & hit
    n0 = oh0.sum(-1).clamp(min=1).to(t.dtype)
    n1 = oh1.sum(-1).clamp(min=1).to(t.dtype)
    zero = torch.zeros_like(crx)
    x0 = torch.where(oh0, crx, zero).sum(-1) / n0
    y0 = torch.where(oh0, cry, zero).sum(-1) / n0
    x1 = torch.where(oh1, crx, zero).sum(-1) / n1
    y1 = torch.where(oh1, cry, zero).sum(-1) / n1
    cnt = hit.sum(-1)

    ptx = torch.cat([x0, x1, pax, pbx], -1)  # (..., 16)
    pty = torch.cat([y0, y1, pay, pby], -1)
    mask = torch.cat([cnt >= 1, cnt >= 2, _inside(pax, pay, pbx, pby),
                      _inside(pbx, pby, pax, pay)], -1)
    return ptx, pty, mask
