"""Plain decode, candidate selection and exact greedy rotated NMS.

Decoding (YOLOv5-OBB): ``xy = (2σ - 0.5 + cell) · stride``, ``wh = (2σ)² ·
anchor``, ``obj = σ``, ``conf = σ(cls) · obj``, θ = ``(argmax bin - 90)°``.
Selection: the best class of each box with ``conf > thr`` and ``obj > thr``
(single-label), or every (box, class) pair with ``conf > thr``
(multi-label); the top ``max_candidates`` by a stable descending sort (ties
keep the lower anchor, then class, index).  NMS: greedy in score order,
within a class, a box is dropped when a kept box overlaps it by rotated IoU
``> iou_thr``; the rotated IoU is the area of the convex polygon that
clipping one rectangle by the other leaves (Sutherland-Hodgman), in
float64.  Rows are ``[cx cy l s theta conf cls]``; a box has its side
``l`` along ``(cos θ, -sin θ)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def decode(maps, anchors_px, strides, nc: int):
    """Flat maps ``(B, ny*nx*na, no)`` per level → ``(B, N, no)`` float32:
    ``[x y w h obj cls... theta_logits...]`` with the sigmoid applied to
    the first ``5 + nc`` channels and the theta logits left raw."""
    out = []
    for li, p in enumerate(maps):
        B, n, no = p.shape
        na = anchors_px.shape[1]
        side = int(round((n // na) ** 0.5))
        p = p.float().reshape(B, side, side, na, no)
        gy, gx = torch.meshgrid(torch.arange(side, device=p.device),
                                torch.arange(side, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :].float()
        s = torch.sigmoid(p[..., :5 + nc])
        xy = (s[..., 0:2] * 2 - 0.5 + grid) * strides[li]
        wh = (s[..., 2:4] * 2) ** 2 * anchors_px[li].to(p.device)
        out.append(torch.cat([xy, wh, s[..., 4:], p[..., 5 + nc:]], -1)
                   .reshape(B, n, no))
    return torch.cat(out, 1)


def candidates(pred, nc: int, conf_thr: float, max_candidates: int,
               multi_label: bool):
    """``(rb (B, k, 5), scores (B, k), cls (B, k))``, score-sorted, empty
    slots at score 0."""
    obj = pred[..., 4]
    conf = pred[..., 5:5 + nc] * obj[..., None]
    B, N = obj.shape
    if multi_label:
        flat = torch.where(conf > conf_thr, conf, 0.0).reshape(B, N * nc)
        k = min(max_candidates, N * nc)
        sc, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        sc, idx = sc[:, :k], idx[:, :k]
        box, cls = idx // nc, idx % nc
    else:
        best, cid = conf.max(-1)
        gate = torch.where((best > conf_thr) & (obj > conf_thr), best, 0.0)
        k = min(max_candidates, N)
        sc, box = torch.sort(gate, dim=1, descending=True, stable=True)
        sc, box = sc[:, :k], box[:, :k]
        cls = torch.gather(cid, 1, box)
    rows = torch.gather(pred, 1, box[..., None].expand(-1, -1,
                                                        pred.shape[-1]))
    theta = (rows[..., 5 + nc:].argmax(-1).float() - 90.0) / 180.0 * math.pi
    rb = torch.cat([rows[..., :4], theta[..., None]], -1)
    return rb, sc, cls


def corners(rb):
    """``(..., 5)`` float64 rboxes → ``(..., 4, 2)`` corners, counter-
    clockwise in a y-up frame."""
    cx, cy, l, s, t = rb.unbind(-1)
    c, si = torch.cos(t), torch.sin(t)
    ax, ay = l / 2 * c, -l / 2 * si
    bx, by = -s / 2 * si, -s / 2 * c
    xs = torch.stack([cx + ax + bx, cx + ax - bx, cx - ax - bx,
                      cx - ax + bx], -1)
    ys = torch.stack([cy + ay + by, cy + ay - by, cy - ay - by,
                      cy - ay + by], -1)
    return torch.stack([xs, ys], -1)


def _area(poly, count):
    """Shoelace area of ``(P, V, 2)`` polygons whose first ``count``
    vertices are live."""
    V = poly.shape[1]
    idx = torch.arange(V, device=poly.device)
    nxt = torch.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cross = poly[..., 0] * q[..., 1] - poly[..., 1] * q[..., 0]
    live = idx[None] < count[:, None]
    return 0.5 * (cross * live).sum(1).abs()


def _orient(poly):
    """Reorder 4-corner polygons counter-clockwise (positive area)."""
    x, y = poly[..., 0], poly[..., 1]
    signed = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)
    return torch.where((signed < 0)[..., None, None], poly.flip(-2), poly)


def rotated_iou_pairs(a, b):
    """Rotated IoU of ``P`` box pairs ``a, b (P, 5)``, float64: ``a``'s
    rectangle clipped by each of ``b``'s four edges in turn."""
    a, b = a.double(), b.double()
    pa, pb = _orient(corners(a)), _orient(corners(b))
    P = a.shape[0]
    V = 8
    poly = torch.zeros(P, V, 2, dtype=torch.float64, device=a.device)
    poly[:, :4] = pa
    count = torch.full((P,), 4, dtype=torch.long, device=a.device)
    idx = torch.arange(V, device=a.device)
    for e in range(4):
        p0, p1 = pb[:, e], pb[:, (e + 1) % 4]
        d = p1 - p0

        def side(q):  # > 0 inside (left of the counter-clockwise edge)
            return d[:, None, 0] * (q[..., 1] - p0[:, None, 1]) - \
                d[:, None, 1] * (q[..., 0] - p0[:, None, 0])

        nxt = torch.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
        q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
        s0, s1 = side(poly), side(q)
        live = idx[None] < count[:, None]
        in0, in1 = s0 >= 0, s1 >= 0
        t = s0 / torch.where(s0 - s1 == 0, 1.0, s0 - s1)
        cross = poly + t[..., None] * (q - poly)
        # each edge (v, next v) emits v if inside, then the crossing if the
        # edge crosses: at most two points an edge, in order
        emit0 = live & in0
        emit1 = live & (in0 != in1)
        pts = torch.stack([poly, cross], 2).reshape(P, 2 * V, 2)
        keep = torch.stack([emit0, emit1], 2).reshape(P, 2 * V)
        order = torch.sort((~keep).to(torch.uint8), dim=1,
                           stable=True).indices
        pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 2))
        count = keep.sum(1)
        if int(count.max()) > V:
            raise RuntimeError("clipped polygon outgrew its buffer")
        poly = pts[:, :V]
    inter = torch.where(count >= 3, _area(poly, count), 0.0)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    return inter / (area_a + area_b - inter).clamp(min=1e-12)


def _cover(rb):
    cx, cy, l, s, t = rb.unbind(-1)
    c, si = torch.cos(t).abs(), torch.sin(t).abs()
    w, h = l * c + s * si, l * si + s * c
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def greedy_nms(rb, scores, cls, iou_thr: float, chunk: int = 1 << 18):
    """Exact greedy rotated NMS of one image's score-sorted rows (score
    <= 0 is empty) → keep mask ``(k,)`` bool (numpy).  The IoU of every
    pair of live same-class rows whose axis-aligned covers meet (other
    pairs do not overlap) is computed; the sweep runs on the host."""
    live = scores > 0
    n = int(live.sum())
    keep = np.zeros(scores.shape[0], bool)
    if n == 0:
        return keep
    rb, cls = rb[:n].double(), cls[:n]
    cov = _cover(rb)
    ii, jj = torch.triu_indices(n, n, 1, device=rb.device)
    meet = ((cls[ii] == cls[jj])
            & (torch.minimum(cov[ii, 2], cov[jj, 2])
               > torch.maximum(cov[ii, 0], cov[jj, 0]))
            & (torch.minimum(cov[ii, 3], cov[jj, 3])
               > torch.maximum(cov[ii, 1], cov[jj, 1])))
    ii, jj = ii[meet], jj[meet]
    over = []
    for s in range(0, ii.numel(), chunk):
        a, b = ii[s:s + chunk], jj[s:s + chunk]
        hit = rotated_iou_pairs(rb[a], rb[b]) > iou_thr
        over.append(torch.stack([a[hit], b[hit]], 1))
    pairs = torch.cat(over).cpu().numpy() if over else np.zeros((0, 2), int)
    pairs = pairs[np.argsort(pairs[:, 1], kind="stable")]
    starts = np.searchsorted(pairs[:, 1], np.arange(n + 1))
    for j in range(n):
        keep[j] = not keep[pairs[starts[j]:starts[j + 1], 0]].any()
    return keep


def nms(maps, anchors_px, strides, nc: int, conf_thr: float, iou_thr: float,
        max_candidates: int, max_det: int, multi_label: bool):
    """Detections of each image: a list of ``(n_i, 7)`` float64 numpy
    arrays ``[cx cy l s theta conf cls]``, score-sorted, at most
    ``max_det`` rows."""
    pred = decode(maps, anchors_px, strides, nc)
    rb, sc, cls = candidates(pred, nc, conf_thr, max_candidates, multi_label)
    out = []
    for b in range(rb.shape[0]):
        keep = greedy_nms(rb[b], sc[b], cls[b], iou_thr)
        rows = torch.cat([rb[b].double(), sc[b, :, None].double(),
                          cls[b, :, None].double()], -1).cpu().numpy()
        out.append(rows[keep][:max_det])
    return out
