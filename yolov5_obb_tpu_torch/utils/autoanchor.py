"""AutoAnchor: the anchors' fit check and their k-means + genetic
evolution, on the rotated boxes' (long, short) edges.

Counterpart of ``yolov5_obb_tpu/utils/autoanchor.py`` (reference
utils/autoanchor.py:20-197), numpy and scipy.  ``dataset_wh`` reads each
image's size through OpenCV, imported inside it.  ``check_anchors``
returns the anchors the run keeps; the train CLI writes them into the
model's meta and every checkpoint's ``meta.json``.
"""

from __future__ import annotations

import numpy as np

from ..ops.geometry import poly2rbox


def _metric(wh: np.ndarray, anchors: np.ndarray):
    """Per box and anchor the worse of the two edge ratios, and each box's
    best (reference autoanchor.py:40-46)."""
    r = wh[:, None] / anchors[None]  # (n, k, 2)
    x = np.minimum(r, 1 / r).min(2)
    return x, x.max(1)


def anchor_fitness(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0):
    """Mean best ratio over the boxes that pass 1/thr (reference
    autoanchor.py:83-90)."""
    _, best = _metric(wh, anchors)
    return float((best * (best > 1.0 / thr)).mean())


def best_possible_recall(wh: np.ndarray, anchors: np.ndarray,
                         thr: float = 4.0):
    """``(bpr, aat)``: the share of boxes some anchor fits within ``thr``,
    and the mean count of anchors that fit a box."""
    x, best = _metric(wh, anchors)
    aat = float((x > 1 / thr).sum(1).mean())
    bpr = float((best > 1 / thr).mean())
    return bpr, aat


def dataset_wh(dataset, img_size: int | None = None):
    """The (l, s) edges of every rbox of ``dataset`` (a ``DotaDataset``),
    scaled as training loads them (long side → ``img_size``)."""
    import cv2

    whs = []
    img_size = img_size or dataset.img_size
    for i, polys in enumerate(dataset.polys):
        if not len(polys):
            continue
        img = cv2.imread(dataset.img_files[i])
        if img is None:
            continue
        r = img_size / max(img.shape[:2])
        rb = poly2rbox(polys.astype(np.float64) * r)
        whs.append(rb[:, 2:4])
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def kmean_anchors(wh: np.ndarray, n: int = 9, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0, verbose: bool = False):
    """k-means start, then ``gen`` generations of mutation keeping the
    fitter anchors (reference autoanchor.py:83-197); ``(n, 2)`` anchors
    sorted by area.  Boxes with both edges under 2 px are left out."""
    from scipy.cluster.vq import kmeans

    rng = np.random.default_rng(seed)
    wh = wh[(wh >= 2.0).any(1)]
    if len(wh) < n:
        raise ValueError(f"need ≥{n} boxes for {n} anchors, have {len(wh)}")

    s = wh.std(0)
    k, _ = kmeans(wh / s, n, iter=30, seed=seed)
    if len(k) != n:  # k-means may merge clusters: quantiles instead
        k = np.quantile(wh / s, np.linspace(0.05, 0.95, n), axis=0)
    k *= s

    f = anchor_fitness(wh, k, thr)
    shape = k.shape
    mp, sigma = 0.9, 0.1  # mutation probability and scale (reference :180)
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = ((rng.random(shape) < mp) * rng.random()
                 * rng.normal(1, sigma, shape)).clip(0.3, 3.0)
            v[v == 0] = 1
        kg = (k * v).clip(2.0, None)
        fg = anchor_fitness(wh, kg, thr)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        bpr, aat = best_possible_recall(wh, k, thr)
        print(f"autoanchor: fitness={f:.4f} bpr={bpr:.4f} aat={aat:.2f}")
    return k


def check_anchors(dataset, meta, thr: float = 4.0, imgsz: int = 1024,
                  bpr_threshold: float = 0.98, evolve_gen: int = 1000):
    """The best possible recall of ``meta.anchors_px`` on ``dataset``;
    below ``bpr_threshold`` new anchors are evolved and kept if their
    recall is higher (reference autoanchor.py:30-80).  Returns the anchors
    ``(nl, na, 2)`` in input pixels."""
    wh = dataset_wh(dataset, imgsz)
    if not len(wh):
        return meta.anchors_px
    anchors = meta.anchors_px.reshape(-1, 2)
    bpr, aat = best_possible_recall(wh, anchors, thr)
    print(f"autoanchor: BPR={bpr:.4f}, anchors/target={aat:.2f}")
    if bpr > bpr_threshold:
        return meta.anchors_px
    print("autoanchor: BPR below threshold, evolving new anchors...")
    try:
        new = kmean_anchors(wh, n=anchors.shape[0], thr=thr, gen=evolve_gen,
                            verbose=True)
    except ValueError as e:  # too few boxes for the anchors
        print(f"autoanchor failed: {e}")
        return meta.anchors_px
    new_bpr, _ = best_possible_recall(wh, new, thr)
    if new_bpr > bpr:
        return new.reshape(meta.anchors_px.shape)
    return meta.anchors_px
