"""Drawing helpers and plots: oriented-box annotation, feature-map grids,
the PR and metric curves, the confusion matrix, the label distribution, the
train-batch mosaic, the ``results.csv`` curves and the evolve scatter.

Counterpart of ``yolov5_obb_tpu/utils/plots.py`` (the reference
utils/plots.py and metrics.py plotting).  ``cv2`` and ``matplotlib`` are
imported inside the calls: nothing on the detect, val or train path draws
unless asked to, and a machine without them runs every path but its plots.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_PALETTE = [
    (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
    (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
    (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
    (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
    (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
]


def class_color(i: int):
    return _PALETTE[int(i) % len(_PALETTE)]


def draw_poly(img, poly, label: str | None = None, color=None,
              line_width: int = 2):
    """Draw one oriented box polygon (and its label) on a BGR image in
    place."""
    import cv2

    pts = np.asarray(poly, np.float64).reshape(4, 2).astype(np.int32)
    color = color or (0, 255, 0)
    cv2.drawContours(img, [pts], 0, color, line_width)
    if label:
        x, y = pts[:, 0].min(), pts[:, 1].min() - 4
        cv2.putText(img, label, (int(x), max(int(y), 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return img


def annotate_detections(img, polys, confs, clses, names, line_width=2,
                        hide_conf=False, hide_labels=False):
    """Draw all detections; ``img`` is BGR uint8 (modified in place)."""
    for poly, conf, c in zip(polys, confs, clses):
        name = names[int(c)] if names and int(c) < len(names) else str(int(c))
        label = (None if hide_labels else name if hide_conf
                 else f"{name} {conf:.2f}")
        draw_poly(img, poly, label, class_color(int(c)), line_width)
    return img


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def feature_visualization(x, module_name, save_dir, n_max=32):
    """Save a grid of a layer's feature-map channels (reference
    plots.py:162-186).  ``x``: a ``(B, H, W, C)`` activation (NHWC, as the
    port's layers hand them on; a tensor or an array).  Returns the file,
    or None for an activation that is not a map."""
    plt = _pyplot()
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    x = np.asarray(x, np.float32)
    if x.ndim != 4 or x.shape[1] < 2 or x.shape[2] < 2:
        return None
    ch = min(x.shape[-1], n_max)
    cols = 8
    rows = int(np.ceil(ch / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.4, rows * 1.4))
    for i, ax in enumerate(np.ravel(axes)):
        ax.axis("off")
        if i < ch:
            ax.imshow(x[0, :, :, i], cmap="gray")
    out = Path(save_dir) / f"{module_name}_features.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_pr_curve(px, py, ap, save_path, names=()):
    """PR curves per class (reference metrics.py:305-325)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else py
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_path, names=(), xlabel="Confidence",
                  ylabel="Metric"):
    """Metric-against-confidence curves, e.g. F1, P, R (reference
    metrics.py:328-344)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.atleast_2d(py)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=str(names[i]))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_path, dpi=250)
    plt.close(fig)
    return save_path


def plot_results(csv_path, save_path=None):
    """Loss and metric curves from ``results.csv`` (reference
    plots.py:442-466) → ``results.png`` beside it."""
    import csv

    plt = _pyplot()
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    keys = [k for k in rows[0].keys() if k not in ("epoch", "time_s")]
    epochs = [int(r["epoch"]) for r in rows]
    n = len(keys)
    cols = 5
    rows_n = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows_n, cols, figsize=(3 * cols, 2.5 * rows_n),
                             tight_layout=True)
    axes = np.atleast_1d(axes).ravel()
    for i, k in enumerate(keys):
        vals = [float(r[k]) for r in rows]
        axes[i].plot(epochs, vals, marker=".")
        axes[i].set_title(k, fontsize=8)
    for ax in axes[n:]:
        ax.axis("off")
    save_path = save_path or str(Path(csv_path).with_name("results.png"))
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_labels(rboxes, classes, names, save_dir):
    """Label distribution → ``labels.png``: class histogram, centres,
    long against short side, angle histogram (reference plots.py:392-440,
    simplified)."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(10, 8), tight_layout=True)
    axes[0, 0].hist(classes, bins=max(
        int(classes.max()) + 1 if len(classes) else 1, 1))
    axes[0, 0].set_title("classes")
    if len(rboxes):
        axes[0, 1].scatter(rboxes[:, 0], rboxes[:, 1], s=2, alpha=0.3)
        axes[0, 1].set_title("centers xy")
        axes[1, 0].scatter(rboxes[:, 2], rboxes[:, 3], s=2, alpha=0.3)
        axes[1, 0].set_title("l vs s")
        axes[1, 1].hist(rboxes[:, 4] * 180 / np.pi, bins=36)
        axes[1, 1].set_title("theta (deg)")
    out = Path(save_dir) / "labels.png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_confusion_matrix(matrix, names, save_path, normalize=True):
    """Confusion-matrix heatmap (reference metrics.py:160-190); ``names``
    are the classes, the background row and column are labelled here."""
    plt = _pyplot()
    m = np.asarray(matrix, float)
    if normalize:
        m = m / np.maximum(m.sum(0, keepdims=True), 1e-9)
    labels = list(names) + ["background"]
    fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
    im = ax.imshow(m, cmap="Blues", vmin=0)
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_images(images, targets, target_mask, names, save_path, max_imgs=16):
    """A training batch as a mosaic with its ground-truth boxes drawn as
    polygons (reference plots.py:221-305).

    Args:
        images: (B, H, W, 3) uint8 RGB batch (as the model is fed).
        targets: (B, M, >=6) padded rows ``[cls cx cy l s theta ...]``.
        target_mask: (B, M) bool validity.
        names: class names.
        save_path: the PNG to write.
    """
    import cv2

    from ..ops.geometry import rbox2poly

    images = np.asarray(images)
    b = min(len(images), max_imgs)
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    h, w = images.shape[1:3]
    canvas = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i in range(b):
        r, c = divmod(i, cols)
        img = np.ascontiguousarray(images[i][:, :, ::-1])  # RGB → BGR
        m = np.asarray(target_mask[i], bool)
        t = np.asarray(targets[i])[m]
        if len(t):
            polys = rbox2poly(t[:, 1:6])
            for p, k in zip(polys, t[:, 0]):
                draw_poly(img, p, label=str(names[int(k)]),
                          color=class_color(int(k)))
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(save_path), canvas)
    return save_path


def plot_evolve(evolve_csv, save_path=None):
    """Each hyperparameter against fitness (reference plots.py:442-466)."""
    import csv

    plt = _pyplot()
    with open(evolve_csv) as f:
        rows = list(csv.reader(f))
    header, data = rows[0], np.array([[float(v) for v in r]
                                      for r in rows[1:]])
    if not len(data):
        return None
    fit_idx = (header.index("fitness") if "fitness" in header
               else len(header) - 1)
    fit = data[:, fit_idx]
    hyp_cols = [j for j in range(len(header)) if j != fit_idx]
    n = len(hyp_cols)
    cols = int(np.ceil(np.sqrt(n)))
    fig, axes = plt.subplots(int(np.ceil(n / cols)), cols,
                             figsize=(3 * cols, 3 * np.ceil(n / cols)))
    for ax, j in zip(np.ravel(axes), hyp_cols):
        ax.scatter(data[:, j], fit, c=fit, cmap="viridis", s=16)
        best = data[fit.argmax(), j]
        ax.scatter(best, fit.max(), marker="*", c="r", s=80)
        ax.set_title(f"{header[j]} = {best:.3g}", fontsize=8)
    for ax in np.ravel(axes)[n:]:
        ax.axis("off")
    save_path = save_path or Path(evolve_csv).with_suffix(".png")
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
