"""Training loggers: CSV, TensorBoard and (opt-in) Weights & Biases.

Counterpart of ``yolov5_obb_tpu/utils/loggers.py`` (reference
utils/loggers/__init__.py:37-175), with the same metric keys and the same
``results.csv`` header and rows.  TensorBoard writes through
``torch.utils.tensorboard`` when it imports (the JAX package tries
``tensorflow``); W&B starts only when asked for and importable, and
``wandb`` is imported inside the calls that need it: the validation
images with their predicted boxes as a table a epoch, the model and
dataset artifacts, and ``wandb-artifact://`` references as weights
(:func:`resolve_wandb_artifact`).
"""

from __future__ import annotations

import csv
from pathlib import Path

LOSS_KEYS = ("train/box_loss", "train/obj_loss", "train/cls_loss",
             "train/theta_loss")
METRIC_KEYS = ("metrics/precision", "metrics/recall", "metrics/HBBmAP.5",
               "metrics/HBBmAP.5:.95")
LR_KEY = "x/lr0"


class Loggers:
    def __init__(self, save_dir, include=("csv", "tb"), hyp=None, opt=None):
        self.save_dir = Path(save_dir)
        self.csv_path = self.save_dir / "results.csv"
        self.keys = [*LOSS_KEYS, *METRIC_KEYS, "fitness", LR_KEY]
        self.csv = "csv" in include
        self.tb = None
        self.wandb = None
        if "tb" in include:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.save_dir / "tb"))
            except ImportError:  # tensorboard is not installed
                self.tb = None
        if "wandb" in include:
            try:
                import wandb

                self.wandb = wandb.init(
                    project="yolov5_obb_tpu", dir=str(self.save_dir),
                    config={"hyp": hyp, "opt": vars(opt) if opt else None})
            except ImportError:
                self.wandb = None

    def log_epoch(self, epoch: int, values: dict):
        """One row of ``values`` keyed by ``self.keys`` (missing → 0)."""
        row = {k: float(values.get(k, 0.0)) for k in self.keys}
        if self.csv:
            new = not self.csv_path.exists()
            with open(self.csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["epoch", *self.keys])
                w.writerow([epoch, *(f"{row[k]:.6f}" for k in self.keys)])
        if self.tb is not None:
            for k, v in row.items():
                self.tb.add_scalar(k, v, epoch)
            self.tb.flush()
        if self.wandb is not None:
            self.wandb.log(row, step=epoch)

    def log_model_artifact(self, ckpt_dir, epoch: int, fitness: float = 0.0,
                           best: bool = False):
        """Version a checkpoint directory as a W&B artifact (reference
        wandb_utils.py:404-419); nothing without W&B."""
        if self.wandb is None:
            return
        import wandb

        art = wandb.Artifact(f"run_{self.wandb.id}_model", type="model",
                             metadata={"epoch": epoch,
                                       "fitness": float(fitness)})
        art.add_dir(str(ckpt_dir))
        aliases = ["latest", f"epoch{epoch}"] + (["best"] if best else [])
        self.wandb.log_artifact(art, aliases=aliases)

    def log_val_predictions(self, epoch: int, detections, names,
                            max_images: int = 16):
        """A W&B table of the first ``max_images`` validation images with
        their predicted boxes drawn on them (JAX loggers.py:85-114; the
        reference's val prediction tables, wandb_utils.py:138-252): W&B
        overlays axis-aligned boxes only, so the rotated polygons are drawn
        into the image.  ``detections``: ``evaluate``'s per-image records
        (path, polys, conf, cls, hw); an unreadable image is skipped.
        Nothing without W&B."""
        if self.wandb is None or not detections:
            return
        import numpy as np
        import wandb

        from . import image_io
        from .plots import annotate_detections

        table = wandb.Table(
            columns=["epoch", "id", "prediction", "n_det", "avg_conf"])
        for d in detections[:max_images]:
            img = image_io.imread(d["path"])
            if img is None:
                continue
            conf = np.asarray(d["conf"], np.float32)
            annotate_detections(img, d["polys"], conf, d["cls"], list(names))
            table.add_data(epoch, Path(d["path"]).stem,
                           wandb.Image(img[..., ::-1]),  # BGR → RGB
                           int(len(conf)),
                           float(conf.mean()) if len(conf) else 0.0)
        self.wandb.log({"val/predictions": table}, step=epoch)

    def log_dataset_artifact(self, data_yaml):
        """Version the dataset yaml as a W&B artifact (reference
        wandb_utils.py:192-238); nothing without W&B."""
        if self.wandb is None:
            return
        import wandb

        art = wandb.Artifact(f"run_{self.wandb.id}_dataset", type="dataset")
        art.add_file(str(data_yaml))
        self.wandb.log_artifact(art)

    def finish(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()


def resolve_wandb_artifact(path) -> str:
    """``wandb-artifact://entity/project/name:alias`` → the directory W&B
    downloads it to (JAX loggers.py:132-143; reference
    wandb_utils.py:68-80); any other path as it is.  Without ``wandb``
    such a reference raises ``ImportError``."""
    prefix = "wandb-artifact://"
    if not str(path).startswith(prefix):
        return path
    import wandb

    return wandb.Api().artifact(str(path)[len(prefix):]).download()
