"""W&B hyperparameter-sweep entry point.

Counterpart of the JAX package's ``tools/sweep.py`` (the reference's
``utils/loggers/wandb/sweep.py``): the W&B sweep agent launches this
program once per trial; ``wandb.config`` carries the sampled
hyperparameters, which split into train options (data, batch size, epochs,
image size, config, weights) and a ``hyp`` override that
:func:`yolov5_obb_tpu_torch.train.run` trains with.  The bundled
``data/configs/sweep.yaml`` is a copy of the JAX package's and names its
program; for this one, give a copy of it the command::

    command: [${env}, ${interpreter}, -m, yolov5_obb_tpu_torch.tools.sweep]

then ``wandb sweep <that copy>`` and ``wandb agent <sweep-id>``.

The in-repo GA (``train --evolve``, ``engine/evolve.py``) covers the same
search without a W&B account.
"""

from __future__ import annotations

# sweep-config keys that go to the train options rather than the hyp dict
_OPT_KEYS = ("data", "batch_size", "epochs", "imgsz", "cfg", "weights")


def sweep():
    import wandb

    from .. import train as train_mod

    wandb.init()
    # the reference reads the private ``_items``; fall back to the public
    # mapping for test doubles and newer clients
    cfg = getattr(wandb.config, "_items", None) or dict(wandb.config)

    opt = train_mod.parse_opt(["--data", str(cfg["data"])], known=True)
    opt.batch_size = int(cfg.get("batch_size", opt.batch_size))
    opt.epochs = int(cfg.get("epochs", opt.epochs))
    opt.imgsz = int(cfg.get("imgsz", opt.imgsz))
    if cfg.get("cfg"):
        opt.cfg = str(cfg["cfg"])
    if cfg.get("weights"):
        opt.weights = str(cfg["weights"])
    opt.nosave = True  # sweeps keep metrics, not checkpoints (as reference)
    opt.wandb = True

    hyp_override = {k: v for k, v in cfg.items() if k not in _OPT_KEYS}
    return train_mod.run(opt, hyp_override=hyp_override)


if __name__ == "__main__":
    sweep()
