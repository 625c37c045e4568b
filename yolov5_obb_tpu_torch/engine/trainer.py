"""Train state and the single-device train step.

Counterpart of ``yolov5_obb_tpu/engine/trainer.py`` (``TrainState`` :24,
``create_train_state`` :33, ``make_train_step`` :75).  The parameters and the
BatchNorm statistics live in the model; the state holds the optimizer
state, the EMA of the parameters and the counters, and gives and takes its
tensors for the checkpoint (``utils/checkpoint.py``).  The step runs eagerly
on the model's device and updates everything in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import resolve_device
from .optim import OptState, Optimizer, ema_update


@dataclasses.dataclass
class TrainState:
    """``ema``: the parameters' exponential moving average by name (the
    BatchNorm statistics are not averaged); ``ema_updates``: its update
    count; ``step``: micro-batch steps taken."""

    opt_state: OptState
    ema: dict
    ema_updates: int = 0
    step: int = 0

    _LISTS = ("acc", "trace", "mu", "nu")

    def state_dict(self) -> dict:
        """The state as plain tensors, lists and ints (no copies)."""
        o = self.opt_state
        return {"ema": dict(self.ema), "ema_updates": int(self.ema_updates),
                "step": int(self.step),
                "opt_state": {"count": int(o.count),
                              "mini_step": int(o.mini_step),
                              **{k: list(getattr(o, k)) for k in self._LISTS}}}

    def ema_state_dict(self, model) -> dict:
        """``model``'s ``state_dict`` with the EMA in place of its
        parameters: the BatchNorm buffers are the live ones, as the JAX
        package evaluates and saves ``ema_params`` with ``batch_stats``."""
        return {**model.state_dict(), **self.ema}

    @torch.no_grad()
    def load_state_dict(self, d: dict) -> None:
        """Copy a :meth:`state_dict` (of the same model and optimizer) into
        this state's tensors, on their devices."""
        if d["ema"].keys() != self.ema.keys():
            raise KeyError("the checkpoint's EMA names differ from the "
                           "model's")
        for k, v in d["ema"].items():
            self.ema[k].copy_(v)
        o, so = self.opt_state, d["opt_state"]
        for k in self._LISTS:
            mine, theirs = getattr(o, k), so[k]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state {k!r}: {len(theirs)} "
                                 f"tensors saved, {len(mine)} expected "
                                 "(another optimizer?)")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        o.count, o.mini_step = int(so["count"]), int(so["mini_step"])
        self.step, self.ema_updates = int(d["step"]), int(d["ema_updates"])


def create_train_state(optimizer: Optimizer) -> TrainState:
    return TrainState(
        opt_state=optimizer.init(),
        ema={n: p.detach().clone()
             for n, p in zip(optimizer.names, optimizer.params)})


def make_train_step(model, loss_fn, optimizer: Optimizer, use_ema: bool = True,
                    mesh=None, remat=False, device=None):
    """The train step ``step(state, image, targets, t_mask) -> metrics``.

    ``image``: the packed ``(B, H, 3W)`` uint8 view for a packed-stem model
    (the /255 is folded into the stem weights), an NHWC uint8 batch
    otherwise; ``targets (B, M, 186)`` float32 and ``t_mask (B, M)`` bool.
    The batch is moved to ``device`` (the card unless ``device="cpu"``), where
    the model must be.  The step runs the model in train mode, the loss
    ``loss_fn(maps, targets, t_mask) -> (total, items)``, the backward
    pass, the optimizer (an update every ``accumulate`` steps) and the EMA.
    A model built with ``packed_stem`` and ``fused_train`` runs its layers
    0-3 in train mode as the fused pass chain (``models/yolo.py``).
    ``metrics`` holds ``loss`` and the ``(4,)`` ``items`` as device tensors:
    reading them synchronises, so read them only when needed.

    ``remat`` and ``mesh`` (data-parallel) are not ported yet."""
    if remat:
        raise NotImplementedError("rematerialisation (remat) is not ported "
                                  "yet")
    if mesh is not None:
        raise NotImplementedError("the data-parallel step (mesh) is not "
                                  "ported yet")
    dev = resolve_device(device)
    params = list(optimizer.params)

    def step(state: TrainState, image, targets, t_mask):
        image, targets, t_mask = (t.to(dev, non_blocking=True)
                                  for t in (image, targets, t_mask))
        x = image if image.dim() == 3 else image.float() / 255.0
        training = model.training
        model.train()
        try:
            maps = model(x)
            total, items = loss_fn(maps, targets, t_mask)
            grads = torch.autograd.grad(total, params)
        finally:
            model.train(training)
        optimizer.apply(state.opt_state, grads)
        if use_ema:
            state.ema_updates += 1
            ema_update(state.ema.values(), params, state.ema_updates)
        state.step += 1
        return {"loss": total.detach(), "items": items.detach()}

    return step
