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

from ..models import step_context
from ..utils.device import resolve_device
from ..utils.profiler import span
from .distributed import DataMesh
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
                    mesh: DataMesh | None = None, remat=False, device=None):
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
    reading them synchronises, so read them only when needed.  In a
    ``torch.profiler`` trace a step is the span ``train.step`` holding
    ``train.h2d`` (the batch's copy), ``train.forward``, ``train.loss``,
    ``train.backward`` (``autograd.grad``), ``train.optimizer`` and
    ``train.ema``.

    ``remat`` (JAX trainer.py:75-102):

    - ``True`` / ``"full"``: the forward runs under non-reentrant
      ``torch.utils.checkpoint``s (``autograd.grad`` rules out the
      reentrant one) and again in the backward: one checkpoint a layer of
      the graph (the fused train region is one), so the step keeps the
      layers' inputs and the backward recomputes one layer at a time.  One
      checkpoint over the whole forward would recompute every saved tensor
      at once when the backward starts, which is the stock step's peak;
      the JAX step's single ``jax.checkpoint`` leaves that schedule to
      XLA.  Every forward kernel launches twice a step;
    - ``"selective"``: every conv block's train-mode BatchNorm + SiLU chain
      runs under a checkpoint of its own that keeps its input, the conv
      output, and recomputes the float32 chain in the backward
      (``models/layers._bn_act``); the convs, the kernels and the fused
      train region run as without remat.  The JAX step keeps only
      the conv outputs (its policy recomputes the next conv's input too);
      here the next conv keeps its input for its weight gradient, a tensor
      in the model dtype, and what goes is the chain's float32 tensors.
      A policy over the whole forward (``create_selective_checkpoint_
      contexts``) would see only ATen ops: the ctypes kernels would run
      again in the recompute and their outputs could not be kept.

    Either way the recompute runs BatchNorm in train mode again, which
    updates the running statistics in place: the step keeps them as the
    forward left them and puts them back after the backward, so they move
    once a step, as in the JAX step.

    ``mesh`` (a :class:`~.distributed.DataMesh`, JAX trainer.py:165-196):
    the data-parallel step, one process per card, each fed its slice of the
    global batch (:func:`put_batch`).  At build the parameters and the
    BatchNorm buffers are broadcast from rank 0.  In the step BatchNorm and
    the loss take the global batch (``engine/distributed.py``), the
    gradients are summed over the ranks in one all-reduce per dtype before
    the optimizer, so every rank applies the same update and EMA, and
    ``metrics`` are the global batch's.  Without a process group
    (``distributed.make_mesh``) there is no mesh."""
    if remat not in (False, None, "", True, "full", "selective"):
        raise ValueError(f"remat={remat!r}: expected full or selective")
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a distributed.DataMesh, got "
                        f"{type(mesh).__name__}")
    dev = resolve_device(device)
    params = list(optimizer.params)
    buffers = [b for _, b in model.named_buffers()]
    if mesh is not None:
        mesh.broadcast_([p.data for p in model.parameters()] + buffers)
    mode = "selective" if remat == "selective" else "full" if remat else None

    def step(state: TrainState, image, targets, t_mask):
        with span("train.step"):
            return _step(state, image, targets, t_mask)

    def _step(state: TrainState, image, targets, t_mask):
        with span("train.h2d"):
            image, targets, t_mask = (t.to(dev, non_blocking=True)
                                      for t in (image, targets, t_mask))
        training = model.training
        model.train()
        try:
            with step_context.train_step(mesh, mode):
                with span("train.forward"):
                    x = image if image.dim() == 3 else image.float() / 255.0
                    maps = model(x)
                with span("train.loss"):
                    total, items = loss_fn(maps, targets, t_mask)
                kept = [b.clone() for b in buffers] if remat else None
                with span("train.backward"):
                    grads = torch.autograd.grad(total, params)
        finally:
            model.train(training)
        if kept is not None:  # the recompute's second update undone
            with torch.no_grad():
                for b, k in zip(buffers, kept):
                    b.copy_(k)
        total, items = total.detach(), items.detach()
        if mesh is not None:
            mesh.sum_tensors_(grads)
            mesh.sum_tensors_([total, items])
        with span("train.optimizer"):
            optimizer.apply(state.opt_state, grads)
        if use_ema:
            state.ema_updates += 1
            with span("train.ema"):
                ema_update(state.ema.values(), params, state.ema_updates)
        state.step += 1
        return {"loss": total, "items": items}

    return step


def put_batch(batch, mesh: DataMesh | None = None):
    """This process's rows of a global batch ``(image, targets, t_mask)``:
    all of it without a mesh, else the strided slice ``[rank::world]``, as
    a contiguous copy (the loader's ``order[shard_index::shard_count]``;
    JAX ``put_batch`` :175)."""
    if mesh is None:
        return tuple(batch)
    r, w = mesh.rank, mesh.world
    return tuple(t[r::w].contiguous() for t in batch)
