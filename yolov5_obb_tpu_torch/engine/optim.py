"""Optimizer: the reference's training recipe, as the JAX package's optax
chain computes it.

Counterpart of ``yolov5_obb_tpu/engine/optim.py`` (``make_schedules`` :53,
``build_optimizer`` :91, EMA :149-156):

* weight decay on conv kernels only (every ``.weight`` with more than one
  dimension, Detect's included), scaled by ``batch_size * accumulate / 64``;
* SGD with Nesterov momentum (dampening 0; optax ``trace(nesterov=True)``
  after ``add_decayed_weights``), or Adam (``scale_by_adam(b1=momentum,
  b2=0.999)``);
* two learning-rate groups: every ``.bias`` (BatchNorm and Detect biases
  alike) follows ``bias_lr_fn``, whose warmup falls from
  ``warmup_bias_lr``; everything else ``lr_fn``;
* one-cycle cosine (or linear) LR stepped per epoch, warmup over
  ``max(warmup_epochs * steps_per_epoch, 100)`` applied updates, momentum
  warmup from ``warmup_momentum``; the schedules count *applied* updates
  from 0;
* accumulation to a nominal batch with ``optax.MultiSteps`` semantics: the
  running mean of k micro-batch gradients, one update every k steps;
* ``freeze`` zeroes the updates of the first N graph layers;
* EMA of the parameters (not of the BatchNorm statistics), decay
  ``0.9999 * (1 - exp(-updates / 2000))``.

Parameters are updated in place under ``torch.no_grad``; the optimizer
state is plain tensors beside them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

DEFAULT_OPT_HYP = {
    "lr0": 0.01,
    "lrf": 0.2,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
}


def one_cycle_factor(epoch: float, epochs: int, lrf: float) -> float:
    """Cosine 1 → lrf factor."""
    return ((1 - math.cos(epoch * math.pi / epochs)) / 2) * (lrf - 1) + 1


def linear_factor(epoch: float, epochs: int, lrf: float) -> float:
    return (1 - epoch / epochs) * (1.0 - lrf) + lrf


def _opt_hyp(hyp: dict) -> dict:
    return {**DEFAULT_OPT_HYP,
            **{k: v for k, v in hyp.items() if k in DEFAULT_OPT_HYP}}


def make_schedules(hyp: dict, epochs: int, steps_per_epoch: int,
                   linear_lr: bool = False):
    """``(lr_fn, bias_lr_fn, momentum_fn)``: callables of the applied-update
    count, in float32 arithmetic as the JAX package computes them."""
    h = _opt_hyp(hyp)
    nw = max(round(h["warmup_epochs"] * steps_per_epoch), 100)
    factor = linear_factor if linear_lr else one_cycle_factor
    f32 = np.float32
    lf = np.array([factor(e, epochs, h["lrf"]) for e in range(epochs + 1)],
                  f32)

    def target_lr(step):
        return f32(h["lr0"]) * lf[min(step // steps_per_epoch, epochs)]

    def warm(step):
        return f32(np.clip(f32(step) / f32(nw), 0.0, 1.0))

    def lr_fn(step: int) -> float:
        t = target_lr(step)
        return float(warm(step) * t if step < nw else t)

    def bias_lr_fn(step: int) -> float:
        t = target_lr(step)
        b = f32(h["warmup_bias_lr"])
        return float(b + warm(step) * (t - b) if step < nw else t)

    def momentum_fn(step: int) -> float:
        m0, m1 = f32(h["warmup_momentum"]), f32(h["momentum"])
        return float(m0 + warm(step) * (m1 - m0) if step < nw else m1)

    return lr_fn, bias_lr_fn, momentum_fn


@dataclasses.dataclass
class OptState:
    """``count``: applied updates (the schedules' step); ``mini_step``:
    micro-batches accumulated toward the next update; ``acc``: their running
    mean; ``trace`` (SGD) or ``mu``/``nu`` (Adam): per-parameter moments."""

    count: int = 0
    mini_step: int = 0
    acc: list = dataclasses.field(default_factory=list)
    trace: list = dataclasses.field(default_factory=list)
    mu: list = dataclasses.field(default_factory=list)
    nu: list = dataclasses.field(default_factory=list)


class Optimizer:
    """The optax chain ``masked(add_decayed_weights) → trace(nesterov) |
    scale_by_adam → per-group -lr schedule → masked(set_to_zero)``, wrapped
    in ``MultiSteps`` when ``accumulate > 1``.

    ``names`` and ``params`` are the model's ``named_parameters``;
    :meth:`init` makes the state, :meth:`apply` takes one micro-batch's
    gradients and updates the parameters in place when an update is due."""

    def __init__(self, named_params, hyp: dict, epochs: int,
                 steps_per_epoch: int, batch_size: int,
                 nominal_batch: int = 64, linear_lr: bool = False,
                 use_adam: bool = False, freeze: int = 0):
        h = _opt_hyp(hyp)
        self.names, self.params = zip(*named_params)
        self.accumulate = max(round(nominal_batch / batch_size), 1)
        self.weight_decay = (h["weight_decay"] * batch_size * self.accumulate
                             / nominal_batch)
        self.lr_fn, self.bias_lr_fn, self.momentum_fn = make_schedules(
            hyp, epochs, steps_per_epoch, linear_lr)
        self.use_adam = use_adam
        self.b1 = h["momentum"]
        self.decay = [n.endswith(".weight") and p.dim() > 1
                      for n, p in zip(self.names, self.params)]
        self.is_bias = [n.endswith(".bias") for n in self.names]
        frozen = {f"model.{i}." for i in range(freeze)}
        self.frozen = [any(n.startswith(f) for f in frozen) for n in self.names]

    def init(self) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        if self.use_adam:
            return OptState(acc=zeros(), mu=zeros(), nu=zeros())
        return OptState(acc=zeros(), trace=zeros())

    @torch.no_grad()
    def apply(self, state: OptState, grads) -> bool:
        """Fold one micro-batch's ``grads`` (one per parameter) into
        ``state``; on every ``accumulate``-th call update the parameters.
        Returns whether they were updated."""
        n = state.mini_step
        if self.accumulate > 1:
            for a, g in zip(state.acc, grads):  # running mean (Welford)
                a.add_((g - a) / (n + 1))
            grads = state.acc
        if n + 1 < self.accumulate:
            state.mini_step = n + 1
            return False
        c = state.count
        lrs = (self.lr_fn(c), self.bias_lr_fn(c))
        m = self.momentum_fn(c)
        b2, eps = 0.999, 1e-8
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.decay[i]:
                g = g + self.weight_decay * p
            if self.use_adam:
                mu, nu = state.mu[i], state.nu[i]
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - b2) * g * g + b2 * nu)
                u = ((mu / (1 - self.b1 ** (c + 1)))
                     / (torch.sqrt(nu / (1 - b2 ** (c + 1))) + eps))
            else:
                tr = state.trace[i]
                tr.copy_(g + m * tr)
                u = g + m * tr
            if not self.frozen[i]:
                p.add_(u * -lrs[self.is_bias[i]])
        if self.accumulate > 1:
            for a in state.acc:
                a.zero_()
        state.count = c + 1
        state.mini_step = 0
        return True


def build_optimizer(model, hyp: dict, epochs: int, steps_per_epoch: int,
                    batch_size: int, nominal_batch: int = 64,
                    linear_lr: bool = False, use_adam: bool = False,
                    freeze: int = 0):
    """``(optimizer, info)`` for ``model``'s parameters; ``info`` holds
    ``accumulate``, ``weight_decay`` and ``lr_fn`` as the JAX function's
    does."""
    opt = Optimizer(model.named_parameters(), hyp, epochs, steps_per_epoch,
                    batch_size, nominal_batch, linear_lr, use_adam, freeze)
    return opt, {"accumulate": opt.accumulate,
                 "weight_decay": opt.weight_decay, "lr_fn": opt.lr_fn}


def ema_decay(updates: int) -> float:
    """Ramped EMA decay."""
    return 0.9999 * (1.0 - math.exp(-updates / 2000.0))


@torch.no_grad()
def ema_update(ema_params, params, updates: int) -> None:
    """``ema = ema·d + p·(1 - d)`` in place, ``d = ema_decay(updates)``."""
    d = ema_decay(updates)
    for e, p in zip(ema_params, params):
        e.mul_(d).add_(p.to(e.dtype) * (1.0 - d))
