"""Event-hook registry of the train CLI (reference utils/callbacks.py:7-77;
``yolov5_obb_tpu/utils/callbacks.py``)."""

from __future__ import annotations


class Callbacks:
    """String-keyed training event bus: ``register_action(hook, name,
    callback)``, then ``run(hook, **kwargs)`` calls each in order."""

    EVENTS = (
        "on_pretrain_routine_start", "on_pretrain_routine_end",
        "on_train_start", "on_train_epoch_start", "on_train_batch_start",
        "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
        "on_train_epoch_end", "on_val_start", "on_val_batch_start",
        "on_val_image_end", "on_val_batch_end", "on_val_end",
        "on_fit_epoch_end", "on_model_save", "on_train_end",
    )

    def __init__(self):
        self._handlers = {e: [] for e in self.EVENTS}

    def register_action(self, hook: str, name: str = "", callback=None):
        if hook not in self._handlers:
            raise ValueError(f"unknown hook {hook!r}; valid: {self.EVENTS}")
        if not callable(callback):
            raise TypeError(f"callback for {hook!r} is not callable")
        self._handlers[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: str | None = None):
        return self._handlers[hook] if hook else self._handlers

    def run(self, hook: str, *args, **kwargs):
        for h in self._handlers.get(hook, []):
            h["callback"](*args, **kwargs)
