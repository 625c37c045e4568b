"""The context of the train step in progress: its data-parallel mesh and
its remat mode, which BatchNorm's train path, the fused train region, the
forward and the loss read.

``engine/trainer.make_train_step`` sets both for its forward, loss and
backward (:func:`train_step`).  They are process state, not context
variables, because the autograd engine runs the backward (and a
rematerialised forward) on threads of its own.

The mesh is an ``engine/distributed.DataMesh``; this module only holds it,
so the model layer imports nothing of the engine.
"""

from __future__ import annotations

import contextlib

_MESH = None
_REMAT = None


@contextlib.contextmanager
def train_step(mesh=None, remat=None):
    """Make ``mesh`` (a ``DataMesh`` or None) and ``remat`` (None, "full"
    or "selective") the step in progress for the block."""
    global _MESH, _REMAT
    prev = _MESH, _REMAT
    _MESH, _REMAT = mesh, remat
    try:
        yield
    finally:
        _MESH, _REMAT = prev


def mesh():
    """The data-parallel mesh of the step in progress, or None."""
    return _MESH


def remat():
    """The remat mode of the step in progress, or None: "full" runs each
    layer of the graph under a checkpoint (``models/yolo.py``),
    "selective" every conv block's train-mode BatchNorm + SiLU chain
    (``models/layers._bn_act``)."""
    return _REMAT
