"""Batched host-side data loading for training and evaluation.

Counterpart of ``yolov5_obb_tpu/data/loader.py`` (``Batch`` :20, ``_stack``
:29, ``create_dataloader`` :40).  Collation is a fixed-shape stack (the
targets are padded per sample), so the batches never change shape.  In
place of the JAX package's Grain workers, a :class:`WorkerPool` runs a
``torch.utils.data.DataLoader``'s worker processes, started once and kept
for every epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class Batch:
    image: np.ndarray  # (B, H, W, 3) uint8 RGB
    targets: np.ndarray  # (B, M, 186) float32
    target_mask: np.ndarray  # (B, M) bool
    index: np.ndarray  # (B,) int32
    orig_hw: np.ndarray | None = None  # (B, 2) int32, eval only

    def _map(self, fn) -> "Batch":
        return Batch(**{f.name: None if (v := getattr(self, f.name)) is None
                        else fn(v) for f in dataclasses.fields(self)})

    def pin_memory(self) -> "Batch":
        """Page-locked copies (``DataLoader``'s ``pin_memory`` calls this),
        so that the copy to the card can overlap the host's work."""
        return self._map(lambda t: t.pin_memory())


def _stack(samples) -> Batch:
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return Batch(image=out["image"], targets=out["targets"],
                 target_mask=out["target_mask"], index=out["index"],
                 orig_hw=out.get("orig_hw"))


def _collate(samples) -> Batch:
    """A worker's batch as torch tensors: they reach the main process
    through shared memory.  (Numpy arrays would be pickled through a pipe,
    and the main process's reading thread would take the interpreter lock
    from the train step once per chunk: on an H100 the steps ran 2-3x
    slower so; PERF.md, Findings.)"""
    return _stack(samples)._map(torch.from_numpy)


class _Records(torch.utils.data.Dataset):
    """Key ``(seed, position, index, augment)`` → the sample ``index``,
    augmented with a generator seeded from ``(seed, position)``: the draws
    do not depend on which worker takes the record or when."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, key):
        seed, position, index, augment = key
        if not augment:
            return self.dataset.get_eval_sample(index)
        return self.dataset.get_train_sample(
            index, np.random.default_rng([seed, position]))


class _Keys:
    """The batch sampler: the batches of keys of the current epoch."""

    def __init__(self):
        self.batches = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


class WorkerPool:
    """``num_workers`` processes that build ``dataset``'s samples for
    :func:`create_dataloader`: started on the first epoch by the platform's
    default (``fork`` on Linux: the workers run numpy and OpenCV only, never
    CUDA, so they need no fresh interpreter) and kept until :meth:`close`,
    the batches in pinned memory when a CUDA device is visible."""

    def __init__(self, dataset, num_workers: int):
        self.dataset = dataset
        self._keys = _Keys()
        self._loader = torch.utils.data.DataLoader(
            _Records(dataset), batch_sampler=self._keys,
            num_workers=num_workers, collate_fn=_collate,
            pin_memory=torch.cuda.is_available(), persistent_workers=True)

    def batches(self, keys) -> Iterator[Batch]:
        """The batches of ``keys`` (lists of ``(seed, position, index,
        augment)``), in order."""
        self._keys.batches = keys
        yield from self._loader

    def close(self) -> None:
        """Stop the workers (the loader's iterator shuts them down when it
        is freed)."""
        self._loader = None


def create_dataloader(dataset, batch_size: int, shuffle: bool = True,
                      augment: bool = True, seed: int = 0,
                      num_epochs: int | None = None,
                      drop_remainder: bool = True, indices=None,
                      shard_index: int = 0, shard_count: int = 1,
                      workers: WorkerPool | None = None) -> Iterator[Batch]:
    """Iterate fixed-shape batches of ``dataset`` (anything with
    ``get_train_sample(i, rng)``, or ``get_eval_sample(i)`` when not
    ``augment``).

    Each epoch's order is ``indices`` (e.g. image-weighted resampling) or
    every sample, shuffled by one generator seeded from ``seed`` when
    ``shuffle``, then the strided ``order[shard_index::shard_count]`` slice
    (the reference's DistributedSampler semantics); ``batch_size`` is per
    process.  With ``drop_remainder`` the order is first cut to whole
    global batches (``batch_size * shard_count``), so every shard yields
    the one-process run's ``len(order) // global batch`` batches and the
    processes of a data-parallel step take their steps together (the JAX
    package's in-process path drops each shard's own remainder, so its
    shards can differ by a batch).

    In-process (``workers`` None): the JAX package's path draw for draw —
    that one generator shuffles and then augments the samples in order, so
    the batches equal the JAX package's bit for bit.

    ``workers`` (a :class:`WorkerPool` of ``dataset``): the order is drawn
    as above; each record is augmented in a worker with a generator seeded
    from ``(seed + epoch, position in the epoch's slice)``, and the batch
    arrives as torch tensors.  The JAX package's Grain loader draws its own
    per-record generators, which cannot be reproduced without Grain: this
    path gives other (equally seeded, reproducible) samples than the JAX
    package's worker path."""
    if workers is not None and workers.dataset is not dataset:
        raise ValueError("the worker pool serves another dataset")
    if indices is not None:
        indices = np.asarray(indices, np.int64)
    rng = np.random.default_rng(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = (indices.copy() if indices is not None
                 else np.arange(len(dataset)))
        if shuffle:
            rng.shuffle(order)
        if shard_count > 1:
            if drop_remainder:  # every shard the same number of batches
                order = order[:len(order) // (batch_size * shard_count)
                              * batch_size * shard_count]
            order = order[shard_index::shard_count]
        stop = (len(order) // batch_size * batch_size if drop_remainder
                else len(order))
        if workers is not None:
            yield from workers.batches([
                [(seed + epoch, p, int(order[p]), augment)
                 for p in range(start, min(start + batch_size, stop))]
                for start in range(0, stop, batch_size)])
        else:
            for start in range(0, stop, batch_size):
                yield _stack([dataset.get_train_sample(int(i), rng)
                              if augment else dataset.get_eval_sample(int(i))
                              for i in order[start:start + batch_size]])
        epoch += 1
