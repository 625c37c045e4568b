"""Pre-augmented shard cache: replay training samples at memory bandwidth.

Counterpart of ``yolov5_obb_tpu/data/shards.py`` (``write_shards`` :27,
``ShardDataset`` :77).  ``aug_epochs`` augmented variants of every sample
are generated once and packed into memory-mappable ``.npy`` shards; the
train loader then replays a fresh variant of each source image per epoch
with one copy a sample.  It trades augmentation freshness for throughput,
as the reference's ``--cache`` does.

Numpy only: replaying a cache needs no OpenCV, which makes it the train
data path of a machine without it (``train.py --cache shards`` finds the
cache under ``<run>/cache/shards``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def write_shards(dataset, out_dir, aug_epochs: int = 4, seed: int = 0,
                 shard_size: int = 64, verbose: bool = True) -> Path:
    """Write ``aug_epochs`` augmented variants of each sample of
    ``dataset`` (``get_train_sample(i, rng)``, one generator seeded from
    ``seed`` in variant-major order) into shards.

    Layout: ``meta.json`` + per shard ``img_NNNN.npy`` (S, H, W, 3 uint8),
    ``tgt_NNNN.npy`` (S, M, 186 float32), ``msk_NNNN.npy`` (S, M bool).
    Variant ``v`` of source ``i`` is row ``v * len(dataset) + i``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(dataset)
    files = []
    buf_i, buf_t, buf_m = [], [], []

    def flush():
        if not buf_i:
            return
        k = len(files)
        np.save(out / f"img_{k:04d}.npy", np.stack(buf_i))
        np.save(out / f"tgt_{k:04d}.npy", np.stack(buf_t))
        np.save(out / f"msk_{k:04d}.npy", np.stack(buf_m))
        files.append(len(buf_i))
        buf_i.clear(), buf_t.clear(), buf_m.clear()

    rng = np.random.default_rng(seed)
    for v in range(aug_epochs):
        for i in range(n):
            s = dataset.get_train_sample(i, rng)
            buf_i.append(np.ascontiguousarray(s["image"]))
            buf_t.append(s["targets"])
            buf_m.append(s["target_mask"])
            if len(buf_i) >= shard_size:
                flush()
        if verbose:
            print(f"[shards] variant epoch {v + 1}/{aug_epochs} packed")
    flush()
    meta = dict(n_source=n, total=n * aug_epochs, aug_epochs=aug_epochs,
                shard_sizes=files, seed=seed)
    (out / "meta.json").write_text(json.dumps(meta))
    return out


class ShardDataset:
    """Memory-mapped replay of a shard pool with the loader's surface
    (``get_train_sample(i, rng)`` as ``DotaDataset``'s; ``rng`` is unused:
    the augmentation happened when the shards were written)."""

    def __init__(self, shard_dir):
        self.dir = Path(shard_dir)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        self.n_source = int(self.meta["n_source"])
        self.aug_epochs = int(self.meta["aug_epochs"])
        self._starts = np.cumsum([0] + self.meta["shard_sizes"])
        self._mm = {}

    def __len__(self):
        return int(self.meta["total"])

    def __getstate__(self):
        # each process maps the shards itself (a pickled map would copy)
        return {**self.__dict__, "_mm": {}}

    def _maps(self, shard: int):
        if shard not in self._mm:
            self._mm[shard] = tuple(
                np.load(self.dir / f"{p}_{shard:04d}.npy", mmap_mode="r")
                for p in ("img", "tgt", "msk"))
        return self._mm[shard]

    def get_train_sample(self, index: int, rng=None):
        shard = int(np.searchsorted(self._starts, index, side="right") - 1)
        row = index - int(self._starts[shard])
        img, tgt, msk = self._maps(shard)
        return {
            "image": np.asarray(img[row]),
            "targets": np.asarray(tgt[row]),
            "target_mask": np.asarray(msk[row]),
            "index": np.int32(index % self.n_source),
        }

    def epoch_indices(self, epoch: int, seed: int = 0,
                      source_indices=None) -> np.ndarray:
        """One epoch: a variant drawn for each source image (or each of
        ``source_indices``, e.g. image-weighted resampling), shuffled; from
        a generator seeded with ``seed + epoch``."""
        rng = np.random.default_rng(seed + epoch)
        src = (np.arange(self.n_source) if source_indices is None
               else np.asarray(source_indices, np.int64))
        variants = rng.integers(0, self.aug_epochs, len(src))
        idx = variants * self.n_source + src
        rng.shuffle(idx)
        return idx
