"""Multi-process data-parallel training: the process group, rank-0 gating,
the per-process batch, a fitness broadcast and the collectives of the
data-parallel train step.

Counterpart of ``yolov5_obb_tpu/engine/distributed.py`` (:28-93).  The JAX
package joins its processes into one runtime and lets XLA insert the
collectives of a batch-sharded step; here each process runs the step on its
slice of the global batch and the step itself calls the collectives
(``engine/trainer.make_train_step(mesh=...)``):

- BatchNorm's batch statistics are taken over the global batch (the mean
  of a batch-sharded array in the JAX step): the per-rank statistics are
  all-reduced before the mean and the variance are formed
  (``models/layers.batch_norm_train``, the fused train region);
- the loss is the one-process loss of the global batch: each rank takes
  its own numerators over the global counts (``engine/loss.py``);
- the gradients are summed over the ranks before the optimizer.

This is not ``DistributedDataParallel``, which averages gradients and keeps
each rank's BatchNorm statistics to itself.

Launch one process per card with torchrun, whose environment
(``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) :func:`maybe_initialize` reads — the reference's protocol
(reference train.py:53-55, 519-526)::

    torchrun --nproc-per-node 4 -m yolov5_obb_tpu_torch.train ...
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


def joined() -> bool:
    """True once this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize(device=None) -> bool:
    """Join the process group when torchrun's environment says there is
    more than one process (``WORLD_SIZE > 1``); returns whether this run is
    multi-process.

    The backend is NCCL for a CUDA ``device`` (``None`` means the card, as
    everywhere in the port) and gloo for the CPU; a CUDA process takes
    ``cuda:{LOCAL_RANK}`` as its current device.  Idempotent: when the
    caller has already called ``init_process_group`` (with any backend:
    this is how two processes share one card through gloo), nothing is
    initialised again and the answer is ``world_size > 1``."""
    if joined():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            world_size=world,
                            rank=int(os.environ["RANK"]))
    return True


def local_device(device: torch.device) -> torch.device:
    """``device`` as this process's card: ``cuda:{LOCAL_RANK}`` for CUDA
    (torchrun's one process per card), the CPU as it is."""
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def is_main() -> bool:
    """True on the process that owns the file-system side effects
    (checkpoints, logs, plots): rank 0, or the only process (the
    reference's ``RANK in (-1, 0)``, train.py:86)."""
    return not joined() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if joined() else 1


def process_index() -> int:
    return dist.get_rank() if joined() else 0


def local_batch_size(global_batch: int) -> int:
    """This process's slice of the global batch (reference train.py:213);
    raises when the batch does not divide by the processes."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "processes")
    return global_batch // n


def broadcast_scalar(x: float) -> float:
    """Rank 0's value on every process: the replicated control flow (early
    stopping, the best checkpoint) stays the same everywhere when only rank
    0 validates."""
    if process_count() == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64,
                     device=_collective_device())
    dist.broadcast(t, 0)
    return float(t.item())


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every process (the run directory that
    rank 0 named)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def barrier() -> None:
    """Wait for every process (nothing with one)."""
    if process_count() > 1:
        dist.barrier()


@contextlib.contextmanager
def main_first():
    """Rank 0 runs the block first (it writes caches), then the others
    (which read them)."""
    if not is_main():
        barrier()
    yield
    if is_main():
        barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if joined():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where a host value goes for a collective: NCCL takes CUDA tensors
    only, gloo takes both."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """``Σ_ranks t``, whose backward is the all-reduce of the incoming
    gradient: rank r's input feeds every rank's output, so its gradient is
    the sum of theirs."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t):
    """Differentiable ``Σ_ranks t`` (SUM all-reduce).  What
    ``torch.distributed.nn.functional.all_reduce`` computes, which this
    torch marks deprecated."""
    return _AllReduceSum.apply(t)


class DataMesh:
    """The data-parallel handle of the train step (the JAX package's
    ``mesh`` argument; here the default process group, one process per
    card).  Build it with :func:`make_mesh` once the process group
    exists."""

    @property
    def world(self) -> int:
        return dist.get_world_size()

    @property
    def rank(self) -> int:
        return dist.get_rank()

    def sum(self, t):
        """Differentiable SUM over the ranks."""
        return all_reduce_sum(t)

    @torch.no_grad()
    def sum_(self, t):
        """SUM over the ranks, in place, no gradient; returns ``t``."""
        dist.all_reduce(t)
        return t

    @torch.no_grad()
    def sum_tensors_(self, tensors) -> None:
        """SUM each of ``tensors`` over the ranks in place, flattened into
        one all-reduce per dtype."""
        _flat_(tensors, dist.all_reduce)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    @torch.no_grad()
    def broadcast_(self, tensors) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place, one
        broadcast per dtype."""
        _flat_(tensors, lambda flat: dist.broadcast(flat, 0))


def _flat_(tensors, collective) -> None:
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def make_mesh() -> DataMesh:
    """The data-parallel handle over the default process group; raises
    without one (:func:`maybe_initialize`, or the caller's
    ``init_process_group``)."""
    if not joined():
        raise RuntimeError("a data-parallel mesh needs a process group: "
                           "launch with torchrun (maybe_initialize) or call "
                           "torch.distributed.init_process_group first")
    return DataMesh()
