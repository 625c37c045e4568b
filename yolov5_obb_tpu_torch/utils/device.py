"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller
    asks for the CPU explicitly.  Raises when CUDA is requested (or
    defaulted to) and no GPU is visible — nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
