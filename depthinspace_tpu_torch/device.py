"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no CUDA card, so a
    run without a card fails instead of quietly running on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (require_cuda).
    The CPU is used only when asked for, as ``device="cpu"``."""
    return require_cuda() if device is None else torch.device(device)
