"""Device selection: the port runs on the card unless asked for the CPU, and
on the card in full float32. Under torchrun (one process per card) a
process's card is ``cuda:LOCAL_RANK``."""

from __future__ import annotations

import os

import torch


def set_full_f32() -> None:
    """Full float32 on the card: TF32 off for cuDNN's convolutions (torch
    defaults to on) and for matrix products (torch defaults to off). The
    port is held to the JAX package in full float32, and every entry point
    that takes the card sets it through :func:`resolve_device`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def require_cuda() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` under torchrun, else
    ``cuda:0``. Raises when PyTorch sees no CUDA card, or not the one
    LOCAL_RANK names, so a run fails instead of quietly running on the CPU
    or sharing another process's card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} names cuda:{index}, but "
                           f"PyTorch sees {torch.cuda.device_count()} CUDA "
                           "device(s)")
    return torch.device("cuda", index)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (require_cuda).
    The CPU is used only when asked for, as ``device="cpu"``. A CUDA device
    turns TF32 off first (:func:`set_full_f32`)."""
    dev = require_cuda() if device is None else torch.device(device)
    if dev.type == "cuda":
        set_full_f32()
    return dev
