"""Device selection: the port runs on the card unless asked for the CPU, and
on the card in full float32."""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Full float32 on the card: TF32 off for cuDNN's convolutions (torch
    defaults to on) and for matrix products (torch defaults to off). The
    port is held to the JAX package in full float32, and every entry point
    that takes the card sets it through :func:`resolve_device`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no CUDA card, so a
    run without a card fails instead of quietly running on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card (require_cuda).
    The CPU is used only when asked for, as ``device="cpu"``. A CUDA device
    turns TF32 off first (:func:`set_full_f32`)."""
    dev = require_cuda() if device is None else torch.device(device)
    if dev.type == "cuda":
        set_full_f32()
    return dev
