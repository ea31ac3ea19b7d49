"""Device selection: the port runs on the card unless asked for the CPU, and
on the card in full float32 and deterministically (one input, one result,
as the JAX package's device gives). Under torchrun (one process per card) a
process's card is ``cuda:LOCAL_RANK``."""

from __future__ import annotations

import os

import torch
import torch.utils.deterministic


def set_full_f32() -> None:
    """Full float32 on the card: TF32 off for cuDNN's convolutions (torch
    defaults to on) and for matrix products (torch defaults to off). The
    port is held to the JAX package in full float32, and every entry point
    that takes the card sets it through :func:`resolve_device`."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# cuBLAS's workspace settings under which its results do not depend on
# which stream or handle ran before (torch refuses the deterministic mode
# without one of them)
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def set_deterministic() -> None:
    """One input, one result on the card, in every process that takes it
    (every entry point, through :func:`resolve_device`):

    - cuDNN's deterministic algorithms, ``benchmark`` off;
    - ``torch.use_deterministic_algorithms(True)``: an op without a
      deterministic CUDA implementation raises instead of varying (the
      port replaced those on its paths: DispNet's bilinear upsampling, the
      replicate padding of a differentiated tensor);
    - ``fill_uninitialized_memory`` off: the mode would otherwise fill each
      ``torch.empty`` with NaN, a pass of bandwidth an allocation; every
      kernel writes each element it returns;
    - ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless it already holds one of
      the deterministic settings. cuBLAS reads it when a process makes its
      first handle, so this runs before the first matrix product.

    No switch turns it off: the JAX package has none, its device being
    deterministic."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_DETERMINISTIC[0]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


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
    turns TF32 off (:func:`set_full_f32`) and the deterministic mode on
    (:func:`set_deterministic`) first."""
    dev = require_cuda() if device is None else torch.device(device)
    if dev.type == "cuda":
        set_full_f32()
        set_deterministic()
    return dev
