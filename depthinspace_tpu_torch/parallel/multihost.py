"""Multi-process data parallelism, port of
``depthinspace_tpu/parallel/multihost.py``.

The JAX package runs one program over a mesh of devices and lets GSPMD
place the collectives. Here one process drives one card: ``torchrun``
(``python -m torch.distributed.run``) starts the processes, on one node or
several, and :func:`init_multihost` joins them into one process group.
Each process loads its block of every global batch
(:func:`process_batch_bounds`, ``mesh.shard_batch``), and the helpers
below are the collectives the losses, the train step and the worker call:
each is the identity on one process.

Backends: NCCL for CUDA devices, gloo for the CPU, unless the caller names
one. Gloo takes CPU tensors here: a CUDA tensor handed to a collective of a
gloo group is copied to the host, reduced or gathered there and copied
back (two processes on one card, which NCCL refuses, run this way).
NCCL and gloo take no 16-bit integers, so ``all_gather_batch`` moves
uint16 and int16 tensors as their bytes.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import require_cuda

# the variables torchrun sets in every process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
_BYTES_OF = (torch.uint16, torch.int16)


def init_multihost(device=None, backend: str | None = None,
                   init_method: str | None = None, rank: int | None = None,
                   world_size: int | None = None) -> bool:
    """Join the process group of a launch; call before building anything
    on the device. With no arguments the rank, world size and rendezvous
    come from torchrun's variables (``TORCHRUN_ENV``), and without them this
    is a no-op that returns False, as the JAX one is without a cluster.

    ``device``: this process's device; None is the card ``cuda:LOCAL_RANK``
    (``device.require_cuda``, which raises when that card does not exist).
    ``backend``: None is NCCL for a CUDA device and gloo for the CPU.
    ``init_method``/``rank``/``world_size`` name another rendezvous (the
    tests use ``file://`` in a temporary directory)."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return False
        init_method = "env://"
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    dev = require_cuda() if device is None else torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes logs, metrics and checkpoints."""
    return rank() == 0


def process_batch_bounds(global_batch_size: int,
                         process_index: int | None = None,
                         world: int | None = None) -> tuple[int, int]:
    """[lo, hi) of the global batch axis process ``process_index`` (None:
    this one) loads; raises ValueError when the world does not divide the
    batch (pad evaluation tails with ``mesh.pad_batch`` first)."""
    index = rank() if process_index is None else process_index
    world = world_size() if world is None else world
    if global_batch_size % world:
        raise ValueError(f"global batch {global_batch_size} does not divide "
                         f"over {world} processes")
    per = global_batch_size // world
    return index * per, (index + 1) * per


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` goes through the host: a CUDA tensor in a gloo
    group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, a new tensor on ``x``'s device;
    ``x`` itself on one process (``group`` None) or a world of one."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    y = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def all_gather_batch(x: torch.Tensor, axis: int = 1,
                     group=None) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``axis``
    in rank order: the global batch of per-rank blocks. ``x`` itself on
    one process."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    y = (x.detach().cpu() if _staged(x, group) else x.detach()).contiguous()
    if x.dtype in _BYTES_OF:
        y = y.view(torch.uint8)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    if x.dtype in _BYTES_OF:
        parts = [p.view(x.dtype) for p in parts]
    return torch.cat(parts, dim=axis).to(x.device)


def broadcast_(tensors, src: int = 0, group=None) -> None:
    """Overwrite each (contiguous) tensor with rank ``src``'s, in place."""
    if group is None or dist.get_world_size(group) == 1:
        return
    for t in tensors:
        if _staged(t, group):
            y = t.detach().cpu()
            dist.broadcast(y, src=src, group=group)
            t.detach().copy_(y)
        else:
            dist.broadcast(t.detach(), src=src, group=group)


def broadcast_object(obj, group=None):
    """Rank 0's picklable ``obj`` on every rank: for decisions the ranks
    must take together (a rank that stops alone leaves the others waiting
    in a collective)."""
    if group is None or dist.get_world_size(group) == 1:
        return obj
    out = [obj]
    dist.broadcast_object_list(out, src=0, group=group)
    return out[0]


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group=None) -> None:
    if group is not None and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def default_group():
    """The launch's process group when it has more than one process, else
    None (the value every helper here takes for "one process")."""
    return dist.group.WORLD if world_size() > 1 else None
