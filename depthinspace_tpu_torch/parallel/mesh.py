"""The batch layout of data parallelism, port of
``depthinspace_tpu/parallel/mesh.py``.

The JAX package shards the batch axis of every ``Batch`` field over a 1-D
``('data',)`` mesh (axis 1, axis 2 for the flow; ``_BATCH_SPECS``), so
device r holds the r-th contiguous block of the global batch, and
replicates the parameters and the optimizer state. Here rank r of the
process group holds the same block (:func:`shard_batch`), rank 0's
parameters and Adam state are broadcast to every rank
(:func:`replicate_state`), and the train step sums the gradients over the
ranks once per optimizer step.

Departure: ``make_mesh`` shrinks the mesh to the largest device count that
divides the batch. Under torchrun the processes already exist, so the rule
becomes a check at the worker's start (:func:`check_batch_divides`):
``train_batch_size`` is the global batch, as in JAX, and a world that does
not divide it raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.batch import Batch
from .multihost import broadcast_


def _batch_axis(field: str) -> int:
    return 2 if field == "flow" else 1


def _take(batch: Batch, idx: np.ndarray) -> Batch:
    """The samples ``idx`` of every present field of a numpy batch."""
    return Batch(**{k: None if v is None else np.take(v, idx,
                                                       axis=_batch_axis(k))
                    for k, v in batch._asdict().items()})


def pad_indices(n: int, multiple: int) -> np.ndarray:
    """0..n-1, then n-1 repeated up to a multiple of ``multiple``."""
    return np.concatenate([np.arange(n),
                           np.full((-n) % multiple, n - 1, np.int64)])


def pad_batch(batch: Batch, multiple: int) -> tuple[Batch, int]:
    """Pad the batch axis of a numpy batch up to a multiple by repeating
    the last sample (an evaluation batch's ragged tail must divide over the
    ranks). Returns (padded batch, original batch size)."""
    bs = batch.im.shape[1]
    if bs % multiple == 0:
        return batch, bs
    return _take(batch, pad_indices(bs, multiple)), bs


def shard_indices(batch_size: int, rank: int, world: int,
                  accum: int = 1) -> np.ndarray:
    """The global sample indices rank ``rank`` of ``world`` holds.

    ``accum = 1``: the rank's contiguous block, the one GSPMD gives device
    r. ``accum = k``: the JAX step chunks the *global* batch into k
    contiguous microbatches (``steps.py::_chunk_batch`` with dp = 1), so
    the rank holds its block of each chunk, in chunk order; ``chunk_batch``
    of its local batch then yields its share of each global microbatch.
    Raises ValueError when k * world does not divide the batch."""
    if batch_size % (accum * world):
        raise ValueError(f"batch size {batch_size} does not divide into "
                         f"{accum} microbatches over {world} processes")
    chunk = batch_size // accum
    per = chunk // world
    return np.concatenate([np.arange(j * chunk + rank * per,
                                     j * chunk + (rank + 1) * per)
                           for j in range(accum)])


def shard_batch(batch: Batch, rank: int, world: int,
                accum: int = 1) -> Batch:
    """Rank ``rank``'s part of a global numpy batch
    (:func:`shard_indices`)."""
    if world == 1:
        return batch
    return _take(batch, shard_indices(batch.im.shape[1], rank, world, accum))


def check_batch_divides(train_batch_size: int, world: int,
                        accum: int = 1) -> None:
    """The worker's start-up check: the global train batch must divide over
    the processes, and each rank's block into ``accum`` microbatches."""
    if train_batch_size % world:
        raise ValueError(f"train_batch_size {train_batch_size} does not "
                         f"divide over a world of {world} processes")
    if train_batch_size % (accum * world):
        raise ValueError(f"train_batch_size {train_batch_size} does not "
                         f"divide into {accum} microbatches on each of "
                         f"{world} processes")


def replicate_state(model: torch.nn.Module, optimizer, group=None) -> None:
    """Give every rank rank 0's parameters and optimizer state (the
    replicated state of the JAX mesh); nothing on one process."""
    tensors = [p.data for p in model.parameters()]
    for p in model.parameters():
        st = optimizer.state.get(p, {})
        tensors += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor)]
    broadcast_(tensors, src=0, group=group)
