"""Checkpoints, port of ``depthinspace_tpu/train/checkpoint.py``, with the
same three artifacts in the experiment directory:

1. ``state/``: a rolling full training state (model, Adam, step, the step's
   generator, the host's numpy and python RNG, {epoch, min_err}), one
   ``<epoch>/state.pt`` file per saved epoch in this package's own
   ``torch.save`` format, the newest ``max_to_keep`` kept. (The JAX package
   writes orbax directories there, which this package cannot read.)
2. ``state_set_<name>_best/``: the same, for the best epoch of a test set.
3. ``net_%04d.params``: the DispNet or FuseNet weights in flax msgpack
   (``utils/flax_msgpack.py``), the file the JAX package's retest and
   presave tools read; this package reads the ones the JAX package writes.

Data parallel: every rank calls ``save`` (it gathers each rank's step
generator), rank 0 alone writes, and a barrier follows; then every rank
can ``restore`` from the same files, each taking its own generator back.
"""

from __future__ import annotations

import os
import random
import shutil
from pathlib import Path

import numpy as np
import torch

from ..models import (FuseNet, dispnet_state_dict_from_flax,
                      flax_tree_from_dispnet_state_dict,
                      flax_tree_from_fusenet_state_dict,
                      fusenet_state_dict_from_flax)
from ..parallel.multihost import all_gather_object, barrier
from ..utils import flax_msgpack
from .state import TrainState


def net_params_path(exp_dir: Path, epoch: int) -> Path:
    return Path(exp_dir) / f"net_{epoch:04d}.params"


def save_net_params(exp_dir: Path, epoch: int,
                    model: torch.nn.Module) -> Path:
    """Write the DispNet's or FuseNet's weights as flax msgpack
    ``net_%04d.params``."""
    path = net_params_path(exp_dir, epoch)
    to_flax = (flax_tree_from_fusenet_state_dict if isinstance(model, FuseNet)
               else flax_tree_from_dispnet_state_dict)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(flax_msgpack.to_bytes(to_flax(model.state_dict())))
    os.replace(tmp, path)
    return path


def load_net_params(path: Path,
                    model: torch.nn.Module | None = None
                    ) -> dict[str, torch.Tensor]:
    """A ``net_%04d.params`` file (written by either package) as a
    ``state_dict`` on the CPU: for ``model`` when it is a FuseNet, else for
    DispNet."""
    tree = flax_msgpack.from_bytes(Path(path).read_bytes())
    if isinstance(model, FuseNet):
        return fusenet_state_dict_from_flax(tree, model)
    return dispnet_state_dict_from_flax(tree)


class StateCheckpointer:
    """Rolling full-state checkpoint at <exp_dir>/<name> (default 'state');
    ``group``: the data-parallel process group, None on one process."""

    FILE = "state.pt"

    def __init__(self, exp_dir: Path, name: str = "state",
                 max_to_keep: int = 2, group=None):
        self.dir = Path(exp_dir) / name
        self.max_to_keep = max_to_keep
        self.group = group
        self.rank = 0 if group is None else torch.distributed.get_rank(group)

    def _epochs(self) -> list[int]:
        if not self.dir.is_dir():
            return []
        return sorted(int(d.name) for d in self.dir.iterdir()
                      if d.name.isdigit() and (d / self.FILE).exists())

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState, min_err: dict) -> None:
        generators = all_gather_object(state.generator.get_state(),
                                       self.group)
        if self.rank == 0:
            self._write(epoch, state, min_err, generators)
        barrier(self.group)

    def _write(self, epoch, state, min_err, generators) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
            "host_rng": {"numpy": np.random.get_state(),
                         "python": random.getstate()},
            "epoch": int(epoch),
            "min_err": {k: float(v) for k, v in min_err.items()},
        }
        if self.group is not None:
            payload["rank_generators"] = generators
        out = self.dir / str(epoch)
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / (self.FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, out / self.FILE)
        for old in self._epochs()[:-self.max_to_keep]:
            shutil.rmtree(self.dir / str(old))

    def restore(self, state: TrainState):
        """Loads the newest saved epoch into ``state`` (model, optimizer,
        step, generator) and the host RNGs. Returns (state, epoch, min_err),
        or None when nothing is saved. A rank takes its own generator back
        when the file was written by a run of as many ranks; else rank 0
        takes the saved one and the other ranks keep their seeded ones."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        # this package's own file: it holds numpy and python RNG states
        payload = torch.load(self.dir / str(epoch) / self.FILE,
                             map_location="cpu", weights_only=False)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        gens = payload.get("rank_generators")
        world = (1 if self.group is None
                 else torch.distributed.get_world_size(self.group))
        if gens is not None and len(gens) == world:
            state.generator.set_state(gens[self.rank])
        elif self.rank == 0:
            state.generator.set_state(payload["generator"])
        np.random.set_state(payload["host_rng"]["numpy"])
        random.setstate(payload["host_rng"]["python"])
        return state, int(payload["epoch"]), dict(payload["min_err"])
