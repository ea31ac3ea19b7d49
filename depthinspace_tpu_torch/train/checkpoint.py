"""Checkpoints, port of ``depthinspace_tpu/train/checkpoint.py``, with the
same three artifacts in the experiment directory:

1. ``state/``: a rolling full training state (model, Adam, step, the
   step's threefry key as ``rng_data``, its two words, as the JAX package
   saves it, the host's numpy and python RNG, {epoch, min_err}), one
   ``<epoch>/state.pt`` file per saved epoch in this package's own
   ``torch.save`` format, the newest ``max_to_keep`` kept. The JAX package
   writes orbax step directories there (``<epoch>/`` with
   ``_CHECKPOINT_METADATA`` and ``state/manifest.ocdbt``), which this
   package reads too (``train/orbax_state.py``): ``restore`` takes the
   newest epoch of either kind (the port's own file when one epoch has
   both), so ``--cmd resume`` continues a run the JAX worker started. The
   rolling deletion removes only this package's files: an orbax directory
   stays.
2. ``state_set_<name>_best/``: the same, for the best epoch of a test set.
3. ``net_%04d.params``: the DispNet or FuseNet weights in flax msgpack
   (``utils/flax_msgpack.py``), the file the JAX package's retest and
   presave tools read; this package reads the ones the JAX package writes.

Data parallel: every rank holds the same key (the JAX mesh step's key is
replicated), every rank calls ``save``, rank 0 alone writes, and a barrier
follows; then every rank can ``restore`` from the same files. A state file
of the port's older format (a torch generator state, no ``rng_data``)
raises on restore: its draws cannot be continued.
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
from ..parallel.multihost import barrier
from ..utils import flax_msgpack, jrandom
from .orbax_state import OrbaxStep, is_orbax_step, restore_from_orbax
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

    def _epochs(self, orbax: bool = True) -> list[int]:
        """The saved epochs: this package's files, and with ``orbax`` the
        JAX package's step directories."""
        if not self.dir.is_dir():
            return []
        return sorted(int(d.name) for d in self.dir.iterdir()
                      if d.name.isdigit() and ((d / self.FILE).exists()
                                               or orbax and is_orbax_step(d)))

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def saved_modules(self) -> set[str] | None:
        """The top-level module names of the model in the newest saved
        epoch (FuseNet's ``block<i>`` are named alike in both packages),
        from its index alone; None when nothing is saved."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        path = self.dir / str(epoch) / self.FILE
        if not path.exists():
            return OrbaxStep(path.parent).modules()
        payload = torch.load(path, map_location="cpu", mmap=True,
                             weights_only=False)
        return {k.split(".")[0] for k in payload["model"]}

    def save(self, epoch: int, state: TrainState, min_err: dict) -> None:
        if self.rank == 0:
            self._write(epoch, state, min_err)
        barrier(self.group)

    def _write(self, epoch, state, min_err) -> None:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "rng_data": jrandom.key_data(state.rng),
            "host_rng": {"numpy": np.random.get_state(),
                         "python": random.getstate()},
            "epoch": int(epoch),
            "min_err": {k: float(v) for k, v in min_err.items()},
        }
        out = self.dir / str(epoch)
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / (self.FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, out / self.FILE)
        for old in self._epochs(orbax=False)[:-self.max_to_keep]:
            d = self.dir / str(old)
            if is_orbax_step(d):        # the JAX package's: keep it
                (d / self.FILE).unlink()
            else:
                shutil.rmtree(d)

    def restore(self, state: TrainState):
        """Loads the newest saved epoch into ``state`` (model, optimizer,
        step, key) and the host RNGs. Returns (state, epoch, min_err), or
        None when nothing is saved. An orbax step directory (the JAX
        package's) is read alike, its ``rng_data`` the key."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        if not (self.dir / str(epoch) / self.FILE).exists():
            return restore_from_orbax(self.dir / str(epoch), state)
        # this package's own file: it holds numpy and python RNG states
        path = self.dir / str(epoch) / self.FILE
        payload = torch.load(path, map_location="cpu", weights_only=False)
        if "rng_data" not in payload:
            raise ValueError(
                f"{path} holds a torch generator state (the port's format "
                "before it drew with the JAX package's threefry keys); its "
                "draws cannot be continued: start the run anew")
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.rng = jrandom.wrap_key_data(payload["rng_data"])
        np.random.set_state(payload["host_rng"]["numpy"])
        random.setstate(payload["host_rng"]["python"])
        return state, int(payload["epoch"]), dict(payload["min_err"])
