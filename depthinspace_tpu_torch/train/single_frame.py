"""DIS-SF / DIS-FTSF worker, port of
``depthinspace_tpu/train/single_frame.py``: the single-frame DispNet and its
train and eval steps (the datasets are the base worker's; ``use_pseudo_gt``
adds the DIS-FTSF pseudo-GT term from multi_frame_disp.hdf5)."""

from __future__ import annotations

import torch

from ..models import DispNet, init_dispnet_
from .steps import make_sf_eval_step, make_sf_train_step
from .worker import Worker


class SingleFrameWorker(Worker):
    architecture = "single_frame"

    def make_model(self) -> DispNet:
        """A seeded init (flax's defaults; the JAX package's init draws
        other numbers from the same seed)."""
        return init_dispnet_(DispNet(max_disp=self.cfg.max_disp),
                             torch.Generator().manual_seed(self.cfg.seed))

    def make_train_step(self, state):
        return make_sf_train_step(state.model, self.ctx, state,
                                  accum_steps=self.accum_steps)

    def make_eval_step(self, model, ctx=None):
        return make_sf_eval_step(model, self.ctx if ctx is None else ctx)
