"""DIS-SF / DIS-FTSF worker, port of
``depthinspace_tpu/train/single_frame.py``: the single-frame DispNet and its
train and eval steps (the datasets are the base worker's; ``use_pseudo_gt``
adds the DIS-FTSF pseudo-GT term from multi_frame_disp.hdf5)."""

from __future__ import annotations

from ..models import DispNet, init_dispnet_
from ..utils import jrandom
from .steps import make_sf_eval_step, make_sf_train_step
from .worker import Worker


class SingleFrameWorker(Worker):
    architecture = "single_frame"

    def make_model(self) -> DispNet:
        """The JAX worker's init: ``DispNet.init(jax.random.key(seed))``,
        drawn on the run's device (the card's draws are the CPU's)."""
        return init_dispnet_(DispNet(max_disp=self.cfg.max_disp).to(
            self.device), jrandom.key(self.cfg.seed))

    def make_train_step(self, state):
        return make_sf_train_step(state.model, self.ctx, state,
                                  accum_steps=self.accum_steps)

    def make_eval_step(self, model, ctx=None):
        return make_sf_eval_step(model, self.ctx if ctx is None else ctx)
