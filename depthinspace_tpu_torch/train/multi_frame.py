"""DIS-MF worker, port of ``depthinspace_tpu/train/multi_frame.py``:
FuseNet over tracks of 4 frames, whose datasets also load the DIS-SF
primary disparities (single_frame_disp.hdf5) that seed the fusion. With
in-memory synthetic samples the primary is the source's seeded stand-in
(``SyntheticSource(primary_noise=...)``)."""

from __future__ import annotations

import logging
import re

import torch

from ..models import FuseNet, init_fusenet_
from ..utils import jrandom
from .steps import make_mf_eval_step, make_mf_train_step
from .worker import Worker


class MultiFrameWorker(Worker):
    architecture = "multi_frame"
    block_num = 4                       # the JAX CLI's FuseNet

    def init_state(self, resume: bool = False):
        """On resume, FuseNet takes as many fusion blocks as the newest
        saved state holds (the JAX package's or this one's)."""
        modules = self.ckpt.saved_modules() if resume else None
        if modules is not None:
            n = sum(bool(re.fullmatch(r"block\d+", m)) for m in modules)
            if n != self.block_num:
                logging.info(f"FuseNet with {n} fusion blocks, as the saved "
                             "state")
            self.block_num = n
        return super().init_state(resume)

    def make_model(self) -> FuseNet:
        """The JAX worker's init: ``FuseNet.init(jax.random.key(seed))``,
        drawn on the run's device."""
        H, W = self.imsize
        model = FuseNet(imsize=(H, W), K=self.settings.K,
                        track_length=self.cfg.track_length,
                        block_num=self.block_num,
                        max_disp=self.cfg.max_disp,
                        compute_dtype=getattr(torch, self.cfg.mf_dtype),
                        use_remat=self.cfg.mf_remat)
        return init_fusenet_(model.to(self.device),
                             jrandom.key(self.cfg.seed))

    def make_train_step(self, state):
        return make_mf_train_step(state.model, self.ctx, state,
                                  accum_steps=self.accum_steps)

    def make_eval_step(self, model, ctx=None):
        return make_mf_eval_step(model, self.ctx if ctx is None else ctx)
