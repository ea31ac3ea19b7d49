"""DIS-MF worker, port of ``depthinspace_tpu/train/multi_frame.py``:
FuseNet over tracks of 4 frames, whose datasets also load the DIS-SF
primary disparities (single_frame_disp.hdf5) that seed the fusion. With
in-memory synthetic samples the primary is the source's seeded stand-in
(``SyntheticSource(primary_noise=...)``)."""

from __future__ import annotations

import torch

from ..models import FuseNet, init_fusenet_
from .steps import make_mf_eval_step, make_mf_train_step
from .worker import Worker


class MultiFrameWorker(Worker):
    architecture = "multi_frame"

    def make_model(self) -> FuseNet:
        """A seeded init (flax's defaults; the JAX package's init draws
        other numbers from the same seed)."""
        H, W = self.imsize
        model = FuseNet(imsize=(H, W), K=self.settings.K,
                        track_length=self.cfg.track_length,
                        max_disp=self.cfg.max_disp,
                        compute_dtype=getattr(torch, self.cfg.mf_dtype),
                        use_remat=self.cfg.mf_remat)
        return init_fusenet_(model, torch.Generator().manual_seed(
            self.cfg.seed))

    def make_train_step(self, state):
        return make_mf_train_step(state.model, self.ctx, state,
                                  accum_steps=self.accum_steps)

    def make_eval_step(self, model, ctx=None):
        return make_mf_eval_step(model, self.ctx if ctx is None else ctx)
