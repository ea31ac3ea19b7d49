"""DIS-SF / DIS-FTSF worker, port of
``depthinspace_tpu/train/single_frame.py``: the single-frame DispNet, its
train and eval steps, and its datasets (optical flow from flow.hdf5 when
flow_source is "file"; ``use_pseudo_gt`` adds the DIS-FTSF pseudo-GT term
from multi_frame_disp.hdf5)."""

from __future__ import annotations

import torch

from ..data import SyntheticTrackDataset, TrackDataset
from ..models import DispNet, init_dispnet_
from .steps import make_sf_eval_step, make_sf_train_step
from .worker import TestSet, Worker


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

    def make_eval_step(self, model):
        return make_sf_eval_step(model, self.ctx)

    def _dataset(self, samples, train: bool):
        load_flow = self.cfg.flow_source == "file"
        if self.source is not None:
            if self.cfg.use_pseudo_gt or self.cfg.data_type == "real":
                raise ValueError("in-memory synthetic samples carry no "
                                 "pseudo GT and no SGM disparities")
            return SyntheticTrackDataset(
                self.source, samples, track_length=self.cfg.track_length,
                train=train, load_flow=load_flow)
        return TrackDataset(
            self.settings, samples, train=train,
            track_length=self.cfg.track_length, load_flow=load_flow,
            load_pseudo_gt=self.cfg.use_pseudo_gt,
            data_type=self.cfg.data_type)

    def make_train_set(self):
        return self._dataset(self.train_samples, train=True)

    def make_test_sets(self):
        return [TestSet("simple", self._dataset(self.test_samples,
                                                train=False),
                        test_frequency=self.cfg.test_frequency)]
