from .batch import Batch, batch_to_torch
from .dataset import (DataLoader, SyntheticSource, SyntheticTrackDataset,
                      TrackDataset, collate)
from .settings import Settings, load_settings, save_settings
from .synthetic import (make_settings, make_dot_pattern, make_track_batch,
                        rigid_flow, smooth_disparity)
