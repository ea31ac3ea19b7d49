from .batch import Batch, batch_to_torch
from .cache import (BASE_FIELDS, CACHE_DIR_NAME, CachedTrackDataset,
                    build_wire_cache, has_wire_cache)
from .dataset import (DataLoader, SyntheticSource, SyntheticTrackDataset,
                      TrackDataset, collate)
from .settings import Settings, load_settings, save_settings
from .synthetic import (make_settings, make_dot_pattern, make_track_batch,
                        rigid_flow, smooth_disparity)
from .wire import decode_batch, decode_batch_np, decode_disp_np, encode_batch
