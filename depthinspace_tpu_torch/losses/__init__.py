from .photometric import photometric_loss
from .smoothness import smoothness_loss
from .geometric import (CameraGeometry, flow_consistency_mf,
                        flow_consistency_sf, geometric_loss_mf,
                        geometric_loss_sf, pairwise_indices)
