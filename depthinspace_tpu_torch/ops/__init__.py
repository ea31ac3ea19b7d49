from .sampling import bilinear_sample, warp, resize_bilinear, resize_flow
from .lcn import lcn, box_sum
from .sobel import sobel
from .geometry import (pixel_rays, unproject, project, reproject,
                       disp_to_depth, depth_to_disp)
from .census import census_sad, census_sad_plain, census_sad_bwd_plain
from .resample import (warp_pattern, flow_warp, flow_warp_pairs, warp2d_v1,
                       xwarp_plain, warp2d_plain, warp2d_pairs_plain,
                       xwarp_bwd_plain, warp2d_bwd_plain,
                       warp2d_pairs_bwd_plain)
