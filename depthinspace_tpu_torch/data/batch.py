"""Track-major batch container (port of ``depthinspace_tpu/data/dataset.py::
Batch``): the same fields in the same layouts, holding numpy arrays on the
host or tensors on a device."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np


class Batch(NamedTuple):
    """Optional members are None when the data is not loaded."""
    im: Any                           # (tl, bs, H, W) raw IR
    ambient: Any                      # (tl, bs, H, W)
    disp_gt: Any                      # (tl, bs, H, W)
    R: Any                            # (tl, bs, 3, 3)
    t: Any                            # (tl, bs, 3)
    flow: Optional[Any] = None        # (tl, tl, bs, H, W, 2)
    grad: Optional[Any] = None        # (tl, bs, H, W)
    primary_disp: Optional[Any] = None  # (tl, bs, H, W)
    pseudo_gt: Optional[Any] = None   # (tl, bs, H, W)
    sgm_disp: Optional[Any] = None    # (tl, bs, H, W)


_WIRE_TYPES = (np.uint16, np.int16)


def batch_to_torch(batch: Batch, device) -> Batch:
    """numpy Batch -> tensors on ``device`` (None stays None): the 16-bit
    fields of the wire encoding (``data/wire.py``) keep their dtype, so
    they cross to the device at half the bytes and ``wire.decode_batch``
    decodes them there; every other field as float32."""
    import torch      # here: the host tools import this module without it

    def conv(v):
        if v is None:
            return None
        v = np.asarray(v)
        if v.dtype not in _WIRE_TYPES:
            v = v.astype(np.float32, copy=False)
        return torch.as_tensor(np.ascontiguousarray(v), device=device)
    return Batch(*(conv(v) for v in batch))
