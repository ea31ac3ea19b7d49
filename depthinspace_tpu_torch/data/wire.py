"""The 16-bit wire encoding of training batches, port of
``depthinspace_tpu/data/wire.py``.

The JAX worker quantizes every batch it trains or tests on to these 16-bit
formats on the host and decodes them to float32 at the start of its steps,
so the values a model learns from are the decoded ones. The port does the
same for parity: the same flags on the same data give both packages the
same inputs. (On the card it also halves the bytes a batch carries to the
device.)

Formats:
  - im / ambient / grad: [0, 1] x 65535, uint16
  - disp_gt / primary_disp / pseudo_gt / sgm_disp: [0, 256) x 256, uint16
  - flow: [-128, 128) x 256, int16
  - R / t: float32, as they are

:func:`decode_batch` follows the dtype: 16-bit fields are decoded, float32
fields pass through unchanged, so an unencoded batch (tests, the servers'
callers, ``chip_smoke.py``) takes the identity path.
"""

from __future__ import annotations

import numpy as np
import torch

from .batch import Batch

_UNIT = ("im", "ambient", "grad")                     # [0, 1] fields
_DISP = ("disp_gt", "primary_disp", "pseudo_gt", "sgm_disp")
_DISP_SCALE = 256.0
_FLOW_SCALE = 256.0


def encode_batch(batch: Batch) -> Batch:
    """Host side (numpy): quantize the float32 fields to 16 bits, bit for
    bit as the JAX package's ``encode_batch``; other fields pass through."""
    out = {}
    for k in Batch._fields:
        v = getattr(batch, k)
        if v is None or v.dtype != np.float32:
            out[k] = v
        elif k in _UNIT:
            out[k] = np.clip(v * 65535.0 + 0.5, 0, 65535).astype(np.uint16)
        elif k in _DISP:
            out[k] = np.clip(v * _DISP_SCALE + 0.5, 0, 65535).astype(np.uint16)
        elif k == "flow":
            out[k] = np.clip(np.rint(v * _FLOW_SCALE), -32768, 32767).astype(
                np.int16)
        else:
            out[k] = v
    return Batch(**out)


def decode_disp_np(disp) -> np.ndarray:
    """A u16 x256 disparity (the eval step's disp0) as float32 pixels;
    float32 passes through."""
    disp = np.asarray(disp)
    if disp.dtype == np.uint16:
        return disp.astype(np.float32) * (1.0 / _DISP_SCALE)
    return disp.astype(np.float32)


def _scale(name: str, dtype) -> float | None:
    """The factor that decodes field ``name`` stored as ``dtype``, or None
    where it is not encoded."""
    if name in _UNIT and dtype == "uint16":
        return 1.0 / 65535.0
    if name in _DISP and dtype == "uint16":
        return 1.0 / _DISP_SCALE
    if name == "flow" and dtype == "int16":
        return 1.0 / _FLOW_SCALE
    return None


def decode_batch_np(batch: Batch) -> Batch:
    """Host side (numpy): the 16-bit fields of a batch back to float32, for
    the host metrics."""
    out = {}
    for k in Batch._fields:
        v = getattr(batch, k)
        if v is not None:
            v = np.asarray(v)
            s = _scale(k, v.dtype.name)
            if s is not None:
                v = v.astype(np.float32) * s
        out[k] = v
    return Batch(**out)


def decode_batch(batch: Batch) -> Batch:
    """On the batch's device (torch): the 16-bit fields back to float32,
    multiplied in float32 by the same factors as :func:`decode_batch_np`,
    so the values are the same bits; float32 fields pass through."""
    out = {}
    for k in Batch._fields:
        v = getattr(batch, k)
        if v is not None:
            s = _scale(k, str(v.dtype).removeprefix("torch."))
            if s is not None:
                v = v.to(torch.float32) * s
        out[k] = v
    return Batch(**out)
