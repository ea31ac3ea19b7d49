"""``jax.random`` in PyTorch: threefry-2x32 keys and the draws the JAX
package makes, bit for bit, on any device.

The JAX package runs jax's default PRNG, threefry-2x32 with the
"partitionable" layout (``jax_threefry_partitionable``, the default since
jax 0.5), and 32-bit integers (x64 off). This module carries its
specification (``jax/_src/prng.py``, ``jax/_src/random.py``):

  - a key is two uint32 words, ``key(seed) = [0, seed mod 2^32]`` (x64
    off converts the seed to int32 first, so only its low 32 bits count);
  - ``threefry2x32(key, (x0, x1))`` is 20 rounds of add, rotate and xor
    with a key injection every 4 rounds;
  - ``split(key, n)[i]`` hashes the counter pair (0, i), ``fold_in(key,
    d)`` the pair (0, d); a draw of ``shape`` hashes, for flat index j,
    the pair (j >> 32, j & 0xFFFFFFFF) and takes the xor of the two words.
    So a value depends on (key, flat index) only, and ``bits_at`` draws any
    subset of a global array (a data-parallel rank's share) without the
    rest;
  - ``uniform`` puts the high mantissa bits under the exponent of 1.0
    (8 random bits for bf16), ``normal`` is ``sqrt(2) * erf_inv(u)`` with
    u uniform on (-1, 1), ``truncated_normal`` the same between
    ``erf(lower / sqrt 2)`` and ``erf(upper / sqrt 2)``.

The float steps follow XLA's CPU code, so that the draws equal the JAX
package's on the CPU bit for bit: ``erf_inv`` is XLA's single-precision
polynomial (Giles), whose ``log1p`` is XLA's (a rational function below
sqrt(2) - 1, else Cephes' ``log(1 + x)``), and ``erf`` is XLA's rational
approximation; XLA's CPU compiler contracts each ``a * b + c`` of these
polynomials into a fused multiply-add, so they do too (:func:`_fma`, an
exact fmaf from float64 steps). ``torch.erfinv`` and ``torch.erf`` differ
from XLA's by up to 64 and 5 ulp, and torch's float32 square root on
the CPU is not always the correctly rounded one, so :func:`_sqrt` takes it
in float64.

Integers: int64 tensors holding uint32 values; the hash itself runs on
their int32 bit patterns (adds wrap, right shifts masked), since torch's
uint32 lacks shifts and adds on the CPU. Keys are host
tuples of two Python ints, so the train step splits and folds them with no
device work; ``csrc/threefry.cu`` draws the step's large arrays on the
card (``ops/kernels.py::threefry_draw``), and :func:`draw` picks it for a
CUDA device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


class Key(NamedTuple):
    """A threefry key: ``jax.random.key_data(key)``'s two words."""
    k0: int
    k1: int


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` with x64 off."""
    return Key(0, int(seed) & _M)


def key_data(k: Key) -> np.ndarray:
    return np.array(k, np.uint32)


def wrap_key_data(data) -> Key:
    """A key from its two words (``jax.random.key_data``'s, or an orbax
    ``rng_data`` array)."""
    words = np.asarray(data).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a threefry key has 2 words, got {words.shape[0]}")
    return Key(int(words[0]) & _M, int(words[1]) & _M)


def _i32(v: int) -> int:
    """A uint32 value as the int32 with its bits."""
    return v - (1 << 32) if v & 0x80000000 else v


def threefry2x32(k: Key, x0, x1):
    """The threefry-2x32 hash of the counter pairs (x0, x1) under key k.
    x0, x1: Python ints, or int64 tensors holding uint32 values; returns
    the two output words alike. Tensors are hashed as int32 bit patterns
    (adds wrap, right shifts are masked), in place."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    if not isinstance(x0, torch.Tensor):
        x0 = (x0 + ks[0]) & _M
        x1 = (x1 + ks[1]) & _M
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1) & _M
                x1 = ((x1 << r) & _M) | (x1 >> (32 - r))
                x1 = x0 ^ x1
            x0 = (x0 + ks[(i + 1) % 3]) & _M
            x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
        return x0, x1
    x0 = (x0 & _M).to(torch.int32).add_(_i32(ks[0]))
    x1 = (x1 & _M).to(torch.int32).add_(_i32(ks[1]))
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            tmp.bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(_i32(ks[(i + 1) % 3]))
        x1.add_(_i32((ks[(i + 2) % 3] + i + 1) & _M))
    return x0.to(torch.int64) & _M, x1.to(torch.int64) & _M


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)``."""
    return [Key(*threefry2x32(k, 0, i)) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``."""
    return Key(*threefry2x32(k, 0, int(data) & _M))


def bits_at(k: Key, index: torch.Tensor) -> torch.Tensor:
    """The 32 random bits at the given flat indices (int64) of any array
    drawn from k: ``jax.random.bits(k, shape).ravel()[index]``. Returns
    int64 holding uint32 values, shaped like ``index``."""
    if index.device.type == "cpu" and index.numel() > _CHUNK:
        # in cache-sized pieces: the ~130 passes of the hash stay in cache
        flat = index.reshape(-1)
        return torch.cat([bits_at(k, flat[i:i + _CHUNK])
                          for i in range(0, flat.numel(), _CHUNK)]
                         ).reshape(index.shape)
    y0, y1 = threefry2x32(k, index >> 32, index & _M)
    return y0 ^ y1


_CHUNK = 1 << 18


def bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64."""
    n = math.prod(shape)
    return bits_at(k, torch.arange(n, dtype=torch.int64, device=device)
                   ).reshape(tuple(shape))


def block_index(count: int, run: int, stride: int, offset: int,
                device=None) -> torch.Tensor:
    """Flat indices ``offset + (i // run) * stride + i % run`` for i <
    count: runs of ``run`` consecutive elements every ``stride`` (a rank's
    share of a global array whose leading axes it shares in blocks)."""
    i = torch.arange(count, dtype=torch.int64, device=device)
    return offset + torch.div(i, run, rounding_mode="floor") * stride \
        + torch.remainder(i, run)


# ------------------------------------------------------------ float steps

def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fmaf(a, b, c): a * b + c rounded once to float32 (a float32 tensor,
    b and c float32 tensors or floats). The float64 product is exact, and
    rounding the float64 sum s to float32 is the single rounding but where
    s lies exactly halfway between two floats; there the sum's error
    (TwoSum) decides. (Subnormal results round twice: XLA's CPU code
    flushes them to zero anyway.)"""
    c64 = torch.as_tensor(c, dtype=torch.float64, device=a.device)
    s = a.double().mul_(b if not isinstance(b, torch.Tensor)
                        else b.double()).add_(c64)
    f = s.float()
    odd = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if not bool(odd.any()):
        return f
    idx = odd.nonzero(as_tuple=True)
    bi = b if not isinstance(b, torch.Tensor) else b.expand_as(a)[idx].double()
    pi = a[idx].double() * bi
    si, ci = s[idx], c64.expand_as(s)[idx]
    bb = si - pi
    err = (pi - (si - bb)) + (ci - bb)
    fi = f[idx]
    toward = torch.where(si > fi.double(), math.inf, -math.inf).float()
    g = torch.nextafter(fi, toward)
    fix = ((fi.double() + g.double()) * 0.5 == si) & (err != 0)
    f[idx] = torch.where(fix, torch.where(err > 0, torch.maximum(fi, g),
                                          torch.minimum(fi, g)), fi)
    return f


def _split_eval(mask: torch.Tensor, x: torch.Tensor, fn_true, fn_false
                ) -> torch.Tensor:
    """torch.where(mask, fn_true(x), fn_false(x)), each function run on its
    elements only (all of fn's operations are elementwise)."""
    flat, mask = x.reshape(-1), mask.reshape(-1)
    out = torch.empty_like(flat)
    for m, fn in ((mask, fn_true), (~mask, fn_false)):
        idx = m.nonzero().squeeze(1)
        if idx.numel():
            out.index_copy_(0, idx, fn(flat.index_select(0, idx)))
    return out.reshape(x.shape)


def _horner(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    p = torch.full_like(x, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        p = _fma(p, x, float(np.float32(c)))
    return p


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's Cephes log, f32 (polynomial_approximations.cc)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, for positive normal x."""
    m, e = torch.frexp(x)
    e = e.float()
    small = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(x, _f32(p[0]), _f32(p[1]))
    y1 = _fma(x, _f32(p[3]), _f32(p[4]))
    y2 = _fma(x, _f32(p[6]), _f32(p[7]))
    y = _fma(y, x, _f32(p[2]))
    y1 = _fma(y1, x, _f32(p[5]))
    y2 = _fma(y2, x, _f32(p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f32(-2.12194440e-4) * e)
    x = x - 0.5 * x2
    x = x + y
    return _fma(e, _f32(0.693359375), x)


_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = (x * x2) * small
    small = _fma(x2, -0.5, small)
    return x + small


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p (elemental_ir_emitter.cc) for x in (-1, 0]:
    a rational function below sqrt(2) - 1, else log(1 + x)."""
    return _split_eval(torch.abs(x) < 0.41421356237309504880, x,
                       _log1p_small, lambda v: _log(v + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (torch's CPU kernel is
    not, in 0.6 % of values), through float64."""
    return torch.sqrt(x.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv`` (Giles' polynomial), for x in [-1, 1]."""
    x = x.float()
    if x.device.type == "cpu" and x.numel() > _CHUNK:
        return torch.cat([erf_inv(c) for c in x.reshape(-1).split(_CHUNK)]
                         ).reshape(x.shape)
    w = -_log1p(-(x * x))
    p = _split_eval(w < 5.0, w,
                    lambda v: _horner(v - 2.5, _ERFINV_LT5),
                    lambda v: _horner(_sqrt(v) - 3.0, _ERFINV_GE5))
    out = p * x
    return torch.where(torch.abs(x) == 1.0,
                       x * torch.finfo(torch.float32).max, out)


_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)


def erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``Erf`` (a rational function on [-c, c], c =
    erfinv(1 - 2^-23))."""
    x = torch.clamp(x.float(), -3.7439211627767994, 3.7439211627767994)
    x2 = x * x
    return (x * _horner(x2, _ERF_ALPHA)) / _horner(x2, _ERF_BETA)


# ------------------------------------------------------------------ draws

_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _unit_floats(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[1, 2) - 1 from random bits (int64 holding uint32), as jax's uniform
    does: f32 from the top 23 bits, bf16 from the low byte's top 7."""
    if dtype == torch.float32:
        f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        return f - 1.0
    if dtype == torch.bfloat16:
        f = (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
        return f - torch.ones((), dtype=dtype, device=b.device)
    raise TypeError(f"uniform: float32 or bfloat16, got {dtype}")


def _scale_uniform(u: torch.Tensor, minval: float, maxval: float
                   ) -> torch.Tensor:
    dt = u.dtype
    lo = torch.tensor(minval, dtype=dt, device=u.device)
    hi = torch.tensor(maxval, dtype=dt, device=u.device)
    if dt == torch.float32:
        out = _fma(u, hi - lo, lo)
    else:
        out = u * (hi - lo) + lo
    return torch.maximum(lo, out)


def _uniform_from_bits(b, dtype, minval, maxval):
    return _scale_uniform(_unit_floats(b, dtype), minval, maxval)


def _normal_from_bits(b, dtype):
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0))) \
        if dtype == torch.float32 else float(
            torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                            torch.tensor(0.0, dtype=dtype)))
    u = _uniform_from_bits(b, dtype, lo, 1.0)
    r = erf_inv(u).to(dtype)
    return torch.tensor(_SQRT2, dtype=dtype, device=b.device) * r


def _bits(k: Key, shape, device, index: Optional[torch.Tensor]):
    if index is None:
        return bits(k, shape, device)
    return bits_at(k, index.to(device)).reshape(tuple(shape))


def uniform(k: Key, shape: Sequence[int] = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *, device=None,
            index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype, minval, maxval)``; with
    ``index``, the elements at those flat indices of a larger draw from k,
    shaped ``shape``."""
    return _uniform_from_bits(_bits(k, shape, device, index), dtype,
                              minval, maxval)


def normal(k: Key, shape: Sequence[int] = (), dtype=torch.float32, *,
           device=None, index: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` (float32, or bfloat16 by
    jax's 16-bit path: 8 random bits, erf_inv in float32); ``index`` as in
    :func:`uniform`."""
    return _normal_from_bits(_bits(k, shape, device, index), dtype)


def truncated_normal(k: Key, lower: float, upper: float,
                     shape: Sequence[int] = (), *, device=None
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal(k, lower, upper, shape)``, float32."""
    bounds = torch.tensor([lower, upper], dtype=torch.float32)
    a, b = erf(bounds / _SQRT2).tolist()
    u = uniform(k, shape, torch.float32, a, b, device=device)
    out = _SQRT2 * erf_inv(u)
    lo = torch.nextafter(bounds[0], torch.tensor(math.inf))
    hi = torch.nextafter(bounds[1], torch.tensor(-math.inf))
    return torch.clamp(out, float(lo), float(hi))


def draw(k: Key, shape: Sequence[int], transform: str, dtype=torch.float32,
         minval: float = 0.0, maxval: float = 1.0, *, device=None,
         run: Optional[int] = None, stride: int = 0, offset: int = 0
         ) -> torch.Tensor:
    """``uniform`` (minval, maxval) or ``normal`` draws at the flat indices
    ``block_index(count, run, stride, offset)`` of a draw from k (``run``
    None: the whole array, indices 0..count-1), shaped ``shape``.

    On a CUDA device one launch of ``csrc/threefry.cu`` makes them; on
    the CPU the plain functions above."""
    count = math.prod(shape)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        from ..ops import kernels
        return kernels.threefry_draw(k, tuple(shape), transform, dtype,
                                     minval, maxval, device=dev,
                                     run=count if run is None else run,
                                     stride=stride, offset=offset)
    index = None if run is None else block_index(count, run, stride, offset,
                                                 dev)
    if transform == "uniform":
        return uniform(k, shape, dtype, minval, maxval, device=dev,
                       index=index)
    if transform == "normal":
        return normal(k, shape, dtype, device=dev, index=index)
    raise ValueError(f"draw: transform 'uniform' or 'normal', got "
                     f"{transform!r}")
