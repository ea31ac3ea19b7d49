"""flax's ``Module.init`` in PyTorch: the same weights from the same key.

flax gives the ``self.param`` calls of the module at path ``p1/p2/...`` the
keys ``fold_in(root, u32(sha1(b"p1" + b"p2" + ... + counter)[:4]))``, where
the counter (1, 2, ... as big-endian bytes) numbers the module's
``self.param`` calls in creation order, constant initializers included
(``flax/core/scope.py``: ``LazyRng``, ``_fold_in_static``, ``make_rng``).
Each leaf is then drawn by its initializer (``jax.nn.initializers``):

  lecun_normal    truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.8796...
  xavier_uniform  uniform(-1, 1) * sqrt(3 / ((fan_in + fan_out) / 2))
  zeros, ones

with fan_in = shape[-2] * the product of the leading axes (a per-row
linear map's (H, Ci, F) kernel has fan-in H * Ci) and fan_out = shape[-1].

A template lists each module's leaves as (path, [(name, flax shape,
initializer), ...]) in ``self.param`` order; it is read off the port's
module (its weights' shapes, and the flax names ``models/convert.py``
maps), and :func:`flax_init` draws the flax tree on the model's device,
which the converters turn into the port's ``state_dict`` there. So
``init_dispnet_(model, key(42))`` gives the weights of
``DispNet().init(jax.random.key(42), x)``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterable, Sequence

import numpy as np
import torch
from torch import nn

from ..utils import jrandom
from ..utils.jrandom import Key

Leaf = tuple[str, tuple, str]              # (name, flax shape, initializer)
Template = Iterable[tuple[tuple, Sequence[Leaf]]]


def param_key(root: Key, path: Sequence[str], counter: int) -> Key:
    """The key of the ``counter``-th ``self.param`` call of the module at
    ``path`` under ``Module.init(root)``."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return jrandom.fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _fans(shape: tuple) -> tuple[float, float]:
    receptive = math.prod(shape) / shape[-2] / shape[-1]
    return shape[-2] * receptive, shape[-1] * receptive


def draw_leaf(k: Key, shape: tuple, initializer: str,
              device=None) -> torch.Tensor:
    """One leaf of flax shape ``shape``, float32, by ``initializer``."""
    if initializer == "zeros":
        return torch.zeros(shape, device=device)
    if initializer == "ones":
        return torch.ones(shape, device=device)
    fan_in, fan_out = _fans(shape)
    if initializer == "lecun_normal":
        variance = np.float32(1.0 / fan_in)
        std = np.float32(np.sqrt(variance)) / np.float32(.87962566103423978)
        return jrandom.truncated_normal(k, -2.0, 2.0, shape,
                                        device=device) * float(std)
    if initializer == "xavier_uniform":
        variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
        scale = np.sqrt(np.float32(3) * variance)
        return jrandom.uniform(k, shape, torch.float32, -1.0, 1.0,
                               device=device) * float(scale)
    raise ValueError(f"unknown initializer {initializer!r}")


def flax_init(template: Template, root: Key, device=None) -> dict:
    """The flax tree {"params": {...}} (nested dicts of float32 tensors)
    that ``Module.init(root)`` gives the module ``template`` describes."""
    params: dict = {}
    for path, leaves in template:
        node = params
        for name in path:
            node = node.setdefault(name, {})
        for counter, (name, shape, initializer) in enumerate(leaves, 1):
            node[name] = draw_leaf(param_key(root, path, counter),
                                   tuple(shape), initializer, device)
    return {"params": params}


def _hwio(w: torch.Tensor) -> tuple:
    """A flax conv kernel's shape (kh, kw, in, out) from torch's OIHW."""
    o, i, kh, kw = w.shape
    return (kh, kw, i, o)


def _conv(path, w: torch.Tensor, bias: bool = True):
    leaves = [("kernel", _hwio(w), "lecun_normal")]
    if bias:
        leaves.append(("bias", (w.shape[0],), "zeros"))
    return path, leaves


def dispnet_template(model: nn.Module) -> list:
    """DispNet's modules in flax's naming (``convert._flax_names``)."""
    from .convert import _flax_names
    out = []
    for prefix, path, transposed in _flax_names():
        w = model.get_parameter(prefix + ".weight")
        if transposed:          # torch (in, out, kh, kw) -> (kh, kw, in, out)
            i, o, kh, kw = w.shape
            out.append((path, [("kernel", (kh, kw, i, o), "lecun_normal"),
                               ("bias", (o,), "zeros")]))
        else:
            out.append(_conv(path, w))
    return out


def flownet_template(model: nn.Module) -> list:
    """FlowNet's 3x3 convs, named as the flax tree (module paths equal)."""
    from .dispnet import SameConv2d
    return [_conv(tuple(name.split(".")), mod.weight)
            for name, mod in model.named_modules()
            if isinstance(mod, SameConv2d)]


def fusenet_template(model: nn.Module) -> list:
    """FuseNet's modules; their names are the flax tree's but the head's
    conv (``predict_disp.conv`` is flax's ``predict_disp/Conv_0``)."""
    from .dispnet import SameConv2d
    from .fusenet import Conv, Dense, GroupNorm
    out = []
    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        if path == ("predict_disp", "conv"):
            path = ("predict_disp", "Conv_0")
        if isinstance(mod, (Conv, SameConv2d)):
            out.append(_conv(path, mod.weight))
        elif isinstance(mod, Dense):
            fout, fin = mod.weight.shape
            leaves = [("kernel", (fin, fout), "xavier_uniform"
                       if mod.init == "xavier" else "lecun_normal")]
            if mod.bias is not None:
                leaves.append(("bias", (fout,), "zeros"))
            out.append((path, leaves))
        elif isinstance(mod, GroupNorm):
            c = mod.weight.shape[0]
            out.append((path, [("scale", (c,), "ones"),
                               ("bias", (c,), "zeros")]))
    return out


# the flax module path of each head kind's parameters
_HEAD_PATH = {"linear": (), "disp": ("Conv_0",),
              "disp_row": ("MultiLinear_0",), "pos": ("Conv_0",),
              "pos_row": ("MultiLinear_0",)}


def head_template(head: nn.Module, kind: str) -> list:
    """A ``make_output_head(kind)`` head: one 3x3 conv, or a per-row linear
    map with kernel (H, Ci, F) (the port's weight is (H, F, Ci))."""
    w = next(p for n, p in head.named_parameters() if n.endswith("weight"))
    path = _HEAD_PATH[kind]
    if w.dim() == 4:
        return [_conv(path, w)]
    h, f, ci = w.shape
    return [(path, [("kernel", (h, ci, f), "lecun_normal"),
                    ("bias", (h, f), "zeros")])]


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def load_flax_init_(model: nn.Module, template: Template, k: Key,
                    to_state_dict) -> nn.Module:
    """Draws ``flax_init(template, k)`` on the model's device and loads it
    through ``to_state_dict`` (a converter of ``models/convert.py``)."""
    model.load_state_dict(to_state_dict(flax_init(template, k,
                                                  _device(model))))
    return model
