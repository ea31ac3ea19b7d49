"""Weights of the flax ``DispNet``, ``FuseNet`` and ``FlowNet``
(``depthinspace_tpu/models/{dispnet,fusenet,flownet}.py``) as a
``state_dict`` for this package's models, and back.

The flax tree, with modules named in creation order, holds 64 leaves:

  params/_Down_{0..6}/Conv_{0,1}/{kernel,bias}      encoder (stride-2, then 1)
  params/_Up_{0..6}/ConvTranspose_0/{kernel,bias}    decoder upsampling
  params/Conv_{0..6}/{kernel,bias}                   iconvs, in call order
  params/SigmoidAffineHead_{0..3}/Conv_0/{kernel,bias}  heads, coarsest first

Conv kernels are HWIO and become OIHW. ConvTranspose kernels are
(kh, kw, in, out) and become torch's (in, out, kh, kw) after a spatial flip
(a flax "SAME" transposed conv correlates with the unflipped kernel).
``flax_tree_from_dispnet_state_dict`` undoes both, so the port can write
``net_%04d.params`` files that the JAX package reads.

The port's FuseNet names its submodules after the flax tree (the frame-major
and the frame-packed flax FuseNet have the same tree), so its weights map by
name: ``block0/conv3d_1/Dense_0/kernel`` is ``block0.conv3d_1.Dense_0.
weight``. Conv kernels HWIO become OIHW, Dense kernels (in, out) become
(out, in), GroupNorm's scale is the weight; the head's ``predict_disp/
Conv_0`` is ``predict_disp.conv``.

An output head's tree (``models/heads.py``) holds one module: a 3x3
conv's kernel and bias (linear, disp, pos) or a per-row linear map's
kernel (H, Ci, F) and bias (H, F) (disp_row, pos_row), which becomes the
port's (H, F, Ci) weight.

FlowNet's tree has 40 leaves, ``encoder/{down,conv}{0..3}`` and
``level{1,2,3}/{dec0,dec1,dec2,flow_head}``, each a 3x3 conv's kernel
(HWIO -> OIHW) and bias; the port's FlowNet has the same module names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .flownet import FlowNet


def _f32(leaf) -> torch.Tensor:
    """A leaf (a numpy array, or a tensor on any device) as float32."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float()
    return torch.tensor(np.asarray(leaf, np.float32))


def _conv(kernel) -> torch.Tensor:
    return _f32(kernel).permute(3, 2, 0, 1).contiguous()


def _conv_transpose(kernel) -> torch.Tensor:
    return _f32(kernel).flip(0, 1).permute(2, 3, 0, 1).contiguous()


def _bias(b) -> torch.Tensor:
    return _f32(b)


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _flax_names():
    """(state_dict prefix, flax path, is a transposed conv) for each layer,
    in flax's creation order (the order of its tree and of its files)."""
    for i in range(7):
        yield f"downs.{i}.conv0", (f"_Down_{i}", "Conv_0"), False
        yield f"downs.{i}.conv1", (f"_Down_{i}", "Conv_1"), False
    for i in range(7):
        yield f"ups.{i}.conv", (f"_Up_{i}", "ConvTranspose_0"), True
        yield f"iconvs.{i}", (f"Conv_{i}",), False
        if i >= 3:
            yield (f"heads.{i - 3}.conv", (f"SigmoidAffineHead_{i - 3}",
                                           "Conv_0"), False)


def dispnet_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """``tree``: the flax variables of DispNet as nested dicts of numpy
    arrays or tensors, with or without the top-level "params" key; the
    weights are on the tensors' device."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {}
    for prefix, path, transposed in _flax_names():
        leaf = p
        for name in path:
            leaf = leaf[name]
        sd[prefix + ".weight"] = (_conv_transpose if transposed
                                  else _conv)(leaf["kernel"])
        sd[prefix + ".bias"] = _bias(leaf["bias"])
    n_leaves = _count_leaves(p)
    if n_leaves != len(sd):
        raise ValueError(f"flax tree has {n_leaves} leaves, the port's "
                         f"DispNet takes {len(sd)}")
    return sd


def flax_tree_from_dispnet_state_dict(sd: Mapping) -> dict:
    """The inverse of :func:`dispnet_state_dict_from_flax`: the flax
    variables {"params": {...}} as nested dicts of float32 numpy arrays."""
    params: dict = {}
    for prefix, path, transposed in _flax_names():
        w = sd[prefix + ".weight"].detach().cpu().numpy().astype(np.float32)
        if transposed:        # (in, out, kh, kw) -> flipped (kh, kw, in, out)
            k = w.transpose(2, 3, 0, 1)[::-1, ::-1]
        else:                 # OIHW -> HWIO
            k = w.transpose(2, 3, 1, 0)
        node = params
        for name in path:
            node = node.setdefault(name, {})
        node["kernel"] = np.ascontiguousarray(k)
        node["bias"] = sd[prefix + ".bias"].detach().cpu().numpy().astype(
            np.float32)
    return {"params": params}


_FUSENET_RENAME = {("predict_disp", "Conv_0"): ("predict_disp", "conv")}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def fusenet_state_dict_from_flax(tree: Mapping,
                                 model: torch.nn.Module) -> dict:
    """``tree``: the flax variables of FuseNet as nested dicts of numpy
    arrays or tensors, with or without the top-level "params" key;
    ``model``: the port's FuseNet they are for (its block count and
    widths). Raises if the tree's leaves are not the model's parameters."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(p):
        *mods, name = path
        mods = list(_FUSENET_RENAME.get(tuple(mods), mods))
        a = _f32(leaf)
        if name == "kernel":
            a = a.permute(3, 2, 0, 1) if a.dim() == 4 else a.T
        key = "bias" if name == "bias" else "weight"
        sd[".".join(mods + [key])] = a.contiguous()
    want = set(model.state_dict())
    if set(sd) != want:
        raise ValueError(
            f"flax tree has {len(sd)} leaves, the port's FuseNet takes "
            f"{len(want)}; not in the model: {sorted(set(sd) - want)[:5]}, "
            f"missing: {sorted(want - set(sd))[:5]}")
    return sd


def flax_tree_from_fusenet_state_dict(sd: Mapping) -> dict:
    """The inverse of :func:`fusenet_state_dict_from_flax`: the flax
    variables {"params": {...}} as nested dicts of float32 numpy arrays."""
    inverse = {v: k for k, v in _FUSENET_RENAME.items()}
    params: dict = {}
    for key, t in sd.items():
        *mods, name = key.split(".")
        mods = inverse.get(tuple(mods), tuple(mods))
        a = t.detach().cpu().numpy().astype(np.float32)
        if name == "bias":
            leaf = "bias"
        elif a.ndim == 1:
            leaf = "scale"
        else:
            leaf = "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": params}


def flownet_state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """``tree``: the flax variables of FlowNet as nested dicts of numpy
    arrays or tensors, with or without the top-level "params" key. Raises
    unless it holds the 40 leaves of the port's FlowNet."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(p):
        *mods, name = path
        sd[".".join(mods + ["weight" if name == "kernel" else name])] = (
            _conv(leaf) if name == "kernel" else _bias(leaf))
    w0 = sd.get("encoder.down0.weight")
    want = set(FlowNet(2 if w0 is None else w0.shape[1]).state_dict())
    if set(sd) != want:
        raise ValueError(
            f"flax tree has {len(sd)} leaves, the port's FlowNet takes "
            f"{len(want)}; not in the model: {sorted(set(sd) - want)[:5]}, "
            f"missing: {sorted(want - set(sd))[:5]}")
    return sd


def flax_tree_from_flownet_state_dict(sd: Mapping) -> dict:
    """The inverse of :func:`flownet_state_dict_from_flax`: the flax
    variables {"params": {...}} as nested dicts of float32 numpy arrays,
    each module's leaves in sorted order as flax writes them."""
    params: dict = {}
    for key in sorted(sd):
        *mods, name = key.split(".")
        a = sd[key].detach().cpu().numpy().astype(np.float32)
        if name == "weight":            # OIHW -> HWIO
            name, a = "kernel", a.transpose(2, 3, 1, 0)
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": params}


_HEAD_PREFIX = {"linear": "", "disp": "conv.", "disp_row": "linear.",
                "pos": "proj.", "pos_row": "proj."}


def head_state_dict_from_flax(tree: Mapping, kind: str) -> dict:
    """``tree``: the flax variables of a ``make_output_head(kind)`` head,
    with or without the top-level "params" key, as a ``state_dict`` of the
    port's head of that kind."""
    p = tree["params"] if "params" in tree else tree
    if "kernel" not in p:               # the head's one submodule
        (p,) = p.values()
    k = _f32(p["kernel"])
    if k.dim() == 4:
        w = _conv(k)
    else:                               # (H, Ci, F) -> (H, F, Ci)
        w = k.permute(0, 2, 1).contiguous()
    prefix = _HEAD_PREFIX[kind]
    return {prefix + "weight": w, prefix + "bias": _bias(p["bias"])}
