"""Weights of the flax ``DispNet`` and ``FuseNet``
(``depthinspace_tpu/models/{dispnet,fusenet}.py``) as a ``state_dict`` for
this package's models, and back.

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
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def _conv_transpose(kernel) -> torch.Tensor:
    k = np.asarray(kernel, np.float32)[::-1, ::-1]
    return torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))


def _bias(b) -> torch.Tensor:
    return torch.from_numpy(np.array(b, np.float32))


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
    arrays, with or without the top-level "params" key."""
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
    arrays, with or without the top-level "params" key; ``model``: the port's
    FuseNet they are for (its block count and widths). Raises if the tree's
    leaves are not the model's parameters."""
    p = tree["params"] if "params" in tree else tree
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(p):
        *mods, name = path
        mods = list(_FUSENET_RENAME.get(tuple(mods), mods))
        a = np.asarray(leaf, np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        key = "bias" if name == "bias" else "weight"
        sd[".".join(mods + [key])] = torch.from_numpy(np.ascontiguousarray(a))
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
