"""A reader of the training state the JAX package saves with orbax
(``depthinspace_tpu/train/checkpoint.py::StateCheckpointer``), without
orbax, tensorstore or zstandard, so that a run started there continues here.

One saved epoch is a step directory ``<exp_dir>/state/<epoch>/`` (or
``state_set_<name>_best/<epoch>/``) with ``_CHECKPOINT_METADATA``,
``meta/metadata`` (JSON: {"epoch", "min_err"}) and ``state/``: an OCDBT
store (``utils/ocdbt.py``) of zarr v2 arrays, one per leaf of the saved
tree {"params", "opt_state", "step", "rng_data"}, named by the leaf's path
joined with "." (``opt_state.0.mu.params.Conv_0.kernel``), and
``state/_METADATA``, the tree's paths. Beside the step directory,
``host_rng_<epoch>.pkl`` pickles numpy's and python's RNG states.

A zarr v2 array is ``<name>/.zarray`` (JSON: shape, chunks, dtype, order,
fill_value, compressor, dimension_separator) and one value per chunk,
``<name>/<i>.<j>...`` (``<name>/0`` for a scalar), each chunk stored at the
full chunk shape and compressed by its compressor (orbax: zstd, decoded by
``utils/zstd.py``). A chunk that is not stored holds the fill value.
Dtypes ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``<u4``, ``|u1``, ``|b1`` read as
they are, ``bfloat16`` widens exactly to float32.

:func:`restore_from_orbax` moves one step into the port's ``TrainState``:
the parameters and Adam's moments ``mu`` and ``nu`` go through the
converters of ``models/convert.py`` (transposes and flips only, and Adam is
elementwise, so the moments map exactly), the count becomes each
parameter's Adam ``step``; optax.adam and ``torch.optim.Adam`` compute the
same update from them. ``rng_data``, the raw uint32 words of the JAX key,
is the step key (``utils/jrandom.py``), so a resumed run continues on the
JAX run's own draws.
"""

from __future__ import annotations

import json
import math
import pickle
import random
from pathlib import Path

import numpy as np
import torch

from ..models import (FuseNet, dispnet_state_dict_from_flax,
                      fusenet_state_dict_from_flax)
from ..utils import jrandom, zstd
from ..utils.ocdbt import OcdbtStore
from .state import TrainState

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
           "<i8": np.int64, "<u4": np.uint32, "|u1": np.uint8,
           "|b1": np.bool_, "bfloat16": np.uint16}


class OrbaxFormatError(ValueError):
    """A step directory that this reader cannot read."""


def is_orbax_step(path) -> bool:
    """Whether ``path`` is an orbax step directory with an OCDBT state."""
    p = Path(path)
    return ((p / "_CHECKPOINT_METADATA").is_file()
            and (p / "state" / "manifest.ocdbt").is_file())


def _nest(tree: dict, path: list[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def read_zarr_array(store: OcdbtStore, name: str,
                    where: str = "") -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` as a numpy array."""
    z = json.loads(store.read(f"{name}/.zarray"))
    where = f"{where}: {name}"
    if z.get("zarr_format") != 2 or z.get("filters"):
        raise OrbaxFormatError(f"{where}: zarr format "
                               f"{z.get('zarr_format')} with filters "
                               f"{z.get('filters')}")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{where}: compressor {comp.get('id')}")
    if z["dtype"] not in _DTYPES:
        raise OrbaxFormatError(f"{where}: dtype {z['dtype']}")
    dtype = np.dtype(_DTYPES[z["dtype"]])
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    order, sep = z.get("order", "C"), z.get("dimension_separator", ".")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    fill = z.get("fill_value") or 0
    if isinstance(fill, str):           # "NaN", "Infinity", "-Infinity"
        fill = float(fill.replace("Infinity", "inf"))
    if z["dtype"] == "bfloat16":        # its bits, rounded to nearest even
        bits = int(np.float32(fill).view(np.uint32))
        fill = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    out = None
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = store.read(key)
        data = (zstd.decompress(raw) if comp
                else np.frombuffer(raw, np.uint8))
        if data.size != dtype.itemsize * math.prod(chunks):
            raise OrbaxFormatError(f"{where}: chunk {key} holds "
                                   f"{data.size} bytes")
        chunk = data.view(dtype).reshape(chunks, order=order)
        if chunks == shape:         # one chunk: no copy
            out = chunk
            break
        if out is None:
            out = np.full(shape, fill, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = chunk[
            tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if out is None:
        out = np.full(shape, fill, dtype)
    if z["dtype"] == "bfloat16":
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out if out.flags.c_contiguous else np.ascontiguousarray(out)


class OrbaxStep:
    """One orbax step directory: :meth:`tree`, :meth:`meta` and
    :meth:`host_rng`."""

    def __init__(self, step_dir):
        self.dir = Path(step_dir)
        if not is_orbax_step(self.dir):
            raise OrbaxFormatError(f"{self.dir} is not an orbax step "
                                   "directory with an OCDBT state")
        self.store = OcdbtStore(self.dir / "state")
        self._metadata = json.loads(
            (self.dir / "state" / "_METADATA").read_text())
        if self._metadata.get("use_zarr3"):
            raise OrbaxFormatError(f"{self.dir}: zarr v3 arrays are not "
                                   "supported")

    def modules(self) -> set[str]:
        """The top-level module names of the saved parameters, as flax
        names them, from ``state/_METADATA`` alone (no array is read)."""
        out = set()
        for entry in self._metadata["tree_metadata"].values():
            path = [str(k["key"]) for k in entry["key_metadata"]]
            if path[0] == "params":
                out.add(next(k for k in path[1:] if k != "params"))
        return out

    def tree(self) -> dict:
        """The saved tree as nested dicts of numpy arrays, sequence indices
        as string keys ("opt_state" -> "0" -> "mu" -> ...)."""
        tree: dict = {}
        for entry in self._metadata["tree_metadata"].values():
            path = [str(k["key"]) for k in entry["key_metadata"]]
            value = entry.get("value_metadata", {})
            if value.get("skip_deserialize"):
                continue
            if value.get("value_type") not in ("jax.Array", "np.ndarray"):
                raise OrbaxFormatError(
                    f"{self.dir}: leaf {'.'.join(path)} is a "
                    f"{value.get('value_type')}, not an array")
            _nest(tree, path, read_zarr_array(self.store, ".".join(path),
                                              where=str(self.dir)))
        return tree

    def meta(self) -> dict:
        """{"epoch": int, "min_err": {set: float}}."""
        return json.loads((self.dir / "meta" / "metadata").read_text())

    def host_rng(self) -> dict | None:
        """{"numpy": state, "python": state} from ``host_rng_<epoch>.pkl``
        beside the step directory, None when there is none."""
        path = self.dir.parent / f"host_rng_{self.dir.name}.pkl"
        if not path.exists():
            return None
        with open(path, "rb") as f:
            return pickle.load(f)


def _state_dict(tree: dict, model: torch.nn.Module) -> dict:
    if isinstance(model, FuseNet):
        return fusenet_state_dict_from_flax(tree, model)
    return dispnet_state_dict_from_flax(tree)


def restore_from_orbax(step_dir, state: TrainState):
    """Loads the orbax step ``step_dir`` into ``state`` (its DispNet or
    FuseNet, its Adam, step and key) and the host's numpy and python RNGs.
    Returns (state, epoch, min_err)."""
    ck = OrbaxStep(step_dir)
    tree = ck.tree()
    model = state.model
    state.model.load_state_dict(_state_dict(tree["params"], model))
    adam = tree["opt_state"]["0"]
    mu, nu = _state_dict(adam["mu"], model), _state_dict(adam["nu"], model)
    count = torch.tensor(float(adam["count"]))
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {"step": count.clone(), "exp_avg": mu[name],
                        "exp_avg_sq": nu[name]}
                    for i, (name, _) in enumerate(model.named_parameters())}
    state.optimizer.load_state_dict(opt)
    state.step = int(tree["step"])
    state.rng = jrandom.wrap_key_data(tree["rng_data"])
    host = ck.host_rng()
    if host is not None:
        np.random.set_state(host["numpy"])
        random.setstate(host["python"])
    meta = ck.meta()
    return state, int(meta["epoch"]), {k: float(v) for k, v in
                                       meta["min_err"].items()}
