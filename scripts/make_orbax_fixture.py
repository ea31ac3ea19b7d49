"""Writes the orbax fixture of the PyTorch port's checkpoint reader:
``tests/data/orbax_fixture/``, the experiment directory the JAX package's
DIS-MF worker leaves after one short epoch, made with the JAX package on the
CPU from a seed.

    python scripts/make_orbax_fixture.py [--out DIR] [--steps N] [--seed S]

FuseNet has the configuration the MF worker and chip_smoke.py phase 12
train (32 channels, tl = 4; its parameters do not depend on the image size)
but one fusion block where they have 4 (the port's MF worker reads the
block count from the saved state on resume), which keeps the fixture at
4.0 MB: with 4 blocks (476,161
parameters) its state, weights file and metadata took 8.0 MB. The epoch is
``--steps`` jitted JAX MF train steps (Adam 1e-4) on 64x56 synthetic
tracks; then the worker's end-of-epoch saves:
``StateCheckpointer.save(0, ...)`` (``multi_frame/state/0/`` and
``multi_frame/state/host_rng_0.pkl``), ``save_net_params`` (``multi_frame/
net_0000.params``) and metrics.json with the epoch's mean train loss. Beside
them, ``expected.npz`` holds every saved leaf's CRC-32 (of its float32 or
int32 bytes, in the flax tree's layout), three sampled values of each ``mu``
and ``nu`` leaf (flat indices 0, n // 2, n - 1), the count, the step and
the key's words, against which the port's reader is checked without JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

H, W, TL = 64, 56, 4
BLOCKS, CHANNELS = 1, 32


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix), tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" /
                                         "orbax_fixture"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax
    from flax import serialization

    from depthinspace_tpu.data.dataset import Batch
    from depthinspace_tpu.models import FuseNet
    from depthinspace_tpu.train import objective
    from depthinspace_tpu.train.checkpoint import (StateCheckpointer,
                                                   save_net_params)
    from depthinspace_tpu.train.state import TrainState
    from depthinspace_tpu.train.steps import _make_step_fns
    from depthinspace_tpu_torch.data import make_settings, make_track_batch

    out = Path(args.out)
    if out.exists():
        shutil.rmtree(out)
    exp = out / "multi_frame"
    exp.mkdir(parents=True)
    settings = make_settings(H, W)
    K = tuple(map(tuple, np.asarray(settings.K, np.float64).tolist()))
    model = FuseNet(imsize=(H, W), K=K, track_length=TL, block_num=BLOCKS,
                    channels=CHANNELS, use_remat=False)
    z = jnp.zeros
    params = model.init(
        jax.random.key(args.seed), z((TL, 1, H, W, 2)), z((TL, 1, H, W, 1)),
        z((TL, 1, H, W, 1)), jnp.ones((TL, 1, H, W, 1)),
        jnp.broadcast_to(jnp.eye(3), (TL, 1, 3, 3)), z((TL, 1, 3)),
        z((TL, TL, 1, H, W, 2)))
    ctx = objective.make_loss_context(settings, track_length=TL)
    opt = optax.adam(1e-4)
    train_step, _, consts = _make_step_fns(model, ctx, opt, "multi_frame")
    step = jax.jit(train_step)
    state = TrainState.create(params, opt, jax.random.key(args.seed + 1))
    comps = []
    for i in range(args.steps):
        b = make_track_batch(settings, tl=TL, bs=1, seed=args.seed + i,
                             disp_range=(2.0, 12.0), primary_noise=0.5)
        state, c = step(state, Batch(**b._asdict()), jnp.asarray(0.0),
                        consts)
        comps.append(np.asarray(c))
        print(f"step {i}: loss components {comps[-1]}")
    mean = [float(c) for c in np.mean(comps, axis=0)]

    np.random.seed(args.seed)           # the host RNG the sidecar saves
    ck = StateCheckpointer(exp)
    ck.save(0, state, {"simple": float(sum(mean))})
    ck.flush()
    ck.close()
    save_net_params(exp, 0, state.params)
    (exp / "metrics.json").write_text(json.dumps(
        {"0": {"train": {"loss": mean}}}, indent=2))

    tree = {"params": jax.tree.map(np.asarray, state.params),
            "mu": jax.tree.map(np.asarray, state.opt_state[0].mu),
            "nu": jax.tree.map(np.asarray, state.opt_state[0].nu)}
    names, crcs, samples = [], [], []
    for name, a in leaves(tree):
        a = np.ascontiguousarray(a)
        names.append(name)
        crcs.append(zlib.crc32(a.tobytes()))
        flat = a.reshape(-1)
        samples.append(flat[[0, flat.size // 2, flat.size - 1]])
    np.savez(out / "expected.npz", names=np.array(names),
             crc32=np.array(crcs, np.uint32),
             samples=np.array(samples, np.float32),
             count=np.asarray(state.opt_state[0].count),
             step=np.asarray(state.step),
             rng_data=np.asarray(jax.random.key_data(state.rng)))
    # the msgpack file holds the same parameters
    back = serialization.from_bytes(params, (exp / "net_0000.params")
                                    .read_bytes())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: {size} bytes in "
          f"{sum(1 for p in out.rglob('*') if p.is_file())} files")


if __name__ == "__main__":
    main()
