#!/usr/bin/env python3
"""What the deterministic train path costs the two train steps of
``chip_smoke.py`` on one NVIDIA card: the DIS-SF step of phase 7 (tl=4,
bs=8, 512x432, f32, Adam(1e-4), augmented on the device) and the DIS-MF
step of phase 12 (4 tracks x 4 frames, FuseNet bf16, Adam(1e-4),
augmented).

    python3 scripts/step_cost_ab.py [--parent DIR] [--steps N]

``--parent`` is an unpacked checkout of an older commit (``git archive``),
timed as that commit runs; the whole cost of a change is this tree's step
against the parent's. Each tree runs in processes of its own, in turns
(parent, this tree, this tree, parent), each building its own kernels
first. In this tree's processes each step is also timed on the torch flags
that training ran under before the deterministic mode (cuDNN's default
algorithms, torch's deterministic mode off; this tree's kernels and model
code), in turns with the mode: that ratio is the flags' share of the cost
alone. Each timing is a warm step and N timed ones (host clock around
synchronized steps). Prints one line a step and setting with the card's
name and power limit, then the medians as one JSON line. The program has
no switch for these settings: the script sets the torch flags itself.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
H, W, TL = 512, 432, 4
SF_BS, MF_TRACKS, SEED = 8, 4, 0
FLAGS_BEFORE = "flags before the mode"
CHILD_TIMEOUT_S = 600


@contextmanager
def flags_before_the_mode():
    """cuDNN's default algorithms and torch's deterministic mode off inside,
    the mode's flags again after."""
    import torch
    torch.backends.cudnn.deterministic = False
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)


def child(tree: Path, steps: int, flags: bool) -> None:
    """Times the SF and the MF step of ``tree``'s package; prints
    {step: {setting: [ms, ...]}} as the last line."""
    sys.path.insert(0, str(tree))
    import torch
    from depthinspace_tpu_torch.data import (batch_to_torch, make_settings,
                                             make_track_batch)
    from depthinspace_tpu_torch.device import resolve_device
    from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                               init_dispnet_, init_fusenet_)
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_mf_train_step,
                                              make_sf_train_step)
    from depthinspace_tpu_torch.utils.jrandom import key

    dev = resolve_device(None)
    settings = make_settings(H, W)

    def sf():
        model = init_dispnet_(DispNet(max_disp=128.0).to(dev), key(SEED + 3))
        state = TrainState.create(model, 1e-4, seed=SEED, device=dev)
        ctx = make_loss_context(settings, TL, device=dev, augment=True)
        batch = make_track_batch(settings, tl=TL, bs=SF_BS, seed=SEED + 2)
        return make_sf_train_step(model, ctx, state), batch

    def mf():
        model = init_fusenet_(FuseNet((H, W), settings.K, TL,
                                      compute_dtype=torch.bfloat16).to(dev),
                              key(SEED + 5))
        state = TrainState.create(model, 1e-4, seed=SEED, device=dev)
        ctx = make_loss_context(settings, TL, device=dev, augment=True)
        batch = make_track_batch(settings, tl=TL, bs=MF_TRACKS,
                                 seed=SEED + 20, primary_noise=0.5)
        return make_mf_train_step(model, ctx, state), batch

    settings_order = (["as is", FLAGS_BEFORE, FLAGS_BEFORE, "as is"] if flags
                      else ["as is"])
    out = {}
    for name, make in (("sf", sf), ("mf", mf)):
        step, batch_np = make()
        batch = batch_to_torch(batch_np, dev)
        ms = {k: [] for k in settings_order}
        for k in settings_order:
            with (flags_before_the_mode() if k == FLAGS_BEFORE
                  else nullcontext()):
                step(batch)
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(batch)
                    torch.cuda.synchronize()
                    ms[k].append((time.perf_counter() - t0) * 1e3)
        out[name] = ms
        del step, batch
        torch.cuda.empty_cache()
    print(json.dumps(out))


def build(tree: Path) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from depthinspace_tpu_torch.ops import kernels; kernels.build()")
    return subprocess.Popen([sys.executable, "-c", code, str(tree)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--flags", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.steps, args.flags)
        return

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    trees = {"this tree": ROOT}
    if args.parent is not None:
        trees["parent"] = args.parent.resolve()
    builds = [build(t) for t in trees.values()]
    for proc in builds:
        if proc.wait() != 0:
            sys.exit(f"kernel build failed: {proc.args}")
    order = (["parent", "this tree", "this tree", "parent"]
             if "parent" in trees else ["this tree", "this tree"])
    ms: dict = {}
    for label in order:
        cmd = [sys.executable, __file__, "--child", str(trees[label]),
               "--steps", str(args.steps)]
        if label == "this tree":
            cmd.append("--flags")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT_S)
        if res.returncode != 0:
            sys.exit(f"{label} failed ({res.returncode}):\n{res.stdout}\n"
                     f"{res.stderr}")
        for step, per in json.loads(res.stdout.strip().splitlines()[-1]
                                    ).items():
            for setting, v in per.items():
                key = (label if setting == "as is"
                       else f"{label}, {setting}")
                ms.setdefault(step, {}).setdefault(key, []).extend(v)
    med = {step: {k: float(np.median(v)) for k, v in per.items()}
           for step, per in ms.items()}
    for step, per in ms.items():
        for k, v in per.items():
            print(f"[{step} step] {k}: {med[step][k]:.2f} ms/step (median of "
                  f"{len(v)}, in turns; min {min(v):.2f}, max {max(v):.2f})"
                  f"; {smi}")
        base = med[step]["this tree"]
        if "parent" in per:
            print(f"[{step} step] this tree / parent: "
                  f"{base / med[step]['parent']:.4f}x")
        print(f"[{step} step] this tree / this tree on the flags before the "
              f"mode: {base / med[step][f'this tree, {FLAGS_BEFORE}']:.4f}x")
    print(json.dumps({"card": smi, "ms": med}))


if __name__ == "__main__":
    main()
