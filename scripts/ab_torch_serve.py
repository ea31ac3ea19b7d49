#!/usr/bin/env python3
"""Both servers of the PyTorch port in this checkout against an older
checkout's, on one NVIDIA card, measured in turns.

    mkdir -p build/old && git archive <commit> | tar -x -C build/old
    python3 scripts/ab_torch_serve.py --old build/old --out build/ab_serve.json

Each side runs in a process of its own that imports
``depthinspace_tpu_torch`` from its own root, in the order old, new, new,
old. A side serves, at 512x432 with seeded weights, TF32 off:

- ``DisparityServer`` (DispNet, ``max_batch=8``) a 13-image request;
- ``TrackDisparityServer`` (DispNet, FuseNet bf16 4 blocks x 32,
  ``output/flownet.msgpack`` of its root) a 4-track request with the
  caller's flow and one without it (FlowNet's flow).

Each request is served twice first (whether the two answers are bit for
bit equal), then ``--reps`` times: the rate is items over the host-clock
seconds of those (``infer`` returns numpy). Prints a line a side and run,
the card's name and power limit, and last one JSON object (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, W = 512, 432


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def serve_side(root: Path, reps: int) -> dict:
    """The measurements of one side, with the package under ``root``."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from depthinspace_tpu_torch.data import make_settings, make_track_batch
    from depthinspace_tpu_torch.device import require_cuda
    from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                               init_dispnet_, init_fusenet_)
    from depthinspace_tpu_torch.serve import (DisparityServer,
                                              TrackDisparityServer)
    from depthinspace_tpu_torch.tools.train_flow import load_flow_params
    import depthinspace_tpu_torch
    assert Path(depthinspace_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), depthinspace_tpu_torch.__file__
    dev = require_cuda()
    settings = make_settings(H, W)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    sf = init_dispnet_(DispNet(max_disp=128.0), gen(0))

    def rate(call, n_items: int) -> tuple[float, bool]:
        first, second = call(), call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        return (n_items * reps / (time.perf_counter() - t0),
                bool(np.array_equal(first, second)))

    out = {}
    b = make_track_batch(settings, tl=4, bs=2, seed=0)
    images = np.concatenate([b.im.reshape(8, H, W),
                             b.ambient.reshape(8, H, W)])[:13]
    srv = DisparityServer(sf, imsize=(H, W), max_batch=8, device=dev)
    out["sf_maps_per_s"], out["sf_twice_equal"] = rate(
        lambda: srv.infer(images), 13)
    del srv

    mf = init_fusenet_(FuseNet((H, W), settings.K, 4,
                               compute_dtype=torch.bfloat16), gen(4))
    flow_net, _ = load_flow_params(root / "output" / "flownet.msgpack")
    tb = make_track_batch(settings, tl=4, bs=4, seed=20)
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 0))
    req = (mv(tb.im), mv(tb.ambient), mv(tb.R), mv(tb.t))
    flow = np.ascontiguousarray(np.moveaxis(tb.flow, 2, 0))
    srv = TrackDisparityServer(sf, mf, flow_net, imsize=(H, W),
                               K=settings.K, max_tracks=4, device=dev)
    out["mf_caller_tracks_per_s"], out["mf_caller_twice_equal"] = rate(
        lambda: srv.infer(*req, flow), 4)
    out["mf_learned_tracks_per_s"], out["mf_learned_twice_equal"] = rate(
        lambda: srv.infer(*req), 4)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="root of the older checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:                       # one side, in its own process
        print(json.dumps(serve_side(Path(args.side), args.reps)))
        return

    smi = smi_name_power()
    roots = {"old": Path(args.old), "new": ROOT}
    runs = []
    for side in ("old", "new", "new", "old"):
        res = subprocess.run(
            [sys.executable, __file__, "--old", args.old, "--reps",
             str(args.reps), "--side", str(roots[side])],
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"the {side} side failed")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"side": side, **r})
        print(f"[{side}] " + ", ".join(f"{k} {v:.2f}" if isinstance(
            v, float) else f"{k} {v}" for k, v in r.items()), flush=True)
    print(smi)
    result = {"card": smi, "reps": args.reps, "runs": runs}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
