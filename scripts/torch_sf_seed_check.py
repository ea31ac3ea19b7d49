#!/usr/bin/env python3
"""How the PyTorch port's self-supervised DIS-SF training depends on the
seed of its init, on one card:

    python3 scripts/torch_sf_seed_check.py --data_dir DIR [--n 320]
        [--procs 8] [--seeds 42,0,1,2,3] [--epochs 5]

Makes ``--n`` synthetic samples at 512x432 in DIR with create_syn_data in
``--procs`` processes when DIR holds none (at 320 the worker's small-set
split tests the first 80 and trains on 240: 30 steps an epoch at bs 8).
Then, for each seed, the SF worker with the staged pipeline's SF recipe
(bs 8, ``--flow_source pred``, device metric, no debug images) is tested at
its init and after each of ``--epochs`` epochs, and its last net is served
on 16 test samples: the signed error (estimate minus GT) over the pixels
with a GT, to tell a biased disparity from a noisy one. Prints one line a
seed and epoch, and one JSON line with every figure.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def generate(data: Path, n: int, procs: int) -> float:
    t0 = time.time()
    step = -(-n // procs)
    children = [subprocess.Popen(
        [sys.executable, "-m", "depthinspace_tpu_torch.tools.create_syn_data",
         "default", "--objects", "procedural", "--data_dir", str(data),
         "--start", str(lo), "--n_samples", str(min(lo + step, n))],
        cwd=ROOT, stdout=subprocess.DEVNULL) for lo in range(0, n, step)]
    if any(c.wait() for c in children):
        raise SystemExit("create_syn_data failed")
    return time.time() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--n", type=int, default=320)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--seeds", default="42,0,1,2,3")
    ap.add_argument("--epochs", type=int, default=5)
    args = ap.parse_args()

    import torch
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.data import hdf5
    from depthinspace_tpu_torch.serve import DisparityServer
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    from depthinspace_tpu_torch.train.worker import split_samples

    data = Path(args.data_dir)
    if not any(data.glob("0*/frames.hdf5")):
        print(f"generated {args.n} samples in "
              f"{generate(data, args.n, args.procs):.1f} s", flush=True)
    samples = sorted(str(p) for p in data.glob("0*/"))
    _, test, _ = split_samples(samples, "synthetic")
    ims, gts = [], []
    for s in test[:16]:
        with hdf5.File(Path(s) / "frames.hdf5") as f:
            ims.append(np.array(f["im"][0, 0], np.float32))
            gts.append(np.array(f["disp"][0, 0], np.float32))
    ims, gts = np.stack(ims), np.stack(gts)
    results = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = data.parent / f"seed_{seed}"
        cfg = RunConfig(data_dir=data, output_dir=out,
                        architecture="single_frame", flow_source="pred",
                        epochs=args.epochs, test_batch_size=16,
                        eval_metrics="device", write_debug_images=False,
                        seed=seed)
        t0 = time.time()
        SingleFrameWorker(cfg).do("test_init")
        SingleFrameWorker(cfg).do("retrain")
        exp = out / "single_frame"
        metrics = json.loads((exp / "metrics.json").read_text())
        srv = DisparityServer.from_net_params(
            exp / f"net_{args.epochs - 1:04d}.params", imsize=ims.shape[1:],
            max_batch=16)
        err = (srv.infer(ims) - gts)[gts > 0]
        row = {"epochs": {}, "signed_error_median": float(np.median(err)),
               "signed_error_mean": float(err.mean()),
               "seconds": time.time() - t0}
        for ep in sorted(metrics, key=int):
            t = metrics[ep]["test"]["0"]
            row["epochs"][ep] = {k: t[k] for k in (
                "dist2_mean", "dist2_median", "of0.5", "of1", "of2", "of5")}
            print(f"seed {seed} epoch {ep}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["epochs"][ep].items()),
                flush=True)
        print(f"seed {seed}: last net's signed error (estimate - GT) on 16 "
              f"test frames: median {row['signed_error_median']:.3f} px, "
              f"mean {row['signed_error_mean']:.3f}; {row['seconds']:.1f} s",
              flush=True)
        results[seed] = row
        torch.cuda.empty_cache()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
