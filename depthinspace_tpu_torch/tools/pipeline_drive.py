"""The staged accuracy pipeline in one process, with wall-clock deadlines,
port of ``scripts/pipeline_drive.py``:

  DIS-SF selfsup -> full-split SF retest -> presave SF disparities ->
  DIS-MF -> full-split MF retest -> presave MF disparities ->
  DIS-FTSF (pseudo-GT fine-tune) -> full-split FTSF retest

  python -m depthinspace_tpu_torch.tools.pipeline_drive --minutes 50 \\
      --flow_source pred --sf_epochs 19 --mf_epochs 7

Paths come from config.json (DATA_DIR, OUTPUT_DIR; ``DIS_CONFIG`` names
another). Each train stage gets a wall-clock budget through
``RunConfig.deadline_ts`` and stops after the epoch in flight (checkpoints
and metrics.json are per epoch, so a cut loses nothing); a rerun resumes
each stage from its checkpoints. The budget: ``--reserve_s`` is kept for
the presaves and retests, SF takes ``--sf_frac`` of the rest, MF
``--mf_frac / (1 - sf_frac)`` of what is left after SF, and FTSF runs until
``0.4 * reserve_s`` before the end. After the MF presave the self-supervised
SF directory is archived as ``single_frame_selfsup/``, and FTSF trains in a
new ``single_frame/``. ``OUTPUT_DIR/pipeline_summary.json`` holds each
stage's metrics.json (``sf_selfsup``, ``sf``, ``mf``) and, beside the JAX
script's keys, ``stage_seconds``.

The presaves cover the samples of the worker's test and train splits
(``train.worker.split_samples``): indices 512 to the end of a synthetic set
of more than 1024 samples, as the JAX script's ``512:{n}``, and every
sample of a smaller set (test = the first quarter). ``main(argv,
device=None)`` runs on the card; ``device="cpu"`` only when asked for.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

from ..config import RunConfig, load_paths
from ..train.multi_frame import MultiFrameWorker
from ..train.single_frame import SingleFrameWorker
from ..train.worker import split_samples
from . import presave_disp


def last_epoch(exp_dir: Path):
    eps = sorted(int(p.stem.split("_")[1])
                 for p in exp_dir.glob("net_*.params"))
    return eps[-1] if eps else None


def presave_ranges(data_dir: Path, data_type: str = "synthetic") -> str:
    """``--ranges`` for presave_disp: the indices, in its sorted sample
    list, of the worker's test and train splits, as lo:hi runs."""
    dirs = sorted(p for p in Path(data_dir).glob("0*")
                  if p.is_dir() and (p / "frames.hdf5").exists())
    train, test, _ = split_samples([str(p) for p in dirs], data_type)
    keep = set(train) | set(test)
    idx = [i for i, p in enumerate(dirs) if str(p) in keep]
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return ",".join(f"{lo}:{hi}" for lo, hi in runs)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, required=True,
                    help="total wall-clock budget")
    ap.add_argument("--flow_source", default="pred",
                    choices=["rigid", "net", "pred"],
                    help="pred = rigid flow from the PREDICTED disparity and "
                         "the poses (GT-free); net = the frozen FlowNet "
                         "(GT-free); rigid = flow from the GT depth "
                         "(plumbing checks only)")
    ap.add_argument("--sf_epochs", type=int, default=100)
    ap.add_argument("--mf_epochs", type=int, default=20)
    ap.add_argument("--ftsf_epochs", type=int, default=15)
    ap.add_argument("--sf_frac", type=float, default=0.45,
                    help="fraction of the post-reserve budget for SF")
    ap.add_argument("--mf_frac", type=float, default=0.35)
    ap.add_argument("--test_samples", type=int, default=128,
                    help="eval-prefix size during training (full split "
                         "retests always run at the end)")
    ap.add_argument("--test_frequency", type=int, default=2)
    ap.add_argument("--test_batch_size", type=int, default=16)
    ap.add_argument("--mf_max_iter", type=int, default=-1,
                    help="cap MF steps/epoch (-1 = full pass)")
    ap.add_argument("--reserve_s", type=float, default=1500,
                    help="reserve for presaves + retests")
    ap.add_argument("--skip_sf", action="store_true",
                    help="SF already trained; start at the SF retest")
    args = ap.parse_args(argv)

    t_start = time.time()
    t_end = t_start + args.minutes * 60.0
    paths = load_paths()
    out_root = Path(paths["OUTPUT_DIR"])
    data_dir = Path(paths["DATA_DIR"])
    seconds = {}
    current = [None, time.time()]

    def mkcfg(architecture, **kw):
        # the train stages write no debug images; the retests neither
        kw.setdefault("write_debug_images", False)
        return RunConfig(data_dir=data_dir, output_dir=out_root,
                         architecture=architecture,
                         flow_source=args.flow_source,
                         test_batch_size=args.test_batch_size,
                         test_frequency=args.test_frequency,
                         test_samples=args.test_samples,
                         eval_metrics="device", **kw)

    def stage(name):
        now = time.time()
        if current[0] is not None:
            seconds[current[0]] = now - current[1]
        current[:] = [name, now]
        print(f"\n=== pipeline stage: {name} ({(t_end - now) / 60:.0f} min "
              "left)", flush=True)

    def retest(worker_cls, architecture, epoch, tag, **kw):
        """Full-split retest (device metrics) of one epoch."""
        stage(f"retest {tag} @ epoch {epoch}")
        cfg = mkcfg(architecture, epochs=epoch + 1, **kw)
        cfg.test_samples = -1
        cfg.test_frequency = 1
        worker_cls(cfg, device=device).retest(epoch=epoch)

    ranges = presave_ranges(data_dir)
    budget = max(0.0, (t_end - time.time()) - args.reserve_s)
    sf_deadline = time.time() + budget * args.sf_frac

    # ---- stage 1: DIS-SF self-supervised
    if not args.skip_sf:
        stage(f"DIS-SF ({args.sf_epochs} epochs max, "
              f"{(sf_deadline - time.time()) / 60:.0f} min budget)")
        cfg = mkcfg("single_frame", epochs=args.sf_epochs,
                    deadline_ts=sf_deadline)
        SingleFrameWorker(cfg, device=device).train(resume=True)

    sf_dir = out_root / "single_frame"
    sf_last = last_epoch(sf_dir)
    if sf_last is None:
        raise SystemExit("no SF checkpoint produced; aborting")

    # ---- stage 2: full-split SF retest (before the dir is archived)
    retest(SingleFrameWorker, "single_frame", sf_last, "DIS-SF selfsup")

    # ---- stage 3: presave SF disparities
    stage(f"presave SF (epoch {sf_last}, ranges {ranges})")
    presave_disp.main(["single_frame", "--epoch", str(sf_last), "--ranges",
                       ranges, "--data_dir", str(data_dir), "--output_dir",
                       str(out_root)], device=device)

    # ---- stage 4: DIS-MF
    mf_deadline = time.time() + max(
        0.0, (t_end - time.time() - args.reserve_s) * args.mf_frac
        / max(1e-6, 1.0 - args.sf_frac))
    stage(f"DIS-MF ({args.mf_epochs} epochs max, "
          f"{(mf_deadline - time.time()) / 60:.0f} min budget)")
    cfg = mkcfg("multi_frame", epochs=args.mf_epochs, train_batch_size=4,
                mf_remat=False, deadline_ts=mf_deadline,
                max_train_iter=args.mf_max_iter)
    MultiFrameWorker(cfg, device=device).train(resume=True)
    mf_last = last_epoch(out_root / "multi_frame")

    if mf_last is not None:
        # ---- stage 5: full-split MF retest + presave MF pseudo-GT
        retest(MultiFrameWorker, "multi_frame", mf_last, "DIS-MF",
               train_batch_size=4, mf_remat=False)
        # the test split too: the FTSF eval loss reads pseudo_gt
        stage(f"presave MF (epoch {mf_last})")
        presave_disp.main(["multi_frame", "--epoch", str(mf_last),
                           "--flow_source", args.flow_source, "--ranges",
                           ranges, "--data_dir", str(data_dir),
                           "--output_dir", str(out_root)], device=device)

        # ---- stage 6: archive selfsup SF, fine-tune DIS-FTSF
        selfsup_dir = out_root / "single_frame_selfsup"
        if selfsup_dir.exists():
            shutil.rmtree(selfsup_dir)
        sf_dir.rename(selfsup_dir)
        sf_dir.mkdir()

        ftsf_deadline = t_end - args.reserve_s * 0.4
        stage(f"DIS-FTSF ({args.ftsf_epochs} epochs max, "
              f"{(ftsf_deadline - time.time()) / 60:.0f} min budget)")
        cfg = mkcfg("single_frame", epochs=args.ftsf_epochs,
                    use_pseudo_gt=True, deadline_ts=ftsf_deadline)
        SingleFrameWorker(cfg, device=device).train(resume=True)
        ftsf_last = last_epoch(sf_dir)
        if ftsf_last is not None:
            retest(SingleFrameWorker, "single_frame", ftsf_last, "DIS-FTSF",
                   use_pseudo_gt=True)

    stage("report")
    summary = {}
    for tag, d in (("sf_selfsup", out_root / "single_frame_selfsup"),
                   ("sf", out_root / "single_frame"),
                   ("mf", out_root / "multi_frame")):
        mpath = d / "metrics.json"
        if mpath.exists():
            summary[tag] = json.loads(mpath.read_text())
    summary["stage_seconds"] = seconds
    (out_root / "pipeline_summary.json").write_text(json.dumps(summary))
    print(f"pipeline finished in {(time.time() - t_start) / 60:.1f} min, "
          f"{(t_end - time.time()) / 60:.1f} min to spare; metrics under "
          f"{out_root}/*/metrics.json", flush=True)
    return summary


if __name__ == "__main__":
    main()
