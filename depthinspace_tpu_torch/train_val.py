"""Train and evaluate DIS-SF with this package, with the CLI of the
repository's ``train_val.py``:

  python -m depthinspace_tpu_torch.train_val --cmd retrain
  python -m depthinspace_tpu_torch.train_val --cmd retest --epoch 49
  python -m depthinspace_tpu_torch.train_val --use_pseudo_gt True ...

Paths come from config.json (OUTPUT_DIR, DATA_DIR; DIS_CONFIG names another
file). Runs on the CUDA card and refuses to start without one.
``--architecture multi_frame`` (DIS-MF) is not ported yet.
"""

from __future__ import annotations

from .config import RunConfig
from .train.single_frame import SingleFrameWorker
from .utils.args import parse_args


def main(argv=None):
    args = parse_args(argv)
    if args.architecture == "multi_frame":
        raise NotImplementedError("DIS-MF (--architecture multi_frame) is "
                                  "not ported yet (slice 2)")
    worker = SingleFrameWorker(RunConfig.from_args(args))
    worker.do(args.cmd, epoch=args.epoch)


if __name__ == "__main__":
    main()
