"""Train and evaluate DIS-SF and DIS-MF with this package, with the CLI of
the repository's ``train_val.py``:

  python -m depthinspace_tpu_torch.train_val --cmd retrain
  python -m depthinspace_tpu_torch.train_val --cmd retest --epoch 49
  python -m depthinspace_tpu_torch.train_val --use_pseudo_gt True ...
  python -m depthinspace_tpu_torch.train_val --architecture multi_frame \
      --cmd retrain --train_batch_size 4

Paths come from config.json (OUTPUT_DIR, DATA_DIR; DIS_CONFIG names another
file). Runs on the CUDA card and refuses to start without one. DIS-MF reads
the DIS-SF predictions from each sample's single_frame_disp.hdf5, and
DIS-FTSF (``--use_pseudo_gt True``, single_frame only, as in the JAX CLI)
the DIS-MF ones from multi_frame_disp.hdf5 (``tools/presave_disp.py``).
"""

from __future__ import annotations

import sys

from .config import RunConfig
from .train.multi_frame import MultiFrameWorker
from .train.single_frame import SingleFrameWorker
from .utils.args import parse_args


def main(argv=None):
    args = parse_args(argv)
    if args.architecture == "multi_frame" and args.use_pseudo_gt:
        print("use_pseudo_gt is only applicable to the single_frame model")
        sys.exit(1)
    worker_cls = (MultiFrameWorker if args.architecture == "multi_frame"
                  else SingleFrameWorker)
    worker = worker_cls(RunConfig.from_args(args))
    worker.do(args.cmd, epoch=args.epoch)


if __name__ == "__main__":
    main()
