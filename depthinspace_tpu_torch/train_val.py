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
``main(argv, device=None)``: the card; ``device="cpu"`` only when asked
for.

Data parallel on N cards (``--train_batch_size`` is the global batch):

  python -m torch.distributed.run --nproc_per_node N \
      -m depthinspace_tpu_torch.train_val --cmd retrain ...

(several nodes: ``--nnodes M --rdzv_backend c10d --rdzv_endpoint
HOST:PORT`` on each). ``main`` joins torchrun's process group first
(``parallel.init_multihost``; NCCL, each process on ``cuda:LOCAL_RANK``).
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from .config import RunConfig
from .parallel import init_multihost
from .train.multi_frame import MultiFrameWorker
from .train.single_frame import SingleFrameWorker
from .utils.args import parse_args


def main(argv=None, device=None):
    args = parse_args(argv)
    if args.architecture == "multi_frame" and args.use_pseudo_gt:
        print("use_pseudo_gt is only applicable to the single_frame model")
        sys.exit(1)
    owned = not dist.is_initialized() and init_multihost(device)
    try:
        worker_cls = (MultiFrameWorker if args.architecture == "multi_frame"
                      else SingleFrameWorker)
        worker = worker_cls(RunConfig.from_args(args), device=device)
        worker.do(args.cmd, epoch=args.epoch)
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
