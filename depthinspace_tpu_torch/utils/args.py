"""CLI arguments: the flags, choices and defaults of
``depthinspace_tpu/utils/args.py`` (the reference's), so that documented
commands keep working. Flags for machinery this package does not have are
accepted and documented as such."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    add = parser.add_argument
    add("--data_type", default="synthetic", choices=["synthetic", "real"],
        type=str)
    add("--cmd", help="Start training or test", default="resume",
        choices=["retrain", "resume", "retest", "test_init"], type=str)
    add("--epoch", help="If larger than -1, retest on the specified epoch",
        default=-1, type=int)
    add("--epochs", help="Training epochs", default=100, type=int)
    add("--warmup_epochs", help="Epochs where SGM disparities supervise "
        "training on the real dataset", default=150, type=int)
    add("--lcn_radius", help="Radius of the window for LCN pre-processing",
        default=5, type=int)
    add("--max_disp", help="Maximum disparity", default=128, type=int)
    add("--track_length", help="Track length for geometric loss", default=4,
        type=int)
    add("--train_batch_size", help="Train batch size", default=8, type=int)
    add("--architecture", default="single_frame",
        choices=["single_frame", "multi_frame"], type=str)
    add("--use_pseudo_gt", help="Only applicable in single-frame model",
        default=False, type=str2bool)
    add("--device_augment", help="Augment the training batches on the "
        "device (False: each sample on the host, data/augment.py)",
        default=True, type=str2bool)
    add("--photometric_pyramid", help="Compute the scale-s photometric loss "
        "at 1/2^s resolution", default=False, type=str2bool)
    add("--wire_cache", help="Read the batches from <data_dir>/wire_cache "
        "(built by python -m depthinspace_tpu.tools.build_cache) when it "
        "holds every field, the flow source is not 'file' and training "
        "augments on the device", default=True, type=str2bool)
    add("--test_frequency", help="Evaluate every N epochs", default=1,
        type=int)
    add("--test_batch_size", help="Eval batch size", default=4, type=int)
    add("--eval_metrics", default="auto", choices=["auto", "exact", "device"],
        help="exact: host metrics on every pixel distance; device: a "
             "histogram on the device at wire resolution (1/256 px); auto: "
             "device for test splits of more than 64 samples")
    add("--flow_source", default="file",
        choices=["file", "rigid", "net", "pred"],
        help="file: flow.hdf5; rigid: from GT disparity + poses (synthetic "
             "data); pred: from the predicted disparity + poses; net: the "
             "frozen learned FlowNet on the batch's images")
    add("--flow_params", default="", help="FlowNet msgpack for "
        "--flow_source net (default OUTPUT_DIR/flownet.msgpack)")
    add("--mf_remat", help="Recompute FuseNet's fusion and decoder blocks "
        "in the backward (torch.utils.checkpoint) instead of keeping their "
        "activations", default=False, type=str2bool)
    add("--accum_steps", help="Gradient-accumulation microbatches per "
        "optimizer step (0 = auto: 2 for DIS-MF without remat at batch "
        ">= 4 and 512x432, else 1)", default=0, type=int)
    add("--geo_max_shift", help="Accepted for compatibility; this package's "
        "flow warp has no shift bound", default=16, type=int)
    add("--max_train_iter", help="Cap train steps per epoch (-1 = full pass)",
        default=-1, type=int)
    add("--test_samples", help="Evaluate on the first N samples of each test "
        "split (-1 = all)", default=-1, type=int)
    add("--mf_dtype", help="FuseNet compute dtype (parameters stay float32)",
        default="bfloat16", choices=["float32", "bfloat16"], type=str)
    return parser.parse_args(argv)
