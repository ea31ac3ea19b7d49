#!/usr/bin/env python3
"""Smoke run of the PyTorch port (depthinspace_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, one or more lines each; any failure raises and exits nonzero:

1. probe   the card, torch, CUDA, nvcc, nvidia-smi (exits nonzero without
           a CUDA card);
2. build   the CUDA kernels of csrc/ with nvcc for sm_90a, one nvcc per
           source, all at once, and beside them the variant library
           (kernels.VARIANT_FLAGS) that times K3's and K4's backward against
           their float-atomic versions and pass by pass; the whole run is
           under the deterministic mode every entry point sets
           (device.set_deterministic), switched off only around a library
           yardstick and the settings compared with it;
3. kernels each kernel (K1 census-SAD, K2 pattern warp, K3 flow warp, K4
           pair-indexed flow warp in bf16 and f32, K5 = K3's kernels through
           the warp_kernel.warp2d entry point, and their backward kernels)
           against its plain PyTorch version at the main paths' shapes (the
           forward kernels at the eval step's and the train step's), with
           the tolerance stated beside it; the median device time of the
           kernel, of the plain version and of the one PyTorch call that
           computes the same function where there is one (F.grid_sample and
           its backward; for K4 also index_select + grid_sample, since K4
           gathers its sources itself), and the kernel's bound; K3's
           backward (the strip kernel, fixed point) at the SF and MF train
           steps' calls on their rigid flows and on a random one, K5's at
           the MF call, each called 3 more times for the same bits and
           timed beside the float-atomic kernel it replaced and pass by
           pass (zeroing, largest |g|, scatter, writing); K2 timed at both
           shapes; K3's forward at each call of the main paths (C = 1 and
           3 of the SF loss, C = 5 of the MF loss and of FuseNet's geometry
           warp), with the path it takes; the kernels K4's forward and
           backward take (vector or scalar), K4's backward called 3 more
           times for the same bits, timed beside the float-atomic
           scatter and pass by pass; K1 and K1 bwd also at the train shape
           on an input with exact ties, each called twice for the same
           bits;
4. serve   DisparityServer at full width (512x432) from a seeded init, a
           ragged 13-image request (8 + 5) served twice, bit for bit equal
           (deterministic cuDNN algorithms, the deterministic mode); maps/s on
           those and on cuDNN's default algorithms (the forward before the
           repair), in turns, and the default ones' run-to-run difference;
           a device profile of one bucket on each;
5. eval    the DIS-SF evaluation step on a (tl=4, bs=2) synthetic track batch
           with flow from the batch and from the prediction. The launch
           counters are zeroed before phase 4 and read after phase 5: every
           forward kernel must have run on that path;
6. parity  the same evaluation at bs=1 on the card (kernels) and on the CPU
           (plain versions), TF32 off, same weights;
7. train   the DIS-SF train step (Adam) at tl=4, bs=8, 512x432, f32, on one
           synthetic batch with flow from the batch, augmented on the
           device as the workers run it (10 threefry draws a step):
           ms/step, peak memory,
           the profiler's device time by kernel group, the loss falling within 30
           steps; the counters are zeroed before it and read after it: every
           kernel, forward and backward, must have run on that path.
           Then the step with accum_steps=2 and device augmentation;
8. train parity  one augmented train step at bs=1 on the card and on the
           CPU from the same weights and key (the same draws, csrc/
           threefry.cu against utils/jrandom.py): components and every
           parameter's gradient; two card steps bitwise equal;
9. worker  SingleFrameWorker on in-memory synthetic samples at 512x432: one
           epoch, a resume that starts at epoch 1, a retest of epoch 0;
           its debug images (train_000_0000.png, test_000_0000.png) and
           errs.png decode with imgproc.read_png to the shapes written.

DIS-MF (FuseNet: 4 blocks, 32 channels, tl = 4, 512x432, bf16 compute), with
the stand-in primary disparity (GT + seeded noise) and rigid flow; the
launch counters are zeroed before phase 10 and read after phase 12 (the MF
path; every kernel but K5 must run on it):

10. mf serve   TrackDisparityServer from seeded DispNet + FuseNet weights: a
               ragged 3-track request (bucket 4), then 4-track requests
               (one served twice: bit for bit equal), tracks/s, on the
               deterministic and the default cuDNN algorithms; per bucket
               exactly 1 K3 and 8 K4 launches;
11. mf eval    the MF eval step at tl = 4, bs = 4, flow from the batch and
               from the primary disparity ("pred");
12. mf train   the MF train step at 4 tracks x 4 frames, bf16, no remat,
               Adam(1e-4), augmented on the device (10 threefry draws a
               step): ms/step, peak memory, the profiler's device time
               by kernel group, the loss falling, exactly 1/1 K1, 1/1 K2,
               3/1 K3 and 8/8 K4 launches (forward/backward) per step;
               then the step in f32 and with accum_steps = 2;
13. mf parity  the MF eval step (bs = 1, f32) and one MF train step (bs = 1,
               f32) on the card and on the CPU from the same weights; two
               card steps bitwise equal;
14. mf worker  MultiFrameWorker on in-memory samples: one epoch, a resume at
               epoch 1, a retest of epoch 0;
15. wire cache 8 synthetic samples with their stand-in primary written as
               HDF5 (data/hdf5.py) and built into a wire cache by
               build_wire_cache: the SF worker (rigid flow) and the MF
               worker (flow from the primary) train 3 steps and test from
               the cache, then retest epoch 0;
16. repeat     the SF (f32), MF (bf16) and --flow_source net SF train
               steps, augmented, 5 times from the same state and batch,
               twice: losses and every weight bitwise equal; then 2 steps, a
               save, a restore into a fresh state and 1 step equal to 3
               steps bit for bit (components, weights, the step key);
17. pipeline   the staged pipeline through the port's tools and workers on 8
               samples at 512x432 written as HDF5 and read back equal:
               presave_flow (rigid); the SF worker (flow.hdf5); presave_disp
               single_frame, held to DisparityServer.infer; the MF worker
               (flow.hdf5, bf16, 4 blocks x 32); presave_disp multi_frame;
               each presave_disp run twice, its files equal byte for byte;
               build_cache with primary_disp and pseudo_gt; the DIS-FTSF
               worker (--use_pseudo_gt True, rigid flow) from the cache and
               its retest. 3 train steps a worker; each stage's seconds and
               kernel launches (K1-K4 fwd and bwd in the MF stage, K1-K3 in
               FTSF's, K3 and K4 fwd in the MF presave); the HDF5 loader's
               time for one SF batch.
18. learned flow  output/flownet.msgpack loaded by the port: FlowNet on
               the card against the CPU at 512x432 (2 pairs, 1e-3 px); its
               forward on a 4-track bucket (48 pairs) with the encoder's and
               the correlation's share; TrackDisparityServer without flow
               (3- and 4-track requests, tracks/s beside the caller-flow
               rate and on the default cuDNN algorithms, 1 K3 and 8 K4
               launches a bucket, a request served twice bit for bit equal,
               and equal to mf_forward on flow_all_pairs' flow on the same
               deterministic algorithms); the SF (bs 8) and MF (4 tracks,
               bf16)
               train steps with --flow_source net (ms/step, the same launches
               as with file flow); presave_flow --provider learned and
               presave_disp multi_frame --flow_source net on phase 17's
               samples; 20 train_flow steps at crop 256x224 (finite loss,
               the saved file reloads, steps/s).
19. plane scenes  16 samples of the port's plane-scene fixture at 512x432
               with SGM disparities (host seconds a sample); the SF
               objective at the GT disparity and at a constant 40 px (the
               geometric component at the GT far below, with_stats' mask
               shares, flow_consistency_sf); DIS-SF overfit on one batch
               (bs 8, f32, Adam(1e-4), ~20 s, from the workers' init
               key(42)): the photometric loss and
               the disparity error fall, K1-K3 forward and backward
               launched each step; train_val --data_type real
               --device_augment False (2 epochs, warmup 1, bs 4: 10 train
               components, the SGM terms on in epoch 0 and exactly 0 in
               epoch 1, 6 test components), its retests with
               --eval_metrics exact and device (equal statistics), and
               the same run augmented on the device (s/epoch and the
               loader's wait of both).
20. generated data  the port's create_syn_data on the card machine's host:
               the renderer built from native/render.cpp (seconds, path,
               os.cpu_count()); 16 default samples at 512x432 with
               procedural objects, once in one process (s a sample) and
               once as 4 processes over --start ranges started together
               (aggregate samples/s; the same bytes as the one process);
               2 --textured samples (the ambient varies from pixel to
               pixel where the untextured does not); 2 real samples (a
               1280x1080 render post-processed to 512x432, sgm_disp); every
               field's shape, dtype and finiteness, the covered share and
               the disparity range; then the port's CLI on the 16 samples
               (test split: the first quarter): presave_flow rigid,
               train_val single_frame (bs 4, 3 steps) and its retest,
               presave_disp single_frame, train_val multi_frame (bf16, bs
               4, 3 steps) and its retest, each stage's seconds, K1-K3
               (SF) and K1-K4 (MF) launched forward and backward.
21. data parallel  on one card: (a) one DIS-SF train step (tl = 4, global
               bs 8, f32, file flow) in 2 gloo ranks on cuda:0 (this script
               as the children) from phase 7's seeded init, against the
               world-1 step: the ranks' parameters bitwise equal,
               components within rtol 1e-4, the gradients within phase 8's
               limits, two world-1 steps bitwise equal, and every
               SF kernel launched on each rank; (b) the same for DIS-MF
               (FuseNet 4 x 32, bf16, 4 tracks, flow rejected everywhere:
               no tie), the whole gradient within bf16's unit roundoff
               and each tensor's within 2e-2, or within twice what bf16
               itself moves it (world 1's bf16 step against its f32
               step);
               ms/step of both beside world 1 (gloo's host staging on one
               card, not NCCL across cards); (c) train_val retrain (1
               epoch, 3 steps) and retest under torchrun --standalone
               --nproc_per_node 1 (NCCL, world 1) on phase 20's samples,
               writing what one process writes, then the SF worker in 2
               gloo ranks against world 1 (metrics.json within 1e-3, only
               rank 0 writes, a resume starts at epoch 1); (d)
               DisparityServer(devices=[cuda:0, cuda:0]) answering phase
               4's 13-image request bit for bit as the one-device server.
               Every child runs under a timeout.
22. orbax resume  the JAX package's DIS-MF state (tests/data/orbax_fixture,
               written on the CPU by scripts/make_orbax_fixture.py: a JAX
               worker's state/ after 2 steps, FuseNet 1 block x 32) read
               here without orbax, tensorstore or zstandard: the zstd
               decoder built from native/zstd_decode.cpp with g++ (seconds)
               and its rate on the fixture's chunks (MB/s of output); the
               restore into a FuseNet on the card (seconds), its weights
               bit for bit equal to net_0000.params and every leaf of the
               weights and Adam's moments, the count and the step equal to
               expected.npz; then train_val --cmd resume (multi_frame,
               FuseNet's block count read from the saved state, bf16, bs 4,
               3 steps) on phase 20's samples
               continues the JAX run at epoch 1: K1-K4 launched forward and
               backward, finite losses, metrics.json holds epochs 0 and 1,
               the orbax epoch stays and the port's state/1/state.pt
               restores.
23. farneback  presave_flow --provider farneback (ops/farneback.py, OpenCV's
               Farnebäck flow in PyTorch; no TPU kernel) through main(...,
               device=None) on 2 of phase 20's samples (512x432, 3 pyramid
               levels): flow.hdf5's 12 pairs a sample held to the same
               function on the CPU (mean |d| <= 1e-3 px, 99.9th percentile
               <= 5e-2 px, the tests' tolerance against cv2); ms for a
               sample's 12 pairs on the card; the EPE to the rigid flow
               beside FlowNet's (output/flownet.msgpack) and zero flow's;
               then one DIS-MF train step (train_val, --flow_source file,
               bf16, bs 1) on those flow files: K1-K4 launched forward and
               backward.
24. threefry   (run after phase 3) csrc/threefry.cu, jax.random's
               threefry-2x32 draws (no TPU kernel: XLA fuses them into the
               JAX step), against its plain version utils/jrandom.py on the
               card at the SF train step's draws (32 frames at 512x432):
               the raw bits, f32 and bf16 uniforms and normals, and a
               data-parallel rank's block of a global draw, each in ulps
               (0 required); the card's DispNet init from key(42) against
               the CPU's, tensor by tensor; the step's 28.3 M values timed
               on the kernel, on the plain version, and torch.randn +
               torch.rand of the same count (another generator, for
               scale), beside the bound (the integer ALU pipe's
               operations in the kernel's SASS).

The last lines are the card's name and power limit, one JSON object with the
kernels' results (launches on the MF path), and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

H, W = 512, 432
TL, BS = 4, 2
TRAIN_BS = 8
SEED = 0

# H100 SXM peaks (NVIDIA's data sheet) for the bounds: HBM bytes/s, f32
# FLOP/s outside the tensor cores, and the special-function units' rsqrt/s
# (132 SMs x 16 per clock x 1.98 GHz boost clock).
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
SFU_PER_S = 132 * 16 * 1.98e9
# 32-bit integer operations/s of the integer ALU pipe: 64 INT32 lanes on
# each of the 132 SMs (NVIDIA's H100 white paper) at the 1.98 GHz boost
# clock
INT32_OPS = 132 * 64 * 1.98e9
# one threefry-2x32 value as nvcc compiles csrc/threefry.cu for sm_90a
# (its SASS, scripts/chip_check_controls.py): 68 instructions, of which 54
# issue on the integer ALU pipe (20 funnel shifts, 21 xors, 13 three-input
# adds that fold the key injections) and 14 adds on the FMA pipe
# (IMAD.IADD, 64 lanes an SM as well); the ALU pipe bounds it
THREEFRY_INT_OPS = 20 + 21 + 13
# float operations a value on top of the hash: a uniform's subtract, FMA
# (2) and max; a normal's uniform, erf_inv (log1p's 12 FMAs and division
# below sqrt(2) - 1, else Cephes' log with 9 FMAs; 8 FMAs of Giles'
# polynomial; ~8 adds and multiplies) and the sqrt(2) product
THREEFRY_FLOPS = {"uniform": 4, "normal": 4 + 2 * 12 + 1 + 2 * 8 + 8 + 1}

# Tolerances of the kernels against their plain versions on the card.
TOL = {
    # the same hardware rsqrt as torch.rsqrt; |h(a) - h(b)| as |a ra - b rb|
    # / 2, each pair's term summed into both pixels in another order
    "census_sad_fwd": 1e-5,
    # round-to-nearest intrinsics in the plain version's order of operations
    "xwarp_fwd": 0.0,
    "warp2d_fwd": 0.0,
    # the same signs as the plain version; each pixel sums up to 160 terms
    # of |.| <= 0.71 |g| / 81 in another order (g ~ N(0, 1) here)
    "census_sad_bwd": 1e-5,
    "xwarp_bwd": 0.0,
    # the plain version sums in float32 in its order, the kernel exactly
    # (fixed point) and rounds once
    "warp2d_bwd": 1e-5,
    # K4: K3's arithmetic in float32 with one rounding at the store (exact
    # in both dtypes); the backward as K3's, over a source pixel's terms
    # from its pairs (f32: 1e-5 at |g| ~ 1; bf16: the exact sum rounded to
    # float32 and once more, one bf16 ulp either side: rtol 2^-6)
    "warp2d_pairs_fwd": 0.0,
    "warp2d_pairs_bwd": 1e-5,
    # K5 runs K3's kernels
    "warp2d_v1_fwd": 0.0,
    "warp2d_v1_bwd": 1e-5,
    # the plain version's roundings, one for one (FMAs where it fuses)
    "threefry": 0.0,
}
BF16_RTOL = 2.0 ** -6
# timed calls of a backward's float-atomic version and of its passes alone
# (phase 3's A/B; the kernels themselves take 25)
PART_REPS = 9
REPLACES = {
    "census_sad_fwd": "depthinspace_tpu/ops/pallas/census_kernel.py:116",
    "xwarp_fwd": "depthinspace_tpu/ops/pallas/warp_kernel.py:123",
    "warp2d_fwd": "depthinspace_tpu/ops/pallas/warp2d_v2.py:256",
    "census_sad_bwd": "depthinspace_tpu/ops/pallas/census_kernel.py:143",
    "xwarp_bwd": "depthinspace_tpu/ops/pallas/warp_kernel.py:156",
    "warp2d_bwd": "depthinspace_tpu/ops/pallas/warp2d_v2.py:300",
    "warp2d_pairs_fwd": "depthinspace_tpu/ops/pallas/warp2d_pairs.py:206",
    "warp2d_pairs_bwd": "depthinspace_tpu/ops/pallas/warp2d_pairs.py:255",
    "warp2d_v1_fwd": "depthinspace_tpu/ops/pallas/warp_kernel.py:407",
    "warp2d_v1_bwd": "depthinspace_tpu/ops/pallas/warp_kernel.py:446",
    # no pl.pallas_call: the jax.random draws XLA fuses into the JAX step
    "threefry": "depthinspace_tpu/train/objective.py:218",
}
SOURCE = {
    "census_sad_fwd": "depthinspace_tpu_torch/csrc/census_sad.cu",
    "xwarp_fwd": "depthinspace_tpu_torch/csrc/xwarp.cu",
    "warp2d_fwd": "depthinspace_tpu_torch/csrc/warp2d.cu",
    "census_sad_bwd": "depthinspace_tpu_torch/csrc/census_sad.cu",
    "xwarp_bwd": "depthinspace_tpu_torch/csrc/xwarp.cu",
    "warp2d_bwd": "depthinspace_tpu_torch/csrc/warp2d.cu",
    "warp2d_pairs_fwd": "depthinspace_tpu_torch/csrc/warp2d_pairs.cu",
    "warp2d_pairs_bwd": "depthinspace_tpu_torch/csrc/warp2d_pairs.cu",
    "warp2d_v1_fwd": "depthinspace_tpu_torch/csrc/warp2d.cu",
    "warp2d_v1_bwd": "depthinspace_tpu_torch/csrc/warp2d.cu",
    "threefry": "depthinspace_tpu_torch/csrc/threefry.cu",
}
# kernel launches per DIS-SF train step (tl=4: 4 photometric scales; one
# geometric loss with a C=1 and a C=3 flow warp, only the first needing
# a gradient)
PER_TRAIN_STEP = {"census_sad_fwd": 4, "xwarp_fwd": 4, "warp2d_fwd": 2,
                  "census_sad_bwd": 4, "xwarp_bwd": 4, "warp2d_bwd": 1}
# per DIS-MF train step: one photometric term (K2, K1), the MF geometric
# loss's C=1 (with gradient) and C=5 K3 calls plus FuseNet's geometry warp,
# and 2 K4 calls in each of the 4 fusion blocks, all with gradient
PER_MF_STEP = {"census_sad_fwd": 1, "xwarp_fwd": 1, "warp2d_fwd": 3,
               "warp2d_pairs_fwd": 8, "warp2d_v1_fwd": 0,
               "census_sad_bwd": 1, "xwarp_bwd": 1, "warp2d_bwd": 1,
               "warp2d_pairs_bwd": 8, "warp2d_v1_bwd": 0}
# threefry launches per train step augmented on the device (phases 7 and
# 12, as the workers train): 7 (n, 1, 1) uniforms, 2 normal planes, the
# (2, n, H, W) salt-and-pepper uniforms
THREEFRY_PER_STEP = 10
MF_TRACKS = 4


def _jkey(seed: int):
    """The port's threefry key for ``seed`` (``jax.random.key(seed)``)."""
    from depthinspace_tpu_torch.utils.jrandom import key
    return key(seed)


def _dispnet(key):
    """DispNet (max_disp 128) with flax's init from ``key``, drawn on the
    card (the CPU's weights bit for bit: phase 24) and returned on the
    CPU."""
    from depthinspace_tpu_torch.models import DispNet, init_dispnet_
    return init_dispnet_(DispNet(max_disp=128.0).to("cuda"), key).cpu()


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Device time of one call: the median over ``reps`` CUDA-event-timed
    calls, after ``warmup`` calls. Each timed call is queued behind a ~20 ms
    device sleep, so the host has enqueued all of the call's launches before
    the device reaches the start event: the time is the device's, not the
    host's launch overhead (which exceeds a small kernel's run time)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(bytes_moved: float, flops: float = 0.0,
             rsqrts: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the bytes over the HBM
    rate and the operations over their peak rate (f32 FLOPs; rsqrt on the
    special-function units)."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = max(flops / F32_FLOPS, rsqrts / SFU_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def census_pairs(shape, block_size: int = 9) -> int:
    """Distinct unordered pairs of pixels that census-SAD compares on images
    of ``shape`` (N, H, W): the pair (p, p+o) and the pair (p+o, p) share
    their d^2, and h(-d) = 1 - h(d), so each pair's two rsqrt (es, ta) serve
    both pixels. A clamped (replicate-padded) tap is a pair in this set or
    p itself (d = 0)."""
    N, Hh, Ww = shape
    r = block_size // 2
    return N * sum(max(Hh - abs(dy), 0) * max(Ww - abs(dx), 0)
                   for dy in range(-r, r + 1) for dx in range(-r, r + 1)
                   if (dy, dx) > (0, 0))


def census_ties(es, ta, g, results) -> None:
    """K1 and K1 bwd against their plain versions where many pairs tie
    exactly: es and ta rounded to a 1/4 grid, a flat region in image 0 and
    es == ta on the lower right third; each kernel called twice must give
    the same bits (no atomics). The kernels line keeps the larger error."""
    import torch
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.ops.census import (census_sad_bwd_plain,
                                                   census_sad_plain)
    Hh, Ww = es.shape[1:]
    es_q, ta_q = torch.round(es * 4) / 4, torch.round(ta * 4) / 4
    es_q[0, :Hh // 2, :Ww // 2] = 0.25
    ta_q[0, :Hh // 2, :Ww // 2] = -0.5
    es_q[:, 2 * Hh // 3:, 2 * Ww // 3:] = ta_q[:, 2 * Hh // 3:, 2 * Ww // 3:]
    for name, call, plain in (
            ("census_sad_fwd", lambda: kernels.census_sad_fwd(es_q, ta_q),
             lambda: census_sad_plain(es_q, ta_q)),
            ("census_sad_bwd", lambda: kernels.census_sad_bwd(es_q, ta_q, g),
             lambda: census_sad_bwd_plain(es_q, ta_q, g))):
        out, again = call(), call()
        ref = plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = bool(torch.equal(out, again))
        print(f"[kernel] {name} {tuple(es.shape)} with exact ties: "
              f"max|kernel-plain| {err:.3g} (tol {TOL[name]:g}); two calls "
              f"bitwise equal: {same}")
        check(err <= TOL[name] and bool(torch.isfinite(out).all()),
              f"{name} disagrees with its plain version on ties: {err}")
        check(same, f"{name} gave other bits on a second call")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)


@contextmanager
def deterministic_mode_off():
    """torch's deterministic mode off inside (on again after): for the
    yardsticks the port never calls (grid_sample's backward raises under
    the mode) and for the settings from before the mode."""
    import torch
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True)


@contextmanager
def default_cudnn_algorithms():
    """cuDNN's default algorithms (deterministic off, so DispNet's
    transposed convolutions run as conv_transpose2d) and torch's
    deterministic mode off inside: the servers' forward as it was before
    they fixed their algorithms. The kernels stay the deterministic ones.
    The program has no such switch."""
    import torch
    torch.backends.cudnn.deterministic = False
    try:
        with deterministic_mode_off():
            yield
    finally:
        torch.backends.cudnn.deterministic = True


def library_ms(fn, **kw) -> float:
    """cuda_ms of a library yardstick, outside the deterministic mode."""
    with deterministic_mode_off():
        return cuda_ms(fn, **kw)


def serve_rates(call, n_items: int, reps: int = 5) -> dict:
    """Items/s of ``call()`` (a request to a server) on the deterministic
    cuDNN algorithms and on the default ones, in turns (deterministic,
    default, deterministic, default), each a warm call and ``reps`` timed
    ones; host clock (infer returns numpy)."""
    secs = {"deterministic": 0.0, "default": 0.0}
    for k in list(secs) * 2:
        with (default_cudnn_algorithms() if k == "default"
              else nullcontext()):
            call()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            secs[k] += time.perf_counter() - t0
    return {k: n_items * reps * 2 / v for k, v in secs.items()}


def default_algorithms_diff(call) -> str:
    """The run-to-run difference of ``call()`` (returning disparities in
    px) on cuDNN's default algorithms (measured, not checked)."""
    with default_cudnn_algorithms():
        a, b = call(), call()
    return (f"max |diff| {np.abs(a - b).max():.3g} px, unequal on "
            f"{np.mean(a != b):.4f} of pixels")


def grid_of(x, y):
    """Pixel coordinates -> grid_sample's normalized grid, align_corners."""
    import torch
    Hh, Ww = x.shape[-2:]
    return torch.stack([x / (Ww - 1) * 2 - 1, y / (Hh - 1) * 2 - 1], dim=-1)


T_START = time.perf_counter()


def main() -> None:
    import torch
    import torch.nn.functional as F
    from depthinspace_tpu_torch.device import (require_cuda,
                                               set_deterministic,
                                               set_full_f32)

    # -- 1. probe ---------------------------------------------------------
    dev = require_cuda()
    card = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    from depthinspace_tpu_torch.ops import kernels
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[probe] {card}; torch {torch.__version__}; cuda "
          f"{torch.version.cuda}; nvcc: {nvcc}; python {sys.version.split()[0]}")
    print(smi)
    # as every entry point sets them (device.resolve_device): the whole run
    # is under the deterministic mode
    set_full_f32()
    set_deterministic()

    # -- 2. build ---------------------------------------------------------
    # the library of the main paths, and beside it (in parallel) the one
    # with the variants' entry points, through which phase 3 times K4
    # backward's parts alone
    with ThreadPoolExecutor(1) as pool:
        variants = pool.submit(kernels.build, kernels.VARIANT_FLAGS)
        so, build_s = kernels.build()
        vso, vbuild_s = variants.result()
    kernels.library()
    print(f"[build] {so.relative_to(ROOT)} in {build_s:.1f} s (nvcc, sm_90a)"
          f"; variant library {vso.relative_to(ROOT)} in {vbuild_s:.1f} s")
    for line in (so.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    # -- 3. kernel parity and time at the main paths' shapes --------------
    from depthinspace_tpu_torch.data import (batch_to_torch, make_settings,
                                             make_track_batch,
                                             smooth_disparity)
    from depthinspace_tpu_torch.losses.geometric import _ordered_directions
    from depthinspace_tpu_torch.ops import disp_to_depth, lcn
    from depthinspace_tpu_torch.ops.census import (census_sad,
                                                   census_sad_bwd_plain,
                                                   census_sad_plain)
    from depthinspace_tpu_torch.ops.resample import (flow_warp,
                                                     warp2d_bwd_plain,
                                                     warp2d_plain,
                                                     warp_pattern,
                                                     xwarp_bwd_plain,
                                                     xwarp_plain)

    settings = make_settings(H, W)
    t0 = time.perf_counter()
    batch_np = make_track_batch(settings, tl=TL, bs=BS, seed=SEED)
    print(f"[data] synthetic track batch tl={TL} bs={BS} {H}x{W} in "
          f"{time.perf_counter() - t0:.1f} s; |flow| max "
          f"{np.abs(batch_np.flow).max():.2f} px")
    batch = batch_to_torch(batch_np, dev)
    rng = np.random.RandomState(SEED)
    n = TL * BS
    pattern = lcn(torch.as_tensor(settings.pattern_gray(), device=dev))[0]
    # contiguous, as the photometric loss's disparity is: smooth_disparity's
    # array is not C-ordered, and XWarp would copy it in every timed call
    disp = torch.as_tensor(smooth_disparity(rng, (n, H, W), 0.0, 128.0),
                           device=dev).contiguous()
    im_lcn = lcn(batch.im.reshape(n, H, W))[0]
    es = xwarp_plain(pattern, disp)

    dirs = _ordered_directions(TL)
    depth = disp_to_depth(batch.disp_gt, settings.focal_length,
                          settings.baseline)
    f0 = torch.cat([batch.flow[a, b] for a, b in dirs]).contiguous()
    img1 = torch.cat([depth[b] for _, b in dirs])[..., None].contiguous()
    img3 = torch.cat([torch.cat([batch.flow[b, a], batch.ambient[b][..., None]],
                                dim=-1) for a, b in dirs]).contiguous()
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]

    results = {}

    def record(name, kernel_out, plain_out, ms, plain_ms, library_ms, bound,
               shapes):
        torch.cuda.synchronize()
        err = float((kernel_out - plain_out).abs().max())
        ok = err <= TOL[name] and bool(torch.isfinite(kernel_out).all())
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"[kernel] {name} {shapes}: max|kernel-plain| {err:.3g} "
              f"(tol {TOL[name]:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} "
              f"ms library {lib} bound {bound[0]:.4f} ms ({bound[1]}; "
              f"{bound[0] / ms:.0%} of it)")
        check(ok, f"{name} disagrees with its plain version: {err}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound[0],
                             bound_by=bound[1])

    px = es.numel()
    # per distinct pair: 2 rsqrt, ~12 FLOPs (2 differences, 2 d^2 + eps,
    # 2 d * r, the |h_es - h_ta| difference, its sum into both pixels)
    pairs = census_pairs(es.shape)
    record("census_sad_fwd", census_sad(es, im_lcn),
           census_sad_plain(es, im_lcn),
           cuda_ms(lambda: census_sad(es, im_lcn)),
           cuda_ms(lambda: census_sad_plain(es, im_lcn)), None,
           bound_ms(3 * 4 * px, flops=12 * pairs, rsqrts=2 * pairs),
           f"es,ta {tuple(es.shape)}")
    # grid_sample with border padding on each pixel's own row is K2
    pat_n = pattern.expand(n, 1, H, W)
    grid_x = grid_of(u - disp, v.expand(n, H, W))
    record("xwarp_fwd", warp_pattern(pattern, disp),
           xwarp_plain(pattern, disp),
           cuda_ms(lambda: warp_pattern(pattern, disp)),
           cuda_ms(lambda: xwarp_plain(pattern, disp)),
           cuda_ms(lambda: F.grid_sample(pat_n, grid_x, mode="bilinear",
                                         padding_mode="border",
                                         align_corners=True)),
           bound_ms(2 * 4 * px + 4 * H * W),
           f"pattern {tuple(pattern.shape)} disp {tuple(disp.shape)}")
    # one geometric-loss evaluation makes one C=1 and one C=3 call
    def k3_call(img, flow, label):
        """K3's forward on one call of a main path: its error, the kernel's,
        the plain version's and grid_sample's times, its bound and the path
        the wrapper takes; one printed line."""
        M_, h_, w_, C_ = img.shape
        nchw = img.permute(0, 3, 1, 2).contiguous()
        uu = torch.arange(w_, dtype=torch.float32, device=dev)
        vv = torch.arange(h_, dtype=torch.float32, device=dev)[:, None]
        grid = grid_of(flow[..., 0] + uu, flow[..., 1] + vv)
        out, ref = flow_warp(img, flow), warp2d_plain(img, flow)
        torch.cuda.synchronize()
        ppt = kernels.warp2d_fwd_path(C_, M_ * h_ * w_, flow.data_ptr(),
                                      out.data_ptr())
        path = "first design" if ppt == 0 else f"vector, {ppt} px a thread"
        # each input read once (flow, the image), the output written once
        b = bound_ms(4 * M_ * h_ * w_ * (2 + 2 * C_))
        r = dict(max_abs_err=float((out - ref).abs().max()),
                 ms=cuda_ms(lambda: flow_warp(img, flow)),
                 plain_ms=cuda_ms(lambda: warp2d_plain(img, flow)),
                 library_ms=cuda_ms(lambda: F.grid_sample(
                     nchw, grid, mode="bilinear", padding_mode="zeros",
                     align_corners=True)),
                 bound_ms=b[0], bound_by=b[1], path=path)
        print(f"[kernel] warp2d_fwd C={C_} {tuple(img.shape)} ({label}; "
              f"{path}): max|kernel-plain| {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
              f"{r['library_ms']:.4f} ms bound {b[0]:.4f} ms ({b[1]}; "
              f"{b[0] / r['ms']:.0%} of it)")
        check(r["max_abs_err"] <= TOL["warp2d_fwd"]
              and bool(torch.isfinite(out).all()),
              f"warp2d_fwd C={C_} {label} disagrees with its plain version: "
              f"{r['max_abs_err']}")
        check(ppt > 0, f"warp2d_fwd C={C_} {label} took the first design")
        return r

    k3 = {img.shape[-1]: k3_call(img, f0, "SF geometric loss")
          for img in (img1, img3)}
    m3 = f0.shape[0] * H * W
    b3 = bound_ms(4 * m3 * (2 + 1 + 1) + 4 * m3 * (2 + 3 + 3))
    # the row's headline: one SF geometric-loss evaluation (C=1 + C=3);
    # each call of the main paths beside it under "calls"
    results["warp2d_fwd"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in k3.values()),
        ms=sum(r["ms"] for r in k3.values()),
        plain_ms=sum(r["plain_ms"] for r in k3.values()),
        library_ms=sum(r["library_ms"] for r in k3.values()),
        bound_ms=b3[0], bound_by=b3[1],
        calls={f"SF loss C={c} {tuple(f0.shape[:3])}": r
               for c, r in k3.items()})
    print(f"[kernel] warp2d_fwd C=1 + C=3: kernel "
          f"{results['warp2d_fwd']['ms']:.4f} ms library "
          f"{results['warp2d_fwd']['library_ms']:.4f} ms bound {b3[0]:.4f} "
          f"ms ({b3[1]}; {b3[0] / results['warp2d_fwd']['ms']:.0%} of it)")

    # backward kernels at the train step's shapes (tl=4, bs=8)
    nt = TL * TRAIN_BS
    rng_b = np.random.RandomState(SEED + 7)
    disp_t = torch.as_tensor(smooth_disparity(rng_b, (nt, H, W), 0.0, 128.0),
                             device=dev).contiguous()
    ta_t = lcn(torch.as_tensor(np.concatenate([batch_np.im.reshape(n, H, W)]
                                              * (nt // n)), device=dev))[0]
    es_t = xwarp_plain(pattern, disp_t)
    g_t = torch.as_tensor(rng_b.randn(nt, H, W).astype(np.float32),
                          device=dev)
    px_t = es_t.numel()
    pairs_t = census_pairs(es_t.shape)

    def bwd(fn, x, g):
        x = x.detach().requires_grad_()
        fn(x).backward(g)
        return x.grad

    def check_fwd(name, kernel_out, plain_out, shapes):
        """A forward kernel against its plain version at the train shapes;
        the kernels line keeps the larger error of the two shapes."""
        torch.cuda.synchronize()
        err = float((kernel_out - plain_out).abs().max())
        print(f"[kernel] {name} {shapes} (train step): max|kernel-plain| "
              f"{err:.3g} (tol {TOL[name]:g})")
        check(err <= TOL[name] and bool(torch.isfinite(kernel_out).all()),
              f"{name} disagrees with its plain version at {shapes}: {err}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    check_fwd("census_sad_fwd", census_sad(es_t, ta_t),
              census_sad_plain(es_t, ta_t), f"es,ta {tuple(es_t.shape)}")
    check_fwd("xwarp_fwd", warp_pattern(pattern, disp_t),
              xwarp_plain(pattern, disp_t),
              f"pattern {tuple(pattern.shape)} disp {tuple(disp_t.shape)}")
    # K2 at the train step's shape too: its row of the kernels line keeps
    # the eval shape's numbers and these beside them
    gs_bwd = torch.ops.aten.grid_sampler_2d_backward
    pat_t = pattern.expand(nt, 1, H, W)
    grid_t = grid_of(u - disp_t, v.expand(nt, H, W))
    k2t = dict(ms=cuda_ms(lambda: warp_pattern(pattern, disp_t)),
               plain_ms=cuda_ms(lambda: xwarp_plain(pattern, disp_t)),
               library_ms=cuda_ms(lambda: F.grid_sample(
                   pat_t, grid_t, mode="bilinear", padding_mode="border",
                   align_corners=True)),
               bound_ms=bound_ms(2 * 4 * px_t + 4 * H * W)[0])
    results["xwarp_fwd"]["train"] = k2t
    print(f"[kernel] xwarp_fwd disp {tuple(disp_t.shape)} (train step): "
          f"kernel {k2t['ms']:.4f} ms plain {k2t['plain_ms']:.4f} ms "
          f"library {k2t['library_ms']:.4f} ms bound {k2t['bound_ms']:.4f} "
          f"ms (bytes; {k2t['bound_ms'] / k2t['ms']:.0%} of it)")
    # per distinct pair: 2 rsqrt, ~16 FLOPs (the forward's differences and
    # d * r, 0.5 * eps * r^3, g(p) + g(q), the signed product, its sum into
    # both pixels)
    record("census_sad_bwd", bwd(lambda e: census_sad(e, ta_t), es_t, g_t),
           census_sad_bwd_plain(es_t, ta_t, g_t),
           cuda_ms(lambda: kernels.census_sad_bwd(es_t, ta_t, g_t)),
           cuda_ms(lambda: census_sad_bwd_plain(es_t, ta_t, g_t), reps=5),
           None, bound_ms(4 * 4 * px_t, flops=16 * pairs_t,
                          rsqrts=2 * pairs_t),
           f"es,ta,g {tuple(es_t.shape)}")
    census_ties(es_t, ta_t, g_t, results)
    g_t4 = g_t[:, None]
    record("xwarp_bwd", bwd(lambda d: warp_pattern(pattern, d), disp_t, g_t),
           xwarp_bwd_plain(pattern, disp_t, g_t),
           cuda_ms(lambda: kernels.xwarp_bwd(pattern, disp_t, g_t)),
           cuda_ms(lambda: xwarp_bwd_plain(pattern, disp_t, g_t)),
           library_ms(lambda: gs_bwd(g_t4, pat_t, grid_t, 0, 1, True,
                                     [False, True])),
           bound_ms(3 * 4 * px_t + 4 * H * W),
           f"pattern {tuple(pattern.shape)} disp,g {tuple(disp_t.shape)}")
    # the geometric loss's C=1 depth sample over the 12 directions x bs=8
    f0_t = f0.repeat(TRAIN_BS // BS, 1, 1, 1).contiguous()
    for img in (img1, img3):
        img_t = img.repeat(TRAIN_BS // BS, 1, 1, 1).contiguous()
        check_fwd("warp2d_fwd", flow_warp(img_t, f0_t),
                  warp2d_plain(img_t, f0_t),
                  f"C={img.shape[-1]} {tuple(img_t.shape)}")
    del img_t
    vlib = kernels.variant_library()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def ab_k3_bwd(flow, g, grad, acc, atomic, parts=15):
        """K3's backward through the variant library: the deterministic
        call or one of its passes alone (parts: 1 zeroing, 2 largest |g|,
        4 scatter, 8 writing grad), or the float-atomic strip kernel
        (atomic = 1)."""
        M_, h_, w_, C_ = g.shape
        err = vlib.dis_ab_warp2d_bwd(
            flow.data_ptr(), g.data_ptr(), grad.data_ptr(), acc.data_ptr(),
            M_, h_, w_, C_, kernels.warp2d_bwd_path(C_, h_, w_,
                                                    flow.data_ptr()),
            kernels.fixed_bits(h_ * w_), atomic, parts, stream())
        check(err == 0, f"dis_ab_warp2d_bwd: CUDA error {err}")

    def k3_bwd_call(name, warp, kernel, flow, label):
        """K3's (or K5's) backward, C = 1, on one call of a main path: the
        gradient through the autograd path against the plain version, three
        more calls on the same input bitwise equal to it, the path the
        wrapper takes (the strip kernel), the kernel's, its passes', the float-atomic kernel's
        float-atomic kernel's (checked against the plain version first),
        the plain version's and grid_sample backward's times and the bound.
        One printed line."""
        M_ = flow.shape[0]
        g = torch.as_tensor(rng_b.randn(M_, H, W, 1).astype(np.float32),
                            device=dev)
        img0 = torch.zeros_like(g)
        out = bwd(lambda x: warp(x, flow), img0, g)
        ref = warp2d_bwd_plain(flow, g)
        repeat = all(torch.equal(kernel(flow, g), out) for _ in range(3))
        path = kernels.warp2d_bwd_path(1, H, W, flow.data_ptr())
        grid = grid_of(flow[..., 0] + u, flow[..., 1] + v)
        g_n, img_n = g.permute(0, 3, 1, 2), img0.permute(0, 3, 1, 2)
        acc = kernels.fixed_scratch(g.numel(), dev)
        old = torch.empty_like(g)
        ab_k3_bwd(flow, g, old, acc, 1)
        torch.cuda.synchronize()
        atomic_err = float((old - ref).abs().max())
        # each input read once (flow, g), the output written once
        b = bound_ms(4 * M_ * H * W * (2 + 1 + 1))
        r = dict(max_abs_err=float((out - ref).abs().max()),
                 ms=cuda_ms(lambda: kernel(flow, g)),
                 plain_ms=cuda_ms(lambda: warp2d_bwd_plain(flow, g), reps=5),
                 library_ms=library_ms(lambda: gs_bwd(
                     g_n, img_n, grid, 0, 0, True, [True, False])),
                 bound_ms=b[0], bound_by=b[1],
                 path="strip kernel" if path else "first design",
                 repeat_equal=repeat,
                 atomic_ms=cuda_ms(lambda: ab_k3_bwd(flow, g, old, acc, 1),
                                   reps=PART_REPS),
                 atomic_max_abs_err=atomic_err,
                 parts={k: cuda_ms(lambda p=p: ab_k3_bwd(flow, g, old, acc, 0,
                                                         p), reps=PART_REPS)
                        for k, p in (("zeroing", 1), ("largest |g|", 2),
                                     ("scatter", 4), ("writing", 8))})
        print(f"[kernel] {name} flow {tuple(flow.shape)} g {tuple(g.shape)} "
              f"({label}; {r['path']}, fixed point): max|kernel-plain| "
              f"{r['max_abs_err']:.3g} (tol {TOL[name]:g}); 3 more calls "
              f"bitwise equal: {repeat}; kernel {r['ms']:.4f} ms ("
              + ", ".join(f"{k} {t:.4f}" for k, t in r["parts"].items())
              + f" alone) against float atomics {r['atomic_ms']:.4f} "
              f"ms (max|atomic-plain| {atomic_err:.3g}); plain "
              f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
              f"bound {b[0]:.4f} ms ({b[1]}; {b[0] / r['ms']:.0%} of it)")
        check(r["max_abs_err"] <= TOL[name] and bool(torch.isfinite(
            out).all()), f"{name} {label} disagrees with its plain version: "
              f"{r['max_abs_err']}")
        check(atomic_err <= TOL[name], f"{name} {label}: the float-atomic kernel "
              f"disagrees with the plain version: {atomic_err}")
        check(repeat, f"{name} {label}: repeated calls differ")
        check(path == 1, f"{name} {label} did not take the strip kernel")
        return r

    # the SF train step's call (12 directions x 8 tracks) on its rigid
    # flow, then on a random flow of +-4 px; the MF step's beside K5 below
    f_rand = torch.as_tensor(rng_b.uniform(-4.0, 4.0, f0_t.shape).astype(
        np.float32), device=dev)
    k3b = {label: k3_bwd_call("warp2d_bwd", flow_warp, kernels.warp2d_bwd,
                              flow, label)
           for label, flow in (("SF train step, rigid flow", f0_t),
                               ("random +-4 px flow", f_rand))}
    head = k3b.pop("SF train step, rigid flow")
    results["warp2d_bwd"] = dict(
        head, calls={f"{k} {tuple(f_rand.shape[:3])}": r
                     for k, r in k3b.items()})
    del f_rand

    # K4 at the DIS-MF train step's shapes: 4 tracks x 4 frames give S = 16
    # source planes and M = 48 pairs of 32 channels, at both fusion scales
    # (256x216 and 128x108), with the rigid flow of a synthetic batch; bf16
    # (the path's type) and f32. A row sums one call at each scale.
    from depthinspace_tpu_torch.models.fusenet import (_pair_flows,
                                                       _pair_list,
                                                       _resize_flow_grid)
    from depthinspace_tpu_torch.ops.resample import (flow_warp_pairs,
                                                     warp2d_pairs_bwd_plain,
                                                     warp2d_pairs_plain,
                                                     warp2d_v1)
    t0 = time.perf_counter()
    mf_np = make_track_batch(settings, tl=TL, bs=MF_TRACKS, seed=SEED + 20,
                             primary_noise=0.5)
    print(f"[data] synthetic track batch tl={TL} bs={MF_TRACKS} with the "
          f"stand-in primary (GT + 0.5 px noise) in "
          f"{time.perf_counter() - t0:.1f} s")
    flow_mf = torch.as_tensor(mf_np.flow, device=dev)
    src_mf = tuple(j * MF_TRACKS + n for _, j in _pair_list(TL)
                   for n in range(MF_TRACKS))
    S_mf = TL * MF_TRACKS
    rng_p = np.random.RandomState(SEED + 11)
    k4 = {}
    parts = {torch.bfloat16: {}, torch.float32: {}}
    repeat = {torch.bfloat16: True, torch.float32: True}
    table_mf = kernels._src_table("warp2d_pairs_bwd", src_mf, S_mf,
                                  len(src_mf), dev)

    def within_k4_bwd(grad, ref_g):
        """K4 bwd's tolerance against its plain version: 1e-5 in f32; in
        bf16 that plus one bf16 ulp either side (rtol 2^-6)."""
        d = (grad.float() - ref_g.float()).abs()
        lim = TOL["warp2d_pairs_bwd"]
        if grad.dtype == torch.bfloat16:
            lim = lim + BF16_RTOL * ref_g.float().abs()
        return bool((d <= lim).all()), float(d.max())

    def k4_bwd_ab(pf, g, S, ref_g):
        """The path K4's backward takes; its passes (zeroing the counts,
        counting, the scan, placing the records, the sums) timed as the
        differences of the call cut after each (every cut starts from the
        zeroing, so the counts stay valid; the sums alone repeat safely),
        and the float-atomic vector scatter (zeroing, float4 atomics,
        cast) whole, checked against the plain version first, through the
        variant library's entry point (the launch counts are the wrapper's
        and do not move)."""
        M_, h_, w_, C_ = g.shape
        bf16 = int(g.dtype == torch.bfloat16)
        work = kernels.pairs_bwd_work(S, M_, h_, w_, dev)
        if 2 * work.numel() < S * h_ * w_ * C_:    # float atomics' scratch
            work = torch.empty((S * h_ * w_ * C_ + 1) // 2,
                               dtype=torch.int64, device=dev)
        grad = torch.empty((S, h_, w_, C_), dtype=g.dtype, device=dev)
        vector = kernels.pairs_bwd_path(C_, g.dtype, g.data_ptr())
        check(vector, f"warp2d_pairs_bwd {g.dtype} took the scalar sum at "
              "the MF shapes")

        def run(atomic, part=31):
            err = vlib.dis_ab_warp2d_pairs_bwd(
                pf.data_ptr(), table_mf[0].data_ptr(), table_mf[1].data_ptr(),
                g.data_ptr(), work.data_ptr(), grad.data_ptr(), S, M_, h_,
                w_, C_, bf16, 1, atomic, part, stream())
            check(err == 0, f"warp2d_pairs_bwd atomic {atomic} part {part}: "
                  f"CUDA error {err}")

        run(1)
        old = grad if bf16 else work.view(torch.float32)[
            :S * h_ * w_ * C_].view(grad.shape)
        ok, atomic_err = within_k4_bwd(old, ref_g)
        check(ok, f"warp2d_pairs_bwd {g.dtype}: the float-atomic kernel disagrees "
              f"with the plain version: {atomic_err}")
        out = {"path": "by destination, 4 channels a thread",
               "atomic_ms": cuda_ms(lambda: run(1), reps=PART_REPS),
               "atomic_max_abs_err": atomic_err}
        cut = {p: cuda_ms(lambda p=p: run(0, p), reps=PART_REPS)
               for p in (1, 3, 7, 15)}
        out.update({"zeroing": cut[1], "count": cut[3] - cut[1],
                    "scan": cut[7] - cut[3], "place": cut[15] - cut[7],
                    "sum": cuda_ms(lambda: run(0, 16), reps=PART_REPS)})
        print(f"[kernel] warp2d_pairs_bwd {g.dtype} {h_}x{w_}x{C_}: "
              + "; ".join(f"{k} {v:.4g}" if k != "path" else v
                          for k, v in out.items()))
        return out

    for dt in (torch.bfloat16, torch.float32):
        elt = 2 if dt == torch.bfloat16 else 4
        # err, ms, plain, library, index_select + library
        acc = {k: [0.0] * 5 for k in ("fwd", "bwd")}
        nbytes = {"fwd": 0, "bwd": 0}
        nflops = {"fwd": 0, "bwd": 0}
        for h, w in ((H // 2, W // 2), (H // 4, W // 4)):
            pf = _pair_flows(_resize_flow_grid(flow_mf, h, w))
            feat = torch.as_tensor(rng_p.randn(S_mf, h, w, 32).astype(
                np.float32), device=dev).to(dt)
            g = torch.as_tensor(rng_p.randn(len(src_mf), h, w, 32).astype(
                np.float32), device=dev).to(dt)
            out = flow_warp_pairs(feat, pf, src_mf)
            ref = warp2d_pairs_plain(feat, pf, src_mf)
            vpt = kernels.pairs_fwd_vpt(32, dt, feat.data_ptr(), pf.data_ptr(),
                                        out.data_ptr())
            k4_path = (f"vector, {vpt * kernels.VEC_CHANNELS[dt]} channels "
                       "a thread" if vpt else "scalar")
            check(vpt > 0, f"warp2d_pairs_fwd {dt} took the scalar kernel "
                  "at the MF shapes")
            grad = bwd(lambda x: flow_warp_pairs(x, pf, src_mf), feat, g)
            ref_g = warp2d_pairs_bwd_plain(pf, src_mf, g, S_mf)
            # three more calls on the same input, bitwise equal
            repeat[dt] &= all(torch.equal(kernels.warp2d_pairs_bwd(
                pf, src_mf, g, S_mf), grad) for _ in range(3))
            check(repeat[dt], f"warp2d_pairs_bwd {dt}: repeated calls "
                  "differ")
            split = k4_bwd_ab(pf, g, S_mf, ref_g)
            parts[dt]["path"] = split.pop("path")
            parts[dt]["atomic_max_abs_err"] = max(
                parts[dt].get("atomic_max_abs_err", 0.0),
                split.pop("atomic_max_abs_err"))
            for part, t in split.items():
                parts[dt][part] = parts[dt].get(part, 0.0) + t
            torch.cuda.synchronize()
            err_f = float((out.float() - ref.float()).abs().max())
            ok_b, err_b = within_k4_bwd(grad, ref_g)
            check(err_f <= TOL["warp2d_pairs_fwd"]
                  and bool(torch.isfinite(out).all()),
                  f"warp2d_pairs_fwd {dt} disagrees with its plain version: "
                  f"{err_f}")
            check(ok_b and bool(torch.isfinite(grad).all()),
                  f"warp2d_pairs_bwd {dt} disagrees with its plain version: "
                  f"{err_b}")
            srcs = torch.as_tensor(src_mf, device=dev)
            feat_nchw = feat.permute(0, 3, 1, 2).contiguous()
            stacked = feat_nchw.index_select(0, srcs)
            u_s = torch.arange(w, dtype=torch.float32, device=dev)
            v_s = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            grid_p = grid_of(pf[..., 0] + u_s, pf[..., 1] + v_s).to(dt)
            g_nchw = g.permute(0, 3, 1, 2).contiguous()
            times = {
                "fwd": (cuda_ms(lambda: kernels.warp2d_pairs_fwd(
                            feat, pf, src_mf)),
                        cuda_ms(lambda: warp2d_pairs_plain(feat, pf, src_mf),
                                reps=5),
                        cuda_ms(lambda: F.grid_sample(
                            stacked, grid_p, mode="bilinear",
                            padding_mode="zeros", align_corners=True)),
                        cuda_ms(lambda: F.grid_sample(
                            feat_nchw.index_select(0, srcs), grid_p,
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True))),
                "bwd": (cuda_ms(lambda: kernels.warp2d_pairs_bwd(
                            pf, src_mf, g, S_mf)),
                        cuda_ms(lambda: warp2d_pairs_bwd_plain(
                            pf, src_mf, g, S_mf), reps=5),
                        library_ms(lambda: gs_bwd(g_nchw, stacked, grid_p, 0,
                                                  0, True, [True, False])))}
            for k, e in (("fwd", err_f), ("bwd", err_b)):
                acc[k][0] = max(acc[k][0], e)
                for i, t in enumerate(times[k]):
                    acc[k][i + 1] += t
            M_px = len(src_mf) * h * w
            # each input read once, each output written once; per output
            # element 4 products and 3 sums, per pixel ~15 for the taps
            nbytes["fwd"] += S_mf * h * w * 32 * elt + M_px * 8 \
                + M_px * 32 * elt
            nbytes["bwd"] += M_px * 8 + M_px * 32 * elt + S_mf * h * w * 32 * elt
            nflops["fwd"] += M_px * (7 * 32 + 15)
            nflops["bwd"] += M_px * (8 * 32 + 15)
            print(f"[kernel] warp2d_pairs {dt} S={S_mf} M={len(src_mf)} "
                  f"{h}x{w}x32: fwd ({k4_path}) max|kernel-plain| "
                  f"{err_f:.3g} kernel {times['fwd'][0]:.4f} ms plain "
                  f"{times['fwd'][1]:.4f} ms grid_sample on the gathered "
                  f"stack {times['fwd'][2]:.4f} ms, index_select + "
                  f"grid_sample {times['fwd'][3]:.4f} ms; bwd max|kernel-"
                  f"plain| {err_b:.3g} kernel {times['bwd'][0]:.4f} ms plain "
                  f"{times['bwd'][1]:.4f} ms grid_sample bwd "
                  f"{times['bwd'][2]:.4f} ms")
            del feat, g, grad, ref_g, out, ref, stacked, g_nchw, grid_p, \
                feat_nchw
        for k in ("fwd", "bwd"):
            b = bound_ms(nbytes[k], flops=nflops[k])
            k4[(k, dt)] = dict(max_abs_err=acc[k][0], ms=acc[k][1],
                               plain_ms=acc[k][2], library_ms=acc[k][3],
                               bound_ms=b[0], bound_by=b[1])
            lib = f"library {acc[k][3]:.4f} ms"
            if k == "fwd":
                k4[(k, dt)].update(library_gather_ms=acc[k][4], path=k4_path)
                lib += f", index_select + grid_sample {acc[k][4]:.4f} ms"
            else:
                k4[(k, dt)].update(parts[dt], repeat_equal=repeat[dt])
                lib += (f"; 3 more calls bitwise equal: {repeat[dt]}"
                        f"; {parts[dt]['path']}; " + ", ".join(
                    f"{p_} {t:.4g}" for p_, t in parts[dt].items()
                    if p_ != "path"))
            print(f"[kernel] warp2d_pairs_{k} {dt} (both scales): kernel "
                  f"{acc[k][1]:.4f} ms, {lib}, bound {b[0]:.4f} ms ({b[1]}; "
                  f"{b[0] / acc[k][1]:.0%} of it)")
    for k in ("fwd", "bwd"):
        results[f"warp2d_pairs_{k}"] = dict(
            **k4[(k, torch.bfloat16)], dtype="bfloat16",
            f32=k4[(k, torch.float32)])

    # K5: K3's kernels through the warp_kernel.warp2d entry point, at the
    # MF geometric loss's depth sample (12 directions x 4 tracks, C = 1);
    # K3's backward at that call too (the MF train step's)
    dirs_mf = _ordered_directions(TL)
    f0_mf = torch.cat([flow_mf[a, b] for a, b in dirs_mf]).contiguous()
    img5 = torch.as_tensor(rng_p.rand(*f0_mf.shape[:3], 1).astype(
        np.float32), device=dev)
    grid5 = grid_of(f0_mf[..., 0] + u, f0_mf[..., 1] + v)
    img5n = img5.permute(0, 3, 1, 2)
    m5 = f0_mf.shape[0] * H * W
    record("warp2d_v1_fwd", warp2d_v1(img5, f0_mf),
           warp2d_plain(img5, f0_mf),
           cuda_ms(lambda: kernels.warp2d_v1_fwd(img5, f0_mf)),
           cuda_ms(lambda: warp2d_plain(img5, f0_mf)),
           cuda_ms(lambda: F.grid_sample(img5n, grid5, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True)),
           bound_ms(4 * m5 * (2 + 1 + 1)),
           f"img {tuple(img5.shape)} flow {tuple(f0_mf.shape)}")
    del img5, grid5, img5n
    label = "MF train step, rigid flow"
    results["warp2d_bwd"]["calls"][f"{label} {tuple(f0_mf.shape[:3])}"] = \
        k3_bwd_call("warp2d_bwd", flow_warp, kernels.warp2d_bwd, f0_mf, label)
    results["warp2d_v1_bwd"] = k3_bwd_call(
        "warp2d_v1_bwd", warp2d_v1, kernels.warp2d_v1_bwd, f0_mf,
        "K5, the MF loss's call")
    k3b = results["warp2d_bwd"]
    k3b["max_abs_err"] = max([k3b["max_abs_err"]] + [
        r["max_abs_err"] for r in k3b["calls"].values()])
    # K3 at C = 5, the MF path's other calls: the MF geometric loss's
    # (flow, ambient, projected primary pixel) sample at full resolution
    # and FuseNet's geometry warp (xyz and the reverse flow) at 256x216
    from depthinspace_tpu_torch.models.fusenet import _resize_flow_grid
    k3r = results["warp2d_fwd"]
    f_fuse = _pair_flows(_resize_flow_grid(flow_mf, H // 2, W // 2))
    for label, flow in (("MF geometric loss", f0_mf),
                        ("FuseNet geometry warp", f_fuse)):
        img = torch.as_tensor(rng_p.rand(*flow.shape[:3], 5).astype(
            np.float32), device=dev)
        r = k3_call(img, flow, label)
        k3r["calls"][f"{label} C=5 {tuple(flow.shape[:3])}"] = r
        k3r["max_abs_err"] = max(k3r["max_abs_err"], r["max_abs_err"])
        del img
    del es_t, ta_t, g_t, pat_t, grid_t
    torch.cuda.empty_cache()

    threefry_phase(dev, smi, results)

    # -- 4. serve ----------------------------------------------------------
    from depthinspace_tpu_torch.models import DispNet, init_dispnet_
    from depthinspace_tpu_torch.serve import DisparityServer
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_sf_eval_step,
                                              make_sf_train_step)

    model = _dispnet(_jkey(SEED))
    cpu_model = copy.deepcopy(model).eval()
    kernels.reset_launches()                     # the eval path starts here
    server = DisparityServer(model, imsize=(H, W), max_batch=8, device=dev)
    server.warmup()
    images = np.concatenate([batch_np.im.reshape(n, H, W),
                             batch_np.ambient.reshape(n, H, W)])[:13]
    out = server.infer(images)
    check(out.shape == (13, H, W), f"serve output shape {out.shape}")
    check(np.isfinite(out).all(), "serve output not finite")
    check(out.min() >= 0.0 and out.max() <= 128.0,
          f"serve output outside [0, 128]: {out.min()} .. {out.max()}")
    # one request, one answer: the server's forward runs on deterministic
    # cuDNN algorithms (the deterministic mode, device.resolve_device)
    check(np.array_equal(server.infer(images), out),
          "SF serve: the same request served twice differs")
    diff = default_algorithms_diff(lambda: server.infer(images))
    ragged = serve_rates(lambda: server.infer(images), 13)
    full = serve_rates(lambda: server.infer(images[:8]), 8)
    reps = 5
    print(f"[serve] out {out.shape} in [{out.min():.3f}, {out.max():.3f}] "
          f"px; served twice: equal; on the default algorithms {diff}; "
          f"{ragged['deterministic']:.1f} maps/s on 13-image requests "
          f"(buckets 8+8), {full['deterministic']:.1f} maps/s on 8-image "
          f"requests; on the default algorithms (before the repair) "
          f"{ragged['default']:.1f} and {full['default']:.1f}; f32, TF32 "
          f"off; {smi}")
    # where the deterministic algorithms spend the time: one 8-image
    # bucket on each setting
    profile_step(lambda b: server.infer(b), images[:8],
                 "SF serve, 8-image bucket, deterministic cuDNN", GROUPS)
    with default_cudnn_algorithms():
        profile_step(lambda b: server.infer(b), images[:8],
                     "SF serve, 8-image bucket, default cuDNN", GROUPS)

    # -- 5. eval step ------------------------------------------------------
    model.eval()
    for flow_source in ("file", "pred"):
        ctx = make_loss_context(settings, TL, device=dev,
                                flow_source=flow_source)
        step = make_sf_eval_step(model, ctx)
        disp_u16, comps = step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            disp_u16, comps = step(batch)
        comps_np = comps.cpu().numpy()
        step_ms = (time.perf_counter() - t0) / reps * 1e3
        check(disp_u16.shape == (TL, BS, H, W), "eval disp0 shape")
        check(np.isfinite(comps_np).all() and (comps_np > 0).all(),
              f"eval components not finite and positive: {comps_np}")
        print(f"[eval] flow_source={flow_source}: components "
              f"{np.array2string(comps_np, precision=6)}; {step_ms:.1f} ms/step "
              f"(tl={TL}, bs={BS}, {H}x{W}, f32)")
    counts = dict(kernels.launches)              # the eval path ends here
    print(f"[eval] kernel launches on the eval path: {counts}")
    for name in ("census_sad_fwd", "xwarp_fwd", "warp2d_fwd"):
        check(counts[name] > 0, f"{name} never launched on the eval path")
    for name in ("census_sad_bwd", "xwarp_bwd", "warp2d_bwd"):
        check(counts[name] == 0, f"{name} launched by the eval step")

    # -- 6. slice parity: card (kernels) vs CPU (plain versions) -----------
    b1_np = make_track_batch(settings, tl=TL, bs=1, seed=SEED + 1)
    ctx_gpu = make_loss_context(settings, TL, device=dev)
    ctx_cpu = make_loss_context(settings, TL, device="cpu")
    d_gpu, c_gpu = make_sf_eval_step(model, ctx_gpu)(batch_to_torch(b1_np, dev))
    t0 = time.perf_counter()
    d_cpu, c_cpu = make_sf_eval_step(cpu_model, ctx_cpu)(
        batch_to_torch(b1_np, "cpu"))
    cpu_s = time.perf_counter() - t0
    c_gpu, c_cpu = c_gpu.cpu().numpy(), c_cpu.numpy()
    rel = np.abs(c_gpu - c_cpu) / np.abs(c_cpu)
    dd = np.abs(d_gpu.cpu().numpy().astype(np.int64)
                - d_cpu.numpy().astype(np.int64))
    print(f"[parity] components card {np.array2string(c_gpu, precision=7)}")
    print(f"[parity] components cpu  {np.array2string(c_cpu, precision=7)}")
    print(f"[parity] relative diff {np.array2string(rel, precision=2)}; "
          f"disp0 u16 max diff {dd.max()}, equal on {np.mean(dd == 0):.5f}; "
          f"cpu step {cpu_s:.1f} s")
    # photometric and smoothness: rtol 1e-3; geometric: rtol 1e-2 (its fb/vc
    # masks are thresholds that an ulp-level difference can flip)
    check((rel[:5] <= 1e-3).all() and rel[5] <= 1e-2,
          f"card and CPU components differ: {rel}")
    check(dd.max() <= 1 and np.mean(dd == 0) >= 0.999,
          "card and CPU disp0 differ")

    # -- 7. train step at tl=4, bs=8 ---------------------------------------
    t0 = time.perf_counter()
    tb_np = make_track_batch(settings, tl=TL, bs=TRAIN_BS, seed=SEED + 2)
    tbatch = batch_to_torch(tb_np, dev)
    print(f"[train] synthetic batch tl={TL} bs={TRAIN_BS} in "
          f"{time.perf_counter() - t0:.1f} s")
    train_model = _dispnet(_jkey(SEED + 3))
    # device augmentation on, as the workers run the step (its 10 draws a
    # step from the state's key: csrc/threefry.cu)
    ctx_t = make_loss_context(settings, TL, device=dev, augment=True)
    state = TrainState.create(train_model, 1e-4, seed=SEED, device=dev)
    train_step = make_sf_train_step(train_model, ctx_t, state)
    kernels.reset_launches()                    # the train path starts here
    torch.cuda.reset_peak_memory_stats()
    totals, times = [], []
    for i in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = train_step(tbatch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        comps_np = comps.cpu().numpy()
        check(np.isfinite(comps_np).all(), f"train components {comps_np}")
        totals.append(float(comps_np.sum()))
        if i >= 6 and totals[-1] < totals[0]:
            break
    steps = len(totals)
    counts_t = dict(kernels.launches)           # the train path ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.median(times[1:]))
    print(f"[train] tl={TL} bs={TRAIN_BS} {H}x{W} f32 TF32 off: "
          f"{step_ms:.1f} ms/step (median of {steps - 1} after a warm step; "
          f"min {min(times[1:]):.1f}, max {max(times[1:]):.1f}); peak "
          f"{peak_gib:.2f} GiB; {smi}")
    print(f"[train] total loss {totals[0]:.6f} at step 0 -> {totals[-1]:.6f} "
          f"at step {steps - 1}; components {np.array2string(comps_np, precision=5)}")
    check(totals[-1] < totals[0], "the train loss did not fall in 30 steps")
    print(f"[train] kernel launches on the train path over {steps} steps: "
          f"{counts_t}")
    for name, per in {**PER_TRAIN_STEP,
                      "threefry": THREEFRY_PER_STEP}.items():
        check(counts_t[name] == per * steps,
              f"{name}: {counts_t[name]} launches, expected {per} x {steps}")

    profile_step(train_step, tbatch, "train step", GROUPS)

    state2 = TrainState.create(copy.deepcopy(train_model), 1e-4, seed=SEED,
                               device=dev)
    ctx_aug = make_loss_context(settings, TL, device=dev, augment=True)
    step2 = make_sf_train_step(state2.model, ctx_aug, state2, accum_steps=2)
    times2 = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c2 = step2(tbatch).cpu().numpy()
        times2.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(c2).all(), f"accum-2 components {c2}")
    print(f"[train] accum_steps=2 with device augmentation: "
          f"{np.median(times2[1:]):.1f} ms/step (median of 3); components "
          f"{np.array2string(c2, precision=5)}")
    del tbatch, state, state2, train_step, step2
    torch.cuda.empty_cache()

    # -- 8. train parity: card vs CPU, one step at bs=1 --------------------
    def one_step(d):
        m = copy.deepcopy(cpu_model)
        st = TrainState.create(m, 1e-4, seed=SEED, device=d)
        t0 = time.perf_counter()
        comps = make_sf_train_step(m, make_loss_context(
            settings, TL, device=d, augment=True), st)(
            batch_to_torch(b1_np, d)).cpu().numpy()
        print(f"[train parity] {d.type} step {time.perf_counter() - t0:.1f} s")
        return comps, {k: p.grad.detach().cpu().double()
                       for k, p in m.named_parameters()}

    c_card, g_card = one_step(dev)
    _, g_card2 = one_step(dev)
    c_cpu, g_cpu = one_step(torch.device("cpu"))
    rel_c = np.abs(c_card - c_cpu) / np.abs(c_cpu)
    rel_all, rel_g = grad_diff(g_card, g_cpu)
    self_all, self_g = grad_diff(g_card2, g_card)
    worst = max(rel_g, key=rel_g.get)
    print(f"[train parity] components relative diff "
          f"{np.array2string(rel_c, precision=2)}; gradients card vs CPU: "
          f"relative L2 {rel_all:.3g} over all parameters; per tensor max "
          f"{rel_g[worst]:.3g} ({worst}, gradient norm "
          f"{float(torch.linalg.vector_norm(g_cpu[worst])):.3g}), median "
          f"{np.median(list(rel_g.values())):.3g} over {len(rel_g)} tensors; "
          f"card vs card: {self_all:.3g} over all, per tensor max "
          f"{max(self_g.values()):.3g}")
    # components: as phase 6. Gradients: the whole gradient within 1e-3
    # relative L2, each tensor within 2e-2: f32 convolutions summed in other
    # orders, and the census signs and geometric masks can flip where a value
    # sits within an ulp of a threshold; the deepest layers' gradients are
    # ~1e-5 of the heads' at this init and carry the largest relative error
    check(self_all == 0.0, f"two card steps from one state differ: "
          f"{self_all}")
    check((rel_c[:5] <= 1e-3).all() and rel_c[5] <= 1e-2,
          f"card and CPU train components differ: {rel_c}")
    check(rel_all <= 1e-3 and rel_g[worst] <= 2e-2,
          f"card and CPU gradients differ: all {rel_all}, {worst} "
          f"{rel_g[worst]}")

    # -- 9. worker: train, resume, retest ----------------------------------
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.data import SyntheticSource
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cfg = RunConfig(data_dir=Path(tmp), output_dir=Path(tmp), epochs=1,
                        train_batch_size=2, test_batch_size=2,
                        max_train_iter=2, num_workers=4, seed=SEED)
        source = SyntheticSource(settings, 8, seed=SEED + 10)   # 2 test
        t0 = time.perf_counter()
        SingleFrameWorker(cfg, device=dev, source=source).do("retrain")
        exp = Path(tmp) / "single_frame"
        names = sorted(p.name for p in exp.iterdir())
        check({"metrics.json", "state", "net_0000.params", "train.log",
               "state_set_simple_best"} <= set(names),
              f"worker artifacts {names}")
        # the debug images and errs.png, drawn without matplotlib
        from depthinspace_tpu_torch.data.imgproc import read_png
        for name, shape in (("train_000_0000.png", (2 * H, 3 * W, 3)),
                            ("test_000_0000.png", (2 * H, 3 * W, 3)),
                            ("errs.png", (600, 800, 3))):
            check((exp / name).is_file(), f"the worker wrote no {name}")
            got = read_png(exp / name).shape
            check(got == shape, f"{name} decodes to {got}, not {shape}")
        print(f"[worker] debug images: train_000_0000.png and "
              f"test_000_0000.png {2 * H}x{3 * W} RGB, errs.png 600x800; "
              "each decodes with imgproc.read_png")
        m0 = json.loads((exp / "metrics.json").read_text())
        loss0 = m0["0"]["test"]["0"]["loss"]
        cfg.epochs = 2
        SingleFrameWorker(cfg, device=dev, source=source).do("resume")
        m1 = json.loads((exp / "metrics.json").read_text())
        check(sorted(m1) == ["0", "1"], f"resumed epochs {sorted(m1)}")
        check("Resumed from epoch 0" in (exp / "train.log").read_text(),
              "the resumed worker did not start at epoch 1")
        SingleFrameWorker(cfg, device=dev, source=source).do("retest",
                                                             epoch=0)
        again = json.loads((exp / "metrics.json").read_text())["0"]["test"][
            "0"]["loss"]
        rel_r = np.abs(np.array(again) - loss0) / np.abs(loss0)
        close_logs()
        print(f"[worker] {names}; epoch 0 test: loss {sum(loss0):.5f}, "
              f"dist2_mean {m0['0']['test']['0']['dist2_mean']:.3f}, of1 "
              f"{m0['0']['test']['0']['of1']:.4f}; resumed at epoch 1; "
              f"retest of epoch 0 within {rel_r.max():.2g} relative; "
              f"{time.perf_counter() - t0:.1f} s")
        check(rel_r.max() <= 1e-4, f"retest of epoch 0 differs: {rel_r}")

    mf_counts = mf_phases(settings, dev, smi, model, mf_np)
    wire_cache_phase(settings, dev)
    repeat_phase(settings, dev, tb_np, mf_np)
    staged_pipeline_phase(settings, dev, smi, then=lambda data, out:
                          learned_flow_phase(settings, dev, smi, model, tb_np,
                                             mf_np, data, out))

    plane_scene_phase(dev, smi)
    def after_generation(data, out):
        data_parallel_phase(settings, dev, smi, model, images, data, out)
        orbax_resume_phase(dev, smi, data)
        farneback_phase(dev, smi, data)

    generated_data_phase(dev, smi, then=after_generation)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": mf_counts[name], **r}
        for name, r in results.items()]}
    print(f"[total] {time.perf_counter() - T_START:.1f} s for the whole run")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


def write_hdf5_samples(d: Path, settings, n: int, seed: int,
                       primary: bool = False) -> dict:
    """A dataset directory in the reference's schema, written with
    data/hdf5.py: settings.pkl and n samples, each a frames.hdf5 (im,
    ambient, grad, disp (4, 1, H, W), R (4, 3, 3), t (4, 3)) of the
    in-memory synthetic sample make_track_batch(seed + i) and, with
    ``primary``, a single_frame_disp.hdf5 of its stand-in primary (GT +
    0.5 px of seeded noise). grad (the reference's Sobel magnitude of the
    ambient, which no stage of the port reads) is the magnitude of numpy's
    central differences, clipped to [0, 1]. Returns {sample name: {file:
    {dataset: array}}} as written."""
    from depthinspace_tpu_torch.data import (hdf5, make_track_batch,
                                             save_settings)
    d.mkdir(parents=True)
    save_settings(d / "settings.pkl", settings)
    written = {}
    for i in range(n):
        b = make_track_batch(settings, tl=TL, bs=1, seed=seed + i,
                             primary_noise=0.5 if primary else None)
        gy, gx = np.gradient(b.ambient, axis=(-2, -1))
        files = {"frames.hdf5": {
            "im": b.im, "ambient": b.ambient,
            "grad": np.clip(np.hypot(gx, gy), 0, 1).astype(np.float32),
            "disp": b.disp_gt, "R": b.R[:, 0], "t": b.t[:, 0]}}
        if primary:
            files["single_frame_disp.hdf5"] = {"disp": b.primary_disp}
        name = f"{i:08d}"
        (d / name).mkdir()
        for fname, datasets in files.items():
            hdf5.write_hdf5(d / name / fname, datasets)
        written[name] = files
    return written


def close_logs() -> None:
    import logging
    for h in list(logging.root.handlers):
        h.close()
        logging.root.removeHandler(h)


def wire_cache_phase(settings, dev) -> None:
    """Phase 15: 8 synthetic samples written as HDF5 (data/hdf5.py) with
    their stand-in primary, and the wire cache built from them by the
    port's build_wire_cache; the SF worker (rigid flow) and the MF worker
    (flow from the primary, "pred") train for 3 steps and test from the
    cache, then retest epoch 0."""
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.data import BASE_FIELDS, build_wire_cache
    from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        data = Path(tmp) / "data"
        t0 = time.perf_counter()
        write_hdf5_samples(data, settings, 8, SEED + 40, primary=True)
        build_wire_cache(data, list(BASE_FIELDS) + ["primary_disp"])
        print(f"[wire cache] 8 synthetic samples {H}x{W} written as HDF5 "
              f"and built into a wire cache in "
              f"{time.perf_counter() - t0:.1f} s")
        for arch, cls, flow in (("single_frame", SingleFrameWorker, "rigid"),
                                ("multi_frame", MultiFrameWorker, "pred")):
            cfg = RunConfig(data_dir=data, output_dir=Path(tmp) / "out",
                            architecture=arch, epochs=1, train_batch_size=2,
                            test_batch_size=2, max_train_iter=3,
                            num_workers=4, seed=SEED, flow_source=flow)
            t0 = time.perf_counter()
            cls(cfg, device=dev).do("retrain")
            exp = Path(tmp) / "out" / arch
            log = (exp / "train.log").read_text()
            m0 = json.loads((exp / "metrics.json").read_text())["0"]
            loss0 = m0["test"]["0"]["loss"]
            cls(cfg, device=dev).do("retest", epoch=0)
            again = json.loads((exp / "metrics.json").read_text())["0"][
                "test"]["0"]["loss"]
            rel_r = np.abs(np.array(again) - loss0) / np.abs(loss0)
            close_logs()
            print(f"[wire cache] {arch} worker, --flow_source {flow}: "
                  f"{len(m0['train']['loss'])} train components after 3 "
                  f"steps, test loss {sum(loss0):.5f}, dist2_mean "
                  f"{m0['test']['0']['dist2_mean']:.3f}; retest of epoch 0 "
                  f"within {rel_r.max():.2g} relative; "
                  f"{time.perf_counter() - t0:.1f} s")
            check("using wire cache for train split" in log
                  and "using wire cache for test split" in log,
                  f"the {arch} worker did not read the wire cache")
            check(np.isfinite(loss0).all() and rel_r.max() <= 1e-4,
                  f"{arch} retest from the wire cache differs: {rel_r}")


K1_K3 = ("census_sad_fwd", "census_sad_bwd", "xwarp_fwd", "xwarp_bwd",
         "warp2d_fwd", "warp2d_bwd")
K1_K4 = K1_K3 + ("warp2d_pairs_fwd", "warp2d_pairs_bwd")


def staged_pipeline_phase(settings, dev, smi, then=None) -> None:
    """Phase 17: the staged pipeline DIS-SF -> presave -> DIS-MF -> presave
    -> DIS-FTSF through the port's tools and workers, on 8 samples at
    512x432 written as HDF5 (data/hdf5.py) and read back; each stage's wall
    seconds and kernel launches; 3 train steps a stage. ``then(data, out)``
    runs last, on the phase's dataset and output directories."""
    import torch
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.data import (TrackDataset, collate,
                                             encode_batch, hdf5)
    from depthinspace_tpu_torch.data.wire import encode_disp
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.serve import DisparityServer
    from depthinspace_tpu_torch.tools import (build_cache, presave_disp,
                                              presave_flow)
    from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    T0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        data, out = Path(tmp) / "data", Path(tmp) / "out"
        t0 = time.perf_counter()
        written = write_hdf5_samples(data, settings, 8, SEED + 60)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, files in written.items():
            with hdf5.File(data / name / "frames.hdf5") as f:
                got = {k: np.asarray(f[k]) for k in f.keys()}
            want = files["frames.hdf5"]
            check(sorted(got) == sorted(want) and all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                 want[k])
                for k in want), f"frames.hdf5 of {name} reads back other")
        mb = sum(f.stat().st_size for f in data.rglob("*.hdf5")) / 2 ** 20
        print(f"[pipeline] 8 samples {H}x{W} written as HDF5 ({mb:.1f} MiB) "
              f"in {write_s:.1f} s, read back equal in "
              f"{time.perf_counter() - t0:.2f} s")

        stage_s = []

        def stage(name, fn):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.launches.items() if v}
            close_logs()
            stage_s.append(sec)
            print(f"[pipeline] {name}: {sec:.2f} s; kernel launches "
                  f"{counts}; {smi}")
            return counts

        def cfg(arch, flow, **kw):
            return RunConfig(data_dir=data, output_dir=out, architecture=arch,
                             epochs=1, train_batch_size=2, test_batch_size=2,
                             max_train_iter=3, num_workers=4, seed=SEED,
                             flow_source=flow, **kw)

        def loader_wait(arch) -> str:
            """The worker's own split of its last epoch: the seconds it
            waited for the loader (4 threads) and spent in the steps."""
            log = (out / arch / "train.log").read_text().splitlines()
            return [ln for ln in log if "timings:" in ln][-1].split(
                "timings: ")[-1]

        def presave(arch, *argv):
            presave_disp.main([arch, "--epoch", "0", "--data_dir", str(data),
                               "--output_dir", str(out), *argv], device=dev)

        def presave_twice(arch, *argv):
            """presave_disp again: every sample's file has the same bytes
            (its forwards run on deterministic cuDNN algorithms)."""
            path = lambda n: data / n / f"{arch}_disp.hdf5"
            first = {n: path(n).read_bytes() for n in written}
            presave(arch, *argv)
            same = [path(n).read_bytes() == first[n] for n in written]
            print(f"[pipeline] presave_disp {arch} run twice: "
                  f"{sum(same)} of {len(same)} files equal byte for byte")
            check(all(same), f"presave_disp {arch} twice wrote other files")

        stage("presave_flow rigid", lambda: presave_flow.main(
            ["--provider", "rigid", "--data_dir", str(data)]))
        for name in written:
            with hdf5.File(data / name / "flow.hdf5") as f:
                check(len(f) == 12 and all(
                    f[k].shape == (1, 2, H, W) and f[k].dtype == np.float32
                    and np.isfinite(f[k]).all() for k in f.keys()),
                    f"flow.hdf5 of {name}")

        # the HDF5 loader on one DIS-SF train batch (the 8 samples, read
        # from the page cache and collated on one thread) and its wire
        # encoding, with and without flow.hdf5
        def load(flow: bool) -> str:
            ds = TrackDataset(settings, sorted(str(p) for p in
                                               data.glob("0*")),
                              load_flow=flow)
            t0 = time.perf_counter()
            host = collate([ds[i] for i in range(8)])
            t1 = time.perf_counter()
            encode_batch(host)
            return (f"read + collate {(t1 - t0) * 1e3:.1f} ms, encode "
                    f"{(time.perf_counter() - t1) * 1e3:.1f} ms")

        print(f"[pipeline] HDF5 loader, one SF batch (bs 8, tl 4) {H}x{W} "
              f"from the page cache: with flow: {load(True)}; without "
              f"flow: {load(False)}")

        stage("SF retrain (--flow_source file)", lambda: SingleFrameWorker(
            cfg("single_frame", "file"), device=dev).do("retrain"))
        print(f"[pipeline] SF worker: {loader_wait('single_frame')}")
        stage("presave_disp single_frame", lambda: presave("single_frame"))
        presave_twice("single_frame")
        # the hand-off against DisparityServer on the same images and
        # weights: within one u16 unit, unequal on <= 0.1 % of pixels (the
        # server's calls of 4 images against the tool's batch of 32)
        srv = DisparityServer.from_net_params(
            out / "single_frame" / "net_0000.params", imsize=(H, W),
            max_batch=8, device=dev)
        diffs = []
        for name, files in written.items():
            ref = srv.infer(files["frames.hdf5"]["im"][:, 0])
            ref_u16 = encode_disp(ref).astype(np.int64)
            with hdf5.File(data / name / "single_frame_disp.hdf5") as f:
                got = np.asarray(f["disp"])
            check(got.shape == (4, 1, H, W), f"SF presave shape {got.shape}")
            diffs.append(np.abs(np.rint(got[:, 0] * 256.0).astype(np.int64)
                                - ref_u16))
        dd = np.stack(diffs)
        print(f"[pipeline] single_frame_disp.hdf5 vs DisparityServer.infer: "
              f"max {dd.max()} u16 units, unequal on {np.mean(dd > 0):.5f}")
        check(dd.max() <= 1 and np.mean(dd > 0) <= 1e-3,
              "single_frame_disp.hdf5 differs from DisparityServer.infer")
        del srv

        mf = stage("MF retrain (--flow_source file, bf16 4x32)",
                   lambda: MultiFrameWorker(
                       cfg("multi_frame", "file", mf_dtype="bfloat16"),
                       device=dev).do("retrain"))
        print(f"[pipeline] MF worker: {loader_wait('multi_frame')}")
        for k in K1_K4:
            check(mf.get(k, 0) > 0, f"{k} never launched in the MF stage")
        mp = stage("presave_disp multi_frame (--flow_source file)",
                   lambda: presave("multi_frame", "--flow_source", "file"))
        for k in ("warp2d_fwd", "warp2d_pairs_fwd"):
            check(mp.get(k, 0) > 0, f"{k} never launched in the MF presave")
        presave_twice("multi_frame", "--flow_source", "file")
        for name in written:
            with hdf5.File(data / name / "multi_frame_disp.hdf5") as f:
                got = np.asarray(f["disp"])
            check(got.shape == (4, 1, H, W) and np.isfinite(got).all()
                  and got.min() >= 0 and got.max() <= 128,
                  f"multi_frame_disp.hdf5 of {name}")
        stage("build_cache", lambda: build_cache.main(
            ["--data_dir", str(data), "--fields",
             "im,ambient,disp,R,t,primary_disp,pseudo_gt"]))
        ftsf_cfg = cfg("single_frame", "rigid", use_pseudo_gt=True)
        exp = out / "single_frame"
        ftsf = stage("FTSF retrain (--use_pseudo_gt True --flow_source "
                     "rigid, wire cache)", lambda: SingleFrameWorker(
                         ftsf_cfg, device=dev).do("retrain"))
        print(f"[pipeline] FTSF worker: {loader_wait('single_frame')}")
        for k in K1_K3:
            check(ftsf.get(k, 0) > 0, f"{k} never launched in the FTSF stage")
        log = (exp / "train.log").read_text()
        check("using wire cache for train split" in log.split(
            "Experiment: single_frame")[-1], "FTSF did not read the cache")
        m0 = json.loads((exp / "metrics.json").read_text())["0"]
        comps, loss0 = m0["train"]["loss"], m0["test"]["0"]["loss"]
        check(len(comps) == 10 and np.isfinite(comps).all(),
              f"FTSF train loss vector {comps}")
        stage("FTSF retest epoch 0", lambda: SingleFrameWorker(
            ftsf_cfg, device=dev).do("retest", epoch=0))
        again = json.loads((exp / "metrics.json").read_text())["0"]["test"][
            "0"]["loss"]
        rel = np.abs(np.array(again) - loss0) / np.abs(loss0)
        print(f"[pipeline] FTSF train components "
              f"{np.array2string(np.array(comps), precision=5)}; test loss "
              f"{sum(loss0):.5f}, retest within {rel.max():.2g} relative")
        check(np.isfinite(loss0).all() and rel.max() <= 1e-4,
              f"FTSF retest of epoch 0 differs: {rel}")
        print(f"[pipeline] stages {sum(stage_s):.1f} s; "
              f"phase {time.perf_counter() - T0:.1f} s; {smi}")
        if then is not None:
            then(data, out)


# phase 19: the plane-scene fixture at full width. The camera of make_settings
# (focal 435.2 px) and a 0.25 m baseline put the GT disparity of the scenes'
# planes (1.3-6 m away) at 22-78 px (measured on the CPU at 512x432)
PLANE_N = 16
PLANE_FOCAL = 435.2
PLANE_BASELINE = 0.25
# the SF geometric component at a constant 40 px over that at the GT
# disparity: 78 measured on the CPU at fixture scale (128x108, focal and
# disparities / 4, a constant 10 px), 347 at 512x432; the check asks for
# half of the first
GEO_RATIO_MIN = 39.0
OVERFIT_S = 20.0                          # the overfit's budget, seconds
# its Adam rate, and the shares of their start the photometric loss and
# the mean |disp - GT| must fall below: half the drops measured on the card.
# From the workers' init (flax's, jax.random.key(42)), whose heads predict
# ~6 px against a GT of 20-80 px, Adam(1e-4) moves them to 0.992x and
# 0.995x in 81-85 steps, in every run; with K2's backward returning zeros
# (no photometric gradient) the photometric loss rises, 1.003x, and fails
# (scripts/chip_check_controls.py). The geometric term with the file's
# flow still teaches the disparity without K2 (0.927x), so the photometric
# limit is the one that catches a broken photometric gradient. A higher
# rate does not learn more surely: Adam(3e-3) ended at 0.930x, 0.999x,
# 0.996x and 1.001x in four runs, and as low with K2 zeroed
OVERFIT_LR = 1e-4
OVERFIT_PH_MAX = 0.996
OVERFIT_DIST_MAX = 0.9975


def plane_scenes(data: Path):
    """Phase 19's PLANE_N plane-scene samples written to ``data``:
    (settings, the first TRAIN_BS samples as a wire-encoded batch, their
    GT disparity (tl, bs, H, W) in px)."""
    from depthinspace_tpu_torch.data import (TrackDataset, collate,
                                             decode_batch_np, encode_batch,
                                             generate_dataset, load_settings)
    generate_dataset(data, n_samples=PLANE_N, imsize=(H, W), seed=SEED + 90,
                     focal=PLANE_FOCAL, baseline=PLANE_BASELINE,
                     write_sgm=True)
    settings = load_settings(data / "settings.pkl")
    paths = sorted(str(p) for p in data.glob("0*"))
    ds = TrackDataset(settings, paths[:TRAIN_BS], train=False,
                      load_flow=True)
    enc = encode_batch(collate([ds[i] for i in range(TRAIN_BS)]))
    return settings, enc, decode_batch_np(enc).disp_gt


def overfit(model, ctx, batch, gt, dev, lr: float, seconds: float):
    """DIS-SF ``model`` trained on the one ``batch`` (Adam(lr)) for
    ``seconds``: (steps, seconds, (photometric, mean |disp - GT| in px)
    before and after, the kernel launches of the steps)."""
    import torch
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.train import (TrainState, make_sf_eval_step,
                                              make_sf_train_step)
    state = TrainState.create(model, lr, seed=SEED, device=dev)
    step = make_sf_train_step(model, ctx, state)
    ev = make_sf_eval_step(model, ctx)

    def accuracy():
        disp_u16, comps = ev(batch)
        es = disp_u16.cpu().numpy().astype(np.float32) / 256.0
        return float(comps[0]), float(np.mean(np.abs(es - gt)[gt > 0]))

    before = accuracy()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        comps = step(batch)
        steps += 1
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    check(np.isfinite(comps.cpu().numpy()).all(), "overfit components")
    return steps, fit_s, before, accuracy(), counts


def plane_scene_phase(dev, smi) -> None:
    """Phase 19: plane scenes on the card. 16 samples of the port's fixture
    (data/fixture.py) at 512x432 with SGM disparities; the SF objective at
    the GT disparity and at a constant 40 px (the geometric component, its
    masks' accept shares, one pair's flow_consistency_sf); DIS-SF overfit
    on one fixed batch (bs 8, f32, Adam(OVERFIT_LR)) for OVERFIT_S seconds,
    the photometric loss and the disparity error falling; then train_val
    --data_type real on the dataset, 2 epochs with the SGM warmup gate,
    augmented on the host and, on the same split, on the device, and two
    retests (--eval_metrics exact and device) that agree."""
    import torch
    import depthinspace_tpu_torch.config as config_mod
    from depthinspace_tpu_torch import train_val
    from depthinspace_tpu_torch.data import batch_to_torch, decode_batch
    from depthinspace_tpu_torch.losses import (flow_consistency_sf,
                                               geometric_loss_sf)
    from depthinspace_tpu_torch.ops import disp_to_depth, kernels
    from depthinspace_tpu_torch.train import make_loss_context
    from depthinspace_tpu_torch.train.objective import sf_losses
    T0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # -- 19a. the dataset ----------------------------------------------
        data = Path(tmp) / "data"
        t0 = time.perf_counter()
        settings, enc, gt = plane_scenes(data)
        gen_s = (time.perf_counter() - t0) / PLANE_N
        print(f"[plane] {PLANE_N} plane-scene samples {H}x{W} (focal "
              f"{PLANE_FOCAL} px, baseline {PLANE_BASELINE} m, SGM "
              f"disparities): {gen_s:.2f} s a sample on the host; the first "
              f"{TRAIN_BS}: GT disparity {gt.min():.1f} .. {gt.max():.1f} px")
        check(gt.min() >= 10.0 and gt.max() <= 100.0,
              f"plane-scene GT disparity {gt.min()} .. {gt.max()} px")

        # -- 19b. the SF objective at the GT and at a constant -------------
        batch = batch_to_torch(enc, dev)
        bt = decode_batch(batch)
        ctx = make_loss_context(settings, TL, device=dev)   # flow.hdf5's
        geo = {}
        kernels.reset_launches()
        with torch.inference_mode():
            for name, disp in (("the GT", bt.disp_gt),
                               ("40 px", torch.full_like(bt.disp_gt, 40.0))):
                o = disp.reshape(TL * TRAIN_BS, H, W, 1)
                _, comps = sf_losses([o] * 4, bt, ctx, train=False)
                depth = disp_to_depth(disp, ctx.focal_length, ctx.baseline)
                _, stats = geometric_loss_sf(
                    ctx.cam, depth, bt.R, bt.t, bt.flow, bt.ambient,
                    clamp=ctx.geo_clamp, with_stats=True)
                pair = flow_consistency_sf(
                    ctx.cam, depth[0], depth[1], bt.R[0], bt.t[0], bt.R[1],
                    bt.t[1], bt.flow[0, 1], bt.flow[1, 0], bt.ambient[0],
                    bt.ambient[1], clamp=ctx.geo_clamp)
                c = comps.cpu().numpy()
                geo[name] = float(c[5])
                check(np.isfinite(c).all() and np.isfinite(float(pair)),
                      f"SF objective at {name}: {c}, pair {float(pair)}")
                print(f"[plane] SF objective at {name}: components "
                      f"{np.array2string(c, precision=6)}; masks accept "
                      + ", ".join(f"{k} {float(v):.4f}"
                                  for k, v in stats.items())
                      + f"; flow_consistency_sf(0, 1) {float(pair):.6f}")
        k3 = kernels.launches["warp2d_fwd"]
        ratio = geo["40 px"] / geo["the GT"]
        print(f"[plane] geometric component: {geo['the GT']:.3g} at the GT, "
              f"{geo['40 px']:.3g} at 40 px ({ratio:.0f}x, at least "
              f"{GEO_RATIO_MIN:.0f}x asked); K3 forward launches {k3}")
        check(ratio >= GEO_RATIO_MIN,
              f"geometric at the GT not far below 40 px: {ratio:.1f}x")
        check(k3 == 2 * (2 + 2 + 2), f"K3 forward launches {k3}, expected "
              "2 a geometric loss, with_stats call and pair, at 2 points")

        # -- 19c. DIS-SF overfits one batch ---------------------------------
        # from the workers' init (RunConfig.seed 42: flax's init from
        # jax.random.key(42), the JAX package's)
        steps, fit_s, (ph0, dist0), (ph1, dist1), counts = overfit(
            _dispnet(_jkey(42)), ctx, batch, gt, dev, OVERFIT_LR, OVERFIT_S)
        print(f"[plane] DIS-SF overfit, one batch (bs {TRAIN_BS}, tl {TL}, "
              f"f32, TF32 off, Adam({OVERFIT_LR:g}), flow.hdf5): {steps} "
              f"steps in {fit_s:.1f} s ({fit_s / steps * 1e3:.1f} ms/step); "
              f"photometric {ph0:.5f} -> {ph1:.5f} ({ph1 / ph0:.3f}x, below "
              f"{OVERFIT_PH_MAX}x asked); mean |disp - GT| {dist0:.3f} -> "
              f"{dist1:.3f} px ({dist1 / dist0:.3f}x, below "
              f"{OVERFIT_DIST_MAX}x asked); kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        for name, per in PER_TRAIN_STEP.items():
            check(counts[name] == per * steps,
                  f"overfit: {counts[name]} launches of {name}, expected "
                  f"{per} x {steps}")
        check(ph1 < OVERFIT_PH_MAX * ph0,
              f"overfit: photometric {ph0} -> {ph1}")
        check(dist1 < OVERFIT_DIST_MAX * dist0,
              f"overfit: disparity error {dist0} -> {dist1}")
        del batch, bt
        torch.cuda.empty_cache()

        # -- 19d. train_val --data_type real --------------------------------
        args = ["--architecture", "single_frame", "--data_type", "real",
                "--epochs", "2", "--warmup_epochs", "1",
                "--train_batch_size", "4"]
        saved_cfg = config_mod.DEFAULT_CONFIG_PATH

        def run(out, *argv):
            cfg = Path(tmp) / f"{out.name}.json"
            cfg.write_text(json.dumps({"OUTPUT_DIR": str(out),
                                       "DATA_DIR": str(data)}))
            config_mod.DEFAULT_CONFIG_PATH = str(cfg)
            try:
                train_val.main(list(argv) + args, device=dev)
            finally:
                config_mod.DEFAULT_CONFIG_PATH = saved_cfg
                close_logs()
            return out / "single_frame"

        def epochs_of(exp) -> str:
            """s/epoch (train and test, from the log's clock) and the
            loader's wait against the steps, of the last training run."""
            log = (exp / "train.log").read_text().split("Start training")[-1]
            ms = {}
            for ln in log.splitlines():
                for key in ("Train epoch 0", "Train epoch 1",
                            "Finished training"):
                    if ln.endswith(key):
                        ms[key] = int(ln.split(":")[0])
            waits = [ln.split("timings: ")[-1] for ln in log.splitlines()
                     if "timings:" in ln]
            e0 = (ms["Train epoch 1"] - ms["Train epoch 0"]) / 1e3
            e1 = (ms["Finished training"] - ms["Train epoch 1"]) / 1e3
            return (f"{e0:.2f} and {e1:.2f} s/epoch; loader wait / steps: "
                    + "; ".join(waits))

        t0 = time.perf_counter()
        exp = run(Path(tmp) / "out_host", "--cmd", "retrain",
                  "--device_augment", "False")
        host_s = time.perf_counter() - t0
        m = json.loads((exp / "metrics.json").read_text())
        l0, l1 = m["0"]["train"]["loss"], m["1"]["train"]["loss"]
        tl0 = m["0"]["test"]["0"]["loss"]
        print(f"[plane] train_val --data_type real --device_augment False "
              f"(2 epochs, bs 4; 14 train, 2 test samples) {host_s:.1f} s: "
              f"{epochs_of(exp)}; train epoch 0 "
              f"{np.array2string(np.array(l0), precision=5)}, epoch 1 "
              f"{np.array2string(np.array(l1), precision=5)}")
        check(len(l0) == len(l1) == 10 and np.isfinite(l0 + l1).all(),
              f"real train components {l0} {l1}")
        check(all(v > 0 for v in l0[6:]), f"SGM terms off in epoch 0: {l0}")
        check(all(v == 0 for v in l1[6:]), f"SGM terms on in epoch 1: {l1}")
        check(len(tl0) == 6 and np.isfinite(tl0).all(),
              f"real test components {tl0}")
        got = {}
        for mode in ("exact", "device"):
            t0 = time.perf_counter()
            run(Path(tmp) / "out_host", "--cmd", "retest", "--epoch", "1",
                "--eval_metrics", mode, "--device_augment", "False")
            got[mode] = json.loads((exp / "metrics.json").read_text())[
                "1"]["test"]["0"]
            got[mode + " s"] = time.perf_counter() - t0
        ex, dv = got["exact"], got["device"]
        same = ("dist2_min", "dist2_max", "of0.1", "of0.5", "of1", "of2",
                "of5")
        print(f"[plane] retest of epoch 1, --eval_metrics exact "
              f"({got['exact s']:.1f} s) / device ({got['device s']:.1f} s): "
              + ", ".join(f"{k} {ex[k]:.6g} / {dv[k]:.6g}" for k in ex
                          if k != "loss"))
        check(all(dv[k] == ex[k] for k in same),
              "device metric differs from the exact: "
              + str({k: (dv[k], ex[k]) for k in same}))
        check(all(abs(dv[k] - ex[k]) <= 1e-6 * abs(ex[k])
                  for k in ("dist2_mean", "dist2_std")),
              "device metric's mean or std differs from the exact")
        check(all(abs(dv[k] - ex[k]) <= 1 / 256 + 1e-9 for k in
                  ("dist2_median", "dist2_q10", "dist2_q90")),
              "device metric's quantiles differ from the exact by more "
              "than 1/256 px")
        t0 = time.perf_counter()
        exp_d = run(Path(tmp) / "out_device", "--cmd", "retrain",
                    "--device_augment", "True")
        print(f"[plane] the same with --device_augment True "
              f"{time.perf_counter() - t0:.1f} s: {epochs_of(exp_d)}")
    print(f"[plane] phase 19 {time.perf_counter() - T0:.1f} s; {smi}")


# phase 20: samples of the port's create_syn_data, made on the card
# machine's host: GEN_N default ones in one process and again in GEN_PROCS
# processes over --start ranges, GEN_SMALL textured and real ones
GEN_N = 16
GEN_PROCS = 4
GEN_SMALL = 2
GEN_TIMEOUT_S = 300
# --textured: the median step of the ambient between covered horizontal
# neighbours, at least this and GEN_TEX_RATIO times the untextured one's
# (measured on a CPU at 512x432: 0.0059-0.0066 textured, 0-0.00027 not)
GEN_TEX_MIN = 2e-3
GEN_TEX_RATIO = 5.0
GEN_FIELDS = {"im": (4, 1, H, W), "ambient": (4, 1, H, W),
              "grad": (4, 1, H, W), "disp": (4, 1, H, W), "R": (4, 3, 3),
              "t": (4, 3)}


def generate(d: Path, ranges, *flags) -> tuple[float, list]:
    """create_syn_data as one process per (start, end) range, all started
    together; returns the wall seconds and each sample's seconds as the
    tool prints them. Every process is waited for or killed."""
    cmd = [sys.executable, "-m", "depthinspace_tpu_torch.tools.create_syn_data",
           *flags, "--objects", "procedural", "--data_dir", str(d)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--start", str(a), "--n_samples",
                                     str(b)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a, b in ranges]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GEN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"create_syn_data {flags} exited "
              f"{p.returncode}:\n{out[-3000:]}")
    took = [float(ln.split(" took ")[1].rstrip("s")) for out in outs
            for ln in out.splitlines() if ln.startswith("sample ")]
    check(len(took) == sum(b - a for a, b in ranges),
          f"create_syn_data {flags} wrote {len(took)} samples")
    return wall, took


def read_samples(d: Path) -> dict:
    from depthinspace_tpu_torch.data import hdf5
    out = {}
    for p in sorted(d.glob("0*")):
        with hdf5.File(p / "frames.hdf5") as f:
            out[p.name] = {k: np.asarray(f[k]) for k in f.keys()}
    return out


def check_fields(samples: dict, what: str, sgm: bool = False) -> str:
    """Shapes, dtypes and finiteness of every field; the covered share of
    each frame and the disparity range, as a line of text."""
    want = dict(GEN_FIELDS, **({"sgm_disp": (4, 1, H, W)} if sgm else {}))
    covered, lo, hi = [], np.inf, 0.0
    for name, fr in samples.items():
        check(sorted(fr) == sorted(want), f"{what} {name} fields {sorted(fr)}")
        for k, shape in want.items():
            check(fr[k].shape == shape and fr[k].dtype == np.float32
                  and np.isfinite(fr[k]).all(),
                  f"{what} {name} {k}: {fr[k].shape} {fr[k].dtype}")
        disp = fr["disp"][:, 0]
        covered += [float(np.mean(f > 0)) for f in disp]
        lo, hi = min(lo, float(disp[disp > 0].min())), max(hi,
                                                           float(disp.max()))
    check(min(covered) > 0.5, f"{what}: a frame covered {min(covered)}")
    return (f"covered share of a frame >= {min(covered):.4f}; disparity "
            f"{lo:.2f} .. {hi:.2f} px")


def ambient_texture(fr: dict) -> float:
    """Median |ambient step| between horizontal neighbours both covered."""
    amb, cov = fr["ambient"][:, 0], fr["disp"][:, 0] > 0
    both = cov[:, :, 1:] & cov[:, :, :-1]
    return float(np.median(np.abs(np.diff(amb, axis=2))[both]))


def generated_data_phase(dev, smi, then=None) -> None:
    """Phase 20: the port makes its own dataset on the card machine's host
    (tools/create_syn_data.py; the renderer built from native/render.cpp),
    and the port's CLI trains DIS-SF and DIS-MF on it on the card.
    ``then(data_dir, out_dir)`` runs last, on the 16 default samples (with
    flow.hdf5) and the CLI's output directory."""
    import os
    import torch
    import depthinspace_tpu_torch.config as config_mod
    from depthinspace_tpu_torch import train_val
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.render import renderer
    from depthinspace_tpu_torch.tools import presave_disp, presave_flow
    T0 = time.perf_counter()
    so, build_s = renderer.build()
    print(f"[gen] renderer built from {renderer.SOURCE.relative_to(ROOT)} in "
          f"{build_s:.2f} s ({' '.join(renderer.CXX_FLAGS)}): "
          f"{so.relative_to(ROOT)}; os.cpu_count() {os.cpu_count()}")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # -- 20a. the dataset, in one process and in GEN_PROCS --------------
        one = tmp / "one"
        wall1, took1 = generate(one, [(0, GEN_N)])
        print(f"[gen] {GEN_N} default samples {H}x{W}, one process: "
              f"{wall1:.1f} s ({np.median(took1):.3f} s a sample, median; "
              f"set-up {wall1 - sum(took1):.1f} s); host figures; {smi}")
        many = tmp / "many"
        step = GEN_N // GEN_PROCS
        wall4, took4 = generate(many, [(i, i + step)
                                       for i in range(0, GEN_N, step)])
        print(f"[gen] {GEN_N} default samples, {GEN_PROCS} processes over "
              f"--start ranges: {wall4:.1f} s, {GEN_N / wall4:.3f} samples/s "
              f"aggregate ({np.median(took4):.3f} s a sample, median; one "
              f"process {GEN_N / wall1:.3f} samples/s); host figures")
        files = sorted(p.relative_to(one) for p in one.rglob("*")
                       if p.is_file())
        check(len(files) == GEN_N + 1 and files == sorted(
            p.relative_to(many) for p in many.rglob("*") if p.is_file())
            and all((one / f).read_bytes() == (many / f).read_bytes()
                    for f in files),
              "the processes' samples differ from the one process's")
        samples = read_samples(one)
        digest = hashlib.sha256((one / "00000000" / "frames.hdf5")
                                .read_bytes()).hexdigest()
        print(f"[gen] {GEN_PROCS} processes wrote the one process's bytes; "
              f"{check_fields(samples, 'default')}; sample 0's frames.hdf5 "
              f"sha256 {digest}")
        tex_dir = tmp / "textured"
        wall_t, _ = generate(tex_dir, [(0, GEN_SMALL)], "--textured")
        tex = [ambient_texture(fr) for fr in read_samples(tex_dir).values()]
        flat = [ambient_texture(samples[f"{i:08d}"]) for i in range(GEN_SMALL)]
        print(f"[gen] {GEN_SMALL} --textured samples {wall_t:.1f} s; ambient "
              f"step over covered neighbours (median): textured "
              f"{', '.join(f'{v:.5f}' for v in tex)}, untextured "
              f"{', '.join(f'{v:.5f}' for v in flat)}")
        check(min(tex) >= GEN_TEX_MIN and min(tex) > GEN_TEX_RATIO * max(flat),
              f"--textured ambient carries no texture: {tex} vs {flat}")
        real = tmp / "real"
        wall_r, took_r = generate(real, [(0, GEN_SMALL)], "real")
        print(f"[gen] {GEN_SMALL} real samples (1280x1080 renders "
              f"post-processed to {H}x{W}): {wall_r:.1f} s, "
              f"{np.median(took_r):.3f} s a sample; "
              f"{check_fields(read_samples(real), 'real', sgm=True)}")

        # -- 20b. the port's CLI trains on the samples ----------------------
        out = tmp / "out"
        saved_cfg = config_mod.DEFAULT_CONFIG_PATH
        cfg = tmp / "config.json"
        cfg.write_text(json.dumps({"OUTPUT_DIR": str(out),
                                   "DATA_DIR": str(one)}))
        stage_s = {}

        def stage(name, fn, reach=()):
            kernels.reset_launches()
            config_mod.DEFAULT_CONFIG_PATH = str(cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                config_mod.DEFAULT_CONFIG_PATH = saved_cfg
                close_logs()
            stage_s[name] = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.launches.items() if v}
            print(f"[gen] {name}: {stage_s[name]:.2f} s; kernel launches "
                  f"{counts}")
            for k in reach:
                check(counts.get(k, 0) > 0, f"{k} never launched in {name}")

        steps = ["--epochs", "1", "--train_batch_size", "4",
                 "--max_train_iter", "3"]
        stage("presave_flow rigid", lambda: presave_flow.main(
            ["--provider", "rigid", "--data_dir", str(one)]))
        stage("train_val single_frame", lambda: train_val.main(
            ["--architecture", "single_frame", "--cmd", "retrain", *steps],
            device=dev), K1_K3)
        stage("train_val single_frame retest", lambda: train_val.main(
            ["--architecture", "single_frame", "--cmd", "retest",
             "--epoch", "0"], device=dev))
        stage("presave_disp single_frame", lambda: presave_disp.main(
            ["single_frame", "--epoch", "0", "--data_dir", str(one),
             "--output_dir", str(out)], device=dev))
        stage("train_val multi_frame", lambda: train_val.main(
            ["--architecture", "multi_frame", "--cmd", "retrain",
             "--mf_dtype", "bfloat16", *steps], device=dev), K1_K4)
        stage("train_val multi_frame retest", lambda: train_val.main(
            ["--architecture", "multi_frame", "--cmd", "retest",
             "--epoch", "0"], device=dev))
        for arch, n_comps in (("single_frame", 6), ("multi_frame", 3)):
            m = json.loads((out / arch / "metrics.json").read_text())["0"]
            loss, test = m["train"]["loss"], m["test"]["0"]
            check(np.isfinite(loss).all() and len(test["loss"]) == n_comps
                  and np.isfinite(test["loss"]).all(),
                  f"{arch} metrics {m}")
            print(f"[gen] {arch} on generated data: train components "
                  f"{np.array2string(np.array(loss), precision=5)}; retest "
                  f"of epoch 0: loss {sum(test['loss']):.5f}, dist2_mean "
                  f"{test['dist2_mean']:.3f} px, of1 {test['of1']:.4f}")
        print(f"[gen] phase 20 {time.perf_counter() - T0:.1f} s (generation "
              f"{wall1 + wall4 + wall_t + wall_r:.1f} s, CLI "
              f"{sum(stage_s.values()):.1f} s); {smi}")
        if then is not None:
            then(one, out)

ORBAX_FIXTURE = ROOT / "tests" / "data" / "orbax_fixture"


def fixture_crcs(model, state) -> dict:
    """{leaf: CRC-32} of a FuseNet's weights and its Adam moments in the
    flax layout, named as the fixture's expected.npz names them."""
    import zlib
    from depthinspace_tpu_torch.models import flax_tree_from_fusenet_state_dict

    def flat(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield ".".join(prefix + (k,)), v

    names = [n for n, _ in model.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    out = {}
    for key, sd in (("params", model.state_dict()),
                    ("mu", {n: opt[i]["exp_avg"] for i, n in
                            enumerate(names)}),
                    ("nu", {n: opt[i]["exp_avg_sq"] for i, n in
                            enumerate(names)})):
        for k, a in flat(flax_tree_from_fusenet_state_dict(sd), (key,)):
            out[k] = zlib.crc32(np.ascontiguousarray(a).tobytes())
    return out


def orbax_resume_phase(dev, smi, data: Path) -> None:
    """Phase 22: a DIS-MF run that the JAX package started, continued on
    the card from its orbax state (the committed fixture), on phase 20's
    samples."""
    import shutil
    import torch
    from depthinspace_tpu_torch import config as config_mod
    from depthinspace_tpu_torch import train_val
    from depthinspace_tpu_torch.data import load_settings
    from depthinspace_tpu_torch.models import FuseNet
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.train import TrainState
    from depthinspace_tpu_torch.train.checkpoint import (StateCheckpointer,
                                                         load_net_params)
    from depthinspace_tpu_torch.utils import zstd
    from depthinspace_tpu_torch.utils.ocdbt import OcdbtStore
    T0 = time.perf_counter()
    # -- 22a. the decoder, built here from its source -------------------
    so, build_s = zstd.build()
    store = OcdbtStore(ORBAX_FIXTURE / "multi_frame" / "state" / "0" /
                       "state")
    frames = [store.read(k) for k in store.keys()
              if not k.endswith(".zarray")]
    zstd.decompress(frames[0])
    reps = 20
    t0 = time.perf_counter()
    out_bytes = sum(zstd.decompress(f).size for _ in range(reps)
                    for f in frames)
    dec_s = time.perf_counter() - t0
    in_bytes = reps * sum(len(f) for f in frames)
    big = max(frames, key=len)
    t0 = time.perf_counter()
    big_out = sum(zstd.decompress(big).size for _ in range(reps))
    big_s = time.perf_counter() - t0
    print(f"[orbax] zstd decoder {so.relative_to(ROOT)} built with g++ in "
          f"{build_s:.2f} s; {len(frames)} zarr chunks of the fixture "
          f"decoded {reps} times: {out_bytes / dec_s / 1e6:.1f} MB/s of "
          f"output ({in_bytes / dec_s / 1e6:.1f} MB/s of input, "
          f"{out_bytes // reps} bytes a pass); its largest chunk ({len(big)} "
          f"bytes to {big_out // reps}) {reps} times: "
          f"{big_out / big_s / 1e6:.1f} MB/s of output; on the host, "
          f"{os.cpu_count()} cores")

    # -- 22b. restore into FuseNet on the card, checked bit for bit -----
    settings = load_settings(data / "settings.pkl")
    want = np.load(ORBAX_FIXTURE / "expected.npz")
    exp_fixture = ORBAX_FIXTURE / "multi_frame"

    def fresh_state():
        model = FuseNet(tuple(settings.imsize), settings.K, TL,
                        block_num=1)
        return model, TrainState.create(model, 1e-4, device=dev)

    model, state = fresh_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, epoch, min_err = StateCheckpointer(exp_fixture).restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    net = load_net_params(exp_fixture / "net_0000.params", model)
    params_equal = all(torch.equal(net[k], v.cpu())
                       for k, v in model.state_dict().items())
    got = fixture_crcs(model, state)
    expected = dict(zip(want["names"].tolist(), want["crc32"].tolist()))
    bad = sorted(k for k in expected if got.get(k) != expected[k])
    count = float(state.optimizer.state_dict()["state"][0]["step"])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[orbax] restore of the JAX DIS-MF state (FuseNet 1 x 32, "
          f"{n_params} parameters, Adam's moments and count) into the card: "
          f"{restore_s:.3f} s; epoch {epoch}, min_err {min_err}, step "
          f"{state.step}, count {count:g}; weights equal net_0000.params "
          f"bit for bit: {params_equal}; {len(expected) - len(bad)} of "
          f"{len(expected)} leaves (weights, mu, nu) equal expected.npz")
    check(params_equal, "restored weights differ from net_0000.params")
    check(not bad and set(got) == set(expected),
          f"restored leaves differ from expected.npz: {bad[:5]}")
    check(epoch == 0 and state.step == int(want["step"])
          and count == float(want["count"]),
          f"restored epoch {epoch}, step {state.step}, count {count}")

    # -- 22c. train_val --cmd resume on the card --------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        out = tmp / "out"
        exp = out / "multi_frame"
        shutil.copytree(exp_fixture, exp)
        cfg = tmp / "config.json"
        cfg.write_text(json.dumps({"OUTPUT_DIR": str(out),
                                   "DATA_DIR": str(data)}))
        saved_cfg = config_mod.DEFAULT_CONFIG_PATH
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            config_mod.DEFAULT_CONFIG_PATH = str(cfg)
            train_val.main(["--architecture", "multi_frame", "--cmd",
                            "resume", "--mf_dtype",
                            "bfloat16", "--epochs", "2",
                            "--train_batch_size", "4", "--max_train_iter",
                            "3"], device=dev)
            torch.cuda.synchronize()
        finally:
            config_mod.DEFAULT_CONFIG_PATH = saved_cfg
            close_logs()
        resume_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launches.items() if v}
        metrics = json.loads((exp / "metrics.json").read_text())
        loss = metrics.get("1", {}).get("train", {}).get("loss", [])
        log = (exp / "train.log").read_text()
        _, again = fresh_state()
        back = StateCheckpointer(exp).restore(again)
        print(f"[orbax] train_val --cmd resume (multi_frame, bf16, bs 4, 3 "
              f"steps) on phase 20's samples: {resume_s:.1f} s; epochs in "
              f"metrics.json {sorted(metrics)}; epoch 1 train components "
              f"{np.array2string(np.array(loss), precision=5)}; kernel "
              f"launches {counts}; state/ holds "
              f"{sorted(p.name for p in (exp / 'state').iterdir())}; "
              f"state/1/state.pt restores to epoch "
              f"{None if back is None else back[1]}")
        check("Resumed from epoch 0" in log, "the resume did not start at "
              "epoch 1")
        check("FuseNet with 1 fusion blocks, as the saved state" in log,
              "the resume did not take the saved state's block count")
        check(sorted(metrics) == ["0", "1"] and len(loss) == 4
              and np.isfinite(loss).all(), f"metrics after resume {metrics}")
        for k in K1_K4:
            check(counts.get(k, 0) > 0, f"{k} never launched in the resume")
        check((exp / "state" / "0" / "_CHECKPOINT_METADATA").is_file(),
              "the JAX epoch was removed")
        check(back is not None and back[1] == 1
              and (exp / "state" / "1" / "state.pt").is_file(),
              "the port's state/1/state.pt does not restore")
    print(f"[orbax] phase 22 {time.perf_counter() - T0:.1f} s; {smi}")


FB_SAMPLES = ("00000000", "00000001")
# the card's flow against the CPU's: the tests' tolerance against cv2 (one
# input gives one flow on a device; a 2x2 system near singular turns an ulp
# of the filters' sums into a large step, so the tail is bounded, not 0)
FB_MEAN_TOL, FB_P999_TOL = 1e-3, 5e-2
FB_TIMED = 5


def epe(a, b) -> float:
    """Mean endpoint error of (..., 2, H, W) flows."""
    return float(np.linalg.norm(a - b, axis=-3).mean())


def farneback_phase(dev, smi, data: Path) -> None:
    """Phase 23: presave_flow --provider farneback on the card on 2 of phase
    20's samples, held to the CPU; its EPE beside FlowNet's and zero flow's;
    one DIS-MF train step on its flow files."""
    import shutil
    import torch
    import depthinspace_tpu_torch.config as config_mod
    from depthinspace_tpu_torch import train_val
    from depthinspace_tpu_torch.data import hdf5
    from depthinspace_tpu_torch.models import flow_all_pairs
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.tools import presave_flow
    from depthinspace_tpu_torch.tools.train_flow import load_flow_params
    T0 = time.perf_counter()
    def read(path):
        with hdf5.File(path) as f:
            return {k: np.array(f[k]) for k in f.keys()}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        fb = tmp / "data"
        fb.mkdir()
        shutil.copy(data / "settings.pkl", fb)
        for name in FB_SAMPLES:
            (fb / name).mkdir()
            for f in ("frames.hdf5", "single_frame_disp.hdf5"):
                shutil.copy(data / name / f, fb / name)
        t0 = time.perf_counter()
        presave_flow.main(["--provider", "farneback", "--data_dir", str(fb)])
        torch.cuda.synchronize()
        presave_s = time.perf_counter() - t0
        fnet = load_flow_params(FLOWNET)[0].to(dev).eval()
        stats = {"fb": [], "learned": [], "zero": []}
        diffs = []
        for name in FB_SAMPLES:
            got = read(fb / name / "flow.hdf5")
            rigid = read(data / name / "flow.hdf5")
            frames = read(fb / name / "frames.hdf5")
            amb = frames["ambient"][:, 0]
            pairs = sorted(got)
            check(pairs == sorted(rigid) and len(pairs) == 12
                  and all(got[k].shape == (1, 2, H, W)
                          and got[k].dtype == np.float32 for k in pairs),
                  f"flow.hdf5 of {name}: {[(k, got[k].shape) for k in got]}")
            src = [int(k[5]) for k in pairs]
            dst = [int(k[6]) for k in pairs]
            cpu = presave_flow.farneback_pairs(amb, src, dst, "cpu")
            card = np.concatenate([got[k] for k in pairs])
            diffs.append(np.abs(card - cpu).ravel())
            gt = np.concatenate([rigid[k] for k in pairs])
            with torch.inference_mode():
                to = lambda a: torch.from_numpy(a[:, None]).to(dev)
                im = frames["im"][:, 0] if fnet.in_channels == 2 else None
                lf = flow_all_pairs(fnet, None if im is None else to(im),
                                    to(amb))
            lf = lf[:, :, 0].permute(0, 1, 4, 2, 3).cpu().numpy()
            learned = np.stack([lf[i, j] for i, j in zip(src, dst)])
            stats["fb"].append(epe(card, gt))
            stats["learned"].append(epe(learned, gt))
            stats["zero"].append(epe(0 * gt, gt))
        d = np.concatenate(diffs)
        mean_d, p999 = float(d.mean()), float(np.quantile(d, 0.999))
        print(f"[farneback] presave_flow --provider farneback on "
              f"{len(FB_SAMPLES)} samples {H}x{W} (3 pyramid levels): "
              f"{presave_s:.2f} s with the HDF5 I/O; card vs CPU over "
              f"{len(FB_SAMPLES) * 12} pairs: mean |d| {mean_d:.3g} px, "
              f"99.9th percentile {p999:.3g}, max {d.max():.3g}, equal "
              f"{np.mean(d == 0):.4f} of the values (tolerance "
              f"{FB_MEAN_TOL:g} / {FB_P999_TOL:g})")
        check(mean_d <= FB_MEAN_TOL and p999 <= FB_P999_TOL,
              f"farneback card vs CPU: mean {mean_d}, 99.9th pct {p999}")
        print(f"[farneback] EPE to the rigid flow (mean over the samples' 12 "
              f"pairs): farneback {np.mean(stats['fb']):.3f} px, learned "
              f"(FlowNet) {np.mean(stats['learned']):.3f} px, zero flow "
              f"{np.mean(stats['zero']):.3f} px; per sample farneback "
              f"{', '.join(f'{v:.3f}' for v in stats['fb'])}")
        check(all(np.isfinite(v) for v in stats["fb"]), f"EPE {stats}")
        # the device time of one sample's 12 pairs (frames on the card)
        u8 = torch.from_numpy(presave_flow._to_u8(amb)).to(dev)
        call = lambda: presave_flow.farneback(u8, src, dst)
        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(FB_TIMED):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"[farneback] a sample's 12 pairs on the card: "
              f"{np.median(times):.2f} ms (median of {FB_TIMED}, host clock "
              f"to synchronize; {min(times):.2f}-{max(times):.2f}); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB since the start; {smi}")
        # one DIS-MF train step on the farneback flow files
        out = tmp / "out"
        cfg = tmp / "config.json"
        cfg.write_text(json.dumps({"OUTPUT_DIR": str(out),
                                   "DATA_DIR": str(fb)}))
        saved_cfg = config_mod.DEFAULT_CONFIG_PATH
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            config_mod.DEFAULT_CONFIG_PATH = str(cfg)
            train_val.main(["--architecture", "multi_frame", "--cmd",
                            "retrain", "--flow_source", "file",
                            "--mf_dtype", "bfloat16", "--epochs", "1",
                            "--train_batch_size", "1", "--max_train_iter",
                            "1"], device=dev)
            torch.cuda.synchronize()
        finally:
            config_mod.DEFAULT_CONFIG_PATH = saved_cfg
            close_logs()
        step_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launches.items() if v}
        m = json.loads((out / "multi_frame" / "metrics.json").read_text())
        loss = m["0"]["train"]["loss"]
        print(f"[farneback] train_val multi_frame --flow_source file on the "
              f"farneback flow.hdf5 (bf16, bs 1, 1 step, a 1-sample test): "
              f"{step_s:.1f} s; train components "
              f"{np.array2string(np.array(loss), precision=5)}; kernel "
              f"launches {counts}")
        check(len(loss) == 4 and np.isfinite(loss).all(),
              f"MF metrics on farneback flow {m}")
        for k in K1_K4:
            check(counts.get(k, 0) > 0, f"{k} never launched in the MF step "
                  "on farneback flow")
    print(f"[farneback] phase 23 {time.perf_counter() - T0:.1f} s; {smi}")


FLOWNET = ROOT / "output" / "flownet.msgpack"
FLOW_CROP = (256, 224)                    # train_flow's default crop


def conv_flops(net, *args) -> float:
    """The FLOPs (2 per multiply-add) of every convolution of one
    ``net(*args)`` call, counted from the shapes by forward hooks."""
    import torch
    total = [0.0]

    def hook(mod, _, out):
        total[0] += 2.0 * mod.weight[0].numel() * out.numel()
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            net(*args)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def learned_flow_phase(settings, dev, smi, sf_model, sf_np, mf_np, data,
                       out) -> None:
    """Phase 18: the learned flow provider (output/flownet.msgpack, loaded
    by the port): FlowNet on the card against the CPU; its forward for a
    4-track bucket (48 pairs) with the encoder's and the correlation's
    share; TrackDisparityServer without flow; the SF and MF train steps
    with --flow_source net; presave_flow --provider learned and presave_disp
    multi_frame --flow_source net on phase 17's samples (``data``, ``out``);
    20 train_flow steps at crop 256x224."""
    import contextlib
    import io
    import torch
    from depthinspace_tpu_torch.data import batch_to_torch
    from depthinspace_tpu_torch.models import (FuseNet, flow_all_pairs,
                                               init_fusenet_)
    from depthinspace_tpu_torch.models.flownet import _correlation_nchw
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.serve import (TrackDisparityServer,
                                              lcn_input, mf_forward,
                                              sf_forward)
    from depthinspace_tpu_torch.data.wire import (decode_field, encode_unit,
                                                  to_u16_disp)
    from depthinspace_tpu_torch.tools import (presave_disp, presave_flow,
                                              train_flow)
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_mf_train_step,
                                              make_sf_train_step)
    T0 = time.perf_counter()
    net_cpu, ch = train_flow.load_flow_params(FLOWNET)
    net = copy.deepcopy(net_cpu).to(dev)
    check(ch == 2, f"flownet.msgpack has {ch} input channels, expected 2")

    # -- 18a. FlowNet card vs CPU at 512x432, 2 pairs -----------------------
    x = np.stack([mf_np.ambient, mf_np.im], -1)           # (tl, n, H, W, 2)
    a, b = x[0, :2], x[1, :2]
    with torch.inference_mode():
        card_out = [f.cpu() for f in net(torch.from_numpy(a).to(dev),
                                         torch.from_numpy(b).to(dev))]
        t0 = time.perf_counter()
        cpu_out = net_cpu(torch.from_numpy(a), torch.from_numpy(b))
        cpu_s = time.perf_counter() - t0
    errs = [float((c - r).abs().max()) for c, r in zip(card_out, cpu_out)]
    print(f"[flownet] card vs CPU, 2 pairs {H}x{W}, output/flownet.msgpack: "
          f"max |diff| by level (1/16, 1/8, 1/4, 1) "
          f"{', '.join(f'{e:.3g}' for e in errs)} px; largest |flow| "
          f"{float(cpu_out[-1].abs().max()):.3f} px; cpu forward {cpu_s:.1f} "
          f"s; TF32 off")
    # float32 convolutions summed in other orders (the port's CPU forward
    # is held to JAX within 1e-3 px; tests/test_torch_flownet.py)
    check(max(errs) <= 1e-3, f"FlowNet card vs CPU differs: {errs} px")

    # -- 18b. FlowNet forward on a 4-track bucket (48 pairs) ----------------
    im_d = torch.as_tensor(mf_np.im, device=dev)            # (tl, 4, H, W)
    amb_d = torch.as_tensor(mf_np.ambient, device=dev)
    fwd_ms = cuda_ms(lambda: flow_all_pairs(net, im_d, amb_d), reps=5,
                     warmup=1)
    frames = torch.stack([amb_d, im_d], -1).reshape(TL * MF_TRACKS, H, W, 2)
    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: net.encode(frames), reps=5, warmup=1)
        feats = net.encode(frames)
        pl = [(i, j) for i in range(TL) for j in range(TL) if i != j]
        src = [i * MF_TRACKS + k for i, _ in pl for k in range(MF_TRACKS)]
        dst = [j * MF_TRACKS + k for _, j in pl for k in range(MF_TRACKS)]
        pairs = [(f[src], f[dst]) for f in feats[1:]]   # 1/4, 1/8, 1/16
        corr_ms = [cuda_ms(lambda p=p: _correlation_nchw(*p, 4), reps=5,
                           warmup=1) for p in pairs]
    n_pairs = TL * (TL - 1) * MF_TRACKS
    flops = conv_flops(net, torch.from_numpy(a[:1]).to(dev),
                       torch.from_numpy(b[:1]).to(dev))
    enc_flops = conv_flops(net.encoder, frames[:1].permute(0, 3, 1, 2))
    bucket_flops = (flops - 2 * enc_flops) * n_pairs + enc_flops * TL * \
        MF_TRACKS
    bnd, by = bound_ms(0.0, bucket_flops)
    print(f"[flownet] flow_all_pairs, 4-track bucket ({n_pairs} pairs, "
          f"{TL * MF_TRACKS} frames encoded once) {H}x{W} f32: {fwd_ms:.2f} "
          f"ms (median of 5); encoder {enc_ms:.2f} ms ({enc_ms / fwd_ms:.1%}"
          f"); correlation at 1/4, 1/8, 1/16 "
          f"{', '.join(f'{c:.2f}' for c in corr_ms)} ms, together "
          f"{sum(corr_ms):.2f} ms ({sum(corr_ms) / fwd_ms:.1%}); "
          f"convolutions {bucket_flops / 1e9:.1f} GFLOP ({flops / 1e9:.2f} a "
          f"pair alone), f32 bound {bnd:.2f} ms ({by}); {smi}")
    del feats, pairs

    # -- 18c. TrackDisparityServer without flow ----------------------------
    mf16 = init_fusenet_(FuseNet((H, W), settings.K, TL,
                                 compute_dtype=torch.bfloat16),
                         _jkey(SEED + 4))
    srv = TrackDisparityServer(sf_model, mf16, net, imsize=(H, W),
                               K=settings.K, max_tracks=MF_TRACKS, device=dev)
    mv = lambda v: np.ascontiguousarray(np.moveaxis(v, 1, 0))
    req = (mv(mf_np.im), mv(mf_np.ambient), mv(mf_np.R), mv(mf_np.t))
    flow_req = np.ascontiguousarray(np.moveaxis(mf_np.flow, 2, 0))
    got3 = srv.infer(*(v[:3] for v in req))
    check(got3.shape == (3, TL, H, W) and np.isfinite(got3).all()
          and got3.min() >= 0 and got3.max() <= 128,
          f"serve with learned flow: {got3.shape}, {got3.min()} .. "
          f"{got3.max()}")
    kernels.reset_launches()
    got = srv.infer(*req)
    per_bucket = {k: v for k, v in kernels.launches.items() if v}
    check(per_bucket == {"warp2d_fwd": 1, "warp2d_pairs_fwd": 8},
          f"serve with learned flow: launches {per_bucket}")
    # one request, one answer: on cuDNN's default algorithms DispNet's
    # transposed convolutions may sum in another order each call, and
    # FuseNet turns the primary's ulps into other neighbour choices; the
    # server runs on the deterministic ones (the deterministic mode)
    check(np.array_equal(srv.infer(*req), got),
          "serve with learned flow: the same request served twice differs")
    diff = default_algorithms_diff(lambda: srv.infer(*req))
    print(f"[flow serve] the same 4-track request twice: equal; on the "
          f"default cuDNN algorithms {diff}")
    # and equal to its composition, bit for bit, on the same algorithms
    with torch.inference_mode():
        # the server's arrays, strides included (a strided input can make
        # cuDNN pick another algorithm, and FuseNet turns ulps into choices)
        to = lambda v: torch.from_numpy(v).to(dev)
        im_w = decode_field("im", to(encode_unit(np.moveaxis(req[0], 0, 1))))
        amb_w = decode_field("ambient",
                             to(encode_unit(np.moveaxis(req[1], 0, 1))))
        ir = lcn_input(im_w)
        ref = mf_forward(mf16, ir, amb_w, sf_forward(sf_model, ir),
                         to(mf_np.R), to(mf_np.t),
                         flow_all_pairs(net, im_w, amb_w), srv.focal,
                         srv.baseline)
        ref = to_u16_disp(ref).cpu().numpy().astype(np.int64)
    dd = np.abs(np.rint(np.moveaxis(got, 0, 1) * 256).astype(np.int64) - ref)
    print(f"[flow serve] infer(flow=None) vs mf_forward on flow_all_pairs' "
          f"flow, deterministic cuDNN: max {dd.max()} u16 units, unequal on "
          f"{np.mean(dd > 0):.6f}; launches a bucket {per_bucket}")
    check(dd.max() == 0,
          f"serve with learned flow differs from its composition: {dd.max()}")
    rates = {}
    for label, extra in (("learned flow", ()), ("caller flow", (flow_req,))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            srv.infer(*(v[:3] for v in req + extra))
        r3 = 3 * 5 / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(5):
            srv.infer(*(req + extra))
        s4 = (time.perf_counter() - t0) / 5
        rates[label] = (r3, MF_TRACKS / s4, s4 * 1e3)
    print("[flow serve] " + "; ".join(
        f"{k}: {r3:.2f} tracks/s on 3-track requests, {r4:.2f} on "
        f"{MF_TRACKS}-track ({ms:.1f} ms each)" for k, (r3, r4, ms)
        in rates.items()) + f"; FuseNet bf16, DispNet and FlowNet f32; {smi}")
    full = serve_rates(lambda: srv.infer(*req), MF_TRACKS, reps=3)
    print(f"[flow serve] learned flow, {MF_TRACKS}-track requests: "
          f"{full['deterministic']:.2f} tracks/s on the deterministic "
          f"algorithms, {full['default']:.2f} on the default ones (before "
          f"the repair); {smi}")
    del srv, mf16
    torch.cuda.empty_cache()

    # -- 18d. SF and MF train steps with --flow_source net ------------------
    ctx = make_loss_context(settings, TL, device=dev, flow_source="net",
                            flow_net=net)
    for arch, np_batch, per_step in (("single_frame", sf_np, PER_TRAIN_STEP),
                                     ("multi_frame", mf_np, PER_MF_STEP)):
        if arch == "single_frame":
            from depthinspace_tpu_torch.models import DispNet, init_dispnet_
            m = _dispnet(_jkey(SEED))
            make = make_sf_train_step
        else:
            m = init_fusenet_(FuseNet((H, W), settings.K, TL,
                                      compute_dtype=torch.bfloat16),
                              _jkey(SEED + 5))
            make = make_mf_train_step
        state = TrainState.create(m, 1e-4, seed=SEED, device=dev)
        step = make(m, ctx, state)
        batch = batch_to_torch(np_batch._replace(flow=None), dev)
        kernels.reset_launches()
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comps = step(batch).cpu().numpy()
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(comps).all(),
                  f"{arch} train with net flow: components {comps}")
        counts = {k: v for k, v in kernels.launches.items() if v}
        want = {k: 6 * v for k, v in per_step.items() if v}
        check(counts == want, f"{arch} train with net flow: launches "
              f"{counts}, expected {want}")
        bs = np_batch.im.shape[1]
        print(f"[flow train] {arch} step, --flow_source net ({bs} tracks x "
              f"{TL} frames, {TL * (TL - 1) * bs} FlowNet pairs a step, "
              f"{'f32' if arch == 'single_frame' else 'bf16'}): "
              f"{np.median(times[1:]):.1f} ms/step (median of 5 after a "
              f"warm step; min {min(times[1:]):.1f}, max "
              f"{max(times[1:]):.1f}); launches as with file flow "
              f"({per_step} a step); components "
              f"{np.array2string(comps, precision=5)}; {smi}")
        del state, step, m, batch
        torch.cuda.empty_cache()

    # -- 18e. the tools on phase 17's samples --------------------------------
    def tool(label, fn):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launches.items() if v}
        print(f"[flow tools] {label}: {time.perf_counter() - t0:.2f} s; "
              f"kernel launches {counts}")
        return counts

    tool("presave_flow --provider learned (8 samples, 12 pairs each)",
         lambda: presave_flow.main(["--provider", "learned", "--data_dir",
                                    str(data), "--flow_params",
                                    str(FLOWNET)], device=dev))
    from depthinspace_tpu_torch.data import hdf5
    for sample in sorted(data.glob("0*")):
        with hdf5.File(sample / "flow.hdf5") as f:
            check(len(f) == 12 and all(
                f[k].shape == (1, 2, H, W) and f[k].dtype == np.float32
                and np.isfinite(f[k]).all() for k in f.keys()),
                f"learned flow.hdf5 of {sample.name}")
    mp = tool("presave_disp multi_frame --flow_source net (2 batches of 4)",
              lambda: presave_disp.main(
                  ["multi_frame", "--epoch", "0", "--flow_source", "net",
                   "--flow_params", str(FLOWNET), "--data_dir", str(data),
                   "--output_dir", str(out)], device=dev))
    check(mp == {"warp2d_fwd": 2, "warp2d_pairs_fwd": 16},
          f"presave_disp net: launches {mp}")
    for sample in sorted(data.glob("0*")):
        with hdf5.File(sample / "multi_frame_disp.hdf5") as f:
            got = np.asarray(f["disp"])
        check(got.shape == (4, 1, H, W) and np.isfinite(got).all()
              and got.min() >= 0 and got.max() <= 128,
              f"multi_frame_disp.hdf5 (net flow) of {sample.name}")

    # -- 18f. train_flow: 20 steps at crop 256x224 ---------------------------
    flow_out = out / "flownet_trained.msgpack"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        train_flow.main(["--data_dir", str(data), "--out", str(flow_out),
                         "--steps", "20", "--batch_size", "8", "--crop",
                         *map(str, FLOW_CROP),
                         "--val_samples", "2", "--pool_size", "48",
                         "--report_every", "1", "--val_every", "0",
                         "--pool_cache", str(out / "pool.npz")], device=dev)
    main_s = time.perf_counter() - t0
    lines = log.getvalue().splitlines()
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines
              if ln.startswith("step")]
    check(len(losses) == 20 and np.isfinite(losses).all(),
          f"train_flow losses {losses}")
    reloaded, rch = train_flow.load_flow_params(flow_out)
    with torch.inference_mode():
        fl = reloaded.to(dev)(torch.from_numpy(a[:1]).to(dev),
                              torch.from_numpy(b[:1]).to(dev))[-1]
    check(rch == 2 and bool(torch.isfinite(fl).all()),
          "the saved FlowNet does not reload")
    pool = np.load(out / "pool.npz")
    pool = train_flow.PairPool.from_arrays(pool["a"], pool["b"], pool["gt"])
    tnet = copy.deepcopy(net_cpu).to(dev)
    step = train_flow.make_train_step(tnet, 2e-4, 40)
    rng = np.random.RandomState(0)
    batches = [tuple(torch.from_numpy(v).to(dev) for v in
                     pool.batch(rng, 8, FLOW_CROP)) for _ in range(21)]
    step(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for bt in batches[1:]:
        loss, _ = step(*bt)
    torch.cuda.synchronize()
    per_s = 20 / (time.perf_counter() - t0)
    check(bool(torch.isfinite(loss)), f"train_flow step loss {loss}")
    print(f"[train_flow] main: 20 steps, bs 8, crop {FLOW_CROP[0]}x"
          f"{FLOW_CROP[1]}, pool of "
          f"{len(pool.a)} pairs: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{[ln for ln in lines if ln.startswith('val EPE')][-1]}; "
          f"{main_s:.1f} s with the pool and validation; the saved file "
          f"reloads; step alone {per_s:.2f} steps/s (20 steps, host-to-"
          f"device copies done ahead); {smi}")
    print(f"[flow] phase 18 {time.perf_counter() - T0:.1f} s; {smi}")


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two float32
    or bfloat16 tensors (as ordered integers)."""
    import torch
    itype = torch.int32 if a.dtype == torch.float32 else torch.int16

    def ordered(x):
        i = x.contiguous().view(itype).to(torch.int64)
        return torch.where(i < 0, -(i & (2 ** (8 * x.element_size() - 1) - 1)),
                           i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def threefry_phase(dev, smi, results) -> None:
    """Phase 24 (run after phase 3): csrc/threefry.cu against its plain
    version (utils/jrandom.py) on the card, at the SF train step's draws
    (tl = 4, bs = 8, 512x432: 32 frames); the card's DispNet init from
    key(42) against the CPU's; the step's draws timed."""
    import torch
    from depthinspace_tpu_torch.models import DispNet, init_dispnet_
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.utils import jrandom

    n = TL * TRAIN_BS
    plane, pair = (n, H, W), (2, n, H, W)
    k = jrandom.key(SEED + 24)
    count = n * H * W
    kb = kernels.threefry_draw(k, plane, "bits", device=dev, run=count)
    pb = jrandom.bits(k, plane, device=dev)
    check(torch.equal(kb.to(torch.int64) & 0xFFFFFFFF, pb),
          "threefry bits differ from the plain version's")
    worst, err = 0, 0.0
    cases = [("uniform", torch.float32, 0.0, 1.0, pair),
             ("uniform", torch.float32, 0.2, 0.5, (n, 1, 1)),
             ("normal", torch.float32, 0.0, 1.0, plane),
             ("normal", torch.bfloat16, 0.0, 1.0, plane),
             ("uniform", torch.bfloat16, 0.0, 3.0, plane)]
    for transform, dtype, lo, hi, shape in cases:
        got = jrandom.draw(k, shape, transform, dtype, lo, hi, device=dev)
        plain = (jrandom.uniform(k, shape, dtype, lo, hi, device=dev)
                 if transform == "uniform"
                 else jrandom.normal(k, shape, dtype, device=dev))
        u = _ulps(got, plain)
        worst = max(worst, u)
        err = max(err, float((got.float() - plain.float()).abs().max()))
        print(f"[threefry] {transform} {str(dtype)[6:]} {tuple(shape)}: "
              f"{u} ulp from the plain version")
    # a data-parallel rank's share: rank 1 of 2 (bs 4 of the global 8)
    hw = H * W
    share = (TL, TRAIN_BS // 2, H, W)
    got = jrandom.draw(k, share, "normal", device=dev,
                       run=TRAIN_BS // 2 * hw, stride=TRAIN_BS * hw,
                       offset=TRAIN_BS // 2 * hw)
    whole = jrandom.normal(k, (TL, TRAIN_BS, H, W), device=dev)
    block = whole[:, TRAIN_BS // 2:].contiguous()
    u = _ulps(got, block)
    worst = max(worst, u)
    err = max(err, float((got - block).abs().max()))
    print(f"[threefry] rank 1 of 2's normals {share}: {u} ulp from the "
          "global draw's block")
    check(worst == 0, f"threefry floats differ from the plain version by "
          f"{worst} ulp")

    # the SF step's draws: 2 normal planes and the (2, n, H, W) uniforms
    def step_draws(draw):
        return [draw(k, plane, "normal"), draw(k, plane, "normal"),
                draw(k, pair, "uniform")]

    def by_kernel(kk, shape, transform):
        return jrandom.draw(kk, shape, transform, device=dev)

    def by_plain(kk, shape, transform):
        return (jrandom.normal(kk, shape, device=dev) if transform == "normal"
                else jrandom.uniform(kk, shape, device=dev))

    ms = cuda_ms(lambda: step_draws(by_kernel))
    plain_ms = cuda_ms(lambda: step_draws(by_plain), reps=5, warmup=1)
    randn_ms = cuda_ms(lambda: (torch.randn(pair, device=dev),
                                torch.rand(pair, device=dev)))
    values = 4 * count
    int_ops = values * THREEFRY_INT_OPS
    flops = 2 * count * (THREEFRY_FLOPS["normal"]) \
        + 2 * count * THREEFRY_FLOPS["uniform"]
    t = {"bytes": values * 4 / HBM_BPS, "operations": max(
        int_ops / INT32_OPS, flops / F32_FLOPS)}
    by = max(t, key=t.get)
    bound = (t[by] * 1e3, by)
    print(f"[threefry] the SF step's draws ({values / 1e6:.1f} M values: 2 "
          f"normal planes, 2 uniform planes of {plane}): kernel {ms:.4f} ms "
          f"(3 launches), plain version {plain_ms:.2f} ms, torch.randn + "
          f"torch.rand of the same count (another generator, for scale) "
          f"{randn_ms:.4f} ms; bound {bound[0]:.4f} ms ({by}: "
          f"{int_ops / 1e9:.2f} G integer ALU ops at {INT32_OPS / 1e12:.1f} "
          f"T/s, {values * 4 / 1e6:.0f} MB written; {bound[0] / ms:.0%} of "
          f"it); "
          f"{smi}")
    results["threefry"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               library_ms=None, bound_ms=bound[0],
                               bound_by=by, randn_ms=randn_ms)

    # the card's init (plain ops on the card) against the CPU's
    t0 = time.perf_counter()
    on_card = init_dispnet_(DispNet(max_disp=128.0).to(dev),
                            jrandom.key(42))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = init_dispnet_(DispNet(max_disp=128.0), jrandom.key(42))
    cpu_s = time.perf_counter() - t0
    sd_cpu = on_cpu.state_dict()
    unequal = [name for name, v in on_card.state_dict().items()
               if not torch.equal(v.cpu(), sd_cpu[name])]
    print(f"[threefry] DispNet init from key(42) on the card ({card_s:.2f} "
          f"s) and on the CPU ({cpu_s:.2f} s): {len(sd_cpu) - len(unequal)}"
          f" of {len(sd_cpu)} tensors bit for bit equal")
    check(not unequal, f"card and CPU inits differ: {unequal[:4]}")
    del on_card, on_cpu, kb, pb, whole
    torch.cuda.empty_cache()


def repeat_phase(settings, dev, sf_np, mf_np) -> None:
    """Phase 16: one input, one result on the card. The SF train step (tl =
    4, bs = 8, f32, file flow), the MF train step (4 tracks, bf16) and the
    SF step with --flow_source net (output/flownet.msgpack), each augmented
    on the device, run 5 times from the same weights, optimizer state, key
    and batch, twice: every loss component and every weight must be
    bitwise equal. Then 2 steps, a save (StateCheckpointer), a restore into
    a fresh state and 1 step must equal the first run's 3 steps bit for
    bit: the components, every weight and the step key."""
    import torch
    from depthinspace_tpu_torch.data import batch_to_torch
    from depthinspace_tpu_torch.models import FuseNet, init_fusenet_
    from depthinspace_tpu_torch.tools.train_flow import load_flow_params
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_mf_train_step,
                                              make_sf_train_step)
    from depthinspace_tpu_torch.train.checkpoint import StateCheckpointer
    T0 = time.perf_counter()
    ctx = make_loss_context(settings, TL, device=dev, augment=True)
    net = load_flow_params(FLOWNET)[0].to(dev).eval()
    ctx_net = make_loss_context(settings, TL, device=dev, augment=True,
                                flow_source="net", flow_net=net)
    cases = (
        ("SF train step, tl=4 bs=8 f32", sf_np, make_sf_train_step,
         lambda: _dispnet(_jkey(SEED + 3)), ctx),
        ("MF train step, 4 tracks bf16", mf_np, make_mf_train_step,
         lambda: init_fusenet_(FuseNet((H, W), settings.K, TL,
                                       compute_dtype=torch.bfloat16),
                               _jkey(SEED + 5)), ctx),
        ("SF train step, --flow_source net", sf_np._replace(flow=None),
         make_sf_train_step, lambda: _dispnet(_jkey(SEED + 3)), ctx_net))
    for label, batch_np, make_step, make_model, c in cases:
        t0 = time.perf_counter()
        batch = batch_to_torch(batch_np, dev)

        def fresh():
            model = make_model()
            state = TrainState.create(model, 1e-4, seed=SEED, device=dev)
            return model, state, make_step(model, c, state)

        def weights(model):
            return [p.detach().clone() for p in model.parameters()]

        runs = []
        for _ in range(2):
            model, state, step = fresh()
            losses, after3 = [], None
            for i in range(5):
                losses.append(step(batch).cpu().numpy())
                if i == 2:
                    after3 = (weights(model), state.rng)
            runs.append((np.array(losses), weights(model), after3))
            del model, state, step
        (l0, w0, (w3, rng3)), (l1, w1, _) = runs
        runs_equal = np.array_equal(l0, l1) and all(
            torch.equal(a, b) for a, b in zip(w0, w1))
        d_loss = float(np.max(np.abs(l1 - l0)))
        d_w = max(float((a - b).abs().max()) for a, b in zip(w0, w1))

        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            model, state, step = fresh()
            for _ in range(2):
                step(batch)
            StateCheckpointer(Path(tmp)).save(1, state, {"simple": 0.25})
            del model, state, step
            model, state, step = fresh()
            _, epoch, _ = StateCheckpointer(Path(tmp)).restore(state)
            comps = step(batch).cpu().numpy()
            resumed = (epoch == 1 and state.step == 3
                       and np.array_equal(comps, l0[2])
                       and state.rng == rng3
                       and all(torch.equal(a, b)
                               for a, b in zip(weights(model), w3)))
            del model, state, step
        print(f"[repeat] {label}: 5 steps from one state, twice: losses and "
              f"every weight bitwise equal: {runs_equal} (largest |diff| of "
              f"a loss component {d_loss:.3g}, of a weight {d_w:.3g}); 2 "
              f"steps + save + restore + 1 step equal to 3 steps bit for "
              f"bit: {resumed}; {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(l0).all(), f"{label}: repeated runs not finite")
        check(runs_equal, f"{label}: two runs from one state differ")
        check(resumed, f"{label}: the resumed run differs from the "
              "uninterrupted one")
        del batch, runs, w0, w1, w3
        torch.cuda.empty_cache()
    print(f"[repeat] phase 16 {time.perf_counter() - T0:.1f} s")


def grad_diff(a: dict, b: dict) -> tuple[float, dict]:
    """(relative L2 of a - b over all parameters, per-tensor relative L2)."""
    import torch
    per = {k: float(torch.linalg.vector_norm(a[k] - b[k])
                    / torch.linalg.vector_norm(b[k])) for k in b}
    whole = float(
        torch.linalg.vector_norm(torch.cat([(a[k] - b[k]).flatten()
                                            for k in b]))
        / torch.linalg.vector_norm(torch.cat([g.flatten()
                                              for g in b.values()])))
    return whole, per


def profile_step(step, batch, label: str, groups: dict) -> float:
    """torch.profiler over 3 calls of ``step(batch)``: prints device ms per
    call by kernel group and the top kernels; returns busy device ms/call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 3e3, e.count // 3)
            for e in prof.key_averages()
            if e.self_device_time_total > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    print(f"[profile] {label}: device time {busy:.2f} ms/step over "
          f"{len(rows)} kernel names; top 12 (ms/step, launches/step):")
    for key, ms, cnt in rows[:12]:
        print(f"[profile]   {ms:8.3f} {cnt:5d}  {key[:110]}")
    seen = set()
    parts = []
    for gname, keys in groups.items():
        ms = sum(r[1] for r in rows if r[0] not in seen
                 and any(k in r[0].lower() for k in keys))
        seen |= {r[0] for r in rows if any(k in r[0].lower() for k in keys)}
        parts.append(f"{gname} {ms:.2f} ({ms / busy:.1%})")
    rest = sum(r[1] for r in rows if r[0] not in seen)
    print(f"[profile] {label} by group (ms/step): " + ", ".join(parts)
          + f", the rest {rest:.2f} ({rest / busy:.1%})")
    return busy


# kernel name fragments of each group, matched in this order
GROUPS = {
    "hand-written K1-K4": ("census_sad", "xwarp", "warp2d", "fixed_sum::",
                           "pairs_bwd_", "scan_totals", "scan_blocks",
                           "scan_starts"),
    "convolutions/GEMM": ("conv", "cudnn", "xmma", "gemm", "wgrad", "dgrad",
                          "fft", "winograd", "sm90_", "cutlass"),
    "gather/scatter/index": ("index", "gather", "scatter"),
    "sort": ("sort", "radix"),
    "reductions": ("reduce",),
    "copies/cat/pad": ("copy", "cat", "pad"),
    "optimizer": ("adam", "multi_tensor", "foreach"),
}


def mf_phases(settings, dev, smi, sf_model, mf_np) -> dict:
    """Phases 10-14 (DIS-MF). Returns the launch counts of the MF path
    (phases 10-12)."""
    import copy
    import torch
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.data import (SyntheticSource, batch_to_torch,
                                             make_track_batch)
    from depthinspace_tpu_torch.models import FuseNet, init_fusenet_
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.serve import TrackDisparityServer
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_mf_eval_step,
                                              make_mf_train_step)
    from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker
    from depthinspace_tpu_torch.train.steps import _mf_forward

    def fusenet(dtype, seed):
        return init_fusenet_(FuseNet((H, W), settings.K, TL,
                                     compute_dtype=dtype),
                             _jkey(seed))

    def delta(before):
        return {k: kernels.launches[k] - before[k] for k in before}

    # -- 10. mf serve -----------------------------------------------------
    mf16 = fusenet(torch.bfloat16, SEED + 4)
    kernels.reset_launches()                     # the MF path starts here
    srv = TrackDisparityServer(sf_model, mf16, imsize=(H, W), K=settings.K,
                               max_tracks=MF_TRACKS, device=dev)
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 0))
    req = (mv(mf_np.im), mv(mf_np.ambient), mv(mf_np.R), mv(mf_np.t),
           np.ascontiguousarray(np.moveaxis(mf_np.flow, 2, 0)))
    out = srv.infer(*(a[:3] for a in req))
    check(out.shape == (3, TL, H, W), f"mf serve output shape {out.shape}")
    check(np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 128.0,
          f"mf serve output outside [0, 128]: {out.min()} .. {out.max()}")
    before = dict(kernels.launches)
    srv.infer(*req)
    per_bucket = delta(before)
    print(f"[mf serve] launches for one bucket of {MF_TRACKS} tracks: "
          f"{per_bucket}")
    for name, n in per_bucket.items():
        want = {"warp2d_fwd": 1, "warp2d_pairs_fwd": 8}.get(name, 0)
        check(n == want, f"mf serve: {n} launches of {name}, expected {want}")
    # one request, one answer (deterministic cuDNN algorithms)
    got = srv.infer(*req)
    check(np.array_equal(srv.infer(*req), got),
          "mf serve with caller flow: the same request served twice differs")
    diff = default_algorithms_diff(lambda: srv.infer(*req))
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        srv.infer(*(a[:3] for a in req))
    ragged = 3 * reps / (time.perf_counter() - t0)
    full = serve_rates(lambda: srv.infer(*req), MF_TRACKS, reps=3)
    print(f"[mf serve] out {out.shape} in [{out.min():.3f}, {out.max():.3f}]"
          f" px; a {MF_TRACKS}-track request served twice: equal; on the "
          f"default algorithms {diff}; {ragged:.2f} tracks/s on 3-track "
          f"requests (bucket 4), {full['deterministic']:.2f} tracks/s on "
          f"{MF_TRACKS}-track requests ({MF_TRACKS / full['deterministic'] * 1e3:.1f} ms "
          f"each), {full['default']:.2f} on the default algorithms (before "
          f"the repair); FuseNet bf16, DispNet f32, TF32 off; {smi}")

    # -- 11. mf eval ------------------------------------------------------
    mfb = batch_to_torch(mf_np, dev)
    for flow_source in ("file", "pred"):
        step = make_mf_eval_step(mf16, make_loss_context(
            settings, TL, device=dev, flow_source=flow_source))
        disp_u16, comps = step(mfb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            disp_u16, comps = step(mfb)
        comps_np = comps.cpu().numpy()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        check(disp_u16.shape == (TL, MF_TRACKS, H, W), "mf eval disp0 shape")
        check(np.isfinite(comps_np).all() and (comps_np > 0).all(),
              f"mf eval components {comps_np}")
        print(f"[mf eval] flow_source={flow_source}: components "
              f"{np.array2string(comps_np, precision=6)}; {ms:.1f} ms/step "
              f"(tl={TL}, bs={MF_TRACKS}, bf16)")
    path = dict(kernels.launches)

    # -- 12. mf train -----------------------------------------------------
    mf_train = fusenet(torch.bfloat16, SEED + 5)
    start_sd = copy.deepcopy(mf_train.state_dict())
    ctx_t = make_loss_context(settings, TL, device=dev, augment=True)
    state = TrainState.create(mf_train, 1e-4, seed=SEED, device=dev)
    train_step = make_mf_train_step(mf_train, ctx_t, state)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    totals, times = [], []
    for i in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = train_step(mfb)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        comps_np = comps.cpu().numpy()
        check(np.isfinite(comps_np).all(), f"mf train components {comps_np}")
        totals.append(float(comps_np.sum()))
        if i >= 6 and totals[-1] < totals[0]:
            break
    steps = len(totals)
    counts_t = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.median(times[1:]))
    print(f"[mf train] {MF_TRACKS} tracks x {TL} frames {H}x{W}, FuseNet "
          f"bf16 4 blocks x 32 ch, no remat, accum 1, Adam(1e-4): "
          f"{step_ms:.1f} ms/step (median of {steps - 1} after a warm step; "
          f"min {min(times[1:]):.1f}, max {max(times[1:]):.1f}); first step "
          f"{times[0]:.1f} ms; peak {peak:.2f} GiB; {smi}")
    print(f"[mf train] total loss {totals[0]:.6f} at step 0 -> "
          f"{totals[-1]:.6f} at step {steps - 1}; components "
          f"{np.array2string(comps_np, precision=5)}")
    check(totals[-1] < totals[0], "the MF train loss did not fall")
    print(f"[mf train] launches over {steps} steps: {counts_t}")
    for name, per in {**PER_MF_STEP, "threefry": THREEFRY_PER_STEP}.items():
        check(counts_t[name] == per * steps,
              f"{name}: {counts_t[name]} launches in the MF train phase, "
              f"expected {per} x {steps}")
    path = {k: path[k] + counts_t[k] for k in path}  # the MF path ends here
    busy = profile_step(train_step, mfb, "mf train bf16", GROUPS)
    print(f"[mf train] device busy {busy:.2f} of {step_ms:.2f} ms/step: idle "
          f"share {max(0.0, 1 - busy / step_ms):.3f}")

    for label, dtype, accum in (("f32", torch.float32, 1),
                                ("bf16 accum_steps=2", torch.bfloat16, 2)):
        m = FuseNet((H, W), settings.K, TL, compute_dtype=dtype)
        m.load_state_dict(start_sd)
        st = TrainState.create(m, 1e-4, seed=SEED, device=dev)
        step = make_mf_train_step(m, ctx_t, st, accum_steps=accum)
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = step(mfb).cpu().numpy()
            ts.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(c).all(), f"mf train {label} components {c}")
        print(f"[mf train] {label}: {np.median(ts[1:]):.1f} ms/step (median "
              f"of 3 after a warm step); peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"components {np.array2string(c, precision=5)}")
        del m, st, step
    del state, train_step, mf_train, srv
    torch.cuda.empty_cache()

    # -- 13. mf parity: card vs CPU, eval and one train step at bs = 1 ----
    b1 = make_track_batch(settings, tl=TL, bs=1, seed=SEED + 21,
                          primary_noise=0.5)
    mf_cpu = fusenet(torch.float32, SEED + 6).eval()
    mf_gpu = copy.deepcopy(mf_cpu).to(dev)
    ctx_gpu = make_loss_context(settings, TL, device=dev)
    ctx_cpu = make_loss_context(settings, TL, device="cpu")
    b1_gpu, b1_cpu = batch_to_torch(b1, dev), batch_to_torch(b1, "cpu")
    d_gpu, c_gpu = make_mf_eval_step(mf_gpu, ctx_gpu)(b1_gpu)
    t0 = time.perf_counter()
    d_cpu, c_cpu = make_mf_eval_step(mf_cpu, ctx_cpu)(b1_cpu)
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        fd = float((_mf_forward(mf_gpu, b1_gpu, ctx_gpu).cpu()
                    - _mf_forward(mf_cpu, b1_cpu, ctx_cpu)).abs().max())
    c_gpu, c_cpu = c_gpu.cpu().numpy(), c_cpu.numpy()
    rel = np.abs(c_gpu - c_cpu) / np.abs(c_cpu)
    dd = np.abs(d_gpu.cpu().numpy().astype(np.int64)
                - d_cpu.numpy().astype(np.int64))
    print(f"[mf parity] eval bs=1 f32 {H}x{W}: components card "
          f"{np.array2string(c_gpu, precision=7)} cpu "
          f"{np.array2string(c_cpu, precision=7)}; relative diff "
          f"{np.array2string(rel, precision=2)}; disparity max diff "
          f"{fd:.3g} px; disp0 u16 max diff {dd.max()}, unequal on "
          f"{np.mean(dd > 0):.5f}; cpu eval {cpu_s:.1f} s")
    # as the SF eval parity: photometric and smoothness rtol 1e-3,
    # geometric rtol 1e-2 (its masks are thresholds). The disparity within
    # 1e-3 px; its u16 x256 quantization within 1 unit, and a float
    # difference d flips a rounding edge on a share ~256 d of the pixels:
    # at most 1 % of them (the same neighbour choices on both devices, the
    # convolutions summed in other orders)
    check((rel[:2] <= 1e-3).all() and rel[2] <= 1e-2,
          f"card and CPU MF components differ: {rel}")
    check(fd <= 1e-3 and dd.max() <= 1 and np.mean(dd > 0) <= 1e-2,
          f"card and CPU MF disp0 differ: {fd} px, {dd.max()} units on "
          f"{np.mean(dd > 0)}")
    del mf_gpu

    def one_step(d):
        m = copy.deepcopy(mf_cpu).to(d)
        st = TrainState.create(m, 1e-4, seed=SEED, device=d)
        t0 = time.perf_counter()
        comps = make_mf_train_step(m, make_loss_context(settings, TL,
                                                        device=d), st)(
            batch_to_torch(b1, d)).cpu().numpy()
        print(f"[mf train parity] {d.type} step {time.perf_counter() - t0:.1f} s")
        return comps, {k: p.grad.detach().cpu().double()
                       for k, p in m.named_parameters()}

    c_card, g_card = one_step(dev)
    _, g_card2 = one_step(dev)
    c_cpu, g_cpu = one_step(torch.device("cpu"))
    rel_c = np.abs(c_card - c_cpu) / np.abs(c_cpu)
    rel_all, rel_g = grad_diff(g_card, g_cpu)
    self_all, self_g = grad_diff(g_card2, g_card)
    worst = max(rel_g, key=rel_g.get)
    print(f"[mf train parity] components relative diff "
          f"{np.array2string(rel_c, precision=2)}; gradients card vs CPU: "
          f"relative L2 {rel_all:.3g} over all parameters; per tensor max "
          f"{rel_g[worst]:.3g} ({worst}), median "
          f"{np.median(list(rel_g.values())):.3g} over {len(rel_g)} tensors; "
          f"card vs card: {self_all:.3g} over all, per tensor max "
          f"{max(self_g.values()):.3g}")
    # the SF train parity's limits: components as the eval parity; the whole
    # gradient within 1e-3 relative L2, each tensor within 2e-2
    check((rel_c[:2] <= 1e-3).all() and rel_c[2] <= 1e-2
          and rel_c[3] <= 1e-3, f"card and CPU MF train components differ: "
          f"{rel_c}")
    check(rel_all <= 1e-3 and rel_g[worst] <= 2e-2,
          f"card and CPU MF gradients differ: all {rel_all}, {worst} "
          f"{rel_g[worst]}")
    check(self_all == 0.0, f"two card MF steps from one state differ: "
          f"{self_all}")

    # -- 14. mf worker: train, resume, retest -----------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cfg = RunConfig(data_dir=Path(tmp), output_dir=Path(tmp),
                        architecture="multi_frame", epochs=1,
                        train_batch_size=2, test_batch_size=2,
                        max_train_iter=2, num_workers=4, seed=SEED)
        source = SyntheticSource(settings, 8, seed=SEED + 30,
                                 primary_noise=0.5)
        t0 = time.perf_counter()
        MultiFrameWorker(cfg, device=dev, source=source).do("retrain")
        exp = Path(tmp) / "multi_frame"
        names = sorted(p.name for p in exp.iterdir())
        check({"metrics.json", "state", "net_0000.params", "train.log",
               "state_set_simple_best"} <= set(names),
              f"mf worker artifacts {names}")
        m0 = json.loads((exp / "metrics.json").read_text())
        loss0 = m0["0"]["test"]["0"]["loss"]
        cfg.epochs = 2
        MultiFrameWorker(cfg, device=dev, source=source).do("resume")
        m1 = json.loads((exp / "metrics.json").read_text())
        check(sorted(m1) == ["0", "1"], f"mf resumed epochs {sorted(m1)}")
        check("Resumed from epoch 0" in (exp / "train.log").read_text(),
              "the resumed MF worker did not start at epoch 1")
        MultiFrameWorker(cfg, device=dev, source=source).do("retest",
                                                            epoch=0)
        again = json.loads((exp / "metrics.json").read_text())["0"]["test"][
            "0"]["loss"]
        rel_r = np.abs(np.array(again) - loss0) / np.abs(loss0)
        close_logs()
        print(f"[mf worker] {names}; epoch 0 test: loss {sum(loss0):.5f}, "
              f"dist2_mean {m0['0']['test']['0']['dist2_mean']:.3f}; resumed "
              f"at epoch 1; retest of epoch 0 within {rel_r.max():.2g} "
              f"relative; {time.perf_counter() - t0:.1f} s")
        check(rel_r.max() <= 1e-4, f"MF retest of epoch 0 differs: {rel_r}")
    print(f"[mf] kernel launches on the MF path (phases 10-12): {path}")
    for name in (*PER_MF_STEP, "threefry"):
        if name.startswith("warp2d_v1"):
            continue
        check(path[name] > 0, f"{name} never launched on the MF path")
    return path


# -- 21. data parallel ---------------------------------------------------------
DP_CHILD = "--data-parallel-child"
DP_TIMEOUT_S = 300
DP_TIMED_STEPS = 3
# a 2-rank step against world 1: components (rtol); the whole gradient
# (relative L2) and each tensor's, phase 8's limits in f32. In bf16 each
# rank's partial sums over its samples round to bf16 (unit roundoff 2^-8)
# before the float32 all-reduce, so the whole gradient gets bf16's unit
# roundoff (on the CPU, without atomics: 1.93e-3 for the MF case)
DP_COMP_RTOL, DP_GRAD_TENSOR = 1e-4, 2e-2
DP_GRAD_ALL = {"float32": 1e-3, "bfloat16": 2.0 ** -8}
# ... unless bf16 itself moves the gradient further: two bf16 steps of one
# gradient (2 ranks, world 1) may each lie as far from the f32 gradient as
# world 1's bf16 step does, so twice that distance, as a whole and tensor
# by tensor, bounds their difference too. The bf16 noise depends on the
# init: from torch's init of seed 5 the whole 2-rank difference was
# 2.44e-3; from flax's init of key(5) 6.4e-3-6.7e-3, and on one tensor as
# far as world 1's own distance from f32 there. Planted in the ranks
# (scripts/chip_check_controls.py), a skipped gradient all-reduce reads
# 0.52 over all in MF bf16 (limit 3.9e-2) and 0.51 in SF f32; ratios over
# each rank's own denominators read 2.6e-3 in SF f32 (limit 1e-3) and
# change nothing in MF, whose two ranks have equal denominators


def start_children(cmds, env=None) -> list:
    return [subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT) for c in cmds]


def run_children(cmds, what: str, env=None, timeout: float = DP_TIMEOUT_S,
                 procs=None):
    """Start every command at once (or take ``procs``, started by
    start_children), wait for all, kill the ones still running at the
    timeout; raise with a child's output when one failed or hung. Returns
    the outputs."""
    procs = procs or start_children(cmds, env)
    outs, hung = [], False
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))[0])
            except subprocess.TimeoutExpired:
                hung = True
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        check(not hung and p.returncode == 0,
              f"{what}: child {i} {'hung' if hung else 'exited'} "
              f"{p.returncode}:\n{out[-3000:]}")
    return outs


def dp_cases(settings):
    """Phase 21's two steps: (label, train step factory, batch, model
    factory, launches a step, compute dtype). SF: phase 7's batch (tl = 4, bs 8, file
    flow) and init, f32. MF: phase 12's tracks (4, bf16, FuseNet 4 x 32)
    with flow the forward-backward test rejects everywhere, which leaves
    each target frame's own 3x3 candidates and a neighbour selection no
    rounding can move (Queue 3, item 7's rule)."""
    import torch
    from depthinspace_tpu_torch.data import make_track_batch
    from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                               init_dispnet_, init_fusenet_)
    from depthinspace_tpu_torch.train import (make_mf_train_step,
                                              make_sf_train_step)
    mf = make_track_batch(settings, tl=TL, bs=MF_TRACKS, seed=SEED + 20,
                          primary_noise=0.5)
    flow = np.zeros_like(mf.flow)
    flow[..., 0] = 5.0 * (1 - np.eye(TL, dtype=np.float32))[
        :, :, None, None, None]
    return (
        ("SF", make_sf_train_step,
         make_track_batch(settings, tl=TL, bs=TRAIN_BS, seed=SEED + 2),
         lambda: _dispnet(_jkey(SEED + 3)),
         PER_TRAIN_STEP, "float32"),
        ("MF", make_mf_train_step, mf._replace(flow=flow),
         lambda dtype=torch.bfloat16: init_fusenet_(
             FuseNet((H, W), settings.K, TL, compute_dtype=dtype),
             _jkey(SEED + 5)),
         PER_MF_STEP, "bfloat16"))


def dp_step(settings, case, dev, group, rank: int, world: int) -> dict:
    """One train step (Adam(1e-4)) of rank ``rank``'s block of the case's
    batch from the seeded init: components, gradients (summed over the
    ranks), a digest of the updated parameters, the kernel launches of
    that step; then the ms of DP_TIMED_STEPS more steps (median)."""
    import torch
    from depthinspace_tpu_torch.data import batch_to_torch
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.parallel import shard_batch
    from depthinspace_tpu_torch.train import TrainState, make_loss_context
    _, make_step, batch_np, make_model, _, _ = case
    model = make_model()
    state = TrainState.create(model, 1e-4, seed=SEED + rank, device=dev)
    step = make_step(model, make_loss_context(settings, TL, device=dev,
                                              group=group), state)
    batch = batch_to_torch(shard_batch(batch_np, rank, world), dev)
    kernels.reset_launches()
    comps = step(batch).cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters()}
    digest = hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes()
        for p in model.parameters())).hexdigest()
    times = []
    for _ in range(DP_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"comps": comps, "grads": grads, "digest": digest,
            "launches": launches, "ms": float(np.median(times[1:]))}


def dp_child(spec: dict) -> None:
    """A rank of phase 21, on cuda:0 in a gloo group of spec["world"]:
    "steps" runs dp_step for both cases, "worker" the SF worker's
    commands (rank 1's first command writes to its own directory, which
    must stay empty)."""
    import torch
    from depthinspace_tpu_torch.data import make_settings
    from depthinspace_tpu_torch.device import resolve_device
    from depthinspace_tpu_torch.parallel import default_group, init_multihost
    dev = resolve_device("cuda:0")
    rank = spec["rank"]
    init_multihost(device=dev, backend="gloo", init_method=spec["init"],
                   rank=rank, world_size=spec["world"])
    if spec["mode"] == "steps":
        settings = make_settings(H, W)
        torch.save([dp_step(settings, case, dev, default_group(), rank,
                            spec["world"]) for case in dp_cases(settings)],
                   spec["out"])
    else:
        from depthinspace_tpu_torch.config import RunConfig
        from depthinspace_tpu_torch.train.single_frame import (
            SingleFrameWorker)
        cfg = RunConfig(**spec["cfg"])
        for i, (cmd, epochs) in enumerate(spec["cmds"]):
            cfg.epochs = epochs
            cfg.output_dir = Path(spec["cfg"]["output_dir"] + (
                "_rank1" if rank == 1 and i == 0 else ""))
            SingleFrameWorker(cfg, device=dev).do(cmd)
            close_logs()
    torch.distributed.destroy_process_group()


def dp_ranks(tmp: Path, spec: dict, world: int = 2) -> list:
    """``world`` ranks of ``dp_child`` started together; their outputs."""
    cmds = [[sys.executable, str(ROOT / "chip_smoke.py"), DP_CHILD,
             json.dumps(dict(spec, rank=r, world=world,
                             init=f"file://{tmp}/rendezvous_{spec['mode']}",
                             out=str(tmp / f"rank{r}.pt")))]
            for r in range(world)]
    return run_children(cmds, f"phase 21 {spec['mode']}")


def dp_grad_limits(settings, case, ref: dict, dev) -> tuple[float, dict]:
    """The limits of a 2-rank step's gradients against world 1's step
    ``ref`` of ``case``: (the whole gradient's relative L2, each tensor's).
    In bf16 each is at least twice world 1's own bf16-to-f32 distance from
    the same init, which this measures."""
    import torch
    whole = DP_GRAD_ALL[case[5]]
    tensor = {k: DP_GRAD_TENSOR for k in ref["grads"]}
    if case[5] == "bfloat16":
        f32 = dp_step(settings, case[:3] + (
            lambda: case[3](torch.float32),) + case[4:], dev, None, 0, 1)
        n_all, n_t = grad_diff(ref["grads"], f32["grads"])
        whole = max(whole, 2 * n_all)
        tensor = {k: max(v, 2 * n_t[k]) for k, v in tensor.items()}
        top = max(n_t, key=n_t.get)
        print(f"[dp] {case[0]} world 1 in bf16 against f32 from the same "
              f"init: gradients relative L2 {n_all:.3g} over all, at most "
              f"{n_t[top]:.3g} ({top}): twice them bound the 2-rank "
              "difference")
    return whole, tensor


def timed(fn) -> float:
    """Seconds of fn()."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def data_parallel_phase(settings, dev, smi, sf_model, images, data: Path,
                        cli_out: Path) -> None:
    """Phase 21: data parallelism on one card. NCCL will not put two ranks
    on one GPU, so (a), (b) and (c)'s second part run 2 gloo ranks on
    cuda:0 (the collectives staged through the host), and (c) runs the
    CLI under torchrun at world size 1 on NCCL. The 2-rank times are the
    cost of gloo's host staging on one card, not a speed figure for NCCL
    across cards."""
    import os
    import torch
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.serve import DisparityServer
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    T0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        # -- 21a, b. one step in 2 gloo ranks against world 1 ---------------
        t0 = time.perf_counter()
        dp_ranks(tmp, {"mode": "steps"})
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        two_s = time.perf_counter() - t0
        for i, case in enumerate(dp_cases(settings)):
            label, per_step = case[0], case[4]
            t0 = time.perf_counter()
            ref, again = (dp_step(settings, case, dev, None, 0, 1)
                          for _ in range(2))
            r0, r1 = ranks[0][i], ranks[1][i]
            rel_c = np.abs(r0["comps"] - ref["comps"]) / np.maximum(
                np.abs(ref["comps"]), 1e-30)
            g_all, g_t = grad_diff(r0["grads"], ref["grads"])
            s_all, s_t = grad_diff(again["grads"], ref["grads"])
            grad_all, tensor_lim = dp_grad_limits(settings, case, ref, dev)
            worst = max(g_t, key=lambda k: g_t[k] / tensor_lim[k])
            print(f"[dp] {label} step, 2 gloo ranks on cuda:0 against world "
                  f"1: components {np.array2string(r0['comps'], precision=6)}"
                  f" vs {np.array2string(ref['comps'], precision=6)} "
                  f"(relative diff max {rel_c.max():.3g}); gradients "
                  f"relative L2 {g_all:.3g} over all (limit {grad_all:.3g}, "
                  f"{case[5]}), per tensor max "
                  f"{g_t[worst]:.3g} ({worst}); world 1 against itself "
                  f"{s_all:.3g} over all, per tensor max "
                  f"{max(s_t.values()):.3g}; ranks' parameters bitwise "
                  f"equal: {r0['digest'] == r1['digest']}; world-1 steps "
                  f"{time.perf_counter() - t0:.1f} s")
            print(f"[dp] {label} launches a step: rank 0 "
                  f"{ {k: v for k, v in r0['launches'].items() if v} }, rank "
                  f"1 { {k: v for k, v in r1['launches'].items() if v} }")
            print(f"[dp] {label} ms/step: 2 gloo ranks on one card "
                  f"{r0['ms']:.1f} (rank 0), {r1['ms']:.1f} (rank 1); world "
                  f"1 {ref['ms']:.1f}; medians of {DP_TIMED_STEPS}; the "
                  f"cost of gloo's host staging on one card, not a speed "
                  f"figure for NCCL across cards; {smi}")
            check(s_all == 0.0 and max(s_t.values()) == 0.0,
                  f"{label}: two world-1 steps from one state differ: "
                  f"{s_all}")
            check(r0["digest"] == r1["digest"],
                  f"{label}: the ranks' parameters differ after the step")
            check(np.array_equal(r0["comps"], r1["comps"]),
                  f"{label}: the ranks report other components")
            check(rel_c.max() <= DP_COMP_RTOL,
                  f"{label}: 2-rank components differ from world 1: {rel_c}")
            check(g_all <= grad_all and g_t[worst] <= tensor_lim[worst],
                  f"{label}: 2-rank gradients differ from world 1: all "
                  f"{g_all}, {worst} {g_t[worst]}")
            for r in (r0, r1):
                for k, n in per_step.items():
                    check(r["launches"][k] == n,
                          f"{label}: {k} launched {r['launches'][k]} times "
                          f"on a rank, expected {n}")
            del ref, again
        del ranks
        torch.cuda.empty_cache()

        # -- 21c. the CLI under torchrun (NCCL, world 1), and beside its
        # retrain (mostly the start of two processes) the SF worker in 2
        # gloo ranks against world 1 -------------------------------------
        steps = ["--epochs", "1", "--train_batch_size", "4",
                 "--max_train_iter", "3"]
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps({"OUTPUT_DIR": str(tmp / "torchrun"),
                                        "DATA_DIR": str(data)}))
        env = dict(os.environ, DIS_CONFIG=str(cfg_path))
        torchrun = [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc_per_node", "1", "-m",
                    "depthinspace_tpu_torch.train_val",
                    "--architecture", "single_frame"]
        t0 = time.perf_counter()
        retrain = start_children([torchrun + ["--cmd", "retrain", *steps]],
                                 env)
        cfg = dict(data_dir=str(data), output_dir=str(tmp / "world1"),
                   epochs=1, train_batch_size=4, test_batch_size=4,
                   max_train_iter=3, num_workers=4, device_augment=False,
                   seed=SEED)
        one_s = timed(lambda: SingleFrameWorker(
            RunConfig(**cfg), device=dev).do("retrain"))
        close_logs()
        two_w_s = timed(lambda: dp_ranks(tmp, {
            "mode": "worker", "cfg": dict(cfg,
                                          output_dir=str(tmp / "world2")),
            "cmds": [("retrain", 1), ("resume", 2)]}))
        run_children(None, "torchrun retrain", procs=retrain)
        cli_s = {"retrain": time.perf_counter() - t0}
        cli_s["retest"] = timed(lambda: run_children(
            [torchrun + ["--cmd", "retest", "--epoch", "0"]],
            "torchrun retest", env=env))
        exp = tmp / "torchrun" / "single_frame"
        got = sorted(p.name for p in exp.iterdir())
        want = sorted(p.name for p in (cli_out / "single_frame").iterdir())
        log = (exp / "train.log").read_text()
        m = json.loads((exp / "metrics.json").read_text())["0"]
        print(f"[dp] torchrun --standalone --nproc_per_node 1 (NCCL, world "
              f"1): train_val retrain {cli_s['retrain']:.1f} s (beside the "
              f"workers below), retest {cli_s['retest']:.1f} s; {got}; "
              f"epoch 0 test loss {sum(m['test']['0']['loss']):.5f}")
        check(got == want, f"torchrun wrote {got}, one process {want}")
        check("device: cuda:0" in log and np.isfinite(
            m["train"]["loss"]).all(), "the torchrun run's log or metrics")

        m1 = json.loads((tmp / "world1" / "single_frame" / "metrics.json")
                        .read_text())["0"]
        exp2 = tmp / "world2" / "single_frame"
        m2 = json.loads((exp2 / "metrics.json").read_text())
        rank1_files = [p for p in (tmp / "world2_rank1").rglob("*")
                       if p.is_file()]
        rel = {f"train {i}": abs(a - b) / abs(b) for i, (a, b) in enumerate(
            zip(m2["0"]["train"]["loss"], m1["train"]["loss"]))}
        for k, v in m1["test"]["0"].items():
            for i, (a, b) in enumerate(zip(np.atleast_1d(m2["0"]["test"]["0"]
                                                         [k]),
                                           np.atleast_1d(v))):
                rel[f"test {k} {i}"] = abs(a - b) / max(abs(b), 1e-30)
        worst = max(rel, key=rel.get)
        print(f"[dp] SF worker, 2 gloo ranks on cuda:0 (global batch 4, host "
              f"augmentation, 3 steps, retrain then resume) {two_w_s:.1f} s, "
              f"world 1 {one_s:.1f} s: metrics.json of epoch 0 within "
              f"{rel[worst]:.3g} relative ({worst}); rank 1 wrote "
              f"{len(rank1_files)} files; epochs {sorted(m2)}")
        check(rel[worst] <= 1e-3, f"2-rank metrics differ: {worst} "
              f"{rel[worst]}")
        check(not rank1_files, f"rank 1 wrote {rank1_files}")
        check(sorted(m2) == ["0", "1"] and "Resumed from epoch 0" in (
            exp2 / "train.log").read_text(), "the 2-rank resume")

        # -- 21d. the server's replicas -----------------------------------
        t0 = time.perf_counter()
        one = DisparityServer(sf_model, imsize=(H, W), max_batch=8,
                              device=dev).infer(images)
        two = DisparityServer(sf_model, imsize=(H, W), max_batch=8,
                              devices=[dev, dev]).infer(images)
        print(f"[dp] DisparityServer(devices=[cuda:0, cuda:0]) on phase 4's "
              f"13-image request (buckets 8 and 8, one a replica): equal "
              f"to devices=None bit for bit: {np.array_equal(one, two)} "
              f"(max |diff| {np.abs(one - two).max():.3g} px); "
              f"{time.perf_counter() - t0:.1f} s")
        check(np.array_equal(one, two), "the 2-replica server differs")
    print(f"[dp] phase 21 {time.perf_counter() - T0:.1f} s (the 2-rank "
          f"steps' children {two_s:.1f} s); {smi}")


if __name__ == "__main__":
    if sys.argv[1:2] == [DP_CHILD]:
        dp_child(json.loads(sys.argv[2]))
    else:
        main()
