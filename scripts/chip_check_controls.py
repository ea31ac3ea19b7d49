"""Negative controls for two limits of chip_smoke.py, and the SASS of the
threefry kernel, on one card:

  python3 scripts/chip_check_controls.py [--parts overfit,dp,sass]

overfit: phase 19's one-batch DIS-SF overfit (its 16 plane scenes, the
first batch, the workers' init from key(42)) for OVERFIT_S seconds at each
Adam learning rate of --lrs, with the port's step and then with K2's
backward returning zeros (the photometric loss gives the disparity no
gradient); each run's photometric and |disp - GT| ratios beside phase 19's
limits.

dp: phase 21's 2-rank steps (2 gloo ranks on cuda:0, SF f32 and MF bf16)
against world 1, with a wrong reduction planted in the ranks: "no
all-reduce" (each rank keeps its own gradient), and "per-rank ratios"
(each rank divides its loss ratios by its own denominators, and the ranks'
gradients sum to the mean of the ranks' ratios, as a plain
DistributedDataParallel average gives); the whole and the worst tensor's
relative L2 beside phase 21's limits.

sass: ``cuobjdump -sass`` of the built library's threefry kernels, counted
by pipe and opcode, whole and over the hash (the listing goes to
chiprun_out/threefry.sass).

Prints one line per run and exits 0; it checks nothing itself.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CHILD = "--controls-dp-child"


def zero_k2_backward():
    """K2's backward launches as usual and returns zeros."""
    from depthinspace_tpu_torch.ops import kernels
    real = kernels.xwarp_bwd
    kernels.xwarp_bwd = lambda *a: real(*a).zero_()


def plant(fault: str) -> None:
    """Plants a wrong cross-rank reduction in this process."""
    import torch
    from depthinspace_tpu_torch.train import steps
    if fault == "no all-reduce":
        steps._all_reduce_grads = lambda params, group: None
        return
    from depthinspace_tpu_torch.losses import geometric, photometric, reduce
    from depthinspace_tpu_torch.train import objective

    def per_rank_ratio(num, den, group=None, eps=None, min_den=None):
        out = reduce.global_ratio(num, den, None, eps, min_den)
        if group is None:
            return out
        return out / torch.distributed.get_world_size(group)

    for mod in (geometric, photometric, objective):
        mod.global_ratio = per_rank_ratio


def overfit_part(dev, smi, lrs) -> None:
    import torch
    from depthinspace_tpu_torch.data import batch_to_torch
    from depthinspace_tpu_torch.ops import kernels
    from depthinspace_tpu_torch.train import make_loss_context
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        settings, enc, gt = cs.plane_scenes(Path(tmp) / "data")
    batch = batch_to_torch(enc, dev)
    ctx = make_loss_context(settings, cs.TL, device=dev)
    real = kernels.xwarp_bwd
    for fault in ("none", "K2 backward zeroed"):
        if fault != "none":
            zero_k2_backward()
        for lr in lrs:
            steps, fit_s, (ph0, d0), (ph1, d1), _ = cs.overfit(
                cs._dispnet(cs._jkey(42)), ctx, batch, gt, dev, lr,
                cs.OVERFIT_S)
            print(f"[controls] overfit, fault {fault!r}, Adam({lr:g}): "
                  f"{steps} steps in {fit_s:.1f} s; photometric {ph0:.5f} "
                  f"-> {ph1:.5f} ({ph1 / ph0:.4f}x; limit "
                  f"{cs.OVERFIT_PH_MAX}x); mean |disp - GT| {d0:.3f} -> "
                  f"{d1:.3f} px ({d1 / d0:.4f}x; limit "
                  f"{cs.OVERFIT_DIST_MAX}x); {smi}", flush=True)
            torch.cuda.empty_cache()
    kernels.xwarp_bwd = real


def dp_part(dev, smi) -> None:
    import torch
    from depthinspace_tpu_torch.data import make_settings
    settings = make_settings(cs.H, cs.W)
    cases = cs.dp_cases(settings)
    refs = [cs.dp_step(settings, c, dev, None, 0, 1) for c in cases]
    limits = [cs.dp_grad_limits(settings, c, r, dev)
              for c, r in zip(cases, refs)]
    for fault in ("none", "no all-reduce", "per-rank ratios"):
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            me = str(Path(__file__).resolve())
            cmds = [[sys.executable, me, CHILD, json.dumps(
                {"mode": "steps", "fault": fault, "rank": r, "world": 2,
                 "init": f"file://{tmp}/rendezvous",
                 "out": str(tmp / f"rank{r}.pt")})] for r in range(2)]
            cs.run_children(cmds, f"controls dp {fault}")
            r0 = torch.load(tmp / "rank0.pt", weights_only=False)
        for case, ref, got, (whole, tensor) in zip(cases, refs, r0, limits):
            g_all, g_t = cs.grad_diff(got["grads"], ref["grads"])
            worst = max(g_t, key=lambda k: g_t[k] / tensor[k])
            print(f"[controls] dp, fault {fault!r}, {case[0]} ({case[5]}): "
                  f"gradients relative L2 {g_all:.4g} over all (limit "
                  f"{whole:.4g}); {worst} {g_t[worst]:.4g} (limit "
                  f"{tensor[worst]:.4g}); the largest per tensor "
                  f"{max(g_t.values()):.4g}; {smi}", flush=True)


def dp_child(spec: dict) -> None:
    if spec["fault"] != "none":
        plant(spec["fault"])
    cs.dp_child(spec)


# the pipe of each opcode on sm_90 (without a listing of NVIDIA's): the
# integer and logic unit, the FMA unit (IMAD issues on its heavy half), the
# special-function unit; anything else is counted as "other"
PIPES = {"IADD3": "alu", "LOP3": "alu", "SHF": "alu", "LEA": "alu",
         "ISETP": "alu", "SEL": "alu", "PRMT": "alu", "IMNMX": "alu",
         "FSETP": "alu", "FSEL": "alu", "FMNMX": "alu", "IABS": "alu",
         "IMAD": "fma", "IMUL": "fma", "FFMA": "fma", "FMUL": "fma",
         "FADD": "fma", "MUFU": "sfu"}


def sass_part(smi) -> None:
    from depthinspace_tpu_torch.ops import kernels
    so, _ = kernels.build()
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    kept = []
    for f in re.split(r"\n\s*Function : ", text)[1:]:
        name = f.split("\n", 1)[0].strip()
        if "threefry" not in name:
            continue
        kept.append("Function : " + f)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", f)
        print(f"[controls] sass {name}: {len(ops)} instructions; "
              f"{by_pipe(ops)}")
        # the hash: from its first funnel shift (a rotation) to the first
        # branch after its last; the two key adds before the first
        # rotation lie outside this span
        rot = [i for i, op in enumerate(ops) if op.startswith("SHF.L.W")]
        end = next(i for i in range(rot[-1], len(ops))
                   if ops[i].startswith("BRA"))
        print(f"[controls] sass {name}, the hash's span ({len(rot)} "
              f"rotations): {by_pipe(ops[rot[0]:end])}")
    (out / "threefry.sass").write_text("\n".join(kept))
    print(f"[controls] sass listing in chiprun_out/threefry.sass; {smi}")


def by_pipe(ops) -> str:
    """Instruction counts by pipe and by opcode (IMAD.IADD apart)."""
    names = collections.Counter(
        "IMAD.IADD" if op.startswith("IMAD.IADD") else op.split(".")[0]
        for op in ops)
    pipes = collections.Counter()
    for op, n in names.items():
        pipes[PIPES.get(op.split(".")[0], "other")] += n
    return f"by pipe {dict(pipes)}, by opcode {dict(names.most_common())}"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="overfit,dp,sass")
    ap.add_argument("--lrs", default="1e-4,3e-4,1e-3,3e-3")
    args = ap.parse_args()
    from depthinspace_tpu_torch.device import require_cuda, set_full_f32
    dev = require_cuda()
    set_full_f32()
    smi = cs.smi_name_power()
    print(smi)
    (ROOT / "build").mkdir(exist_ok=True)
    parts = args.parts.split(",")
    t0 = time.perf_counter()
    if "sass" in parts:
        sass_part(smi)
    if "overfit" in parts:
        overfit_part(dev, smi, [float(x) for x in args.lrs.split(",")])
    if "dp" in parts:
        dp_part(dev, smi)
    print(f"[controls] {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    if sys.argv[1:2] == [CHILD]:
        dp_child(json.loads(sys.argv[2]))
    else:
        main()
