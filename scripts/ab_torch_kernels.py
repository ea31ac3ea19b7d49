#!/usr/bin/env python3
"""K2 and K4 forward of the PyTorch port against an older version of their
CUDA sources, on one NVIDIA card, measured in turns.

    mkdir -p build/old && git archive <commit> depthinspace_tpu_torch/csrc \\
        | tar -x -C build/old
    python3 scripts/ab_torch_kernels.py \\
        --old build/old/depthinspace_tpu_torch/csrc --out build/ab.json

Builds this checkout's kernels (``depthinspace_tpu_torch/csrc``) and the
older ``xwarp.cu`` and ``warp2d_pairs.cu`` (the interface they had before
the K4 forward took a source-major order and the K2 forward an item width)
with nvcc into one library under ``build/ab/``. Every variant's output must be
bit-identical to the plain version's. Then each variant is timed at the main
paths' shapes, first in the listed order and then in reverse (old, new, ...,
new, old), each time as ``chip_smoke.cuda_ms`` times a kernel (median of 25,
each call queued behind a device sleep):

- K2 at the eval step's (8, 512, 432) and the train step's (32, 512, 432),
  the (H, W) projector pattern;
- K4 at the DIS-MF train step's shapes (S = 16, M = 48, 32 channels, at
  256x216 and 128x108, summed; the rigid flow of a synthetic batch) in
  bfloat16 and float32: the old kernel, the vector kernel with each
  ownership (1, 2, 4 and, in float32, 8 vectors a thread; 4 in bfloat16 and
  8 in float32 are a whole pixel), and the chosen ownership with the pairs
  in table order instead of source-major order; and K4's backward, old and
  new (unchanged but for the taps' flow argument), within chip_smoke.py's
  tolerance of the plain version.

The yardsticks (F.grid_sample; for K4 on the pre-gathered stack and after
index_select) are timed once. Prints one line a measurement, the card's name
and power limit, and last one JSON object (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (cuda_ms, grid_of, smi_name_power)

H, W = 512, 432
OLD_SOURCES = ("xwarp.cu", "warp2d_pairs.cu")


def build_ab(old_csrc: Path, kernels) -> ctypes.CDLL:
    """One library of this checkout's kernels and the older xwarp.cu and
    warp2d_pairs.cu, whose entry points are renamed dis_old_* (one library,
    so no entry point or kernel is defined twice in the process)."""
    renames = [f"-D{n}=dis_old_{n[4:]}" for n in (
        "dis_xwarp_fwd", "dis_xwarp_bwd", "dis_warp2d_pairs_fwd",
        "dis_warp2d_pairs_bwd")]
    jobs = [(kernels.CSRC / n, n, []) for n in kernels.SOURCES]
    jobs += [(old_csrc / n, f"old_{n}", renames) for n in OLD_SOURCES]
    digest = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for path, name, extra in jobs:
        digest.update(name.encode() + " ".join(extra).encode())
        digest.update(path.read_bytes())
    so = ROOT / "build" / "ab" / digest.hexdigest()[:16] / "libab.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        nvcc, objs, procs = kernels.nvcc_path(), [], []
        for path, name, extra in jobs:
            obj = so.parent / f"{Path(name).stem}.o"
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, *extra, "-c", str(path), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed: {proc.args}\n{out}")
        subprocess.run([nvcc, "-shared", "-o", str(so), *objs], check=True)
    lib = kernels.bind(ctypes.CDLL(str(so)))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dis_old_xwarp_fwd.argtypes = [ptr, i64, ptr, ptr, i32, i32, i32, ptr]
    lib.dis_old_warp2d_pairs_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                             i32, i32, i32, ptr]
    lib.dis_old_warp2d_pairs_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32,
                                             i32, i32, i32, i32, i32, ptr]
    return lib


def call(fn, *args) -> None:
    import torch
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def agreement(name: str, out, ref) -> bool:
    """Whether out equals ref bit for bit; prints what differs if not."""
    import torch
    if torch.equal(out, ref):
        return True
    diff = (out.float() - ref.float()).abs()
    print(f"[ab] {name} differs from the plain version: "
          f"{int((out != ref).sum())} of {out.numel()} elements, "
          f"{int(torch.isnan(out).sum())} NaN (outputs start as NaN), max "
          f"|diff| {float(diff.nan_to_num(0.0).max()):.3g}")
    return False


def within(grad, ref, bf16: bool) -> bool:
    """K4 bwd's tolerance in chip_smoke.py: 1e-5, plus 2^-6 relative in
    bfloat16."""
    tol = 1e-5 + (2.0 ** -6 * ref.abs() if bf16 else 0.0)
    return bool(((grad.float() - ref).abs() <= tol).all())


def in_turns(variants: dict) -> dict:
    """{name: [ms in the forward pass, ms in the reverse pass]}."""
    names = list(variants)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(chip_smoke.cuda_ms(variants[n]))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the older xwarp.cu, warp2d_pairs.cu")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    from depthinspace_tpu_torch.data import (make_settings, make_track_batch,
                                             smooth_disparity)
    from depthinspace_tpu_torch.device import require_cuda
    from depthinspace_tpu_torch.models.fusenet import (_pair_flows,
                                                       _pair_list,
                                                       _resize_flow_grid)
    from depthinspace_tpu_torch.ops import kernels, lcn
    from depthinspace_tpu_torch.ops.resample import (warp2d_pairs_bwd_plain,
                                                     warp2d_pairs_plain,
                                                     xwarp_plain)

    dev = require_cuda()
    smi = chip_smoke.smi_name_power()
    print(smi)
    lib = build_ab(args.old, kernels)
    settings = make_settings(H, W)
    result = {"card": smi}

    # -- K2 --------------------------------------------------------------
    pattern = lcn(torch.as_tensor(settings.pattern_gray(), device=dev))[0]
    u = torch.arange(W, dtype=torch.float32, device=dev)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    for n in (8, 32):
        rng = np.random.RandomState(n)
        disp = torch.as_tensor(smooth_disparity(rng, (n, H, W), 0.0, 128.0),
                               device=dev).contiguous()
        out_old = torch.full_like(disp, float("nan"))
        out_new = torch.full_like(disp, float("nan"))
        ptrs = (pattern.data_ptr(), disp.data_ptr(), out_new.data_ptr())
        vec = kernels.xwarp_fwd_vec(W, *ptrs)
        variants = {
            "old": lambda: call(lib.dis_old_xwarp_fwd, pattern.data_ptr(), 0,
                                disp.data_ptr(), out_old.data_ptr(), n, H, W),
            "new": lambda: call(lib.dis_xwarp_fwd, ptrs[0], 0, ptrs[1],
                                ptrs[2], n, H, W, vec)}
        for f in variants.values():
            f()
        ref = xwarp_plain(pattern, disp)
        torch.cuda.synchronize()
        same = {name: agreement(f"K2 ({n}, {H}, {W}) {name}", o, ref)
                for name, o in (("old", out_old), ("new", out_new))}
        if not same["new"]:
            raise RuntimeError("K2 differs from the plain version")
        times = in_turns(variants)
        pat_n = pattern.expand(n, 1, H, W)
        grid = chip_smoke.grid_of(u - disp, v.expand(n, H, W))
        lib_ms = chip_smoke.cuda_ms(lambda: F.grid_sample(
            pat_n, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        bound = chip_smoke.bound_ms(2 * 4 * disp.numel() + 4 * H * W)[0]
        result[f"xwarp_fwd ({n}, {H}, {W})"] = dict(
            times, vec=vec, grid_sample_ms=lib_ms, bound_ms=bound,
            exact=same)
        print(f"[ab] xwarp_fwd ({n}, {H}, {W}), vec {vec}: old "
              f"{times['old']} ms, new {times['new']} ms; grid_sample "
              f"{lib_ms:.4f} ms; bound {bound:.4f} ms")
        del disp, out_old, out_new, ref, grid

    # -- K4 --------------------------------------------------------------
    tl, tracks = 4, 4
    mf = make_track_batch(settings, tl=tl, bs=tracks, seed=20,
                          primary_noise=0.5)
    flow = torch.as_tensor(mf.flow, device=dev)
    src = tuple(j * tracks + n for _, j in _pair_list(tl)
                for n in range(tracks))
    S, M, C = tl * tracks, len(src), 32
    table = kernels._src_table("ab", src, S, M, dev)
    identity = torch.arange(M, dtype=torch.int32, device=dev)
    src_old = table[0]
    rng = np.random.RandomState(11)
    for dt in (torch.bfloat16, torch.float32):
        bf16 = int(dt == torch.bfloat16)
        vpts = (1, 2, 4) if bf16 else (1, 2, 4, 8)
        total: dict = {}
        exact: dict = {}
        for h, w in ((H // 2, W // 2), (H // 4, W // 4)):
            pf = _pair_flows(_resize_flow_grid(flow, h, w))
            feat = torch.as_tensor(rng.randn(S, h, w, C).astype(np.float32),
                                   device=dev).to(dt)
            ref = warp2d_pairs_plain(feat, pf, src)
            outs, variants = {}, {}

            def add(name, fn, a):
                out = torch.full_like(ref, float("nan"))
                outs[name] = out
                variants[name] = lambda: call(fn, *a(out))

            add("old", lib.dis_old_warp2d_pairs_fwd,
                lambda o: (feat.data_ptr(), pf.data_ptr(), src_old.data_ptr(),
                           o.data_ptr(), M, h, w, C, bf16))
            chosen = kernels.pairs_fwd_vpt(C, dt, feat.data_ptr(),
                                           pf.data_ptr(), ref.data_ptr())
            for vpt in vpts:
                add(f"vpt {vpt}", lib.dis_warp2d_pairs_fwd,
                    lambda o, vpt=vpt: (feat.data_ptr(), pf.data_ptr(),
                                        table[0].data_ptr(),
                                        table[1].data_ptr(), o.data_ptr(), M,
                                        h, w, C, bf16, vpt))
            add(f"vpt {chosen}, table order", lib.dis_warp2d_pairs_fwd,
                lambda o: (feat.data_ptr(), pf.data_ptr(), table[0].data_ptr(),
                           identity.data_ptr(), o.data_ptr(), M, h, w, C,
                           bf16, chosen))
            for f in variants.values():
                f()
            torch.cuda.synchronize()
            same = {name: agreement(f"K4 {dt} {h}x{w} {name}", o, ref)
                    for name, o in outs.items()}
            if not all(ok for name, ok in same.items() if name != "old"):
                raise RuntimeError(f"K4 {dt} differs from the plain version")
            exact[f"{h}x{w}"] = same
            times = in_turns(variants)
            srcs = torch.as_tensor(src, device=dev)
            feat_nchw = feat.permute(0, 3, 1, 2).contiguous()
            stacked = feat_nchw.index_select(0, srcs)
            u_s = torch.arange(w, dtype=torch.float32, device=dev)
            v_s = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            grid = chip_smoke.grid_of(pf[..., 0] + u_s,
                                      pf[..., 1] + v_s).to(dt)
            times["grid_sample on the gathered stack"] = [chip_smoke.cuda_ms(
                lambda: F.grid_sample(stacked, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True))]
            times["index_select + grid_sample"] = [chip_smoke.cuda_ms(
                lambda: F.grid_sample(feat_nchw.index_select(0, srcs), grid,
                                      mode="bilinear", padding_mode="zeros",
                                      align_corners=True))]
            # the backward, unchanged but for taps() taking the flow as two
            # floats: old and new in turns, each within chip_smoke's
            # tolerance of the plain version (atomics: no bitwise equality)
            g = torch.as_tensor(rng.randn(M, h, w, C).astype(np.float32),
                                device=dev).to(dt)
            ref_g = warp2d_pairs_bwd_plain(pf, src, g, S).float()
            scratch = torch.empty((S, h, w, C), device=dev)
            grad = torch.empty((S, h, w, C), dtype=dt, device=dev)
            bwd_args = (pf.data_ptr(), table[0].data_ptr(), g.data_ptr(),
                        scratch.data_ptr(), grad.data_ptr(), S, M, h, w, C,
                        bf16)
            for name, fn in (("old", lib.dis_old_warp2d_pairs_bwd),
                             ("new", lib.dis_warp2d_pairs_bwd)):
                variants[f"bwd {name}"] = lambda fn=fn: call(fn, *bwd_args)
                scratch.fill_(float("nan"))
                grad.fill_(float("nan"))
                variants[f"bwd {name}"]()
                if not within(grad if bf16 else scratch, ref_g, bf16):
                    raise RuntimeError(f"K4 bwd {dt} {name} differs from the "
                                       "plain version")
            times.update(in_turns({k: variants[k]
                                   for k in ("bwd old", "bwd new")}))
            for name, t in times.items():
                print(f"[ab] warp2d_pairs {dt} {h}x{w}x{C}: {name} {t} ms")
                acc = total.setdefault(name, [0.0] * len(t))
                total[name] = [a + b for a, b in zip(acc, t)]
            del feat, ref, outs, variants, stacked, feat_nchw, grid, g, \
                ref_g, scratch, grad
        result[f"warp2d_pairs {dt} (both scales)"] = dict(
            total, chosen_vpt=chosen, exact=exact)
        for name, t in total.items():
            print(f"[ab] warp2d_pairs {dt} both scales: {name} "
                  f"{[round(x, 4) for x in t]} ms")
    print(smi)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
