#!/usr/bin/env python3
"""K1 forward and backward, K3/K5 forward and backward and K4 backward of
the PyTorch port against an older version of their CUDA sources, on one
NVIDIA card, measured in turns.

    mkdir -p build/old && git archive <commit> depthinspace_tpu_torch/csrc \\
        | tar -x -C build/old
    python3 scripts/ab_torch_kernels.py --kernels k1 \\
        --old build/old/depthinspace_tpu_torch/csrc --out build/ab.json

Builds this checkout's kernels (``depthinspace_tpu_torch/csrc``, with
``kernels.VARIANT_FLAGS``: the ``dis_ab_*`` entry points, which also run
K3's and K4's backward with the float atomics they had before they became
deterministic, or one pass of a call alone) and the older sources of the
chosen kernels (``--kernels``, a comma list of k1, k3, k4) with nvcc into
one library under ``build/ab/``, the older entry points renamed
``dis_old_*``: k1 takes the older ``census_sad.cu`` (any version with the
forward and the backward: their C interface has not changed), k3 the older
``warp2d.cu`` and k4 the older ``warp2d_pairs.cu``, each with the interface
their backwards took when they became deterministic (K3's: the fixed-point
scratch after grad, c after the path; K4's: no order table, a workspace
sized by ``dis_warp2d_pairs_bwd_work``). Every variant is checked against the plain
version before any time is printed: K1, K1 bwd and K3 bwd within
chip_smoke.py's 1e-5, K3's forward bit for bit, K4's backward within
chip_smoke.py's tolerance. Then each variant is timed at the main paths'
shapes, first in the listed order and then in reverse (old, new, ..., new,
old), each time as ``chip_smoke.cuda_ms`` times a kernel (median of 25, each
call queued behind a device sleep):

- K1 and K1 bwd at the SF eval step's (8, 512, 432) and the SF train
  step's (32, 512, 432): the old kernel and this checkout's, as its entry
  point chooses the rows a warp writes and with 16, 32 and 64 rows;
- K3's forward on the rigid flows of synthetic batches: the SF geometric
  loss's C = 1 and C = 3 at (24, 512, 432), the MF loss's (and K5's) C = 1
  and C = 5 at (48, 512, 432), FuseNet's geometry warp C = 5 at
  (48, 256, 216): the old kernel, the first design and the entry point's
  choice;
- K3's (and K5's) backward, C = 1, on the rigid flows of the SF train
  step (96, 512, 432) and the MF step and K5 (48, 512, 432), and on a
  random flow of +-4 px at (96, 512, 432): the old kernel, the entry point
  (the strip kernel), the first design and the float-atomic strip
  kernel; then the entry point's zeroing, largest |g|, scatter and writing,
  each alone;
- K4's backward at the DIS-MF train step's shapes (S = 16, M = 48, 32
  channels, at 256x216 and 128x108, summed) in bfloat16 and float32: the
  old kernel, the entry point (summed by destination, 4 channels a
  thread), one channel a thread and the float-atomic vector scatter;
  then the entry point's passes (the call cut after each, and the sums
  alone).

The yardstick (F.grid_sample or its backward; for K4 grid_sample's backward
on the gathered stack) is timed once; K1 has none. Prints one line a measurement, the card's
name and power limit, and last one JSON object (also written to ``--out``).
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

import chip_smoke  # noqa: E402  (cuda_ms, grid_of, bound_ms, smi_name_power)

H, W = 512, 432
TL = 4
# the older source each section builds, and its entry points (renamed
# dis_old_*)
OLD_SOURCES = {
    "k1": ("census_sad.cu", ("dis_census_sad_fwd", "dis_census_sad_bwd",
                             "dis_error_string")),
    "k3": ("warp2d.cu", ("dis_warp2d_fwd", "dis_warp2d_bwd")),
    "k4": ("warp2d_pairs.cu", ("dis_warp2d_pairs_fwd",
                               "dis_warp2d_pairs_bwd",
                               "dis_warp2d_pairs_bwd_work")),
}
# the passes of K3's backward (dis_ab_warp2d_bwd's parts), each alone
PARTS = {"zeroing": 1, "largest |g|": 2, "scatter": 4, "writing": 8}


def build_ab(old_csrc: Path, kernels, sections) -> ctypes.CDLL:
    """One library of this checkout's kernels and the older sources of the
    chosen sections, whose entry points are renamed dis_old_* (one library,
    so no entry point or kernel is defined twice in the process)."""
    jobs = [(kernels.CSRC / n, n, list(kernels.VARIANT_FLAGS))
            for n in kernels.SOURCES]
    for sec in sections:
        name, entries = OLD_SOURCES[sec]
        jobs.append((old_csrc / name, f"old_{name}",
                     [f"-D{e}=dis_old_{e[4:]}" for e in entries]))
    digest = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for path, name, extra in jobs:
        digest.update(name.encode() + " ".join(extra).encode())
        digest.update(path.read_bytes())
    for name in kernels.HEADERS:
        digest.update((kernels.CSRC / name).read_bytes())
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
    lib = kernels.bind_variants(kernels.bind(ctypes.CDLL(str(so))))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if "k1" in sections:
        lib.dis_old_census_sad_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                               f32, ptr]
        lib.dis_old_census_sad_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                               i32, f32, f32, f32, ptr]
    if "k3" in sections:
        lib.dis_old_warp2d_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                           i32, ptr]
        lib.dis_old_warp2d_bwd.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    if "k4" in sections:
        lib.dis_old_warp2d_pairs_bwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.dis_old_warp2d_pairs_bwd_work.argtypes = [i32] * 4
        lib.dis_old_warp2d_pairs_bwd_work.restype = ctypes.c_longlong
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


def k1(lib, dev) -> dict:
    """K1 and K1 bwd, old and new, at the SF eval and train shapes."""
    import torch
    from depthinspace_tpu_torch.ops.census import (census_sad_bwd_plain,
                                                   census_sad_plain)

    eps, tol = 0.5, chip_smoke.TOL["census_sad_fwd"]
    result = {}
    for n in (8, 32):
        rng = np.random.RandomState(n)
        es, ta, g = (torch.as_tensor(rng.randn(n, H, W).astype(np.float32),
                                     device=dev) for _ in range(3))
        ptrs = (es.data_ptr(), ta.data_ptr())
        pairs = chip_smoke.census_pairs(es.shape)
        for kind in ("fwd", "bwd"):
            key = f"census_sad_{kind} ({n}, {H}, {W})"
            out = torch.empty_like(es)
            if kind == "fwd":
                ref = census_sad_plain(es, ta)
                args = (*ptrs, out.data_ptr(), n, H, W, eps)
                bound = chip_smoke.bound_ms(3 * 4 * es.numel(),
                                            flops=12 * pairs,
                                            rsqrts=2 * pairs)
            else:
                ref = census_sad_bwd_plain(es, ta, g)
                args = (*ptrs, g.data_ptr(), out.data_ptr(), n, H, W, eps,
                        0.5 * eps, 1.0 / 81)
                bound = chip_smoke.bound_ms(4 * 4 * es.numel(),
                                            flops=16 * pairs,
                                            rsqrts=2 * pairs)
            variants = {
                "old": lambda f=getattr(lib, f"dis_old_census_sad_{kind}"):
                    call(f, *args),
                "new": lambda f=getattr(lib, f"dis_census_sad_{kind}"):
                    call(f, *args)}
            # the rows a warp writes (the new entry point chooses 32 at
            # N = 8 and 64 at N = 32)
            for rows in (16, 32, 64):
                variants[f"new, {rows} rows"] = (
                    lambda f=getattr(lib, f"dis_ab_census_sad_{kind}"),
                    rows=rows: call(f, *args, rows))
            errs = {}
            for name, f in variants.items():
                out.fill_(float("nan"))
                f()
                torch.cuda.synchronize()
                errs[name] = float((out - ref).abs().max())
                if not errs[name] <= tol:
                    raise RuntimeError(f"{key} {name} differs from the plain "
                                       f"version: {errs[name]}")
            times = in_turns(variants)
            result[key] = dict(times, max_abs_err=errs, bound_ms=bound[0],
                               bound_by=bound[1])
            for name, t in times.items():
                print(f"[ab] {key}: {name} {[round(x, 4) for x in t]} ms "
                      f"(max|kernel-plain| {errs[name]:.3g})")
            print(f"[ab] {key}: bound {bound[0]:.4f} ms ({bound[1]})")
        del es, ta, g, out, ref
    return result


def k3_forward(lib, kernels, dev, sf_flow, mf_flow) -> dict:
    """K3's forward, old and new, at the main paths' calls."""
    import torch
    import torch.nn.functional as F
    from depthinspace_tpu_torch.losses.geometric import _ordered_directions
    from depthinspace_tpu_torch.models.fusenet import (_pair_flows,
                                                       _resize_flow_grid)
    from depthinspace_tpu_torch.ops.resample import warp2d_plain

    dirs = _ordered_directions(TL)
    f_sf = torch.cat([sf_flow[a, b] for a, b in dirs]).contiguous()
    f_mf = torch.cat([mf_flow[a, b] for a, b in dirs]).contiguous()
    f_fuse = _pair_flows(_resize_flow_grid(mf_flow, H // 2, W // 2))
    calls = [("SF loss", f_sf, 1), ("SF loss", f_sf, 3),
             ("MF loss, K5", f_mf, 1), ("MF loss", f_mf, 5),
             ("FuseNet geometry", f_fuse, 5)]
    rng = np.random.RandomState(31)
    result = {}
    for label, flow, C in calls:
        M, h, w = flow.shape[:3]
        img = torch.as_tensor(rng.rand(M, h, w, C).astype(np.float32),
                              device=dev)
        ref = warp2d_plain(img, flow)
        args = (img.data_ptr(), flow.data_ptr())
        outs, variants = {}, {}

        def add(name, fn, *extra):
            out = torch.full_like(ref, float("nan"))
            outs[name] = out
            variants[name] = lambda: call(fn, *args, out.data_ptr(), M, h, w,
                                          C, *extra)

        chosen = kernels.warp2d_fwd_path(C, M * h * w, flow.data_ptr(),
                                         ref.data_ptr())
        add("old", lib.dis_old_warp2d_fwd, chosen)
        add("first design", lib.dis_warp2d_fwd, 0)
        add(f"entry point, {chosen} px a thread", lib.dis_warp2d_fwd, chosen)
        for f in variants.values():
            f()
        torch.cuda.synchronize()
        same = {name: agreement(f"K3 {label} C={C} {name}", o, ref)
                for name, o in outs.items()}
        if not all(same.values()):
            raise RuntimeError(f"K3 {label} C={C} differs from the plain "
                               "version")
        times = in_turns(variants)
        u = torch.arange(w, dtype=torch.float32, device=dev)
        v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        grid = chip_smoke.grid_of(flow[..., 0] + u, flow[..., 1] + v)
        nchw = img.permute(0, 3, 1, 2).contiguous()
        times["grid_sample"] = [chip_smoke.cuda_ms(lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True))]
        bound = chip_smoke.bound_ms(4 * M * h * w * (2 + 2 * C))[0]
        key = f"warp2d_fwd {label} ({M}, {h}, {w}, {C})"
        result[key] = dict(times, chosen_ppt=chosen, bound_ms=bound,
                           exact=same)
        for name, t in times.items():
            print(f"[ab] {key}: {name} {[round(x, 4) for x in t]} ms")
        print(f"[ab] {key}: chosen: {chosen} px a thread; bound "
              f"{bound:.4f} ms")
        del img, ref, outs, variants, grid, nchw
    return result


def k3_backward(lib, kernels, dev, sf_flow, mf_flow) -> dict:
    """K3's backward (C = 1), old and new, at the SF and MF train steps'
    calls, on their rigid flows and on a random one."""
    import torch
    from depthinspace_tpu_torch.losses.geometric import _ordered_directions
    from depthinspace_tpu_torch.ops.resample import warp2d_bwd_plain

    gs_bwd = torch.ops.aten.grid_sampler_2d_backward
    dirs = _ordered_directions(TL)
    f_sf = torch.cat([sf_flow[a, b] for a, b in dirs])
    f_sf = f_sf.repeat(96 // f_sf.shape[0], 1, 1, 1).contiguous()
    f_mf = torch.cat([mf_flow[a, b] for a, b in dirs]).contiguous()
    rng = np.random.RandomState(32)
    f_rand = torch.as_tensor(rng.uniform(-4.0, 4.0, f_sf.shape).astype(
        np.float32), device=dev)
    tol = chip_smoke.TOL["warp2d_bwd"]
    result = {}
    for label, flow in (("SF train step, rigid flow", f_sf),
                        ("MF train step and K5, rigid flow", f_mf),
                        ("random +-4 px flow", f_rand)):
        M, h, w = flow.shape[:3]
        g = torch.as_tensor(rng.randn(M, h, w, 1).astype(np.float32),
                            device=dev)
        ref = warp2d_bwd_plain(flow, g)
        grad = torch.empty_like(g)
        acc = kernels.fixed_scratch(g.numel(), dev)
        chosen = kernels.warp2d_bwd_path(1, h, w, flow.data_ptr())
        c = kernels.fixed_bits(h * w)
        args = (flow.data_ptr(), g.data_ptr(), grad.data_ptr(),
                acc.data_ptr(), M, h, w, 1)

        def ab(path, atomic=0, parts=15):
            return lambda: call(lib.dis_ab_warp2d_bwd, *args, path, c,
                                atomic, parts)

        variants = {
            "old": lambda: call(lib.dis_old_warp2d_bwd, *args, chosen, c),
            "entry point": lambda: call(lib.dis_warp2d_bwd, *args, chosen,
                                        c),
            "first design": ab(0),
            "strip kernel, float atomics": ab(1, atomic=1)}
        errs = {}
        for name, f in variants.items():
            grad.fill_(float("nan"))
            f()
            torch.cuda.synchronize()
            errs[name] = float((grad - ref).abs().max())
            if not errs[name] <= tol:
                raise RuntimeError(f"K3 bwd {label} {name} differs from the "
                                   f"plain version: {errs[name]}")
        times = in_turns(variants)
        for part, bits in PARTS.items():
            times[f"entry point, {part} alone"] = [chip_smoke.cuda_ms(
                ab(chosen, parts=bits))]
        u = torch.arange(w, dtype=torch.float32, device=dev)
        v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        grid = chip_smoke.grid_of(flow[..., 0] + u, flow[..., 1] + v)
        g_n, img_n = g.permute(0, 3, 1, 2), torch.zeros_like(g).permute(
            0, 3, 1, 2)
        times["grid_sample bwd"] = [chip_smoke.cuda_ms(lambda: gs_bwd(
            g_n, img_n, grid, 0, 0, True, [True, False]))]
        bound = chip_smoke.bound_ms(4 * M * h * w * (2 + 1 + 1))[0]
        key = f"warp2d_bwd {label} ({M}, {h}, {w}, 1)"
        result[key] = dict(times, chosen_path=chosen, bound_ms=bound,
                           max_abs_err=errs)
        for name, t in times.items():
            print(f"[ab] {key}: {name} {[round(x, 4) for x in t]} ms"
                  + (f" (max|kernel-plain| {errs[name]:.3g})"
                     if name in errs else ""))
        print(f"[ab] {key}: chosen path {chosen}; bound {bound:.4f} ms")
        del g, ref, grad, acc, grid, g_n, img_n, variants
    return result


def k4_backward(lib, kernels, dev, mf_flow) -> dict:
    """K4's backward, old and new, at the DIS-MF shapes."""
    import torch
    from depthinspace_tpu_torch.models.fusenet import (_pair_flows,
                                                       _pair_list,
                                                       _resize_flow_grid)
    from depthinspace_tpu_torch.ops.resample import warp2d_pairs_bwd_plain

    gs_bwd = torch.ops.aten.grid_sampler_2d_backward
    tracks = mf_flow.shape[2]
    src = tuple(j * tracks + n for _, j in _pair_list(TL)
                for n in range(tracks))
    S, M, C = TL * tracks, len(src), 32
    table = kernels._src_table("ab", src, S, M, dev)
    rng = np.random.RandomState(12)
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        bf16 = int(dt == torch.bfloat16)
        total: dict = {}
        for h, w in ((H // 2, W // 2), (H // 4, W // 4)):
            pf = _pair_flows(_resize_flow_grid(mf_flow, h, w))
            g = torch.as_tensor(rng.randn(M, h, w, C).astype(np.float32),
                                device=dev).to(dt)
            ref = warp2d_pairs_bwd_plain(pf, src, g, S).float()
            # this checkout's workspace, the older one's and float atomics' float32
            # scratch in one
            work = torch.empty(max(
                kernels.pairs_bwd_work(S, M, h, w, dev).numel(),
                lib.dis_old_warp2d_pairs_bwd_work(S, M, h, w) // 8,
                (S * h * w * C + 1) // 2), dtype=torch.int64, device=dev)
            grad = torch.empty((S, h, w, C), dtype=dt, device=dev)
            vector = int(kernels.pairs_bwd_path(C, dt, g.data_ptr()))
            common = (pf.data_ptr(), table[0].data_ptr())
            sizes = (S, M, h, w, C, bf16, vector)

            def new(vec=vector, atomic=0, parts=31):
                return lambda: call(lib.dis_ab_warp2d_pairs_bwd, *common,
                                    table[1].data_ptr(), g.data_ptr(),
                                    work.data_ptr(), grad.data_ptr(),
                                    *sizes[:-1], vec, atomic, parts)

            variants = {
                "old": lambda: call(lib.dis_old_warp2d_pairs_bwd, *common,
                                    g.data_ptr(), work.data_ptr(),
                                    grad.data_ptr(), *sizes),
                "entry point": lambda: call(lib.dis_warp2d_pairs_bwd,
                                            *common, g.data_ptr(),
                                            work.data_ptr(), grad.data_ptr(),
                                            *sizes),
                "one channel a thread": new(vec=0),
                "vector scatter, float atomics": new(atomic=1)}
            for name, f in variants.items():
                work.fill_(-1)
                grad.fill_(float("nan"))
                f()
                torch.cuda.synchronize()
                # float atomics' float32 result is their scratch
                out = grad if bf16 or "atomics" not in name else \
                    work.view(torch.float32)[:grad.numel()].view(grad.shape)
                if not within(out, ref, bf16):
                    raise RuntimeError(f"K4 bwd {dt} {h}x{w} {name} differs "
                                       "from the plain version")
            times = in_turns(variants)
            # the passes: the call cut after each (every cut starts from the
            # zeroing, so the counts stay valid), and the sums alone
            cut = {p: chip_smoke.cuda_ms(new(parts=p)) for p in (1, 3, 7, 15)}
            for part, t in (("zeroing", cut[1]), ("count", cut[3] - cut[1]),
                            ("scan", cut[7] - cut[3]),
                            ("place", cut[15] - cut[7]),
                            ("sum", chip_smoke.cuda_ms(new(parts=16)))):
                times[f"entry point, {part}"] = [t]
            srcs = torch.as_tensor(src, device=dev)
            stacked = torch.zeros((S, C, h, w), dtype=dt,
                                  device=dev).index_select(0, srcs)
            u_s = torch.arange(w, dtype=torch.float32, device=dev)
            v_s = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
            grid = chip_smoke.grid_of(pf[..., 0] + u_s,
                                      pf[..., 1] + v_s).to(dt)
            g_nchw = g.permute(0, 3, 1, 2).contiguous()
            times["grid_sample bwd on the gathered stack"] = [
                chip_smoke.cuda_ms(lambda: gs_bwd(g_nchw, stacked, grid, 0, 0,
                                                  True, [True, False]))]
            for name, t in times.items():
                print(f"[ab] warp2d_pairs_bwd {dt} {h}x{w}x{C}: {name} "
                      f"{[round(x, 4) for x in t]} ms")
                got = total.setdefault(name, [0.0] * len(t))
                total[name] = [a + b for a, b in zip(got, t)]
            del g, ref, work, grad, variants, stacked, grid, g_nchw
        result[f"warp2d_pairs_bwd {dt} (both scales)"] = dict(
            total, vector=bool(vector))
        for name, t in total.items():
            print(f"[ab] warp2d_pairs_bwd {dt} both scales: {name} "
                  f"{[round(x, 4) for x in t]} ms")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the older sources of the chosen "
                         "kernels")
    ap.add_argument("--kernels", default="k1,k3,k4",
                    help="comma list of k1, k3, k4 (default: all)")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    sections = args.kernels.split(",")
    if not sections or set(sections) - set(OLD_SOURCES):
        ap.error(f"--kernels: a comma list of {', '.join(OLD_SOURCES)}")

    import torch
    from depthinspace_tpu_torch.data import make_settings, make_track_batch
    from depthinspace_tpu_torch.device import require_cuda
    from depthinspace_tpu_torch.ops import kernels

    dev = require_cuda()
    smi = chip_smoke.smi_name_power()
    print(smi)
    lib = build_ab(args.old, kernels, sections)
    result = {"card": smi}
    if "k1" in sections:
        result.update(k1(lib, dev))
    if "k3" in sections or "k4" in sections:
        settings = make_settings(H, W)
        mf_flow = torch.as_tensor(make_track_batch(
            settings, tl=TL, bs=4, seed=20, primary_noise=0.5).flow,
            device=dev)
    if "k3" in sections:
        sf_flow = torch.as_tensor(make_track_batch(settings, tl=TL, bs=2,
                                                   seed=0).flow, device=dev)
        result.update(k3_forward(lib, kernels, dev, sf_flow, mf_flow))
        result.update(k3_backward(lib, kernels, dev, sf_flow, mf_flow))
    if "k4" in sections:
        result.update(k4_backward(lib, kernels, dev, mf_flow))
    print(smi)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
