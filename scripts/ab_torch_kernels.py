#!/usr/bin/env python3
"""K3/K5 forward and K4 backward of the PyTorch port against an older
version of their CUDA sources, on one NVIDIA card, measured in turns.

    mkdir -p build/old && git archive <commit> depthinspace_tpu_torch/csrc \\
        | tar -x -C build/old
    python3 scripts/ab_torch_kernels.py \\
        --old build/old/depthinspace_tpu_torch/csrc --out build/ab.json

Builds this checkout's kernels (``depthinspace_tpu_torch/csrc``, with
``kernels.VARIANT_FLAGS``: the variants that lost, and the ``dis_ab_*``
entry points that reach them) and the older ``warp2d.cu`` and
``warp2d_pairs.cu`` (the interface they had before K3's forward took a path
and K4's backward an order table and a path) with nvcc into one library
under ``build/ab/``. Every
variant is checked against the plain version before any time is printed:
K3's forward bit for bit, K4's backward within chip_smoke.py's tolerance
(float atomics). Then each variant is timed at the main paths' shapes,
first in the listed order and then in reverse (old, new, ..., new, old),
each time as ``chip_smoke.cuda_ms`` times a kernel (median of 25, each call
queued behind a device sleep):

- K3's forward on the rigid flows of synthetic batches: the SF geometric
  loss's C = 1 and C = 3 at (24, 512, 432), the MF loss's (and K5's) C = 1
  and C = 5 at (48, 512, 432), FuseNet's geometry warp C = 5 at
  (48, 256, 216): the old kernel, the first design as this checkout builds
  it, and the vector kernel with 1, 2 and 4 pixels a thread (C = 1) or with
  direct and staged stores (C >= 2);
- K4's backward at the DIS-MF train step's shapes (S = 16, M = 48, 32
  channels, at 256x216 and 128x108, summed) in bfloat16 and float32: the
  old kernel, the scalar scatter, the vector scatter with 1 and 2 vectors a
  thread of 1, 2, 4 and 8 pixels in source-major order and some of them in
  table order; then the chosen path's zeroing, scatter and cast, each
  alone.

The yardstick (F.grid_sample; for K4 grid_sample's backward on the gathered
stack) is timed once. Prints one line a measurement, the card's name and
power limit, and last one JSON object (also written to ``--out``).
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
OLD_SOURCES = ("warp2d.cu", "warp2d_pairs.cu")
OLD_ENTRIES = ("dis_warp2d_fwd", "dis_warp2d_bwd", "dis_warp2d_pairs_fwd",
               "dis_warp2d_pairs_bwd")
# dis_ab_warp2d_pairs_bwd's parts: each alone, or all (the whole call)
PARTS = {"zeroing": 1, "scatter": 2, "cast": 4}
ALL = 7


def build_ab(old_csrc: Path, kernels) -> ctypes.CDLL:
    """One library of this checkout's kernels and the older warp2d.cu and
    warp2d_pairs.cu, whose entry points are renamed dis_old_* (one library,
    so no entry point or kernel is defined twice in the process)."""
    renames = [f"-D{n}=dis_old_{n[4:]}" for n in OLD_ENTRIES]
    jobs = [(kernels.CSRC / n, n, list(kernels.VARIANT_FLAGS))
            for n in kernels.SOURCES]
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
    lib = kernels.bind_variants(kernels.bind(ctypes.CDLL(str(so))))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dis_old_warp2d_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
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


def k3_forward(lib, kernels, dev, sf_flow, mf_flow) -> dict:
    """K3's forward, old and every new variant, at the main paths' calls."""
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

        add("old", lib.dis_old_warp2d_fwd)
        add("first design", lib.dis_warp2d_fwd, 0)
        for ppt, staged in (((1, 0), (2, 0), (4, 0)) if C == 1
                            else ((1, 0), (1, 1))):
            add(f"vector, {ppt} px a thread" if C == 1 else
                f"vector, {'staged' if staged else 'direct'} stores",
                lib.dis_ab_warp2d_fwd, ppt, staged)
        for f in variants.values():
            f()
        torch.cuda.synchronize()
        same = {name: agreement(f"K3 {label} C={C} {name}", o, ref)
                for name, o in outs.items()}
        if not all(same.values()):
            raise RuntimeError(f"K3 {label} C={C} differs from the plain "
                               "version")
        chosen = kernels.warp2d_fwd_path(C, M * h * w, flow.data_ptr(),
                                         ref.data_ptr())
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


def k4_backward(lib, kernels, dev, mf_flow) -> dict:
    """K4's backward, old and every new variant, at the DIS-MF shapes."""
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
    identity = torch.arange(M, dtype=torch.int32, device=dev)
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
            scratch = torch.empty((S, h, w, C), device=dev)
            grad = torch.empty((S, h, w, C), dtype=dt, device=dev)
            # the wrapper's vector scatter: 1 vector a thread, 8 pixels
            chosen = (1, 8) if kernels.pairs_bwd_path(
                C, dt, g.data_ptr(), pf.data_ptr(), scratch.data_ptr()) \
                else (0, 0)
            grad_ptr = grad.data_ptr() if bf16 else None
            common = (pf.data_ptr(), table[0].data_ptr())
            variants = {"old": lambda: call(
                lib.dis_old_warp2d_pairs_bwd, *common, g.data_ptr(),
                scratch.data_ptr(), grad_ptr, S, M, h, w, C, bf16)}

            def new(path, order, parts=ALL):
                return lambda: call(lib.dis_ab_warp2d_pairs_bwd, *common,
                                    order.data_ptr(), g.data_ptr(),
                                    scratch.data_ptr(), grad_ptr, S, M, h, w,
                                    C, bf16, *path, parts)

            variants["scalar"] = new((0, 0), table[1])
            for vpt in (1, 2):
                for px in (1, 2, 4, 8):
                    variants[f"vpt {vpt} px {px}"] = new((vpt, px), table[1])
            for vpt, px in sorted({(1, 1), (2, 1), chosen}):
                variants[f"vpt {vpt} px {px}, table order"] = new(
                    (vpt, px), identity)
            for name, f in variants.items():
                scratch.fill_(float("nan"))
                grad.fill_(float("nan"))
                f()
                torch.cuda.synchronize()
                if not within(grad if bf16 else scratch, ref, bf16):
                    raise RuntimeError(f"K4 bwd {dt} {h}x{w} {name} differs "
                                       "from the plain version")
            times = in_turns(variants)
            # the chosen path's parts, each alone (the scatter adds onto
            # the scratch as it stands: the time does not depend on it)
            for part, bit in PARTS.items():
                if part == "cast" and not bf16:
                    continue
                times[f"chosen {part} alone"] = [chip_smoke.cuda_ms(
                    new(chosen, table[1], bit))]
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
                acc = total.setdefault(name, [0.0] * len(t))
                total[name] = [a + b for a, b in zip(acc, t)]
            del g, ref, scratch, grad, variants, stacked, grid, g_nchw
        result[f"warp2d_pairs_bwd {dt} (both scales)"] = dict(
            total, chosen_vpt_px=list(chosen))
        for name, t in total.items():
            print(f"[ab] warp2d_pairs_bwd {dt} both scales: {name} "
                  f"{[round(x, 4) for x in t]} ms")
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the older warp2d.cu, warp2d_pairs.cu")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()

    import torch
    from depthinspace_tpu_torch.data import make_settings, make_track_batch
    from depthinspace_tpu_torch.device import require_cuda
    from depthinspace_tpu_torch.ops import kernels

    dev = require_cuda()
    smi = chip_smoke.smi_name_power()
    print(smi)
    lib = build_ab(args.old, kernels)
    settings = make_settings(H, W)
    sf_flow = torch.as_tensor(make_track_batch(settings, tl=TL, bs=2,
                                               seed=0).flow, device=dev)
    mf_flow = torch.as_tensor(make_track_batch(settings, tl=TL, bs=4, seed=20,
                                               primary_noise=0.5).flow,
                              device=dev)
    result = {"card": smi}
    result.update(k3_forward(lib, kernels, dev, sf_flow, mf_flow))
    result.update(k4_backward(lib, kernels, dev, mf_flow))
    print(smi)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
