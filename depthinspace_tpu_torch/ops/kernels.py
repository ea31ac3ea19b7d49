"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources have a plain C interface. Each is compiled with ``nvcc`` for
``sm_90a`` into an object file, all of them at once in parallel, and the
objects are linked into one shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The library is built at first
use, from the sources in this checkout only, into ``build/kernels/<hash>/``
at the repository root; the hash covers the sources and the flags, so an
edited source is rebuilt and an unchanged one is not.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else, allocates its output with ``torch.empty``, launches on the
current stream, raises if ``cudaGetLastError()`` is nonzero, and adds one to
its entry of :data:`launches`. Each forward kernel has a backward kernel
beside it; ``ops/census.py`` and ``ops/resample.py`` pair them in
``torch.autograd.Function``s. Nothing here falls back to PyTorch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("census_sad.cu", "xwarp.cu", "warp2d.cu", "warp2d_pairs.cu",
           "threefry.cu")
HEADERS = ("round_fixed.cuh",)   # included by sources; in the library's hash
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# adds the entry points that time K3's and K4's backward against their
# float-atomic versions, or one pass of a call alone, and K1 with the rows a
# warp writes given, to a second library (variant_library)
VARIANT_FLAGS = ("-DDIS_AB_VARIANTS",)

# Launches of each kernel since the last reset_launches(). warp2d_v1_* are
# K3's kernels reached through the K5 entry point (ops/resample.py::
# warp2d_v1), counted on their own.
launches = {"census_sad_fwd": 0, "xwarp_fwd": 0, "warp2d_fwd": 0,
            "warp2d_pairs_fwd": 0, "warp2d_v1_fwd": 0,
            "census_sad_bwd": 0, "xwarp_bwd": 0, "warp2d_bwd": 0,
            "warp2d_pairs_bwd": 0, "warp2d_v1_bwd": 0, "threefry": 0}

_lib = None
# device copies of the static pair tables of warp2d_pairs and their
# source-major orders, per call site
_src_tables: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def library_path(flags: tuple = ()) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / "libdis_kernels.so"


def build(flags: tuple = ()) -> tuple[Path, float]:
    """Compile the library unless it is already built: one ``nvcc -c`` per
    source, all started together, then one link; ``flags`` go to nvcc after
    :data:`NVCC_FLAGS` (:data:`VARIANT_FLAGS` builds the variant library).

    Returns (path, seconds spent compiling; 0.0 when it was built before).
    The compiler's ``-Xptxas -v`` report lands in ``ptxas.log`` beside it."""
    so = library_path(flags)
    if so.exists():
        return so, 0.0
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        obj = so.parent / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / name), "-o",
               str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    tmp = so.with_name(f"libdis_kernels.{tag}.so")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}): "
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    (so.parent / "ptxas.log").write_text("".join(log))
    os.replace(tmp, so)
    return so, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        so, _ = build()
        _lib = bind(ctypes.CDLL(str(so)))
    return _lib


def variant_library() -> ctypes.CDLL:
    """The kernels built with :data:`VARIANT_FLAGS`: the entry points of
    :func:`library` and the ``dis_ab_*`` ones, which also launch K3's and
    K4's backward with the float atomics they had before they became
    deterministic, run one pass of those backwards alone, or run K1 with
    the rows a warp writes given, for timing (scripts/ab_torch_kernels.py,
    chip_smoke.py). No wrapper calls it."""
    so, _ = build(VARIANT_FLAGS)
    return bind_variants(bind(ctypes.CDLL(str(so))))


def bind_variants(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of the ``dis_ab_*`` entry points on lib."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dis_ab_warp2d_bwd.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.dis_ab_warp2d_bwd.restype = i32
    lib.dis_ab_warp2d_pairs_bwd.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.dis_ab_warp2d_pairs_bwd.restype = i32
    f32 = ctypes.c_float
    lib.dis_ab_census_sad_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, f32,
                                          i32, ptr]
    lib.dis_ab_census_sad_fwd.restype = i32
    lib.dis_ab_census_sad_bwd.argtypes = [ptr] * 4 + [i32] * 3 + [f32] * 3 \
        + [i32, ptr]
    lib.dis_ab_census_sad_bwd.restype = i32
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of the entry points of ``csrc/`` on lib."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_longlong, ctypes.c_float)
    lib.dis_census_sad_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, f32,
                                       ptr]
    lib.dis_census_sad_fwd.restype = i32
    lib.dis_xwarp_fwd.argtypes = [ptr, i64, ptr, ptr, i32, i32, i32, i32,
                                  ptr]
    lib.dis_xwarp_fwd.restype = i32
    lib.dis_warp2d_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                   ptr]
    lib.dis_warp2d_fwd.restype = i32
    lib.dis_census_sad_bwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                       f32, f32, f32, ptr]
    lib.dis_census_sad_bwd.restype = i32
    lib.dis_xwarp_bwd.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32,
                                  ptr]
    lib.dis_xwarp_bwd.restype = i32
    lib.dis_warp2d_bwd.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.dis_warp2d_bwd.restype = i32
    lib.dis_warp2d_pairs_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32,
                                         i32, i32, i32, i32, i32, ptr]
    lib.dis_warp2d_pairs_fwd.restype = i32
    lib.dis_warp2d_pairs_bwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.dis_warp2d_pairs_bwd.restype = i32
    lib.dis_warp2d_pairs_bwd_work.argtypes = [i32] * 4
    lib.dis_warp2d_pairs_bwd_work.restype = i64
    u32 = ctypes.c_uint
    lib.dis_threefry_draw.argtypes = [ptr, i64, u32, u32, i64, i64, i64, i32,
                                      i32, f32, f32, f32, ptr]
    lib.dis_threefry_draw.restype = i32
    lib.dis_error_string.argtypes = [i32]
    lib.dis_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, ndim: int,
           dtypes: tuple = (torch.float32,)) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(kernel: str, *tensors: torch.Tensor) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kernel}: tensors on different devices")


def _grid_fits(kernel: str, images: int, rows: int) -> None:
    """The kernels put images and rows on the grid's y and z axes."""
    if images > 65535 or rows > 65535:
        raise ValueError(f"{kernel}: at most 65535 images and 65535 rows "
                         "per call")


def _launch(kernel: str, fn, *args, device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        msg = library().dis_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch: {msg}")
    launches[kernel] += 1


# the kernels' rsqrt flushes denormals: its input d^2 + eps must be normal
FLT_MIN = 2.0 ** -126


def _census_shapes(kernel: str, es: torch.Tensor, ta: torch.Tensor,
                   block_size: int, eps: float) -> tuple[int, int, int]:
    _check("es", es, 3)
    _check("ta", ta, 3)
    _same_device(kernel, es, ta)
    if es.shape != ta.shape:
        raise ValueError(f"{kernel}: shapes {tuple(es.shape)} and "
                         f"{tuple(ta.shape)} differ")
    if block_size != 9:
        raise ValueError(f"{kernel}: the kernel is built for 9x9 blocks")
    if not eps >= FLT_MIN:
        raise ValueError(f"{kernel}: eps must be at least {FLT_MIN:g}, "
                         f"got {eps}")
    N, H, W = es.shape
    _grid_fits(kernel, N, 1)
    return N, H, W


def census_sad_fwd(es: torch.Tensor, ta: torch.Tensor,
                   block_size: int = 9, eps: float = 0.5) -> torch.Tensor:
    """K1: es, ta (N, H, W) float32 -> (N, H, W); each unordered pixel
    pair evaluated once, deterministic (no atomics)."""
    N, H, W = _census_shapes("census_sad_fwd", es, ta, block_size, eps)
    out = torch.empty_like(es)
    if out.numel():
        _launch("census_sad_fwd", library().dis_census_sad_fwd, es.data_ptr(),
                ta.data_ptr(), out.data_ptr(), N, H, W, float(eps),
                device=es.device)
    return out


def census_sad_bwd(es: torch.Tensor, ta: torch.Tensor, g: torch.Tensor,
                   block_size: int = 9, eps: float = 0.5) -> torch.Tensor:
    """K1 bwd: es, ta, g (N, H, W) float32 -> d<g, census_sad(es, ta)>/d es;
    each pixel pair once, deterministic (no atomics: the same bits on every
    call)."""
    N, H, W = _census_shapes("census_sad_bwd", es, ta, block_size, eps)
    _check("g", g, 3)
    _same_device("census_sad_bwd", es, g)
    if g.shape != es.shape:
        raise ValueError(f"census_sad_bwd: g {tuple(g.shape)} does not fit "
                         f"es {tuple(es.shape)}")
    grad = torch.empty_like(es)
    if grad.numel():
        _launch("census_sad_bwd", library().dis_census_sad_bwd, es.data_ptr(),
                ta.data_ptr(), g.data_ptr(), grad.data_ptr(), N, H, W,
                float(eps), float(0.5 * eps), float(1.0 / block_size ** 2),
                device=es.device)
    return grad


def _xwarp_shapes(kernel: str, pattern: torch.Tensor,
                  disp: torch.Tensor) -> tuple[int, int, int, int]:
    """Returns (N, H, W, the pattern's batch stride)."""
    if pattern.dim() not in (2, 3):
        raise ValueError(f"{kernel}: pattern must be (H, W) or (N, H, W), "
                         f"got {tuple(pattern.shape)}")
    _check("pattern", pattern, pattern.dim())
    _check("disp", disp, 3)
    _same_device(kernel, pattern, disp)
    N, H, W = disp.shape
    if pattern.shape[-2:] != (H, W) or (pattern.dim() == 3
                                        and pattern.shape[0] != N):
        raise ValueError(f"{kernel}: pattern {tuple(pattern.shape)} does "
                         f"not fit disp {tuple(disp.shape)}")
    _grid_fits(kernel, N, H)
    return N, H, W, 0 if pattern.dim() == 2 else H * W


XWARP_MAX_W = 12288   # a staged pattern row in 48 KB of shared memory


def xwarp_fwd_vec(W: int, *ptrs: int) -> int:
    """The pixels each item of K2's forward holds: 4 (float4 loads and
    stores) when W % 4 == 0 and every pointer is 16-byte aligned, else 1."""
    return 4 if W % 4 == 0 and not any(p % 16 for p in ptrs) else 1


def xwarp_fwd(pattern: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """K2: pattern (H, W) or (N, H, W), disp (N, H, W) -> (N, H, W)."""
    N, H, W, stride = _xwarp_shapes("xwarp_fwd", pattern, disp)
    if W > XWARP_MAX_W:
        raise ValueError(f"xwarp_fwd: at most {XWARP_MAX_W} columns, got {W}")
    out = torch.empty_like(disp)
    if out.numel():
        ptrs = (pattern.data_ptr(), disp.data_ptr(), out.data_ptr())
        _launch("xwarp_fwd", library().dis_xwarp_fwd, ptrs[0], stride,
                ptrs[1], ptrs[2], N, H, W, xwarp_fwd_vec(W, *ptrs),
                device=disp.device)
    return out


def xwarp_bwd(pattern: torch.Tensor, disp: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """K2 bwd: pattern (H, W) or (N, H, W), disp, g (N, H, W) -> grad wrt
    disp (N, H, W); the pattern gets none."""
    N, H, W, stride = _xwarp_shapes("xwarp_bwd", pattern, disp)
    _check("g", g, 3)
    _same_device("xwarp_bwd", disp, g)
    if g.shape != disp.shape:
        raise ValueError(f"xwarp_bwd: g {tuple(g.shape)} does not fit disp "
                         f"{tuple(disp.shape)}")
    grad = torch.empty_like(disp)
    if grad.numel():
        _launch("xwarp_bwd", library().dis_xwarp_bwd, pattern.data_ptr(),
                stride, disp.data_ptr(), g.data_ptr(), grad.data_ptr(), N, H,
                W, device=disp.device)
    return grad


def _warp2d_shapes(kernel: str, name: str, x: torch.Tensor,
                   flow: torch.Tensor) -> tuple[int, int, int, int]:
    """x is the image (forward) or the output gradient (backward)."""
    _check(name, x, 4)
    _check("flow", flow, 4)
    _same_device(kernel, x, flow)
    M, H, W, C = x.shape
    if tuple(flow.shape) != (M, H, W, 2):
        raise ValueError(f"{kernel}: flow {tuple(flow.shape)} does not fit "
                         f"{name} {tuple(x.shape)}")
    _grid_fits(kernel, M, H)
    return M, H, W, C


# K3's vector forward: C as a template parameter up to this many channels
WARP2D_VEC_MAX_C = 8
# the largest call the vector kernel's 32-bit flat pixel index takes
WARP2D_VEC_MAX_PIXELS = 2 ** 31 - 1025


def warp2d_fwd_path(C: int, pixels: int, flow_ptr: int,
                    out_ptr: int) -> int:
    """Which kernel K3's (and K5's) forward launches for C channels over
    ``pixels`` = M*H*W pixels, as the pixels a thread: 0 is the first design
    (any C), for C > WARP2D_VEC_MAX_C, more than WARP2D_VEC_MAX_PIXELS
    pixels or a flow not 8-byte aligned. Else the vector kernel: two pixels
    a thread for C = 1 where flow and out are 16-byte aligned, else one."""
    if not 1 <= C <= WARP2D_VEC_MAX_C or pixels > WARP2D_VEC_MAX_PIXELS \
            or flow_ptr % 8:
        return 0
    return 2 if C == 1 and flow_ptr % 16 == 0 and out_ptr % 16 == 0 else 1


def _warp2d_fwd(kernel: str, img: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
    M, H, W, C = _warp2d_shapes(kernel, "img", img, flow)
    out = torch.empty_like(img)
    if out.numel():
        ppt = warp2d_fwd_path(C, M * H * W, flow.data_ptr(), out.data_ptr())
        _launch(kernel, library().dis_warp2d_fwd, img.data_ptr(),
                flow.data_ptr(), out.data_ptr(), M, H, W, C, ppt,
                device=img.device)
    return out


# K3's strip backward: C as a template parameter up to this many channels
WARP2D_BWD_STRIP_MAX_C = 8


def warp2d_bwd_path(C: int, H: int, W: int, flow_ptr: int) -> int:
    """Which kernel K3's (and K5's) backward launches for C channels on
    H x W images: 1 is the strip kernel (corners merged in registers; C =
    1..8, a flow 8-byte aligned for its float2 loads, and (H + 2) * (W + 4)
    below 2^31 for its packed corner keys), 0 the first design (any C)."""
    return int(1 <= C <= WARP2D_BWD_STRIP_MAX_C and flow_ptr % 8 == 0
               and (H + 2) * (W + 4) < 2 ** 31)


def fixed_bits(terms: int) -> int:
    """c of K3 backward's fixed-point sum (``csrc/warp2d.cu``): the least
    c >= 1 with 2^c >= ``terms``, the bound on the terms one cell receives
    (H * W: a pixel adds to a cell of its own plane at most once)."""
    return max(1, (terms - 1).bit_length())


def fixed_scratch(cells: int, device) -> torch.Tensor:
    """The fixed-point scratch of K3's backward over ``cells`` elements:
    two int64 words a cell and two more for the call's largest |g|; the
    kernel zeroes it."""
    return torch.empty(2 * cells + 2, dtype=torch.int64, device=device)


def _warp2d_bwd(kernel: str, flow: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    M, H, W, C = _warp2d_shapes(kernel, "g", g, flow)
    grad = torch.empty_like(g)
    if grad.numel():
        c = fixed_bits(H * W)
        if c > 29:   # fixed_sum's three flag bits and 32-bit low part
            raise ValueError(f"{kernel}: at most 2^29 pixels a plane")
        acc = fixed_scratch(grad.numel(), g.device)
        path = warp2d_bwd_path(C, H, W, flow.data_ptr())
        _launch(kernel, library().dis_warp2d_bwd, flow.data_ptr(),
                g.data_ptr(), grad.data_ptr(), acc.data_ptr(), M, H, W, C,
                path, c, device=g.device)
    return grad


def warp2d_fwd(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K3: img (M, H, W, C), flow (M, H, W, 2) float32 -> (M, H, W, C). The
    vector kernel or the first design, as :func:`warp2d_fwd_path` chooses
    by C, size and alignment."""
    return _warp2d_fwd("warp2d_fwd", img, flow)


def warp2d_bwd(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3 bwd: flow (M, H, W, 2), g (M, H, W, C) float32 -> grad wrt img
    (M, H, W, C); the flow gets none. The strip kernel or the first design,
    as :func:`warp2d_bwd_path` chooses by C and alignment, adding into a
    fixed-point scratch: the same bits on every call with the same
    inputs."""
    return _warp2d_bwd("warp2d_bwd", flow, g)


def warp2d_v1_fwd(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K5 (``warp_kernel.warp2d``, the K3 contract in float32): K3's kernel,
    counted as warp2d_v1_fwd."""
    return _warp2d_fwd("warp2d_v1_fwd", img, flow)


def warp2d_v1_bwd(flow: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5 bwd: K3 bwd's kernel, counted as warp2d_v1_bwd."""
    return _warp2d_bwd("warp2d_v1_bwd", flow, g)


_PAIR_TYPES = (torch.float32, torch.bfloat16)
# the channels of one 16-byte vector in K4's vector forward
VEC_CHANNELS = {torch.float32: 4, torch.bfloat16: 8}
# the vectors of a pixel's channels that one thread of it owns: 2 was the
# fastest of 1, 2, 4 and 8 at the DIS-MF shapes in both types
PAIRS_VPT = 2


def pairs_fwd_vpt(C: int, dtype: torch.dtype, feat_ptr: int, flow_ptr: int,
                  out_ptr: int) -> int:
    """Which kernel K4's forward launches: the vectors of a pixel's C
    channels (8 bfloat16 or 4 float32 each) that one thread of the vector
    kernel owns, or 0 for the scalar kernel (one thread per element). The
    vector kernel needs C a multiple of the vector, at most 256 threads a
    pixel, feat and out 16-byte aligned and flow 8-byte aligned; a thread
    owns PAIRS_VPT vectors where C holds a whole number of them, else one."""
    n = VEC_CHANNELS[dtype]
    if C % n or C // n > 256 or (feat_ptr | out_ptr) % 16 or flow_ptr % 8:
        return 0
    return PAIRS_VPT if C % (n * PAIRS_VPT) == 0 else 1


def pairs_bwd_path(C: int, dtype: torch.dtype, g_ptr: int) -> bool:
    """Whether K4's backward sums 4 channels a thread (one 16-byte float32
    or 8-byte bfloat16 load of g a record), else one. 4 needs C a multiple
    of 4 and g aligned to 4 channels (16 bytes in float32, 8 in
    bfloat16)."""
    g_align = 4 * (2 if dtype == torch.bfloat16 else 4)
    return not (C % 4 or g_ptr % g_align)


def source_major_order(src) -> tuple:
    """The pairs grouped by source, sources ascending, in table order
    within a source: the order in which K4's vector kernels run them, so
    the pairs that read (forward) or scatter into (backward) one source
    plane run while it is in L2."""
    return tuple(sorted(range(len(src)), key=lambda m: src[m]))


def _src_table(kernel: str, src_idx, S: int, M: int,
               device: torch.device) -> torch.Tensor:
    """The static pair table and its source-major order (the forward's
    launch order) as an int32 (2, M) tensor on ``device``, checked on the host (0 <= src[m] < S) and
    made once per table and device."""
    key = (tuple(src_idx), device)
    table = _src_tables.get(key)
    if table is None:
        src = key[0]
        if len(src) != M:
            raise ValueError(f"{kernel}: {len(src)} source indices for "
                             f"{M} pairs")
        if not all(isinstance(s, int) and 0 <= s < S for s in src):
            raise ValueError(f"{kernel}: source indices must be ints in "
                             f"[0, {S}), got {src}")
        with torch.inference_mode(False):
            table = torch.tensor([src, source_major_order(src)],
                                 dtype=torch.int32, device=device)
        _src_tables[key] = table
    return table


def _pairs_shapes(kernel: str, name: str, x: torch.Tensor, flow: torch.Tensor,
                  rows: int) -> tuple[int, int, int, int]:
    """x is feat (forward) or the output gradient (backward); ``rows`` is
    its leading size S or M. Returns (M, H, W, C)."""
    _check(name, x, 4, _PAIR_TYPES)
    _check("flow", flow, 4)
    _same_device(kernel, x, flow)
    M = flow.shape[0]
    _, H, W, C = x.shape
    if tuple(flow.shape) != (M, H, W, 2) or x.shape[0] != rows:
        raise ValueError(f"{kernel}: flow {tuple(flow.shape)} does not fit "
                         f"{name} {tuple(x.shape)}")
    _grid_fits(kernel, M, H)
    if W * C >= 2 ** 31 or H * W >= 2 ** 31:
        raise ValueError(f"{kernel}: a row's W*C elements and a plane's H*W "
                         "pixels must fit in int32")
    return M, H, W, C


def warp2d_pairs_fwd(feat: torch.Tensor, flow: torch.Tensor,
                     src_idx) -> torch.Tensor:
    """K4: out[m] = warp(feat[src_idx[m]], flow[m]). feat (S, H, W, C)
    float32 or bfloat16, flow (M, H, W, 2) float32, src_idx a sequence of M
    ints in [0, S) -> (M, H, W, C) in feat's dtype. The vector kernel or the
    scalar one, as :func:`pairs_fwd_vpt` chooses by shape and alignment;
    both count as warp2d_pairs_fwd."""
    S = feat.shape[0] if feat.dim() == 4 else 0
    M, H, W, C = _pairs_shapes("warp2d_pairs_fwd", "feat", feat, flow, S)
    table = _src_table("warp2d_pairs_fwd", src_idx, S, M, feat.device)
    out = torch.empty((M, H, W, C), dtype=feat.dtype, device=feat.device)
    if out.numel():
        vpt = pairs_fwd_vpt(C, feat.dtype, feat.data_ptr(), flow.data_ptr(),
                            out.data_ptr())
        _launch("warp2d_pairs_fwd", library().dis_warp2d_pairs_fwd,
                feat.data_ptr(), flow.data_ptr(), table[0].data_ptr(),
                table[1].data_ptr(), out.data_ptr(), M, H, W, C,
                int(feat.dtype == torch.bfloat16), vpt, device=feat.device)
    return out


def pairs_bwd_work(S: int, M: int, H: int, W: int, device) -> torch.Tensor:
    """K4 backward's workspace (the cells' counts and first records, the
    records): int64 words, as many as the library asks for; the kernel
    zeroes what it needs."""
    nbytes = library().dis_warp2d_pairs_bwd_work(S, M, H, W)
    return torch.empty(nbytes // 8, dtype=torch.int64, device=device)


def warp2d_pairs_bwd(flow: torch.Tensor, src_idx, g: torch.Tensor,
                     S: int) -> torch.Tensor:
    """K4 bwd: flow (M, H, W, 2) float32, g (M, H, W, C) float32 or
    bfloat16 -> grad wrt feat (S, H, W, C) in g's dtype; the flow gets
    none. Each cell sums the terms it receives from every pair of its
    source as integers and rounds once (the same bits on every call with
    the same inputs), 4 channels a thread or one, as
    :func:`pairs_bwd_path` chooses by C and alignment."""
    M, H, W, C = _pairs_shapes("warp2d_pairs_bwd", "g", g, flow,
                               flow.shape[0] if flow.dim() == 4 else -1)
    table = _src_table("warp2d_pairs_bwd", src_idx, S, M, g.device)
    if 4 * M * H * W >= 2 ** 31:
        raise ValueError("warp2d_pairs_bwd: 4 * M * H * W must fit in int32")
    grad = torch.empty((S, H, W, C), dtype=g.dtype, device=g.device)
    if grad.numel():
        work = pairs_bwd_work(S, M, H, W, g.device)
        _launch("warp2d_pairs_bwd", library().dis_warp2d_pairs_bwd,
                flow.data_ptr(), table[0].data_ptr(), g.data_ptr(),
                work.data_ptr(), grad.data_ptr(), S, M, H, W, C,
                int(g.dtype == torch.bfloat16),
                int(pairs_bwd_path(C, g.dtype, g.data_ptr())),
                device=g.device)
    return grad


_TRANSFORMS = {"uniform": 0, "normal": 1, "bits": 2}


def threefry_draw(key, shape: tuple, transform: str,
                  dtype: torch.dtype = torch.float32, minval: float = 0.0,
                  maxval: float = 1.0, *, device, run: int, stride: int = 0,
                  offset: int = 0) -> torch.Tensor:
    """``utils/jrandom.py``'s uniform (minval, maxval) or normal draws from
    the threefry key ``key`` (two uint32 words) at the flat indices
    ``offset + (i // run) * stride + i % run`` of the draw, i < count =
    prod(shape); float32 or bfloat16 (jax's 16-bit path), shaped
    ``shape``, on the CUDA ``device``; ``transform="bits"``: the 32 random
    bits as int32 (``dtype`` ignored). One launch."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"threefry_draw: expected a CUDA device, got "
                         f"{device}")
    if transform not in _TRANSFORMS:
        raise ValueError(f"threefry_draw: transform 'uniform', 'normal' or "
                         f"'bits', got {transform!r}")
    if transform == "bits":
        dtype = torch.int32
    elif dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"threefry_draw: float32 or bfloat16, got {dtype}")
    count = 1
    for d in shape:
        count *= int(d)
    if run <= 0 or stride < 0 or offset < 0:
        raise ValueError(f"threefry_draw: run {run}, stride {stride}, "
                         f"offset {offset}")
    out = torch.empty(shape, dtype=dtype, device=device)
    if transform == "bits":
        lo = hi = torch.zeros(())
    elif transform == "normal":
        one = torch.tensor(1.0, dtype=dtype)
        lo = torch.nextafter(-one, torch.zeros((), dtype=dtype))
        hi = one
    else:
        lo = torch.tensor(minval, dtype=dtype)
        hi = torch.tensor(maxval, dtype=dtype)
    scale = hi - lo                   # rounded to dtype, as the plain version
    sqrt2 = torch.tensor(float(np.float32(np.sqrt(2.0))),
                         dtype=torch.float32 if transform == "bits" else dtype)
    if count:
        _launch("threefry", library().dis_threefry_draw, out.data_ptr(),
                count, int(key[0]), int(key[1]), run, stride, offset,
                _TRANSFORMS[transform], int(dtype == torch.bfloat16),
                float(lo), float(scale), float(sqrt2), device=out.device)
    return out
