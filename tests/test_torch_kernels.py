"""The CUDA kernels of depthinspace_tpu_torch against their plain PyTorch
versions, on the card, forward and backward, and each backward kernel
against finite differences of the plain forward in float64. Every test here
needs an NVIDIA card and skips without one. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_kernels.py -q --noconftest
"""
import numpy as np
import pytest
import torch

from depthinspace_tpu_torch.ops import kernels
from depthinspace_tpu_torch.ops.census import (census_sad,
                                               census_sad_bwd_plain,
                                               census_sad_plain)
from depthinspace_tpu_torch.ops.resample import (flow_warp, flow_warp_pairs,
                                                 warp2d_bwd_plain,
                                                 warp2d_pairs_bwd_plain,
                                                 warp2d_pairs_plain,
                                                 warp2d_plain, warp2d_v1,
                                                 warp_pattern,
                                                 xwarp_bwd_plain, xwarp_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _randn(shape, seed, device, scale=1.0, offset=0.0):
    rng = np.random.RandomState(seed)
    a = (rng.randn(*shape) * scale + offset).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.parametrize("shape", [(3, 70, 45), (1, 5, 3), (8, 512, 432)])
def test_census_kernel_matches_plain(cuda, shape):
    es, ta = _randn(shape, 0, cuda), _randn(shape, 1, cuda)
    before = kernels.launches["census_sad_fwd"]
    out = census_sad(es, ta)
    torch.cuda.synchronize()
    assert kernels.launches["census_sad_fwd"] == before + 1
    # rsqrtf (<= 2 ulp) against torch.rsqrt, summed over 81 taps
    torch.testing.assert_close(out, census_sad_plain(es, ta), rtol=0,
                               atol=1e-5)


# W % 4 != 0 (one pixel an item) and == 0 (float4 items), ragged and at
# the eval step's and the train step's shapes
@pytest.mark.parametrize("N,H,W", [(3, 37, 50), (3, 37, 48), (1, 5, 3),
                                   (8, 512, 432), (32, 512, 432)])
def test_xwarp_kernel_matches_plain(cuda, N, H, W):
    pat = _randn((H, W), 2, cuda)
    rng = np.random.RandomState(3)
    disp = torch.from_numpy(rng.uniform(-3.0, W + 3.0, (N, H, W)).astype(
        np.float32)).to(cuda)
    assert kernels.xwarp_fwd_vec(W, pat.data_ptr(), disp.data_ptr()) == \
        (4 if W % 4 == 0 else 1)
    before = kernels.launches["xwarp_fwd"]
    out = warp_pattern(pat, disp)
    # pattern batch stride H*W: each image's row is staged
    out_n = warp_pattern(pat.expand(N, H, W).contiguous(), disp)
    torch.cuda.synchronize()
    assert kernels.launches["xwarp_fwd"] == before + 2
    # round-to-nearest intrinsics in the plain version's order: exact
    torch.testing.assert_close(out, xwarp_plain(pat, disp), rtol=0, atol=0)
    torch.testing.assert_close(out_n, out, rtol=0, atol=0)


def _shifted(x, elems):
    """A contiguous copy of x whose data starts ``elems`` elements past an
    aligned address."""
    flat = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    y = flat[elems:].view(x.shape)
    y.copy_(x)
    return y


def _offset_by_one(x):
    """A contiguous copy of x whose data starts one element past an aligned
    address (not 16-byte aligned)."""
    return _shifted(x, 1)


def test_xwarp_kernel_unaligned_rows_take_one_pixel_items(cuda):
    N, H, W = 4, 19, 44
    pat = _randn((H, W), 7, cuda)
    disp = torch.from_numpy(np.random.RandomState(8).uniform(
        -3.0, W + 3.0, (N, H, W)).astype(np.float32)).to(cuda)
    disp1 = _offset_by_one(disp)
    assert kernels.xwarp_fwd_vec(W, pat.data_ptr(), disp1.data_ptr()) == 1
    out = kernels.xwarp_fwd(pat, disp1)
    out_n = kernels.xwarp_fwd(_offset_by_one(pat.expand(N, H, W)), disp)
    torch.cuda.synchronize()
    ref = xwarp_plain(pat, disp)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(out_n, ref, rtol=0, atol=0)


@pytest.mark.parametrize("M,H,W,C,max_flow", [(3, 37, 50, 1, 30.0),
                                              (2, 9, 7, 5, 12.0),
                                              (24, 512, 432, 3, 4.0)])
def test_warp2d_kernel_matches_plain(cuda, M, H, W, C, max_flow):
    img = _randn((M, H, W, C), 4, cuda)
    rng = np.random.RandomState(5)
    flow = torch.from_numpy(rng.uniform(-max_flow, max_flow, (M, H, W, 2))
                            .astype(np.float32)).to(cuda)
    before = kernels.launches["warp2d_fwd"]
    out = flow_warp(img, flow)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_fwd"] == before + 1
    torch.testing.assert_close(out, warp2d_plain(img, flow), rtol=0, atol=0)


def _flow(shape, seed, device, max_flow):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-max_flow, max_flow, shape + (2,))
                            .astype(np.float32)).to(device)


def _call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"CUDA error {err}"


# K3's forward: the vector kernel at C = 1..8 and the first design at
# C = 11, at W = 432, odd widths and pixel counts that are no multiple of
# 2 (the pixels a thread at C = 1) or of 256 (a block); flows of up to
# 30 px leave the image
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 11])
@pytest.mark.parametrize("M,H,W", [(3, 16, 432), (2, 9, 7), (1, 5, 3),
                                   (5, 37, 51)])
def test_warp2d_fwd_paths_are_exact(cuda, M, H, W, C):
    img = _randn((M, H, W, C), 80, cuda)
    flow = _flow((M, H, W), 81, cuda, 30.0)
    ref = warp2d_plain(img, flow)
    ppt = kernels.warp2d_fwd_path(C, M * H * W, flow.data_ptr(),
                                  ref.data_ptr())
    assert (ppt > 0) == (C <= kernels.WARP2D_VEC_MAX_C)
    before = kernels.launches["warp2d_fwd"]
    out = flow_warp(img, flow)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_fwd"] == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # every path the C interface takes for this C, whatever the wrapper
    # chooses
    for ppt in [0] + ([1, 2] if C == 1 else [1] if C <= 8 else []):
        o = torch.full_like(ref, float("nan"))
        _call(kernels.library().dis_warp2d_fwd, img.data_ptr(),
              flow.data_ptr(), o.data_ptr(), M, H, W, C, ppt)
        torch.cuda.synchronize()
        torch.testing.assert_close(o, ref, rtol=0, atol=0, msg=f"ppt {ppt}")


@pytest.mark.parametrize("C", [1, 3, 5])
def test_warp2d_fwd_unaligned_flow_takes_the_first_design(cuda, C):
    M, H, W = 2, 19, 45
    img = _randn((M, H, W, C), 82, cuda)
    flow = _flow((M, H, W), 83, cuda, 12.0)
    ref = warp2d_plain(img, flow)
    flow4 = _shifted(flow, 1)     # 4 bytes off: the first design
    flow8 = _shifted(flow, 2)     # 8 bytes off: one pixel a thread
    assert kernels.warp2d_fwd_path(C, M * H * W, flow4.data_ptr(), 0) == 0
    assert kernels.warp2d_fwd_path(C, M * H * W, flow8.data_ptr(), 0) == 1
    for f in (flow4, flow8):
        out = kernels.warp2d_fwd(img, f)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _randn((2, 16, 16), 6, cuda)
    with pytest.raises(TypeError):
        kernels.census_sad_fwd(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.census_sad_fwd(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError, match="9x9"):
        kernels.census_sad_fwd(x, x, block_size=7)
    with pytest.raises(ValueError, match="eps"):
        kernels.census_sad_bwd(x, x, x, eps=0.0)
    with pytest.raises(ValueError):
        kernels.xwarp_fwd(x[0, :8], x)
    with pytest.raises(ValueError):
        kernels.warp2d_fwd(x[..., None], x[..., None])
    with pytest.raises(ValueError, match="fit"):
        kernels.census_sad_bwd(x, x, x[:, :8].contiguous())
    with pytest.raises(ValueError, match="fit"):
        kernels.xwarp_bwd(x[0], x, x[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.warp2d_bwd(x[..., None].expand(2, 16, 16, 2),
                           x[..., None].expand(2, 16, 16, 3))
    before = dict(kernels.launches)
    empty = torch.empty(0, 4, 4, device=cuda)
    assert kernels.census_sad_fwd(empty, empty).shape == (0, 4, 4)
    assert kernels.launches == before


def _grad_of(fn, x, g):
    x = x.clone().requires_grad_()
    fn(x).backward(g)
    return x.grad


# Ragged and border-heavy shapes, then the DIS-SF train step's (tl=4, bs=8).
BWD_SHAPES = [(1, 5, 3), (3, 37, 50), (2, 9, 7), (32, 512, 432)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_census_bwd_kernel_matches_plain(cuda, shape):
    es, ta, g = (_randn(shape, s, cuda) for s in (10, 11, 12))
    before = kernels.launches["census_sad_bwd"]
    grad = _grad_of(lambda e: census_sad(e, ta), es, g)
    torch.cuda.synchronize()
    assert kernels.launches["census_sad_bwd"] == before + 1
    # the signs agree (round-to-nearest h in the plain order); dh uses
    # the hardware rsqrt and each pair's terms are summed in another order
    torch.testing.assert_close(grad, census_sad_bwd_plain(es, ta, g),
                               rtol=0, atol=1e-5)


def _census_ties(shape, kind, device):
    """es, ta, g with exact ties: values on a 1/4 grid, a flat region, or es
    == ta on a patch (as tests/test_torch_census_pairs.py makes them)."""
    rng = np.random.RandomState(40)
    es, ta, g = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    N, H, W = shape
    if kind == "quarter grid":
        es, ta = np.round(es * 4) / 4, np.round(ta * 4) / 4
    elif kind == "flat region":
        es[:, :H // 2, :W // 2] = 0.25
        ta[:, :H // 2, :W // 2] = -0.5
    else:
        es[:, H // 3:, W // 3:] = ta[:, H // 3:, W // 3:]
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in (es, ta, g))


# border-heavy; bands of 56 columns whose staged columns avoid the border
# beside the first and last band, row bands split mid-image; a last band
# one column wide (W = 433); the eval and train shapes
TIE_SHAPES = [(2, 9, 7), (3, 37, 50), (2, 100, 250), (1, 40, 433),
              (8, 512, 432), (32, 512, 432)]


@pytest.mark.parametrize("kind", ["quarter grid", "flat region",
                                  "es == ta patch"])
@pytest.mark.parametrize("shape", TIE_SHAPES)
def test_census_kernels_match_plain_on_ties(cuda, shape, kind):
    """K1 and K1 bwd against their plain versions where many pairs tie
    exactly (h(a) == h(b)): a sign taken otherwise than the plain version
    takes it would cost ~1e-2 at a pixel."""
    es, ta, g = _census_ties(shape, kind, cuda)
    out = kernels.census_sad_fwd(es, ta)
    grad = kernels.census_sad_bwd(es, ta, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, census_sad_plain(es, ta), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(grad, census_sad_bwd_plain(es, ta, g),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 37, 50), (1, 40, 433),
                                   (32, 512, 432)])
def test_census_kernels_are_deterministic(cuda, shape):
    """No atomics: two calls on the same input give the same bits."""
    es, ta, g = (_randn(shape, s, cuda) for s in (13, 14, 15))
    out = [kernels.census_sad_fwd(es, ta) for _ in range(2)]
    grad = [kernels.census_sad_bwd(es, ta, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])
    assert torch.equal(grad[0], grad[1])


def _disp(shape, seed, device):
    N, H, W = shape
    rng = np.random.RandomState(seed)
    d = rng.uniform(-3.0, W + 3.0, shape).astype(np.float32)
    d[0, 0, :min(W, 3)] = [0.0, float(W - 1), 1.0][:min(W, 3)]
    return torch.from_numpy(d).to(device)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_xwarp_bwd_kernel_matches_plain(cuda, shape):
    N, H, W = shape
    pat, g, disp = _randn((H, W), 13, cuda), _randn(shape, 14, cuda), \
        _disp(shape, 15, cuda)
    before = kernels.launches["xwarp_bwd"]
    grad = _grad_of(lambda d: warp_pattern(pat, d), disp, g)
    grad_t = _grad_of(lambda d: warp_pattern(pat, d), disp, g.mT.contiguous().mT)
    torch.cuda.synchronize()
    assert kernels.launches["xwarp_bwd"] == before + 2
    torch.testing.assert_close(grad, xwarp_bwd_plain(pat, disp, g), rtol=0,
                               atol=0)
    torch.testing.assert_close(grad_t, grad, rtol=0, atol=0)


# (shape, C, max |flow|, the path warp2d_bwd_path takes): ragged blocks (W
# and H not multiples of the strip kernel's 32 columns x 16 rows, W below
# one block), C = 1..8 (the strip kernel) and C = 9 (the first design)
@pytest.mark.parametrize("shape,C,max_flow,path", [
    ((1, 5, 3), 1, 4.0, 1), ((3, 37, 50), 1, 30.0, 1),
    ((2, 9, 7), 5, 12.0, 1), ((96, 512, 432), 1, 4.0, 1),
    ((2, 40, 64), 1, 6.0, 1), ((1, 100, 433), 1, 8.0, 1),
    ((2, 17, 130), 3, 3.0, 1), ((2, 33, 68), 3, 3.0, 1),
    ((2, 37, 70), 8, 6.0, 1), ((2, 21, 19), 9, 6.0, 0)])
def test_warp2d_bwd_kernel_matches_plain(cuda, shape, C, max_flow, path):
    M, H, W = shape
    rng = np.random.RandomState(16)
    flow = torch.from_numpy(rng.uniform(-max_flow, max_flow, (M, H, W, 2))
                            .astype(np.float32)).to(cuda)
    img, g = _randn((M, H, W, C), 17, cuda), _randn((M, H, W, C), 18, cuda)
    assert kernels.warp2d_bwd_path(C, H, W, flow.data_ptr()) == path
    before = dict(kernels.launches)
    grad = _grad_of(lambda x: flow_warp(x, flow), img, g)
    grad_v1 = _grad_of(lambda x: warp2d_v1(x, flow), img, g)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_bwd"] == before["warp2d_bwd"] + 1
    assert kernels.launches["warp2d_v1_bwd"] == before["warp2d_v1_bwd"] + 1
    # the plain version's float32 sums in its order against the kernel's
    # exact sum rounded once
    ref = warp2d_bwd_plain(flow, g)
    torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(grad_v1, ref, rtol=0, atol=1e-5)


def _rigid_flows(tracks, seed):
    """The rigid flows of synthetic 512x432 tracks of 4 frames, as the
    geometric losses warp with them: the 12 ordered directions of each
    track, (12 * tracks, 512, 432, 2)."""
    from depthinspace_tpu_torch.data import make_settings, make_track_batch
    from depthinspace_tpu_torch.losses.geometric import _ordered_directions
    b = make_track_batch(make_settings(512, 432), tl=4, bs=tracks, seed=seed)
    return torch.cat([torch.from_numpy(np.ascontiguousarray(b.flow[i, j]))
                      for i, j in _ordered_directions(4)])


# the SF train step's K3 bwd (12 directions x 8 tracks) and the MF step's
# and K5's (12 x 4), on the smooth rigid flows the strip kernel is built for
@pytest.mark.parametrize("M", [96, 48])
def test_warp2d_bwd_strip_kernel_on_rigid_flow(cuda, M):
    flow = _rigid_flows(4, 5)
    flow = torch.cat([flow] * (M // 48)).to(cuda)
    g = _randn((M, 512, 432, 1), 19, cuda)
    grad = kernels.warp2d_bwd(flow, g)
    assert kernels.warp2d_bwd_path(1, 512, 432, flow.data_ptr()) == 1
    torch.testing.assert_close(grad, warp2d_bwd_plain(flow, g), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(kernels.warp2d_v1_bwd(flow, g), grad, rtol=0,
                               atol=1e-5)


def _rough_flow(kind, shape, seed):
    """Flows under which neighbouring pixels share few corners: a step
    across column 100 (inside the strip kernel's fourth block of 32
    columns), a random flow of +-60 px, and a small random flow with NaN
    and +-1e9 entries (5 % each)."""
    M, H, W = shape
    rng = np.random.RandomState(seed)
    if kind == "step":
        flow = np.empty((M, H, W, 2), np.float32)
        flow[:, :, :100] = (3.25, 1.5)
        flow[:, :, 100:] = (-45.5, 20.25)
        flow += rng.uniform(-0.5, 0.5, flow.shape).astype(np.float32)
    elif kind == "random60":
        flow = rng.uniform(-60.0, 60.0, (M, H, W, 2)).astype(np.float32)
    else:
        flow = rng.uniform(-4.0, 4.0, (M, H, W, 2)).astype(np.float32)
        pick = rng.rand(*flow.shape)
        flow[pick < 0.05] = np.nan
        flow[(pick >= 0.05) & (pick < 0.075)] = 1e9
        flow[(pick >= 0.075) & (pick < 0.1)] = -1e9
    return torch.from_numpy(flow)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", ["step", "random60", "nan_huge"])
def test_warp2d_bwd_on_step_random_and_nan_flows(cuda, kind, C):
    shape = (2, 70, 200)
    flow = _rough_flow(kind, shape, 60).to(cuda)
    g = _randn(shape + (C,), 61, cuda)
    grad = kernels.warp2d_bwd(flow, g)
    # a NaN coordinate has no valid corner, as a flow that leaves the
    # image (the kernels clamp before the int conversion; the plain
    # version's cast of NaN to an index differs between devices)
    ref = warp2d_bwd_plain(flow.nan_to_num(nan=1e9), g)
    assert bool(torch.isfinite(grad).all())
    torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", [0, 1])
@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("kind", ["smooth", "step", "random60", "nan_huge"])
def test_warp2d_bwd_every_path_matches_plain(cuda, kind, C, path):
    """Each of dis_warp2d_bwd's kernels (0: the first design, 1: the strip
    kernel), called through the library, on smooth flow, where neighbouring
    pixels share corners, and on flows where they do not."""
    shape = (2, 70, 200)
    if kind == "smooth":
        rng = np.random.RandomState(64)
        yy, xx = np.mgrid[0:70, 0:200].astype(np.float32)
        flow = np.stack([3.3 + 0.02 * xx + rng.uniform(-0.1, 0.1, (70, 200)),
                         -2.1 + 0.03 * yy], -1).astype(np.float32)
        flow = torch.from_numpy(np.stack([flow, -flow]))
    else:
        flow = _rough_flow(kind, shape, 65)
    flow = flow.to(cuda).contiguous()
    g = _randn(shape + (C,), 66, cuda)
    grad = _k3_bwd(flow, g, path)
    ref = warp2d_bwd_plain(flow.nan_to_num(nan=1e9), g)
    torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)


def _k3_bwd(flow, g, path):
    """dis_warp2d_bwd with the given path (0: the first design, 1: the
    strip kernel) into a NaN-filled grad, so that an element the kernel
    does not write shows."""
    M, H, W, C = g.shape
    grad = torch.full_like(g, float("nan"))
    acc = kernels.fixed_scratch(g.numel(), g.device)
    _call(kernels.library().dis_warp2d_bwd, flow.data_ptr(), g.data_ptr(),
          grad.data_ptr(), acc.data_ptr(), M, H, W, C, path,
          kernels.fixed_bits(H * W))
    torch.cuda.synchronize()
    return grad


def _converging_flow(shape, seed):
    """A flow that sends every pixel into the 2x2 block of cells at (10, 7)
    (jittered within it): each of those cells receives a term from every
    pixel, the most contention a scatter can meet."""
    M, H, W = shape
    rng = np.random.RandomState(seed)
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    flow = np.empty((M, H, W, 2), np.float32)
    flow[..., 0] = 10.0 + rng.uniform(0.0, 1.0, (M, H, W)) - u
    flow[..., 1] = 7.0 + rng.uniform(0.0, 1.0, (M, H, W)) - v
    return torch.from_numpy(flow)


def _wide_g(shape, seed):
    """g of either sign with magnitudes log-uniform over 1e-8 .. 1e3."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-8.0, 3.0, shape)
    sign = np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)
    return torch.from_numpy((sign * mag).astype(np.float32))


def _test_flow(kind, shape, seed):
    if kind == "converging":
        return _converging_flow(shape, seed)
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-20.0, 20.0, (*shape, 2))
                            .astype(np.float32))


def _test_g(kind, shape, seed):
    return _wide_g(shape, seed) if kind == "wide" else torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _assert_near_exact(grad, exact, magnitude, dtype):
    """Within 1e-5 of each cell's sum of |terms| (``magnitude``) of the
    exact sum of the float32 terms (the plain version in float64), and for
    bfloat16 also one rounding to bfloat16 (2^-8 of the value)."""
    lim = 1e-5 * magnitude + 1e-30
    if dtype == torch.bfloat16:
        lim = lim + 2.0 ** -8 * exact.abs()
    assert bool(((grad.double() - exact).abs() <= lim).all())


# K3's (and K5's) backward on each path, C = 1 and 3 (the strip kernel or
# the first design) and C = 9 (the first design only), on a random flow
# and a flow that converges into one 2x2 block, with g ~ N(0, 1) and g of
# magnitudes 1e-8 .. 1e3: three calls on one input give the same bits,
# within 1e-5 relative of the exact sum of the plain version's terms
@pytest.mark.parametrize("g_kind", ["normal", "wide"])
@pytest.mark.parametrize("flow_kind", ["random", "converging"])
@pytest.mark.parametrize("path,C", [(1, 1), (1, 3), (0, 1), (0, 3), (0, 9)])
def test_warp2d_bwd_repeats_bit_for_bit(cuda, path, C, flow_kind, g_kind):
    shape = (2, 37, 70)
    flow = _test_flow(flow_kind, shape, 70).to(cuda)
    g = _test_g(g_kind, shape + (C,), 71).to(cuda)
    first = _k3_bwd(flow, g, path)
    for _ in range(2):
        assert torch.equal(_k3_bwd(flow, g, path), first)
    exact = warp2d_bwd_plain(flow, g.double())
    magnitude = warp2d_bwd_plain(flow, g.double().abs())
    _assert_near_exact(first, exact, magnitude, torch.float32)
    # the wrappers take the strip kernel here; K5's runs K3's kernels
    if path == 1:
        assert torch.equal(kernels.warp2d_bwd(flow, g), first)
        assert torch.equal(kernels.warp2d_v1_bwd(flow, g), first)


# K4's backward, float32 and bfloat16, 4 channels a thread (C = 32) and
# one (C = 5), the same flows and g
@pytest.mark.parametrize("g_kind", ["normal", "wide"])
@pytest.mark.parametrize("flow_kind", ["random", "converging"])
@pytest.mark.parametrize("C", [32, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp2d_pairs_bwd_repeats_bit_for_bit(cuda, dtype, C, flow_kind,
                                               g_kind):
    src = (2, 0, 1, 2, 0, 1)
    S, H, W = 3, 37, 70
    flow = _test_flow(flow_kind, (len(src), H, W), 72).to(cuda)
    g = _test_g(g_kind, (len(src), H, W, C), 73).to(cuda).to(dtype)
    assert kernels.pairs_bwd_path(C, dtype, g.data_ptr()) == (C == 32)
    first = kernels.warp2d_pairs_bwd(flow, src, g, S)
    for _ in range(2):
        assert torch.equal(kernels.warp2d_pairs_bwd(flow, src, g, S), first)
    # the plain version's float32 terms (warp2d_bwd_plain with the float32
    # flow) summed into their planes in float64
    index = torch.as_tensor(src, device=cuda)

    def exact_sum(gd):
        out = torch.zeros((S, H, W, C), dtype=torch.float64, device=cuda)
        return out.index_add_(0, index, warp2d_bwd_plain(flow, gd))

    _assert_near_exact(first, exact_sum(g.double()),
                       exact_sum(g.double().abs()), dtype)


def test_warp2d_bwd_unaligned_flow_takes_the_first_design(cuda):
    M, H, W, C = 2, 37, 70, 1
    buf = _randn((M * H * W * 2 + 1,), 62, cuda, scale=5.0)
    flow = buf[1:].view(M, H, W, 2)
    assert flow.is_contiguous() and flow.data_ptr() % 8
    g = _randn((M, H, W, C), 63, cuda)
    assert kernels.warp2d_bwd_path(C, H, W, flow.data_ptr()) == 0
    torch.testing.assert_close(kernels.warp2d_bwd(flow, g),
                               warp2d_bwd_plain(flow, g), rtol=0, atol=1e-5)


def _fd_check(kernel_grad, plain_fn, x, g, seed, h=1e-6):
    """<kernel_grad, v> against the central difference of <g, plain(x)>
    along a random direction v, in float64."""
    v = _randn(tuple(x.shape), seed, x.device).double()
    x64, g64 = x.double(), g.double()
    fd = (torch.sum(g64 * plain_fn(x64 + h * v))
          - torch.sum(g64 * plain_fn(x64 - h * v))) / (2 * h)
    an = torch.sum(kernel_grad.double() * v)
    assert abs(float(an - fd)) <= 1e-4 * max(1.0, abs(float(fd))), (an, fd)


def test_bwd_kernels_match_finite_differences(cuda):
    shape = (2, 21, 19)
    es, ta, g = (_randn(shape, s, cuda) for s in (20, 21, 22))
    _fd_check(_grad_of(lambda e: census_sad(e, ta), es, g),
              lambda e: census_sad_plain(e, ta.double()), es, g, 23)
    pat = _randn(shape[1:], 24, cuda)
    disp = torch.from_numpy(np.random.RandomState(25).uniform(
        1.2, 17.8, shape).astype(np.float32)).to(cuda)
    _fd_check(_grad_of(lambda d: warp_pattern(pat, d), disp, g),
              lambda d: xwarp_plain(pat.double(), d), disp, g, 26)
    flow = torch.from_numpy(np.random.RandomState(27).uniform(
        -6.0, 6.0, shape + (2,)).astype(np.float32)).to(cuda)
    img, g4 = _randn(shape + (3,), 28, cuda), _randn(shape + (3,), 29, cuda)
    _fd_check(_grad_of(lambda x: flow_warp(x, flow), img, g4),
              lambda x: warp2d_plain(x, flow.double()), img, g4, 30)


# K4: ragged shapes with tables that repeat and skip planes, then the DIS-MF
# train step's (4 tracks x 4 frames: S = 16, M = 48, both fusion scales).
PAIR_CASES = [((3, 9, 7, 1), (0, 2, 2, 0, 2, 0)),
              ((3, 37, 50, 5), (1, 1, 1, 0, 0, 1)),
              ((3, 21, 19, 32), (2, 0, 1, 2, 0, 1)),
              ((16, 256, 216, 32), None),
              ((16, 128, 108, 32), None)]


def _track_table(S):
    """The FuseNet table for tl = 4, N = S / 4 (fusenet._pair_list)."""
    N = S // 4
    return tuple(j * N + n for i in range(4) for j in range(4) if j != i
                 for n in range(N))


def _pair_inputs(cuda, shape, src, dtype, seed):
    S, H, W, C = shape
    src = _track_table(S) if src is None else src
    feat = _randn(shape, seed, cuda).to(dtype)
    rng = np.random.RandomState(seed + 1)
    flow = torch.from_numpy(rng.uniform(-12.0, 12.0, (len(src), H, W, 2))
                            .astype(np.float32)).to(cuda)
    g = _randn((len(src), H, W, C), seed + 2, cuda).to(dtype)
    return feat, flow, src, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,src", PAIR_CASES)
def test_warp2d_pairs_kernels_match_plain(cuda, shape, src, dtype):
    feat, flow, src, g = _pair_inputs(cuda, shape, src, dtype, 40)
    before = dict(kernels.launches)
    out = flow_warp_pairs(feat, flow, src)
    grad = _grad_of(lambda x: flow_warp_pairs(x, flow, src), feat, g)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_pairs_fwd"] == \
        before["warp2d_pairs_fwd"] + 2
    assert kernels.launches["warp2d_pairs_bwd"] == \
        before["warp2d_pairs_bwd"] + 1
    assert out.dtype == dtype and grad.dtype == dtype
    # the forward: K3's arithmetic in float32, one rounding at the store,
    # as the plain version: exact
    torch.testing.assert_close(out, warp2d_pairs_plain(feat, flow, src),
                               rtol=0, atol=0)
    # the backward: the plain version sums the pairs' terms in float32 in
    # its order, the kernel exactly and rounds once (float32: 1e-5 at
    # |g| ~ 1); bfloat16 rounds the float32 sum once, so a neighbour of the
    # plain version's value (one bf16 ulp, 2^-8 relative, on either side:
    # rtol 2^-6)
    ref = warp2d_pairs_bwd_plain(flow, src, g, feat.shape[0])
    if dtype == torch.float32:
        torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(grad.float(), ref.float(), rtol=2 ** -6,
                                   atol=1e-5)


# K4's vector forward: 8 and 4 channels a 16-byte vector, tables that
# repeat and skip planes, a ragged plane
VECTOR_CASES = [(torch.bfloat16, 8), (torch.bfloat16, 16),
                (torch.bfloat16, 32), (torch.float32, 4), (torch.float32, 32)]


@pytest.mark.parametrize("src", [(0, 2, 2, 0, 2, 0), (1, 1, 1, 0, 0, 1)])
@pytest.mark.parametrize("dtype,C", VECTOR_CASES)
def test_warp2d_pairs_vector_forward_is_exact(cuda, dtype, C, src):
    feat, flow, src, _ = _pair_inputs(cuda, (3, 21, 19, C), src, dtype, 45)
    out_ptr = torch.empty(16, device=cuda).data_ptr()
    assert kernels.pairs_fwd_vpt(C, dtype, feat.data_ptr(), flow.data_ptr(),
                                 out_ptr) > 0
    before = kernels.launches["warp2d_pairs_fwd"]
    out = flow_warp_pairs(feat, flow, src)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_pairs_fwd"] == before + 1
    torch.testing.assert_close(out, warp2d_pairs_plain(feat, flow, src),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp2d_pairs_scalar_forward_is_exact(cuda, dtype):
    """C = 1 and 5, and 32 channels that start off a 16-byte boundary, take
    the scalar kernel."""
    cases = [((3, 9, 7, 1), None), ((3, 37, 50, 5), None),
             ((3, 21, 19, 32), _offset_by_one)]
    for shape, move in cases:
        feat, flow, src, _ = _pair_inputs(cuda, shape, (2, 0, 1, 2, 0, 1),
                                          dtype, 46)
        if move is not None:
            feat = move(feat)
        assert kernels.pairs_fwd_vpt(shape[-1], dtype, feat.data_ptr(),
                                     flow.data_ptr(), 0) == 0
        out = kernels.warp2d_pairs_fwd(feat, flow, src)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, warp2d_pairs_plain(feat, flow, src),
                                   rtol=0, atol=0)


def _assert_pairs_grad(grad, ref, dtype):
    """K4 bwd's tolerance (test_warp2d_pairs_kernels_match_plain)."""
    if dtype == torch.float32:
        torch.testing.assert_close(grad, ref, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(grad.float(), ref.float(), rtol=2 ** -6,
                                   atol=1e-5)


@pytest.mark.parametrize("src", [(0, 2, 2, 0, 2, 0), (1, 1, 1, 0, 0, 1)])
@pytest.mark.parametrize("dtype,C", VECTOR_CASES)
def test_warp2d_pairs_vector_backward_within_tolerance(cuda, dtype, C, src):
    _, flow, src, g = _pair_inputs(cuda, (3, 21, 19, C), src, dtype, 47)
    S, M, H, W = 3, len(src), 21, 19
    assert kernels.pairs_bwd_path(C, dtype, g.data_ptr())
    ref = warp2d_pairs_bwd_plain(flow, src, g, S)
    before = kernels.launches["warp2d_pairs_bwd"]
    grad = kernels.warp2d_pairs_bwd(flow, src, g, S)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_pairs_bwd"] == before + 1
    _assert_pairs_grad(grad, ref, dtype)
    # through the library into a NaN-filled grad and a workspace of
    # garbage: every element written, the wrapper's bits, twice
    table = kernels._src_table("test", src, S, M, cuda)
    bf16 = dtype == torch.bfloat16
    for _ in range(2):
        out = torch.full((S, H, W, C), float("nan"), dtype=dtype,
                         device=cuda)
        work = kernels.pairs_bwd_work(S, M, H, W, cuda)
        work.fill_(-1)
        _call(kernels.library().dis_warp2d_pairs_bwd, flow.data_ptr(),
              table[0].data_ptr(), g.data_ptr(), work.data_ptr(),
              out.data_ptr(), S, M, H, W, C, int(bf16), 1)
        torch.cuda.synchronize()
        _assert_pairs_grad(out, ref, dtype)
        assert torch.equal(out, grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp2d_pairs_scalar_backward_within_tolerance(cuda, dtype):
    """C = 1 and 5, and 32 channels of g that start off a 4-channel
    boundary, take the scalar scatter."""
    cases = [((3, 9, 7, 1), None), ((3, 37, 50, 5), None),
             ((3, 21, 19, 32), _offset_by_one)]
    for shape, move in cases:
        _, flow, src, g = _pair_inputs(cuda, shape, (2, 0, 1, 2, 0, 1),
                                       dtype, 48)
        if move is not None:
            g = move(g)
        assert not kernels.pairs_bwd_path(shape[-1], dtype, g.data_ptr())
        grad = kernels.warp2d_pairs_bwd(flow, src, g, shape[0])
        torch.cuda.synchronize()
        _assert_pairs_grad(grad, warp2d_pairs_bwd_plain(flow, src, g,
                                                        shape[0]), dtype)


def test_warp2d_pairs_bwd_matches_finite_differences(cuda):
    feat, flow, src, g = _pair_inputs(cuda, (3, 13, 11, 4),
                                      (2, 0, 0, 2, 1, 2), torch.float32, 50)
    _fd_check(_grad_of(lambda x: flow_warp_pairs(x, flow, src), feat, g),
              lambda x: warp2d_pairs_plain(x, flow.double(), src), feat, g,
              51)


def test_warp2d_pairs_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    feat, flow, src, g = _pair_inputs(cuda, (3, 9, 7, 2),
                                      (0, 1, 2, 0, 1, 2), torch.float32, 60)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_pairs_fwd(feat.cpu(), flow.cpu(), src)
    with pytest.raises(TypeError):
        kernels.warp2d_pairs_fwd(feat.half(), flow, src)
    with pytest.raises(TypeError):
        kernels.warp2d_pairs_fwd(feat, flow.double(), src)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.warp2d_pairs_fwd(feat.transpose(1, 2), flow, src)
    with pytest.raises(ValueError, match="fit"):
        kernels.warp2d_pairs_fwd(feat, flow[:, :8].contiguous(), src)
    with pytest.raises(ValueError, match="source indices"):
        kernels.warp2d_pairs_fwd(feat, flow, (0, 1, 2, 0, 1))
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        kernels.warp2d_pairs_fwd(feat, flow, (0, 1, 3, 0, 1, 2))
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        kernels.warp2d_pairs_bwd(flow, (0, -1, 2, 0, 1, 2), g, 3)
    with pytest.raises(ValueError, match="fit"):
        kernels.warp2d_pairs_bwd(flow, src, g[:5].contiguous(), 3)


@pytest.mark.parametrize("M,H,W,C", [(2, 9, 7, 5), (3, 37, 50, 1)])
def test_warp2d_v1_runs_k3_kernels_under_its_own_counters(cuda, M, H, W, C):
    img, g = _randn((M, H, W, C), 70, cuda), _randn((M, H, W, C), 71, cuda)
    flow = torch.from_numpy(np.random.RandomState(72).uniform(
        -15.0, 15.0, (M, H, W, 2)).astype(np.float32)).to(cuda)
    before = dict(kernels.launches)
    out = warp2d_v1(img, flow)
    grad = _grad_of(lambda x: warp2d_v1(x, flow), img, g)
    torch.cuda.synchronize()
    assert kernels.launches["warp2d_v1_fwd"] == before["warp2d_v1_fwd"] + 2
    assert kernels.launches["warp2d_v1_bwd"] == before["warp2d_v1_bwd"] + 1
    assert kernels.launches["warp2d_fwd"] == before["warp2d_fwd"]
    torch.testing.assert_close(out, warp2d_plain(img, flow), rtol=0, atol=0)
    torch.testing.assert_close(grad, warp2d_bwd_plain(flow, g), rtol=0,
                               atol=1e-5)


# csrc/threefry.cu: jax.random's draws, against utils/jrandom.py's plain
# version on the same card, bit for bit (the kernel rounds where the plain
# version does: its FMAs fused, every other operation a _rn intrinsic)
@pytest.mark.parametrize("transform,dtype,lo,hi", [
    ("uniform", torch.float32, 0.0, 1.0), ("uniform", torch.float32, -1.3,
                                           0.01),
    ("normal", torch.float32, 0.0, 1.0), ("normal", torch.bfloat16, 0.0, 1.0),
    ("uniform", torch.bfloat16, 0.2, 3.7)])
@pytest.mark.parametrize("shape", [(1,), (3, 5, 7), (8, 512, 432)])
def test_threefry_kernel_matches_plain(cuda, transform, dtype, lo, hi,
                                       shape):
    from depthinspace_tpu_torch.utils import jrandom
    k = jrandom.key(42)
    before = kernels.launches["threefry"]
    got = jrandom.draw(k, shape, transform, dtype, lo, hi, device=cuda)
    torch.cuda.synchronize()
    assert kernels.launches["threefry"] == before + 1
    want = (jrandom.uniform(k, shape, dtype, lo, hi, device=cuda)
            if transform == "uniform"
            else jrandom.normal(k, shape, dtype, device=cuda))
    itype = torch.int32 if dtype == torch.float32 else torch.int16
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got.view(itype), want.view(itype))


def test_threefry_bits_and_a_ranks_block(cuda):
    """The raw bits, and a block draw (runs of 3 frames every 8 from frame
    4, as a data-parallel rank's share), equal the plain whole draw's."""
    from depthinspace_tpu_torch.utils import jrandom
    k = jrandom.key(7)
    bits = kernels.threefry_draw(k, (6, 8, 33), "bits", device=cuda,
                                 run=6 * 8 * 33)
    assert torch.equal(bits.to(torch.int64) & 0xFFFFFFFF,
                       jrandom.bits(k, (6, 8, 33), device=cuda))
    whole = jrandom.normal(k, (6, 8, 33), device=cuda)
    got = jrandom.draw(k, (6, 3, 33), "normal", device=cuda, run=3 * 33,
                       stride=8 * 33, offset=4 * 33)
    assert torch.equal(got.view(torch.int32),
                       whole[:, 4:7].contiguous().view(torch.int32))
