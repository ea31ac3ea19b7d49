"""What the port's kernel wrappers decide on the host, where no card is
needed: which kernel K4's forward and backward, K3's forward and backward
and K2's forward take for a shape, type and alignment, the source-major launch order
of K4's pairs, and that a wrapper refuses a CPU tensor instead of computing
anything itself."""
import numpy as np
import pytest
import torch

from depthinspace_tpu_torch.models.fusenet import _pair_list
from depthinspace_tpu_torch.ops import kernels


@pytest.mark.parametrize("dtype,C,vpt", [
    (torch.bfloat16, 8, 1), (torch.bfloat16, 16, 1), (torch.bfloat16, 32, 1),
    (torch.bfloat16, 2048, 1), (torch.float32, 4, 1), (torch.float32, 32, 1),
    (torch.float32, 1024, 1),
    # not a whole vector, or more than 256 threads a pixel: scalar
    (torch.bfloat16, 1, 0), (torch.bfloat16, 4, 0), (torch.bfloat16, 12, 0),
    (torch.bfloat16, 2056 + 8, 0), (torch.float32, 1, 0),
    (torch.float32, 5, 0), (torch.float32, 6, 0), (torch.float32, 1028, 0)])
def test_pairs_fwd_path_by_channels_and_type(dtype, C, vpt):
    want = kernels.PAIRS_VPT if vpt and C % (
        kernels.VEC_CHANNELS[dtype] * kernels.PAIRS_VPT) == 0 else vpt
    assert kernels.pairs_fwd_vpt(C, dtype, 512, 1024, 2048) == want


@pytest.mark.parametrize("feat,flow,out,vector", [
    (0, 0, 0, True), (16, 8, 32, True), (256, 24, 4096, True),
    (8, 0, 0, False), (2, 0, 0, False), (0, 4, 0, False), (0, 0, 8, False),
    (0, 2, 16, False)])
def test_pairs_fwd_path_by_alignment(feat, flow, out, vector):
    for dtype, C in ((torch.bfloat16, 32), (torch.float32, 32)):
        assert (kernels.pairs_fwd_vpt(C, dtype, feat, flow, out) > 0) == vector


@pytest.mark.parametrize("W,ptrs,vec", [
    (432, (0, 16, 4096), 4), (48, (256, 512, 768), 4), (4, (0, 0, 0), 4),
    (50, (0, 16, 32), 1), (3, (0, 0, 0), 1), (432, (0, 4, 16), 1),
    (432, (8, 16, 32), 1), (432, (0, 16, 36), 1)])
def test_xwarp_fwd_item_width(W, ptrs, vec):
    assert kernels.xwarp_fwd_vec(W, *ptrs) == vec


@pytest.mark.parametrize("C", range(1, 13))
def test_warp2d_fwd_path_by_channels(C):
    ppt = kernels.warp2d_fwd_path(C, 24 * 512 * 432, 256, 4096)
    if C > kernels.WARP2D_VEC_MAX_C:
        assert ppt == 0
    else:
        assert ppt == (2 if C == 1 else 1)


@pytest.mark.parametrize("C,flow,out,want", [
    # C = 1: two pixels a thread need flow and out 16-byte aligned
    (1, 0, 0, 2), (1, 8, 0, 1), (1, 0, 8, 1), (1, 0, 4, 1), (1, 4, 0, 0),
    # C >= 2: one pixel a thread, however out lies; the flow 8-byte aligned
    (3, 8, 0, 1), (3, 0, 4, 1), (5, 24, 12, 1), (5, 2, 0, 0), (8, 4, 16, 0)])
def test_warp2d_fwd_path_by_alignment(C, flow, out, want):
    assert kernels.warp2d_fwd_path(C, 1000, flow, out) == want


@pytest.mark.parametrize("C", range(1, 13))
def test_warp2d_bwd_path_by_channels(C):
    path = kernels.warp2d_bwd_path(C, 512, 432, 256)
    assert path == (0 if C > kernels.WARP2D_BWD_STRIP_MAX_C else 1)


@pytest.mark.parametrize("C,flow,want", [
    # the strip kernel reads the flow as float2: 8-byte aligned
    (1, 0, 1), (1, 8, 1), (1, 24, 1), (1, 4, 0), (3, 2, 0), (8, 16, 1),
    (9, 0, 0)])
def test_warp2d_bwd_path_by_alignment(C, flow, want):
    assert kernels.warp2d_bwd_path(C, 5, 3, flow) == want


def test_warp2d_bwd_path_by_size():
    """The strip kernel's corner keys y0 * (W + 4) + x0 fit in int32."""
    assert kernels.warp2d_bwd_path(1, 65535, 32000, 0) == 1
    assert kernels.warp2d_bwd_path(1, 65535, 32763, 0) == 1
    assert kernels.warp2d_bwd_path(1, 65535, 32764, 0) == 0
    assert kernels.warp2d_bwd_path(1, 1, 2 ** 30, 0) == 0


def test_warp2d_fwd_path_by_size():
    big = kernels.WARP2D_VEC_MAX_PIXELS
    assert kernels.warp2d_fwd_path(1, big, 0, 0) == 2
    assert kernels.warp2d_fwd_path(1, big + 1, 0, 0) == 0
    assert kernels.warp2d_fwd_path(5, big + 1, 0, 0) == 0


@pytest.mark.parametrize("dtype,C,vector", [
    (torch.bfloat16, 4, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 12, True), (torch.bfloat16, 32, True),
    (torch.float32, 4, True), (torch.float32, 8, True),
    (torch.float32, 12, True), (torch.float32, 32, True),
    (torch.float32, 1024, True), (torch.float32, 1028, True),
    (torch.bfloat16, 2056, True),
    # not a whole 4-channel vector
    (torch.bfloat16, 1, False), (torch.bfloat16, 5, False),
    (torch.bfloat16, 6, False), (torch.float32, 1, False),
    (torch.float32, 5, False), (torch.float32, 6, False)])
def test_pairs_bwd_path_by_channels_and_type(dtype, C, vector):
    assert kernels.pairs_bwd_path(C, dtype, 512) is vector


@pytest.mark.parametrize("g,f32,bf16", [
    (0, True, True), (16, True, True),
    # bfloat16 g needs 8 bytes (4 channels), float32 16
    (8, False, True), (24, False, True),
    (2, False, False), (4, False, False),
    (12, False, False), (32, True, True)])
def test_pairs_bwd_path_by_alignment(g, f32, bf16):
    for dtype, vector in ((torch.float32, f32), (torch.bfloat16, bf16)):
        assert kernels.pairs_bwd_path(32, dtype, g) is vector


class _Recorder:
    """Stands in for the library and the launch: records what a wrapper
    would launch, with the CUDA checks switched off for CPU tensors."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kernels, "_check", lambda *a, **k: None)
        monkeypatch.setattr(kernels, "library", lambda: self)
        monkeypatch.setattr(kernels, "_launch",
                            lambda name, fn, *a, device: self.calls.append(
                                (name, fn, a)))

    def __getattr__(self, name):
        return name

    def dis_warp2d_pairs_bwd_work(self, S, M, H, W):
        return 64


def test_pairs_bwd_launches_in_the_cached_source_major_order(monkeypatch):
    rec = _Recorder(monkeypatch)
    src = _track_table(4, 2)
    S, M, C = 8, len(src), 32
    flow = torch.zeros(M, 5, 7, 2)
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.zeros(M, 5, 7, C, dtype=dtype)
        kernels.warp2d_pairs_bwd(flow, src, g, S)
        name, fn, args = rec.calls[-1]
        table = kernels._src_table("test", src, S, M, torch.device("cpu"))
        assert (name, fn) == ("warp2d_pairs_bwd", "dis_warp2d_pairs_bwd")
        # flow, src, g, work, grad, S, M, H, W, C, bf16, vector: the cached
        # table's sources (the backward sums by destination, in no order;
        # the table keeps the forward's source-major order)
        assert args[1] == table[0].data_ptr()
        assert args[2] == g.data_ptr()
        assert tuple(table[1].tolist()) == kernels.source_major_order(src)
        assert args[5:11] == (S, M, 5, 7, C, int(dtype == torch.bfloat16))
        assert kernels.pairs_bwd_path(C, dtype, args[2])
        assert args[11:] == (1,)


@pytest.mark.parametrize("C", [1, 3, 5, 11])
def test_warp2d_fwd_launches_the_chosen_path(monkeypatch, C):
    rec = _Recorder(monkeypatch)
    img, flow = torch.zeros(2, 9, 7, C), torch.zeros(2, 9, 7, 2)
    for fn, name in ((kernels.warp2d_fwd, "warp2d_fwd"),
                     (kernels.warp2d_v1_fwd, "warp2d_v1_fwd")):
        fn(img, flow)
        got, lib_fn, args = rec.calls[-1]
        assert (got, lib_fn) == (name, "dis_warp2d_fwd")
        # img, flow, out, M, H, W, C, ppt
        assert args[3:7] == (2, 9, 7, C)
        assert args[7:] == (kernels.warp2d_fwd_path(C, 2 * 9 * 7, args[1],
                                                    args[2]),)


@pytest.mark.parametrize("C,W", [(1, 7), (1, 8), (3, 8), (8, 7), (11, 8)])
def test_warp2d_bwd_launches_the_chosen_path(monkeypatch, C, W):
    rec = _Recorder(monkeypatch)
    g, flow = torch.zeros(2, 9, W, C), torch.zeros(2, 9, W, 2)
    for fn, name in ((kernels.warp2d_bwd, "warp2d_bwd"),
                     (kernels.warp2d_v1_bwd, "warp2d_v1_bwd")):
        grad = fn(flow, g)
        got, lib_fn, args = rec.calls[-1]
        assert (got, lib_fn) == (name, "dis_warp2d_bwd")
        # flow, g, grad, acc, M, H, W, C, path, c
        assert args[:3] == (flow.data_ptr(), g.data_ptr(), grad.data_ptr())
        assert args[4:8] == (2, 9, W, C)
        # a cell of a plane receives at most one term from each of its
        # 9 * W pixels
        assert args[8:] == (kernels.warp2d_bwd_path(C, 9, W, args[0]),
                            kernels.fixed_bits(9 * W))


def _track_table(tl: int, N: int) -> tuple:
    """The table FuseNet's fusion blocks give K4 (Block2D3D.
    gather_warped_feat): target-major pairs, each source plane j*N + n."""
    return tuple(j * N + n for _, j in _pair_list(tl) for n in range(N))


def _check_order(src) -> None:
    order = kernels.source_major_order(src)
    assert sorted(order) == list(range(len(src)))
    runs = [src[m] for m in order]
    # grouped by source, sources ascending, each source once
    assert runs == sorted(src)
    # stable: within a source, the pairs keep the table's order
    for s in set(src):
        mine = [m for m in order if src[m] == s]
        assert mine == sorted(mine)


@pytest.mark.parametrize("N", [1, 2, 4])
def test_source_major_order_of_the_fusenet_table(N):
    src = _track_table(4, N)
    assert len(src) == 12 * N
    _check_order(src)
    order = kernels.source_major_order(src)
    # the three pairs that read one plane run back to back
    assert all(len({src[m] for m in order[3 * k:3 * k + 3]}) == 1
               for k in range(4 * N))
    if N == 4:
        # the tl = 4 table puts them 12 pairs apart
        assert [m for m in range(len(src)) if src[m] == 0] == [12, 24, 36]


@pytest.mark.parametrize("seed", range(4))
def test_source_major_order_of_ragged_tables(seed):
    rng = np.random.RandomState(seed)
    S = int(rng.randint(1, 7))
    src = tuple(int(s) for s in rng.randint(0, S, size=rng.randint(1, 30)))
    _check_order(src)
    # tables that repeat and skip planes, and an empty one
    for table in ((0, 2, 2, 0, 2, 0), (1, 1, 1, 0, 0, 1), (3,), ()):
        _check_order(table)


def test_src_table_holds_the_table_and_its_order():
    src = (2, 0, 1, 2, 0, 1)
    table = kernels._src_table("test", src, 3, 6, torch.device("cpu"))
    assert table.dtype == torch.int32 and tuple(table.shape) == (2, 6)
    assert tuple(table[0].tolist()) == src
    assert tuple(table[1].tolist()) == (1, 4, 2, 5, 0, 3)
    assert kernels._src_table("test", list(src), 3, 6,
                              torch.device("cpu")) is table


def test_wrappers_refuse_cpu_tensors():
    """The wrappers launch a kernel or raise: a CPU tensor never reaches a
    plain version through them (ops/resample.py takes that for CPU tensors
    before any wrapper is called)."""
    feat = torch.zeros(3, 9, 7, 8, dtype=torch.bfloat16)
    flow = torch.zeros(6, 9, 7, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_pairs_fwd(feat, flow, (0, 1, 2, 0, 1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_pairs_bwd(flow, (0, 1, 2, 0, 1, 2),
                                 torch.zeros(6, 9, 7, 8), 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.xwarp_fwd(torch.zeros(9, 8), torch.zeros(2, 9, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_fwd(torch.zeros(2, 9, 7, 3), torch.zeros(2, 9, 7, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.warp2d_bwd(torch.zeros(2, 9, 7, 2), torch.zeros(2, 9, 7, 3))
