"""What the port's kernel wrappers decide on the host, where no card is
needed: which kernel K4's forward and K2's forward take for a shape, type
and alignment, the source-major launch order of K4's pairs, and that a
wrapper refuses a CPU tensor instead of computing anything itself."""
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
        kernels.xwarp_fwd(torch.zeros(9, 8), torch.zeros(2, 9, 8))
