"""The port's jax.random (depthinspace_tpu_torch/utils/jrandom.py) and
flax's initializers (models/init.py) against jax 0.9 and flax on the CPU,
on the same keys: keys, split, fold_in and bits bit for bit; uniform,
normal (f32 and the bf16 path) and truncated_normal bit for bit (the float
steps are XLA's: its erf_inv, log1p and erf polynomials with their fused
multiply-adds); bits_at on a strided index set; the inits of DispNet,
FuseNet, FlowNet and every head equal to flax's init leaf by leaf; and
draw_augment's draws through augment_batch_device equal to the JAX
function's on the same key."""
import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.models import FlowNet as JaxFlowNet
from depthinspace_tpu.models import FuseNet as JaxFuseNet
from depthinspace_tpu.models import heads as jax_heads
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu_torch.data import (batch_to_torch, make_settings,
                                         make_track_batch)
from depthinspace_tpu_torch.models import (
    DispNet, FlowNet, FuseNet, flax_tree_from_dispnet_state_dict,
    flax_tree_from_flownet_state_dict, flax_tree_from_fusenet_state_dict,
    head_state_dict_from_flax, init_dispnet_, init_flownet_, init_fusenet_,
    make_output_head)
from depthinspace_tpu_torch.models.init import draw_leaf, param_key
from depthinspace_tpu_torch.train import (augment_batch_device,
                                          make_loss_context)
from depthinspace_tpu_torch.train.objective import draw_augment
from depthinspace_tpu_torch.utils import jrandom as jr

SEEDS = (0, 42, 2 ** 31 + 5, 2 ** 32 + 7)
SHAPES = ((), (0,), (3, 5), (2, 7, 5, 3))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _words(k) -> list:
    return np.asarray(jax.random.key_data(k)).tolist()


def _bits_equal(a, b) -> None:
    """Bit for bit (NaN-free float arrays of one dtype)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    iview = {2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
    assert np.array_equal(a.view(iview), b.view(iview)), \
        f"{int((a.view(iview) != b.view(iview)).sum())} of {a.size} differ"


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in(seed):
    """key(seed) with x64 off (the low 32 bits), split into 1, 3 and 10,
    and fold_in nested twice: the same words."""
    k, K = jr.key(seed), jax.random.key(seed)
    assert list(k) == _words(K)
    for n in (1, 3, 10):
        assert [list(s) for s in jr.split(k, n)] == [
            _words(s) for s in jax.random.split(K, n)]
    assert list(jr.fold_in(jr.fold_in(k, 7), 2 ** 32 - 1)) == _words(
        jax.random.fold_in(jax.random.fold_in(K, 7), 2 ** 32 - 1))
    assert jr.wrap_key_data(jr.key_data(k)) == k


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform(shape):
    """bits and uniform (f32 on [0, 1) and [-1.3, 0.01), bf16) bit for
    bit."""
    k, K = jr.key(42), jax.random.key(42)
    got = jr.bits(k, shape)
    assert got.shape == shape
    assert np.array_equal(got.numpy().astype(np.uint32),
                          np.asarray(jax.random.bits(K, shape)))
    for lo, hi in ((0.0, 1.0), (-1.3, 0.01)):
        _bits_equal(jr.uniform(k, shape, torch.float32, lo, hi).numpy(),
                    jax.random.uniform(K, shape, jnp.float32, lo, hi))
    _bits_equal(jr.uniform(k, shape, torch.bfloat16, 0.2, 3.7).view(
        torch.int16).numpy(), np.asarray(jax.random.uniform(
            K, shape, jnp.bfloat16, 0.2, 3.7)).view(np.int16))


def test_normal_and_truncated_normal():
    """normal in f32 and bf16 (jax's 16-bit path) and truncated_normal(-2,
    2): bit for bit over 2^18 values each, tails included."""
    k, K = jr.key(3), jax.random.key(3)
    n = (1 << 18,)
    _bits_equal(jr.normal(k, n).numpy(), jax.random.normal(K, n))
    _bits_equal(jr.normal(k, n, torch.bfloat16).view(torch.int16).numpy(),
                np.asarray(jax.random.normal(K, n, jnp.bfloat16)).view(
                    np.int16))
    _bits_equal(jr.truncated_normal(k, -2.0, 2.0, n).numpy(),
                jax.random.truncated_normal(K, -2.0, 2.0, n))
    _bits_equal(jr.truncated_normal(k, -2.0, 2.0, (4, 3)).numpy(),
                jax.random.truncated_normal(K, -2.0, 2.0, (4, 3)))


def test_bits_at_and_block_draws_are_the_slice_of_the_whole():
    """bits_at on a strided index set, and a rank's block draw (runs of 3
    every 7 from offset 2, as a data-parallel share), equal the elements of
    the whole array's draw."""
    k, K = jr.key(11), jax.random.key(11)
    whole = np.asarray(jax.random.bits(K, (6, 7, 5))).reshape(-1)
    idx = torch.arange(5, 210, 13)
    assert np.array_equal(jr.bits_at(k, idx).numpy(), whole[idx.numpy()])
    want = np.asarray(jax.random.normal(K, (6, 7, 5))).reshape(6, 7 * 5)
    got = jr.draw(k, (6, 3 * 5), "normal", run=3 * 5, stride=7 * 5,
                  offset=2 * 5)
    _bits_equal(got.numpy(), want[:, 10:25])


def test_param_keys_and_initializers_are_flax():
    """The key of a module's n-th self.param call is fold_in(root,
    sha1(path + counter)[:4]); the lecun-normal and xavier-uniform leaves
    equal jax's initializers on that key."""
    root = jr.key(5)
    k = param_key(root, ("_Down_0", "Conv_0"), 2)
    h = int.from_bytes(hashlib.sha1(b"_Down_0Conv_0\x02").digest()[:4],
                       "big")
    assert list(k) == _words(jax.random.fold_in(jax.random.key(5), h))
    init = jax.nn.initializers
    for name, fn, shape in (("lecun_normal", init.lecun_normal(),
                             (3, 3, 16, 8)),
                            ("xavier_uniform", init.xavier_uniform(),
                             (32, 32)),
                            ("lecun_normal", init.lecun_normal(),
                             (12, 6, 1))):
        _bits_equal(draw_leaf(k, shape, name).numpy(),
                    fn(jax.random.wrap_key_data(jr.key_data(k)), shape,
                       jnp.float32))


def _tree_equal(got, want, path=""):
    assert set(got) == set(want), path
    for name, w in want.items():
        if isinstance(w, dict):
            _tree_equal(got[name], w, f"{path}/{name}")
        else:
            _bits_equal(got[name], np.asarray(w))


@pytest.mark.parametrize("seed", [42, 0])
def test_dispnet_init_is_flax_init(seed):
    """init_dispnet_(key(seed)) equals DispNet().init(jax.random.key(seed))
    at full width (31,595,332 parameters) leaf by leaf, bit for bit (the
    JAX worker's init for --seed 42, and 0)."""
    want = JaxDispNet().init(jax.random.key(seed), jnp.zeros((1, 8, 8, 2)))
    got = flax_tree_from_dispnet_state_dict(
        init_dispnet_(DispNet(), jr.key(seed)).state_dict())
    _tree_equal(got, want)


@pytest.mark.parametrize("packed,remat", [(True, True), (False, False)])
def test_fusenet_init_is_flax_init(packed, remat):
    """FuseNet, 1 block x 32 channels, in its frame-packed and frame-major
    flax forms (the same tree), with and without remat: every leaf bit for
    bit, FuseNet's Dense_2 from xavier_uniform and GroupNorm's ones."""
    H, W, TL = 32, 24, 4
    s = make_settings(H, W)
    b = make_track_batch(s, tl=TL, bs=1, seed=1, disp_range=(2.0, 12.0),
                         primary_noise=0.5)
    pd = b.primary_disp[..., None]
    args = (np.zeros((TL, 1, H, W, 2), np.float32), b.ambient[..., None],
            pd, (s.baseline * s.focal_length / pd).astype(np.float32), b.R,
            b.t, b.flow)
    K = tuple(map(tuple, np.asarray(s.K, np.float64).tolist()))
    jm = JaxFuseNet(imsize=(H, W), K=K, track_length=TL, block_num=1,
                    channels=32, packed=packed, use_remat=remat)
    want = jm.init(jax.random.key(7), *map(jnp.asarray, args))
    m = init_fusenet_(FuseNet((H, W), s.K, TL, block_num=1, channels=32),
                      jr.key(7))
    _tree_equal(flax_tree_from_fusenet_state_dict(m.state_dict()), want)
    dense = np.asarray(want["params"]["block0"]["conv3d_1"]["Dense_2"][
        "kernel"])
    assert np.abs(dense).max() <= np.sqrt(6.0 / 64)


def test_flownet_and_heads_init_are_flax_init():
    """FlowNet (2 input channels) and each make_output_head kind: the
    weights flax's init gives for the same key, bit for bit (the per-row
    heads' kernels lecun-normal over fan-in H * Ci, truncated)."""
    z = jnp.zeros((1, 32, 32, 2))
    want = JaxFlowNet().init(jax.random.key(3), z, z)
    got = flax_tree_from_flownet_state_dict(
        init_flownet_(FlowNet(2), jr.key(3)).state_dict())
    _tree_equal(got, want)
    H, C = 12, 6
    params = {"linear": {}, "disp": {"alpha": 64.0},
              "disp_row": {"alpha": 64.0}, "pos": {"alpha": 10.0},
              "pos_row": {"alpha": 10.0}}
    for kind, kw in params.items():
        jm = jax_heads.make_output_head(kind, height=H, **kw)
        want = head_state_dict_from_flax(jax.tree.map(np.asarray, jm.init(
            jax.random.key(1), jnp.zeros((2, H, 10, C)))), kind)
        got = make_output_head(kind, C, height=H, key=jr.key(1),
                               **kw).state_dict()
        assert set(got) == set(want), kind
        for name, t in want.items():
            _bits_equal(got[name].numpy(), t.numpy())


def test_draw_augment_is_the_jax_augmentation():
    """draw_augment(key) against the JAX augment_batch_device on the same
    key (blur and salt & pepper on: aug_max_sp_noise 0.2 so the coins and
    ratios show): each draw bit for bit equal to the JAX function's
    expression for it (a 10-way split, (n, 1, 1) uniforms, (n, H, W)
    normals, (2, n, H, W) uniforms), and the augmented images within 1e-6
    (the blur's exp and sums rounded otherwise: 3.6e-7 seen)."""
    H, W, TL, BS = 32, 24, 4, 2
    n = TL * BS
    s = make_settings(H, W)
    b = make_track_batch(s, tl=TL, bs=BS, seed=2, disp_range=(2.0, 12.0))
    kw = dict(augment=True, aug_max_sp_noise=0.2)
    jctx = jax_objective.make_loss_context(s, track_length=TL, **kw)
    ctx = make_loss_context(s, TL, device="cpu", **kw)
    for seed in (0, 9):
        draws = draw_augment(n, H, W, ctx, jr.key(seed))
        ks = jax.random.split(jax.random.key(seed), 10)
        uni = lambda k, lo, hi: jax.random.uniform(k, (n, 1, 1), minval=lo,
                                                   maxval=hi)
        want = (uni(ks[0], 0.0, 1.0), uni(ks[1], 0.2, jctx.aug_max_blur),
                uni(ks[2], 0.2, jctx.aug_max_blur),
                jax.random.normal(ks[3], (n, H, W)),
                uni(ks[4], 0.0, jctx.aug_max_noise),
                jax.random.normal(ks[5], (n, H, W)),
                uni(ks[6], 0.0, jctx.aug_max_noise), uni(ks[7], 0.0, 1.0),
                uni(ks[8], 0.0, jctx.aug_max_sp_noise),
                jax.random.uniform(ks[9], (2, n, H, W)))
        for got, w in zip(draws, want):
            _bits_equal(got.numpy(), w)
        ref = jax_objective.augment_batch_device(JaxBatch(**b._asdict()),
                                                 jax.random.key(seed), jctx)
        got = augment_batch_device(batch_to_torch(b, "cpu"), draws)
        for name in ("im", "ambient"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=0, atol=1e-6)
