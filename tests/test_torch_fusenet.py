"""The port's FuseNet (DIS-MF) against the JAX package's on the CPU, on the
same numpy inputs and weights converted from a JAX init (the default
frame-packed flax module, whose tree is the frame-major one): 64x56, tl = 4,
N = 2, 2 fusion blocks of 16 channels.

FuseNet picks each point's 9 neighbours among 36 candidates by their
distance in the image plane, and many candidates tie exactly (the target
frame's four axis neighbours are equidistant), so which one is taken is
decided by the last bit of the geometry. The port computes the geometry
with elementwise float32 operations that round alike on every device; the
JAX package's jitted graph fuses them and rounds otherwise (its own jitted
and op-by-op outputs differ by up to 0.15 px here). So the forward is held
against JAX run op by op (``jax.disable_jit``), with translation-only poses
(R = I), where the 3x3 rotation products are exact in both packages and the
geometry is bit-identical; the selection itself is held to equal indices on
the same inputs, rotations included."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as flax_nn
import torch

from depthinspace_tpu.models import FuseNet as JaxFuseNet
from depthinspace_tpu.models import fusenet as jax_fusenet
from depthinspace_tpu.train.checkpoint import load_net_params as jax_load
from depthinspace_tpu_torch.data import make_settings, make_track_batch
from depthinspace_tpu_torch.models import (FuseNet,
                                           flax_tree_from_fusenet_state_dict,
                                           fusenet_state_dict_from_flax,
                                           init_fusenet_, pointconv_select)
from depthinspace_tpu_torch.models.dispnet import _same_pads
from depthinspace_tpu_torch.models.fusenet import GroupNorm
from depthinspace_tpu_torch.train.checkpoint import (load_net_params,
                                                     save_net_params)
from depthinspace_tpu_torch.utils import jrandom

H, W, TL, N = 64, 56, 4, 2
BLOCKS, CH = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(max_angle):
    s = make_settings(H, W)
    b = make_track_batch(s, tl=TL, bs=N, seed=1, disp_range=(2.0, 12.0),
                         max_angle=max_angle, primary_noise=0.5)
    rng = np.random.RandomState(0)
    ir = rng.rand(TL, N, H, W, 2).astype(np.float32)
    pd = b.primary_disp[..., None]
    pdepth = (s.baseline * s.focal_length / pd).astype(np.float32)
    return s, (ir, b.ambient[..., None], pd, pdepth, b.R, b.t, b.flow)


@pytest.fixture(scope="module")
def setup():
    s, args = _inputs(0.0)
    K = tuple(map(tuple, np.asarray(s.K, np.float64).tolist()))
    jm = JaxFuseNet(imsize=(H, W), K=K, track_length=TL, block_num=BLOCKS,
                    channels=CH, use_remat=False)
    params = jm.init(jax.random.key(0), *map(jnp.asarray, args))
    params_np = jax.tree.map(np.array, params)
    return s, K, args, jm, params, params_np


@pytest.fixture(scope="module")
def jax_eager(setup):
    """The JAX FuseNet run op by op: its output and the gradient of
    mean(out) with respect to its parameters, from one VJP."""
    _, _, args, jm, params, _ = setup
    jargs = list(map(jnp.asarray, args))
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p: jm.apply(p, *jargs), params)
        (grad,) = vjp(jnp.full(out.shape, 1.0 / out.size, out.dtype))
    return np.asarray(out), jax.tree.map(np.array, grad)


def _port(K, params_np, dtype=torch.float32):
    m = FuseNet((H, W), K, TL, block_num=BLOCKS, channels=CH,
                compute_dtype=dtype)
    m.load_state_dict(fusenet_state_dict_from_flax(params_np, m))
    return m


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def test_same_pads_match_lax_for_fusenets_kernels():
    for n in (4, 5, 7, 27, 28, 64, 108, 216, 256):
        for k, stride in ((1, 1), (3, 1), (4, 2), (3, 2)):
            ref = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")[0]
            assert _same_pads(n, k, stride) == tuple(ref), (n, k, stride)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_group_norm_matches_flax(dtype):
    """flax GroupNorm(num_groups=1): epsilon 1e-6, float32 statistics; the
    output in the input's dtype, within 1e-6 relative in float32 (the means
    are summed in another order) and one bf16 ulp."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 9, 7, 8) * 3 + 1).astype(np.float32)
    gn = flax_nn.GroupNorm(num_groups=1, dtype=dtype)
    p = gn.init(jax.random.key(0), jnp.asarray(x, dtype))
    p = jax.tree.map(lambda a: a + jnp.asarray(rng.randn(*a.shape),
                                               a.dtype), p)
    ref = np.asarray(gn.apply(p, jnp.asarray(x, dtype)).astype(jnp.float32))
    m = GroupNorm(8)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.array(p["params"]["scale"])))
        m.bias.copy_(torch.from_numpy(np.array(p["params"]["bias"])))
        tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        out = m(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == jnp.float32 else \
        dict(rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("size", [(64, 56), (512, 432), (66, 58)])
def test_core_ray_matches_jax(size):
    """The half-res rays at cv2 INTER_NEAREST's pixels, floor(i * W / cw)."""
    K = ((40.0, 0.0, size[1] / 2), (0.0, 40.0, size[0] / 2),
         (0.0, 0.0, 1.0))
    ref, ch, cw = JaxFuseNet(imsize=size, K=K)._core_ray()
    ray, core = FuseNet._core_ray(size, K)
    assert core == (ch, cw)
    np.testing.assert_array_equal(ray.numpy(), np.asarray(ref))


@pytest.mark.parametrize("stride", [1, 2])
def test_pointconv_select_indices_equal_jax(stride):
    """Per target (the JAX package vmaps over targets, each with its own
    maximum): equal indices and equal neighbour xyz, with a sparse mask that
    leaves fewer than 9 valid candidates at many pixels (ties among the
    masked ones decide those) and candidates that tie exactly."""
    rng = np.random.RandomState(2 + stride)
    xyz = rng.randn(TL, TL, N, 12, 10, 3).astype(np.float32)
    xyz[..., 2] = np.abs(xyz[..., 2]) + 2.0
    xyz[:, 2] = xyz[:, 1]                       # exact duplicates
    mask = (rng.rand(TL, TL, N, 12, 10, 1) < 0.15).astype(np.float32)
    mask[:, 0] = 1.0
    idx, nb = jax.vmap(lambda x, m: jax_fusenet.pointconv_select(
        x, m, stride=stride))(jnp.asarray(xyz), jnp.asarray(mask))
    t_idx, t_nb = pointconv_select(torch.from_numpy(xyz),
                                   torch.from_numpy(mask), stride=stride)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_nb.numpy(), np.asarray(nb))
    valid = mask[:, :, :, ::stride, ::stride, 0].sum(axis=1)
    assert (valid < 9).mean() > 0.3


def test_fusenet_f32_forward_matches_jax(setup, jax_eager):
    """Within 1e-3 px of the JAX FuseNet run op by op (R = I)."""
    s, K, args, jm, params, params_np = setup
    ref = jax_eager[0]
    m = _port(K, params_np)
    with torch.no_grad():
        out = m(*_torch(args)).numpy()
    assert out.shape == (TL, N, H, W, 1)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


def test_fusenet_gradient_matches_jax(setup, jax_eager):
    """The gradient of mean(out) over all parameters within 1e-3 relative
    L2 of the JAX one (op by op, R = I)."""
    s, K, args, jm, params, params_np = setup
    m = _port(K, params_np)
    m(*_torch(args)).mean().backward()
    ref = fusenet_state_dict_from_flax(jax_eager[1], m)
    got = dict(m.named_parameters())
    diff = torch.cat([(got[k].grad - ref[k]).flatten() for k in ref])
    whole = torch.cat([ref[k].flatten() for k in ref])
    assert float(diff.norm() / whole.norm()) <= 1e-3


def test_fusenet_bf16_forward_tracks_jax_bf16(setup):
    """bfloat16 compute against the JAX bf16 FuseNet (op by op): 0.03 px
    on average, 0.3 px at the 99th percentile, 2 px at most (measured
    0.016, 0.18 and 0.93). bf16 keeps 8 bits and the two packages round at
    other places (the JAX CPU warp takes bf16 weights, the K4 path float32
    ones); the geometry is float32 in both, but the tails come from pixels
    whose neighbours' features differ by bf16 ulps through four convolution
    layers."""
    s, K, args, _, params, params_np = setup
    jm16 = JaxFuseNet(imsize=(H, W), K=K, track_length=TL, block_num=BLOCKS,
                      channels=CH, use_remat=False,
                      compute_dtype=jnp.bfloat16)
    with jax.disable_jit():
        ref = np.asarray(jm16.apply(params, *map(jnp.asarray, args)))
    m = _port(K, params_np, torch.bfloat16)
    with torch.no_grad():
        out = m(*_torch(args))
    assert out.dtype == torch.float32
    d = np.abs(out.numpy() - ref)
    p99 = float(np.quantile(d, 0.99))
    assert d.mean() <= 0.03 and p99 <= 0.3 and d.max() <= 2.0, \
        (d.mean(), p99, d.max())


def test_converter_round_trip_and_net_params_cross(setup, tmp_path):
    """flax tree -> state_dict -> flax tree is the identity; a
    net_%04d.params written by the port loads into the JAX FuseNet as the
    same tree, and back into the port."""
    s, K, args, jm, params, params_np = setup
    m = _port(K, params_np)
    back = flax_tree_from_fusenet_state_dict(m.state_dict())
    ref_leaves = jax.tree_util.tree_flatten_with_path(params_np)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(ref_leaves)
    for path, leaf in ref_leaves:
        np.testing.assert_array_equal(got[path], leaf)
    path = save_net_params(tmp_path, 5, m)
    assert path.name == "net_0005.params"
    loaded = jax_load(path, params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    m2 = init_fusenet_(FuseNet((H, W), K, TL, block_num=BLOCKS, channels=CH),
                       jrandom.key(0))
    m2.load_state_dict(load_net_params(path, m2))
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v)
    with pytest.raises(ValueError, match="leaves"):
        fusenet_state_dict_from_flax(params_np, FuseNet(
            (H, W), K, TL, block_num=BLOCKS + 1, channels=CH))


def test_init_follows_flax_defaults():
    """init_fusenet_: lecun-normal kernels (std 1/sqrt(fan_in) after the
    2-std truncation's rescale), xavier-uniform for the point
    convolutions' last map, zero biases, unit GroupNorm scales."""
    m = init_fusenet_(FuseNet((32, 32), np.eye(3), 4, channels=32),
                      jrandom.key(0))
    w = m.ref_res1.Conv_0.weight
    assert abs(float(w.detach().std()) * np.sqrt(32 * 9) - 1.0) < 0.05
    x = m.block0.conv3d_1.Dense_2.weight
    assert float(x.detach().abs().max()) <= np.sqrt(6.0 / 64)
    assert float(m.block0.conv_mf.bias.abs().max()) == 0.0
    assert torch.equal(m.block0.GroupNorm_0.weight, torch.ones(32))


def test_remat_recomputes_the_same_gradients(setup):
    """use_remat (--mf_remat) wraps the fusion and decoder residual blocks in
    torch.utils.checkpoint: the same output and, after the recomputation in
    the backward, the same gradients (within 1e-6 relative L2)."""
    s, K, args, _, _, params_np = setup
    grads = []
    for remat in (False, True):
        m = _port(K, params_np)
        m.use_remat = remat
        out = m(*_torch(args))
        out.mean().backward()
        grads.append((out.detach(), torch.cat([p.grad.flatten()
                                               for p in m.parameters()])))
    assert torch.equal(grads[0][0], grads[1][0])
    assert float((grads[0][1] - grads[1][1]).norm()
                 / grads[0][1].norm()) <= 1e-6
