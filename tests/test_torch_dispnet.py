"""The port's DispNet against the flax DispNet on the CPU, through the
weight converter: flax "SAME" padding at odd and even sizes, the
transposed conv, and the whole network at 64x56 (all 4 outputs within
1e-3 px)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as nn
import torch

from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu_torch.models import (DispNet, dispnet_state_dict_from_flax,
                                           init_dispnet_)
from depthinspace_tpu_torch.models.dispnet import (SameConv2d,
                                                   SameConvTranspose2d,
                                                   _same_pads)
from depthinspace_tpu_torch.utils import jrandom

H, W = 64, 56


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores at once;
    two intra-op threads per process keep torch from oversubscribing them
    (test_init_is_seeded's two full-width inits took 748 s with all of
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_dispnet():
    model = JaxDispNet(max_disp=128.0)
    params = model.init(jax.random.key(0), jnp.zeros((1, H, W, 2)))
    return model, params


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_xla(k, stride):
    for n in (7, 14, 27, 28, 54, 432):
        assert _same_pads(n, k, stride) == tuple(
            jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")[0])


@pytest.mark.parametrize("n", [7, 8])
def test_conv_and_conv_transpose_match_flax(n):
    rng = np.random.RandomState(0)
    x = rng.randn(2, n, n + 3, 4).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k in (3, 5):
        conv = nn.Conv(6, (k, k), strides=(2, 2), padding="SAME")
        p = conv.init(jax.random.key(1), jnp.asarray(x))
        ref = np.asarray(conv.apply(p, jnp.asarray(x)))
        tc = SameConv2d(4, 6, k, stride=2)
        tc.weight.data = torch.from_numpy(
            np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
        tc.bias.data = torch.from_numpy(np.array(p["params"]["bias"]))
        out = tc(xt).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)

    up = nn.ConvTranspose(5, (3, 3), strides=(2, 2), padding="SAME")
    p = up.init(jax.random.key(2), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.1, p)             # nonzero bias
    ref = np.asarray(up.apply(p, jnp.asarray(x)))
    tu = SameConvTranspose2d(4, 5)
    k = np.asarray(p["params"]["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    tu.weight.data = torch.from_numpy(k.copy())
    tu.bias.data = torch.from_numpy(np.array(p["params"]["bias"]))
    out = tu(xt).permute(0, 2, 3, 1).detach().numpy()
    assert out.shape == ref.shape == (2, 2 * n, 2 * (n + 3), 5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # the same function as a 2x2 convolution and a pixel shuffle (the
    # card's path under deterministic cuDNN algorithms)
    out = tu.as_convolution(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_converter_layout(jax_dispnet):
    _, params = jax_dispnet
    tree = _np_tree(params)
    sd = dispnet_state_dict_from_flax(tree)
    assert len(sd) == 64 == len(jax.tree.leaves(params))
    model = DispNet()
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    del tree["params"]["Conv_6"]
    with pytest.raises(KeyError):
        dispnet_state_dict_from_flax(tree)


def test_dispnet_matches_flax(jax_dispnet):
    """All 4 outputs within 1e-3 px at 64x56, whose encoder widths
    56 -> 28 -> 14 -> 7 -> 4 -> 2 -> 1 reach odd sizes."""
    model, params = jax_dispnet
    rng = np.random.RandomState(3)
    x = rng.randn(2, H, W, 2).astype(np.float32)
    ref = model.apply(params, jnp.asarray(x))

    net = DispNet().eval()
    net.load_state_dict(dispnet_state_dict_from_flax(_np_tree(params)))
    with torch.inference_mode():
        outs = net(torch.from_numpy(x))
    assert len(outs) == 4
    for o, r in zip(outs, ref):
        assert o.shape == (2, H, W, 1)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3)


def test_init_is_seeded():
    a = init_dispnet_(DispNet(), jrandom.key(5))
    b = init_dispnet_(DispNet(), jrandom.key(5))
    c = init_dispnet_(DispNet(), jrandom.key(6))
    wa, wb, wc = (m.downs[0].conv0.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # lecun-normal scale: std ~ sqrt(1 / fan_in)
    w = a.iconvs[0].weight.detach()
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
