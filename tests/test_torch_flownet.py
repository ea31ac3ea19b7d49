"""The port's FlowNet (models/flownet.py) and its trainer (tools/train_flow.py)
against the JAX package on the CPU, on the same numpy inputs and weights:
the correlation volume, the forward on all four levels with the trained
output/flownet.msgpack, flow_all_pairs, the weight converter and the
msgpack files both ways, the losses, the learning-rate schedule, three
train steps from the same init and batch, and the pair pool.

Tolerances: the correlation 1e-6 (sums over channels in another order);
the forward 1e-3 px at every level (measured ~5e-7 px at 64x64 and 64x56);
the train steps rtol 1e-4 on the losses, the weights within 1 % of an
Adam step (float32 convolutions and their gradients summed in other
orders)."""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data.cache import build_wire_cache as jax_build_wire_cache
from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data import load_settings as jax_load_settings
from depthinspace_tpu.models import flownet as jfn
from depthinspace_tpu.tools import presave_flow as jax_presave_flow
from depthinspace_tpu.tools import train_flow as jax_train_flow
from depthinspace_tpu_torch.models import (FlowNet, correlation, epe,
                                           flax_tree_from_flownet_state_dict,
                                           flow_all_pairs,
                                           flownet_state_dict_from_flax,
                                           multiscale_epe_loss)
from depthinspace_tpu_torch.tools import train_flow
from depthinspace_tpu_torch.utils import flax_msgpack

WEIGHTS = Path(__file__).resolve().parents[1] / "output" / "flownet.msgpack"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """output/flownet.msgpack as the port's FlowNet and as flax params."""
    net, ch = train_flow.load_flow_params(WEIGHTS)
    params, jch = jax_train_flow.load_flow_params(WEIGHTS, (64, 64))
    assert ch == jch == 2
    return net, params


def _port_net_from(params, in_channels):
    net = FlowNet(in_channels)
    net.load_state_dict(flownet_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return net


@pytest.mark.parametrize("radius", [4, 3])
def test_correlation_matches_jax(radius):
    rng = np.random.RandomState(radius)
    f1 = rng.randn(2, 12, 10, 16).astype(np.float32)
    f2 = rng.randn(2, 12, 10, 16).astype(np.float32)
    ref = np.asarray(jfn.correlation(jnp.asarray(f1), jnp.asarray(f2),
                                     radius))
    out = correlation(torch.from_numpy(f1), torch.from_numpy(f2), radius)
    assert out.shape == ref.shape == (2, 12, 10, (2 * radius + 1) ** 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_correlation_identifies_shift():
    """The JAX test on the port: the volume peaks at the true integer
    displacement (dy-major channel order)."""
    rng = np.random.RandomState(0)
    f = rng.randn(1, 16, 16, 16).astype(np.float32)
    dy, dx = 2, -1
    f2 = np.zeros_like(f)
    f2[:, 2:, :15, :] = f[:, :-2, 1:, :]
    c = correlation(torch.from_numpy(f), torch.from_numpy(f2), radius=3)
    win = c[0, 8, 8].reshape(7, 7).numpy()
    iy, ix = np.unravel_index(np.argmax(win), win.shape)
    assert (iy - 3, ix - 3) == (dy, dx)


@pytest.mark.parametrize("size", [(64, 64), (64, 56)],
                         ids=["64x64", "64x56"])
def test_flownet_matches_jax_with_trained_weights(trained, size):
    """All four levels within 1e-3 px; 64x56 runs the encoder's odd sizes
    (7 -> 4 at 1/16), which flax's "SAME" pads unevenly."""
    net, params = trained
    H, W = size
    rng = np.random.RandomState(H + W)
    a = rng.rand(2, H, W, 2).astype(np.float32)
    b = rng.rand(2, H, W, 2).astype(np.float32)
    ref = jfn.FlowNet().apply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        out = net(torch.from_numpy(a), torch.from_numpy(b))
    assert len(out) == len(ref) == 4
    for r, o in zip(ref, out):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3)
    assert out[-1].shape == (2, H, W, 2)


def test_flow_all_pairs_matches_jax(trained):
    """(tl, tl, n, H, W, 2): out[i, j] is the flow from frame i to frame j
    of each track, the diagonal exactly zero, no gradient."""
    net, params = trained
    tl, n, H, W = 3, 2, 32, 48
    rng = np.random.RandomState(3)
    im = rng.rand(tl, n, H, W).astype(np.float32)
    amb = rng.rand(tl, n, H, W).astype(np.float32)
    ref = np.asarray(jfn.flow_all_pairs(jfn.FlowNet(), params,
                                        jnp.asarray(im), jnp.asarray(amb), 2))
    out = flow_all_pairs(net, torch.from_numpy(im), torch.from_numpy(amb))
    assert out.shape == ref.shape == (tl, tl, n, H, W, 2)
    assert not out.requires_grad
    for i in range(tl):
        assert torch.all(out[i, i] == 0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)
    with torch.no_grad():
        one = net(torch.from_numpy(np.stack([amb[2, 1], im[2, 1]], -1)[None]),
                  torch.from_numpy(np.stack([amb[0, 1], im[0, 1]], -1)[None]))
    np.testing.assert_allclose(out[2, 0, 1].numpy(), one[-1][0].numpy(),
                               rtol=0, atol=1e-5)


def test_converter_round_trip_and_leaf_check():
    """output/flownet.msgpack -> state_dict -> msgpack gives the file's
    bytes back; a tree without one of the 40 leaves is refused."""
    data = WEIGHTS.read_bytes()
    tree = flax_msgpack.from_bytes(data)
    sd = flownet_state_dict_from_flax(tree)
    assert len(sd) == 40
    assert sd["encoder.down0.weight"].shape == (16, 2, 3, 3)
    assert sd["level1.dec0.weight"].shape == (96, 115, 3, 3)
    assert flax_msgpack.to_bytes(flax_tree_from_flownet_state_dict(sd)) == data
    del tree["params"]["level2"]["flow_head"]["bias"]
    with pytest.raises(ValueError, match="39 leaves"):
        flownet_state_dict_from_flax(tree)


@pytest.mark.parametrize("in_channels", [1, 2])
def test_load_flow_params_detects_channels(tmp_path, in_channels):
    """A JAX-saved 1- or 2-channel net loads with its channel count read
    from the file, and computes what the JAX net computes."""
    z = jnp.zeros((1, 32, 32, in_channels))
    params = jfn.FlowNet().init(jax.random.key(in_channels), z, z)
    path = tmp_path / "flownet.msgpack"
    jax_train_flow.save_params(params, path)
    net, ch = train_flow.load_flow_params(path)
    assert ch == in_channels == net.in_channels
    rng = np.random.RandomState(0)
    a, b = (rng.rand(1, 32, 32, in_channels).astype(np.float32)
            for _ in range(2))
    ref = jfn.FlowNet().apply(params, jnp.asarray(a), jnp.asarray(b))[-1]
    with torch.no_grad():
        out = net(torch.from_numpy(a), torch.from_numpy(b))[-1]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_saved_params_cross_load(tmp_path):
    """A file saved by the port loads in the JAX package to the same
    weights, and one saved by the JAX package loads in the port."""
    z = jnp.zeros((1, 32, 32, 2))
    params = jfn.FlowNet().init(jax.random.key(5), z, z)
    net = _port_net_from(params, 2)
    port_path = tmp_path / "port.msgpack"
    train_flow.save_params(net, port_path)
    back, ch = jax_train_flow.load_flow_params(port_path, (32, 32))
    assert ch == 2
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    jax_path = tmp_path / "jax.msgpack"
    jax_train_flow.save_params(params, jax_path)
    net2, _ = train_flow.load_flow_params(jax_path)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(net2.state_dict()[k], v, rtol=0, atol=0)


def test_losses_match_jax():
    rng = np.random.RandomState(6)
    H, W = 32, 48
    shapes = [(2, H // 16, W // 16, 2), (2, H // 8, W // 8, 2),
              (2, H // 4, W // 4, 2), (2, H, W, 2)]
    flows = [(rng.randn(*s) * 3).astype(np.float32) for s in shapes]
    gt = (rng.randn(2, H, W, 2) * 3).astype(np.float32)
    ref = jfn.multiscale_epe_loss([jnp.asarray(f) for f in flows],
                                  jnp.asarray(gt))
    out = multiscale_epe_loss([torch.from_numpy(f) for f in flows],
                              torch.from_numpy(gt))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    np.testing.assert_allclose(
        float(epe(torch.from_numpy(flows[-1]), torch.from_numpy(gt))),
        float(jfn.epe(jnp.asarray(flows[-1]), jnp.asarray(gt))), rtol=1e-6)


@pytest.mark.parametrize("steps", [3, 50, 2000])
def test_warmup_cosine_lr_matches_optax(steps):
    lr = 2e-4
    sched = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.05, peak_value=lr,
        warmup_steps=min(200, steps // 10 + 1), decay_steps=steps,
        end_value=lr / 20.0)
    for count in sorted({0, 1, 2, steps // 3, steps // 2, steps - 1, steps,
                         steps + 5}):
        np.testing.assert_allclose(train_flow.warmup_cosine_lr(count, lr,
                                                               steps),
                                   float(sched(count)), rtol=1e-5)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    """2 samples at 48x48 (the JAX PairPool test's fixture) and a copy with
    a wire cache built by the JAX package."""
    root = tmp_path_factory.mktemp("flow") / "data"
    generate_dataset(root, n_samples=2, imsize=(48, 48), write_flow=False)
    return root


def _pools(root, in_channels=2):
    settings = jax_load_settings(root / "settings.pkl")
    args = (settings.K, settings.baseline, settings.focal_length)
    ref = jax_train_flow.PairPool(
        root, jax_train_flow._sample_dirs(root), *args, pool_size=6,
        rng=np.random.RandomState(0), in_channels=in_channels)
    pool = train_flow.PairPool(
        root, train_flow._sample_dirs(root), *args, pool_size=6,
        rng=np.random.RandomState(0), in_channels=in_channels)
    return ref, pool


@pytest.mark.parametrize("source", ["hdf5", "wire_cache"])
def test_pair_pool_matches_jax(fixture_dir, tmp_path, source):
    """The same pairs, 16-bit images and int16 flow from the same seed,
    and the same cropped batches, from HDF5 and from the wire cache."""
    root = fixture_dir
    if source == "wire_cache":
        import shutil
        root = tmp_path / "data"
        shutil.copytree(fixture_dir, root)
        jax_build_wire_cache(root)
    ref, pool = _pools(root)
    assert pool.a.dtype == np.uint16 and pool.gt.dtype == np.int16
    assert pool.a.shape == (6, 48, 48, 2)
    np.testing.assert_array_equal(pool.a, ref.a)
    np.testing.assert_array_equal(pool.b, ref.b)
    assert np.abs(pool.gt.astype(np.int32) - ref.gt).max() <= 1
    got = pool.batch(np.random.RandomState(1), 3, crop=(32, 32))
    want = ref.batch(np.random.RandomState(1), 3, crop=(32, 32))
    for g, w in zip(got[:2], want[:2]):
        assert g.shape[:3] == (3, 32, 32)
        np.testing.assert_array_equal(g, w)


def test_load_pair_matches_jax(fixture_dir):
    settings = jax_load_settings(fixture_dir / "settings.pkl")
    args = (settings.K, settings.baseline, settings.focal_length)
    sample = train_flow._sample_dirs(fixture_dir)[0]
    for ch in (1, 2):
        got = train_flow.load_pair(sample, *args, np.random.RandomState(4),
                                   ch)
        want = jax_train_flow.load_pair(sample, *args,
                                        np.random.RandomState(4), ch)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


def test_train_flow_steps_match_jax(fixture_dir):
    """Three steps from one converted init on one pool's cropped batches:
    the JAX tool's step (Adam over the warmup-cosine schedule, the
    multi-scale loss, the in-graph wire decode) against the port's: losses
    and EPEs within rtol 1e-4; every weight within 1 % of the peak lr, one
    Adam step's size (measured 7.8e-7 = 0.4 %: Adam divides by the
    gradient's own scale, so where a gradient is near zero its last-bit
    differences become a visible part of a step)."""
    _, pool = _pools(fixture_dir)
    rng = np.random.RandomState(2)
    batches = [pool.batch(rng, 2, crop=(32, 32)) for _ in range(3)]
    net = jfn.FlowNet()
    z = jnp.zeros((2, 32, 32, 2))
    params = net.init(jax.random.key(3), z, z)
    lr, steps = 2e-4, 10
    opt = optax.adam(optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.05, peak_value=lr,
        warmup_steps=min(200, steps // 10 + 1), decay_steps=steps,
        end_value=lr / 20.0))
    opt_state = opt.init(params)

    @jax.jit
    def jstep(params, opt_state, im1, im2, gt):
        im1 = im1.astype(jnp.float32) * (1.0 / 65535.0)
        im2 = im2.astype(jnp.float32) * (1.0 / 65535.0)
        gt = gt.astype(jnp.float32) * (1.0 / 256.0)

        def loss_fn(p):
            flows = net.apply(p, im1, im2)
            return jfn.multiscale_epe_loss(flows, gt), jfn.epe(flows[-1], gt)
        (loss, e), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, e

    port = _port_net_from(params, 2)
    step = train_flow.make_train_step(port, lr, steps)
    for a, b, gt in batches:
        params, opt_state, ref_loss, ref_epe = jstep(params, opt_state, a, b,
                                                     gt)
        loss, e = step(*(torch.from_numpy(x) for x in (a, b, gt)))
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
        np.testing.assert_allclose(float(e), float(ref_epe), rtol=1e-4)
    want = flownet_state_dict_from_flax(jax.tree.map(np.asarray, params))
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=0.01 * lr, err_msg=k)


def test_train_flow_main_writes_params_both_packages_read(fixture_dir,
                                                          tmp_path, capsys):
    """``main`` on the fixture: steps, the validation line with the learned,
    Farneback and zero-flow EPE (the Farneback EPE that of the JAX tool's
    cv2 flow on the held-out pair), and a msgpack both load_flow_params
    read."""
    out = tmp_path / "flownet.msgpack"
    train_flow.main(["--data_dir", str(fixture_dir), "--out", str(out),
                     "--steps", "3", "--batch_size", "2", "--crop", "32",
                     "32", "--val_samples", "1", "--pool_size", "4",
                     "--report_every", "1", "--pool_cache",
                     str(tmp_path / "pool.npz")], device="cpu")
    text = capsys.readouterr().out
    assert "step     2" in text and "zero-flow" in text
    m = re.search(r"learned [0-9.]+px  farneback ([0-9.]+)px  zero-flow "
                  r"[0-9.]+px  \(1 held-out samples\)", text)
    assert m, text
    settings = jax_load_settings(fixture_dir / "settings.pkl")
    a, b, gt = train_flow.load_pair(train_flow._sample_dirs(fixture_dir)[0],
                                    settings.K, settings.baseline,
                                    settings.focal_length,
                                    np.random.RandomState(12345))
    fb = np.moveaxis(jax_presave_flow.farneback_flow(a[..., 0], b[..., 0]),
                     0, -1)
    assert m.group(1) == f"{np.mean(np.linalg.norm(fb - gt, axis=-1)):.3f}"
    assert (tmp_path / "pool.npz").exists()
    net, ch = train_flow.load_flow_params(out)
    params, jch = jax_train_flow.load_flow_params(out, (32, 32))
    assert ch == jch == 2
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(params))
    assert all(torch.isfinite(v).all() for v in net.state_dict().values())
