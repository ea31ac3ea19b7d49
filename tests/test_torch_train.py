"""The DIS-SF training path against the JAX package on the CPU, on the same
numpy inputs: the train step for 3 steps (components and the first step's
gradients) with and without gradient accumulation, Adam against
optax.adam, the training-only loss terms with the JAX noise injected, the
device augmentation, and the flax msgpack weights file both ways."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.data.settings import Settings
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu.train.checkpoint import load_net_params as jax_load
from depthinspace_tpu.train.checkpoint import save_net_params as jax_save
from depthinspace_tpu.train.state import TrainState as JaxTrainState
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu.train.steps import _sf_forward as jax_sf_forward
from depthinspace_tpu_torch.data import (batch_to_torch,
                                         make_dot_pattern, make_track_batch,
                                         smooth_disparity)
from depthinspace_tpu_torch.models import DispNet, dispnet_state_dict_from_flax
from depthinspace_tpu_torch.train import (AugmentDraws, TrainState,
                                          augment_batch_device,
                                          make_loss_context,
                                          make_sf_train_step, sf_losses)
from depthinspace_tpu_torch.train.checkpoint import (load_net_params,
                                                     save_net_params)
from depthinspace_tpu_torch.train.objective import _gauss_blur5

H, W = 64, 56
TL, BS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores at once;
    two intra-op threads per process keep torch from oversubscribing them
    (with all cores each, this file's steps ran ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    K = np.array([[435.2, 0, W / 2], [0, 435.2, H / 2], [0, 0, 1]],
                 np.float32)
    settings = Settings(imsize=(H, W), pattern=make_dot_pattern(H, W),
                        baseline=0.025, K=K)
    model = JaxDispNet(max_disp=128.0)
    params = model.init(jax.random.key(0), jnp.zeros((1, H, W, 2)))
    params_np = jax.tree.map(np.asarray, params)
    batch = make_track_batch(settings, tl=TL, bs=BS, seed=1,
                             disp_range=(2.0, 12.0))
    return settings, model, params, params_np, batch


def _port_step(settings, params_np, accum_steps):
    net = DispNet()
    net.load_state_dict(dispnet_state_dict_from_flax(params_np))
    state = TrainState.create(net, 1e-4, seed=0, device="cpu")
    step = make_sf_train_step(net, make_loss_context(settings, TL,
                                                     device="cpu"),
                              state, accum_steps=accum_steps)
    return net, state, step


def _jax_components(setup, accum_steps, n_steps=3):
    settings, model, params, _, batch = setup
    ctx = jax_objective.make_loss_context(settings, track_length=TL)
    opt = optax.adam(1e-4)
    train_step, _, consts = _make_step_fns(model, ctx, opt, "single_frame",
                                           accum_steps=accum_steps)
    step = jax.jit(train_step)
    state = JaxTrainState.create(params, opt, jax.random.key(1))
    out = []
    for _ in range(n_steps):
        state, comps = step(state, JaxBatch(**batch._asdict()),
                            jnp.asarray(0.0), consts)
        out.append(np.asarray(comps))
    return out


def test_train_step_matches_jax_for_three_steps(setup):
    """Components within rtol 1e-4 at each of 3 steps (measured <= 7e-6);
    the first step's gradient of every parameter tensor within relative L2
    2e-3 (measured 2.4e-4: convolution sums in another order)."""
    settings, model, params, params_np, batch = setup
    ref = _jax_components(setup, accum_steps=1)
    ctx = jax_objective.make_loss_context(settings, track_length=TL)
    jb = JaxBatch(**batch._asdict())

    def loss(p):
        outs = jax_sf_forward(model, p, jb, ctx)
        return jax_objective.sf_losses(outs, jb, ctx, train=True,
                                       epoch=jnp.asarray(0.0),
                                       rng=jax.random.key(0))[0]

    g_ref = dispnet_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))

    net, state, step = _port_step(settings, params_np, 1)
    tb = batch_to_torch(batch, "cpu")
    for i in range(3):
        comps = step(tb)
        np.testing.assert_allclose(comps.numpy(), ref[i], rtol=1e-4, atol=0)
        if i == 0:
            for name, p in net.named_parameters():
                rel = torch.linalg.vector_norm(p.grad - g_ref[name]) / \
                    torch.linalg.vector_norm(g_ref[name])
                assert float(rel) <= 2e-3, (name, float(rel))
    assert state.step == 3


def test_train_step_accum2_matches_jax_accum2(setup):
    """accum_steps=2: two consecutive microbatches of bs/2, gradients summed
    and scaled by 1/2, components averaged, as in JAX; rtol 1e-4 over 3
    steps (measured <= 2.2e-6)."""
    settings, _, _, params_np, batch = setup
    ref = _jax_components(setup, accum_steps=2)
    _, _, step = _port_step(settings, params_np, 2)
    tb = batch_to_torch(batch, "cpu")
    for i in range(3):
        np.testing.assert_allclose(step(tb).numpy(), ref[i], rtol=1e-4,
                                   atol=0)


def test_adam_matches_optax():
    """torch.optim.Adam as TrainState builds it against optax.adam(1e-4)
    over 6 steps of given gradients: within 2e-7, an ulp or two of weights
    of size ~2 (the same update in another order of operations)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 1e-6, 0.5, 2.0)]
    opt = optax.adam(1e-4)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    lin = torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0))
    state = TrainState.create(lin, 1e-4, seed=0, device="cpu")
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        lin.weight.grad = torch.from_numpy(g.copy())
        state.optimizer.step()
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(p),
                               rtol=0, atol=2e-7)


def _random_outs(n, seed):
    rng = np.random.RandomState(seed)
    return [smooth_disparity(rng, (n, H, W), 2.0, 12.0)[..., None]
            for _ in range(4)]


@pytest.mark.parametrize("pyramid", [False, True])
@pytest.mark.parametrize("epoch", [0.0, 150.0])
def test_training_terms_match_jax(setup, pyramid, epoch):
    """sf_losses(train=True) on real data with pseudo GT: 6 + 4 pseudo-GT +
    4 SGM-warmup components, the SGM noise drawn from the JAX key and
    injected; the warmup gate closes at epoch 150. With the photometric
    pyramid the scales 1..3 run at 1/2^s resolution. rtol 1e-4."""
    settings, _, _, _, batch = setup
    n = TL * BS
    rng = np.random.RandomState(2)
    sgm = batch.disp_gt + rng.normal(0, 0.5, batch.disp_gt.shape)
    sgm[rng.rand(*sgm.shape) < 0.2] = 0.0
    pseudo = batch.disp_gt + rng.normal(0, 0.3, batch.disp_gt.shape)
    batch = batch._replace(sgm_disp=np.maximum(sgm, 0).astype(np.float32) * 4,
                           pseudo_gt=pseudo.astype(np.float32))
    outs = _random_outs(n, 3)
    kw = dict(data_type="real", use_pseudo_gt=True,
              photometric_pyramid=pyramid)
    key = jax.random.key(5)
    ctx_j = jax_objective.make_loss_context(settings, track_length=TL, **kw)
    _, ref = jax_objective.sf_losses(
        tuple(jnp.asarray(o) for o in outs), JaxBatch(**batch._asdict()),
        ctx_j, train=True, epoch=jnp.asarray(epoch), rng=key)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, (n, H, W))))
             for k in jax.random.split(key, 4)]
    ctx = make_loss_context(settings, TL, device="cpu", **kw)
    _, comps = sf_losses([torch.from_numpy(o) for o in outs],
                         batch_to_torch(batch, "cpu"), ctx, train=True,
                         epoch=epoch, sgm_noise=noise)
    assert comps.shape == (14,)
    np.testing.assert_allclose(comps.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-7)
    assert (comps[10:].numpy() == 0).all() == (epoch >= 150)


def test_gauss_blur5_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 20, 17).astype(np.float32)
    sigma = rng.uniform(0.2, 0.5, (3, 1, 1)).astype(np.float32)
    ref = np.asarray(jax_objective._gauss_blur5(jnp.asarray(x),
                                                jnp.asarray(sigma)))
    out = _gauss_blur5(torch.from_numpy(x), torch.from_numpy(sigma))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_augment_matches_jax_with_injected_draws(setup):
    """augment_batch_device against the JAX function, with the JAX draws
    (the same key splits) handed to the port; within 1e-6."""
    settings, _, _, _, batch = setup
    n = TL * BS
    ctx_j = jax_objective.make_loss_context(
        settings, track_length=TL, aug_max_sp_noise=0.05)
    key = jax.random.key(11)
    ref = jax_objective.augment_batch_device(JaxBatch(**batch._asdict()),
                                             key, ctx_j)
    ks = jax.random.split(key, 10)

    def uni(k, lo, hi, shape=(n, 1, 1)):
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, minval=lo, maxval=hi)))

    def normal(k):
        return torch.from_numpy(np.array(jax.random.normal(k, (n, H, W))))

    draws = AugmentDraws(
        blur_coin=uni(ks[0], 0.0, 1.0), blur_sigma_im=uni(ks[1], 0.2, 0.5),
        blur_sigma_amb=uni(ks[2], 0.2, 0.5), noise_im=normal(ks[3]),
        noise_scale_im=uni(ks[4], 0.0, 3.0), noise_amb=normal(ks[5]),
        noise_scale_amb=uni(ks[6], 0.0, 3.0), sp_coin=uni(ks[7], 0.0, 1.0),
        sp_ratio=uni(ks[8], 0.0, 0.05),
        sp_u=uni(ks[9], 0.0, 1.0, (2, n, H, W)))
    out = augment_batch_device(batch_to_torch(batch, "cpu"), draws)
    np.testing.assert_allclose(out.im.numpy(), np.asarray(ref.im), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(out.ambient.numpy(), np.asarray(ref.ambient),
                               rtol=0, atol=1e-6)
    assert not np.array_equal(out.im.numpy(), batch.im)


def test_net_params_cross_between_jax_and_the_port(setup, tmp_path):
    """A net_%04d.params written by the JAX package loads into the port as
    the same state_dict, and one written by the port loads into JAX as the
    same tree, bit for bit (the files are byte-identical)."""
    _, _, params, params_np, _ = setup
    (tmp_path / "jax").mkdir()
    jax_path = jax_save(tmp_path / "jax", 3, params)
    sd = load_net_params(jax_path)
    ref = dispnet_state_dict_from_flax(params_np)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], ref[k])

    net = DispNet()
    net.load_state_dict(ref)
    (tmp_path / "port").mkdir()
    port_path = save_net_params(tmp_path / "port", 3, net)
    assert port_path.name == "net_0003.params"
    back = jax_load(port_path, params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port_path.read_bytes() == jax_path.read_bytes()
