"""The DIS-MF path of the port against the JAX package on the CPU, on the
same numpy inputs and weights: the MF geometric loss and loss vector, the
eval step, the train step (3 steps, accumulation, the "pred" flow source),
TrackDisparityServer, and the worker on a fixture dataset with presaved
primary disparities.

FuseNet's neighbour selection breaks exact ties by the last bit of its
geometry (tests/test_torch_fusenet.py), and the JAX package's jitted graph
rounds that geometry otherwise than its op-by-op execution: its own jitted
and op-by-op MF steps differ by ~1e-3 relative in the geometric term, which
subtracts two nearly equal depths. The steps are therefore held against the
JAX steps run op by op (``jax.disable_jit``), with translation-only poses
(R = I, where the rotation products are exact in both packages)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.losses.geometric import CameraGeometry as JaxCam
from depthinspace_tpu.losses.geometric import geometric_loss_mf as jax_geo_mf
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.models import FuseNet as JaxFuseNet
from depthinspace_tpu.serve import TrackDisparityServer as JaxTrackServer
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu.train.state import TrainState as JaxTrainState
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (batch_to_torch, load_settings,
                                         make_settings, make_track_batch)
from depthinspace_tpu_torch.losses import CameraGeometry, geometric_loss_mf
from depthinspace_tpu_torch.models import (FuseNet,
                                           fusenet_state_dict_from_flax)
from depthinspace_tpu_torch.serve import TrackDisparityServer
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_mf_eval_step,
                                          make_mf_train_step, mf_losses)
from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker

H, W, TL = 64, 56, 4
BLOCKS, CH = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    s = make_settings(H, W)
    K = tuple(map(tuple, np.asarray(s.K, np.float64).tolist()))
    jm = JaxFuseNet(imsize=(H, W), K=K, track_length=TL, block_num=BLOCKS,
                    channels=CH, use_remat=False)
    z = jnp.zeros
    params = jm.init(
        jax.random.key(0), z((TL, 1, H, W, 2)), z((TL, 1, H, W, 1)),
        z((TL, 1, H, W, 1)), jnp.ones((TL, 1, H, W, 1)),
        jnp.broadcast_to(jnp.eye(3), (TL, 1, 3, 3)), z((TL, 1, 3)),
        z((TL, TL, 1, H, W, 2)))
    return s, K, jm, params, jax.tree.map(np.array, params)


def _batch(s, bs, seed=1, max_angle=0.0):
    return make_track_batch(s, tl=TL, bs=bs, seed=seed,
                            disp_range=(2.0, 12.0), max_angle=max_angle,
                            primary_noise=0.5)


def _port_net(K, params_np):
    m = FuseNet((H, W), K, TL, block_num=BLOCKS, channels=CH)
    m.load_state_dict(fusenet_state_dict_from_flax(params_np, m))
    return m


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))


def test_geometric_loss_mf_matches_jax(setup):
    """With rotations, random disparities for the depth; the rf mask from
    the stand-in primary: rtol 1e-5."""
    s = setup[0]
    b = _batch(s, 2, max_angle=0.004)
    rng = np.random.RandomState(4)
    disp = b.disp_gt + rng.normal(0, 0.3, b.disp_gt.shape).astype(np.float32)
    f = s.focal_length * s.baseline
    depth, pdepth = f / np.maximum(disp, 0.1), f / b.primary_disp
    ref = jax_geo_mf(JaxCam.create(s.K, H, W), jnp.asarray(depth),
                     jnp.asarray(b.R), jnp.asarray(b.t), jnp.asarray(b.flow),
                     jnp.asarray(b.ambient), jnp.asarray(pdepth))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    out = geometric_loss_mf(CameraGeometry.create(s.K, H, W), t(depth),
                            t(b.R), t(b.t), t(b.flow), t(b.ambient),
                            t(pdepth))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("train,epoch,data_type", [
    (False, 0.0, "synthetic"), (True, 1.0, "synthetic"),
    (True, 2.0, "synthetic"), (True, 0.0, "real"), (True, 150.0, "real")])
def test_mf_losses_match_jax(setup, train, epoch, data_type):
    """mf_losses on the same disparities: 3 components, + the primary L1
    when training (gated off from epoch 2), + the SGM warmup on real data
    (gated off from epoch 150; the JAX noise injected); rtol 1e-4."""
    s = setup[0]
    b = _batch(s, 2, max_angle=0.004)
    rng = np.random.RandomState(5)
    out = (b.disp_gt + rng.normal(0, 0.3, b.disp_gt.shape))[..., None]
    out = out.astype(np.float32)
    sgm = np.maximum(b.disp_gt + rng.normal(0, 0.5, b.disp_gt.shape), 0) * 4
    sgm[rng.rand(*sgm.shape) < 0.2] = 0.0
    b = b._replace(sgm_disp=sgm.astype(np.float32))
    key = jax.random.key(6)
    ctx_j = jax_objective.make_loss_context(s, track_length=TL,
                                            data_type=data_type)
    _, ref = jax_objective.mf_losses(jnp.asarray(out), JaxBatch(
        **b._asdict()), ctx_j, train=train, epoch=jnp.asarray(epoch),
        rng=key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (TL * 2, H, W))))
    _, comps = mf_losses(torch.from_numpy(out), batch_to_torch(b, "cpu"),
                         make_loss_context(s, TL, device="cpu",
                                           data_type=data_type),
                         train=train, epoch=epoch, sgm_noise=noise)
    n = 3 + train + (train and data_type == "real")
    assert comps.shape == (n,)
    np.testing.assert_allclose(comps.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-7)
    if train:
        assert (float(comps[3]) == 0.0) == (epoch >= 2)


@pytest.mark.parametrize("flow_source", ["file", "pred"])
def test_mf_eval_step_matches_jax(setup, flow_source):
    """Against the JAX eval step run op by op, bs = 1, R = I: components
    rtol 1e-4 (measured <= 1e-6),
    disp0 within 1 u16 unit (1/256 px)."""
    s, K, jm, params, params_np = setup
    b = _batch(s, 1)
    ctx = jax_objective.make_loss_context(s, track_length=TL,
                                          flow_source=flow_source)
    _, eval_step, consts = _make_step_fns(jm, ctx, optax.adam(1e-4),
                                          "multi_frame")
    with jax.disable_jit():
        d_ref, c_ref = eval_step(params, JaxBatch(**b._asdict()),
                                 jnp.asarray(0.0), consts)
    step = make_mf_eval_step(_port_net(K, params_np), make_loss_context(
        s, TL, device="cpu", flow_source=flow_source))
    d_out, c_out = step(batch_to_torch(b, "cpu"))
    assert c_out.shape == (3,) and d_out.dtype == torch.uint16
    assert d_out.shape == (TL, 1, H, W)
    np.testing.assert_allclose(c_out.numpy(), np.asarray(c_ref), rtol=1e-4)
    dd = np.abs(d_out.numpy().astype(np.int64)
                - np.asarray(d_ref).astype(np.int64))
    assert dd.max() <= 1


def _jax_steps(setup, b, accum_steps=1, flow_source="file", n_steps=3):
    """The JAX MF train step run op by op, n_steps times."""
    s, _, jm, params, _ = setup
    ctx = jax_objective.make_loss_context(s, track_length=TL,
                                          flow_source=flow_source)
    opt = optax.adam(1e-4)
    train_step, _, consts = _make_step_fns(jm, ctx, opt, "multi_frame",
                                           accum_steps=accum_steps)
    state = JaxTrainState.create(params, opt, jax.random.key(1))
    out = []
    with jax.disable_jit():
        for _ in range(n_steps):
            state, comps = train_step(state, JaxBatch(**b._asdict()),
                                      jnp.asarray(0.0), consts)
            out.append(np.asarray(comps))
    return out


def _port_steps(setup, b, accum_steps=1, flow_source="file", n_steps=3):
    s, K, _, _, params_np = setup
    m = _port_net(K, params_np)
    state = TrainState.create(m, 1e-4, seed=0, device="cpu")
    step = make_mf_train_step(m, make_loss_context(
        s, TL, device="cpu", flow_source=flow_source), state,
        accum_steps=accum_steps)
    tb = batch_to_torch(b, "cpu")
    out = [step(tb).numpy() for _ in range(n_steps)]
    assert state.step == n_steps
    return m, out


def test_mf_train_step_matches_jax_for_three_steps(setup):
    """Adam(1e-4), f32, bs = 1: the 4 components within rtol 1e-4 at each
    of 3 steps (measured <= 5.3e-5, the smoothness term at step 2), and the
    first step's gradient within 1e-3 relative L2 over all parameters."""
    s, K, jm, params, params_np = setup
    b = _batch(s, 1)
    ref = _jax_steps(setup, b)
    ctx = jax_objective.make_loss_context(s, track_length=TL)
    jb = JaxBatch(**b._asdict())
    from depthinspace_tpu.train.steps import _mf_forward as jax_mf_forward

    def loss(p):
        out = jax_mf_forward(jm, p, jb, ctx)
        return jax_objective.mf_losses(out, jb, ctx, train=True,
                                       epoch=jnp.asarray(0.0),
                                       rng=jax.random.key(0))[0]

    with jax.disable_jit():
        g_tree = jax.tree.map(np.array, jax.grad(loss)(params))
    m = _port_net(K, params_np)
    g_ref = fusenet_state_dict_from_flax(g_tree, m)
    state = TrainState.create(m, 1e-4, seed=0, device="cpu")
    step = make_mf_train_step(m, make_loss_context(s, TL, device="cpu"),
                              state)
    tb = batch_to_torch(b, "cpu")
    for i in range(3):
        comps = step(tb).numpy()
        assert comps.shape == (4,)
        np.testing.assert_allclose(comps, ref[i], rtol=1e-4, atol=0)
        if i == 0:
            got = dict(m.named_parameters())
            diff = torch.cat([(got[k].grad - g_ref[k]).flatten()
                              for k in g_ref])
            whole = torch.cat([g_ref[k].flatten() for k in g_ref])
            assert float(diff.norm() / whole.norm()) <= 1e-3


@pytest.mark.parametrize("accum_steps,flow_source", [(2, "file"),
                                                     (1, "pred")])
def test_mf_train_step_variants_match_jax(setup, accum_steps, flow_source):
    """accum_steps = 2 (bs = 2: two microbatches, gradients summed and
    halved, components averaged) and flow_source = "pred" (the rigid flow
    of the primary disparity): rtol 1e-4 over 2 steps."""
    b = _batch(setup[0], accum_steps)
    ref = _jax_steps(setup, b, accum_steps, flow_source, n_steps=2)
    _, out = _port_steps(setup, b, accum_steps, flow_source, n_steps=2)
    for i in range(2):
        np.testing.assert_allclose(out[i], ref[i], rtol=1e-4, atol=0)


def test_track_server_matches_jax_server():
    """TrackDisparityServer with flow given against the JAX server
    (compute_dtype float32, 32x32, fresh inits as tests/test_serve.py makes
    them), a ragged 3-track request padded to bucket 4, within one output
    unit (1/256 px). The primary comes from DispNet, whose float32 sums
    round differently in the two packages, and an ulp of the primary moves
    tied neighbour choices (the JAX server's own jitted and op-by-op
    outputs differ by 0.3 px on average on consistent flow); so the flow
    here is one the forward-backward test rejects everywhere, which leaves
    the target frame's own 3x3 candidates and a selection no rounding can
    move. Consistent (rigid) flow then changes the output; without flow the
    server raises, naming the unported FlowNet."""
    Ht, Wt, n = 32, 32, 3
    K = np.array([[20.0, 0, Wt / 2], [0, 20.0, Ht / 2], [0, 0, 1]],
                 np.float32)
    sf_params = JaxDispNet(max_disp=128.0).init(jax.random.key(0),
                                                jnp.zeros((1, Ht, Wt, 2)))
    mf = JaxFuseNet(imsize=(Ht, Wt), K=tuple(map(tuple, K.tolist())),
                    track_length=TL, max_disp=128.0)
    z = jnp.zeros
    mf_params = mf.init(
        jax.random.key(1), z((TL, 1, Ht, Wt, 2)), z((TL, 1, Ht, Wt, 1)),
        z((TL, 1, Ht, Wt, 1)), jnp.ones((TL, 1, Ht, Wt, 1)),
        jnp.broadcast_to(jnp.eye(3), (TL, 1, 3, 3)), z((TL, 1, 3)),
        z((TL, TL, 1, Ht, Wt, 2)))
    settings = make_settings(Ht, Wt, focal=20.0)
    b = make_track_batch(settings, tl=TL, bs=n, seed=2,
                         disp_range=(2.0, 8.0))
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 0))
    im, amb, R, t = mv(b.im), mv(b.ambient), mv(b.R), mv(b.t)
    rigid = np.ascontiguousarray(np.moveaxis(b.flow, 2, 0))
    rejected = np.zeros_like(rigid)
    rejected[..., 0] = 5.0                  # |f + f_back|^2 = 100 > 1.0
    ref = JaxTrackServer(sf_params, mf_params, None, imsize=(Ht, Wt), K=K,
                         track_length=TL, max_tracks=4,
                         compute_dtype=jnp.float32).infer(
                             im, amb, R, t, flow=rejected)
    srv = TrackDisparityServer.from_jax_params(
        jax.tree.map(np.array, sf_params), jax.tree.map(np.array, mf_params),
        imsize=(Ht, Wt), K=K, track_length=TL, compute_dtype=torch.float32,
        max_tracks=4, device="cpu")
    out = srv.infer(im, amb, R, t, rejected)
    assert out.shape == (n, TL, Ht, Wt) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.0 / 256)
    assert np.abs(srv.infer(im, amb, R, t, rigid) - out).mean() > 0.1
    with pytest.raises(NotImplementedError, match="FlowNet"):
        srv.infer(im, amb, R, t)


def test_multi_frame_worker_on_a_fixture_with_presaved_primary(tmp_path):
    """MultiFrameWorker on a fixture dataset written by the JAX package plus
    a single_frame_disp.hdf5 per sample (the GT with seeded noise, written
    here with h5py): retrain one epoch, resume at epoch 1, retest epoch 0 to
    the same test loss; net_0000.params is written and the JAX worker's
    metrics.json keys are there."""
    import h5py
    d = tmp_path / "ds"
    generate_dataset(d, n_samples=4, imsize=(64, 56), seed=3)
    rng = np.random.RandomState(0)
    for sample in sorted(d.glob("0*")):
        with h5py.File(sample / "frames.hdf5", "r") as f:
            gt = np.asarray(f["disp"], np.float32)
        with h5py.File(sample / "single_frame_disp.hdf5", "w") as f:
            f["disp"] = np.maximum(gt + rng.randn(*gt.shape) * 0.5,
                                   0.1).astype(np.float32)
    cfg = RunConfig(data_dir=d, output_dir=tmp_path / "out",
                    architecture="multi_frame", epochs=1, train_batch_size=1,
                    test_batch_size=1, max_train_iter=2, num_workers=1,
                    mf_dtype="float32")
    MultiFrameWorker(cfg, device="cpu").do("retrain")
    exp = tmp_path / "out" / "multi_frame"
    assert (exp / "net_0000.params").exists()
    m0 = (exp / "metrics.json").read_text()
    import json
    m0 = json.loads(m0)
    loss0 = m0["0"]["test"]["0"]["loss"]
    assert len(loss0) == 3 and {"dist2_mean", "of1"} <= set(m0["0"]["test"]
                                                            ["0"])
    assert len(m0["0"]["train"]["loss"]) == 4
    cfg.epochs = 2
    MultiFrameWorker(cfg, device="cpu").do("resume")
    assert "Resumed from epoch 0" in (exp / "train.log").read_text()
    assert sorted(json.loads((exp / "metrics.json").read_text())) == \
        ["0", "1"]
    MultiFrameWorker(cfg, device="cpu").do("retest", epoch=0)
    again = json.loads((exp / "metrics.json").read_text())["0"]["test"]["0"]
    np.testing.assert_allclose(again["loss"], loss0, rtol=1e-5)
    assert load_settings(d / "settings.pkl").imsize == (64, 56)


def test_auto_accumulation_follows_the_jax_rule(tmp_path):
    """accum_steps = 0: 2 for DIS-MF without remat at bs >= 4 (even) and
    512x432, else 1; an explicit value wins."""
    from depthinspace_tpu_torch.data import SyntheticSource

    def accum(**kw):
        src = SyntheticSource(make_settings(*kw.pop("size")), 2,
                              primary_noise=0.5)
        cfg = RunConfig(data_dir=tmp_path, output_dir=tmp_path,
                        architecture="multi_frame", **kw)
        return MultiFrameWorker(cfg, device="cpu", source=src).accum_steps

    assert accum(size=(512, 432), train_batch_size=4) == 2
    assert accum(size=(512, 432), train_batch_size=4, mf_remat=True) == 1
    assert accum(size=(512, 432), train_batch_size=3) == 1
    assert accum(size=(64, 56), train_batch_size=4) == 1
    assert accum(size=(512, 432), train_batch_size=4, accum_steps=1) == 1
