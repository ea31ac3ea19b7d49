"""The port's paths that take their optical flow from FlowNet
(output/flownet.msgpack), on the CPU: ``presave_flow --provider learned``
against the JAX tool; ``presave_disp multi_frame --flow_source net``, the
MF train step with ``net`` flow and TrackDisparityServer without flow
against the port's own composition (mf_forward fed flow_all_pairs' output);
the SF train and eval steps with ``flow_source="net"`` against the JAX
steps; the workers and the CLI's flags with ``--flow_source net``.

FuseNet turns float ulps into neighbour choices (tests/test_torch_mf.py),
so the paths that feed it learned flow are held to the port's own
composition, bit for bit, and FlowNet itself to JAX in
tests/test_torch_flownet.py."""
import json
from pathlib import Path

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data import load_settings as jax_load_settings
from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.tools import presave_flow as jax_presave_flow
from depthinspace_tpu.tools.train_flow import (
    load_flow_params as jax_load_flow_params)
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu.train.state import TrainState as JaxTrainState
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (TrackDataset, batch_to_torch,
                                         collate, decode_batch, encode_batch,
                                         hdf5, load_settings, make_settings,
                                         make_track_batch)
from depthinspace_tpu_torch.data.wire import (decode_field, encode_unit,
                                              to_u16_disp)
from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                           flax_tree_from_dispnet_state_dict,
                                           flow_all_pairs, init_dispnet_,
                                           init_fusenet_)
from depthinspace_tpu_torch.serve import (TrackDisparityServer, lcn_input,
                                          mf_forward, sf_forward)
from depthinspace_tpu_torch.tools import presave_disp, presave_flow
from depthinspace_tpu_torch.tools.train_flow import load_flow_params
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_mf_train_step,
                                          make_sf_eval_step,
                                          make_sf_train_step)
from depthinspace_tpu_torch.train.checkpoint import save_net_params
from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
from depthinspace_tpu_torch.utils.args import parse_args
from depthinspace_tpu_torch.utils import jrandom

H, W = 64, 56
WEIGHTS = Path(__file__).resolve().parents[1] / "output" / "flownet.msgpack"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow_net():
    return load_flow_params(WEIGHTS)[0]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 JAX fixture samples at 64x56 without flow.hdf5, each with a
    single_frame_disp.hdf5 (the GT plus seeded noise)."""
    d = tmp_path_factory.mktemp("netflow") / "data"
    generate_dataset(d, n_samples=3, imsize=(H, W), seed=9, write_flow=False)
    rng = np.random.RandomState(0)
    for sample in _samples(d):
        with hdf5.File(sample / "frames.hdf5") as f:
            gt = np.asarray(f["disp"], np.float32)
        hdf5.write_hdf5(sample / "single_frame_disp.hdf5", {
            "disp": np.maximum(gt + rng.randn(*gt.shape) * 0.5,
                               0.1).astype(np.float32)})
    return d


def _samples(d):
    return sorted(p for p in Path(d).glob("0*") if p.is_dir())


def test_presave_flow_learned_matches_jax(data, tmp_path):
    """flow.hdf5: the 12 flows (1, 2, H, W) float32 of each sample within
    1e-3 px of the JAX tool's (measured 1.4e-6)."""
    import shutil
    ref_dir = tmp_path / "jax"
    shutil.copytree(data, ref_dir)
    jax_presave_flow.main(["--provider", "learned", "--data_dir",
                           str(ref_dir), "--flow_params", str(WEIGHTS)])
    port_dir = tmp_path / "port"
    shutil.copytree(data, port_dir)
    presave_flow.main(["--provider", "learned", "--data_dir", str(port_dir),
                       "--flow_params", str(WEIGHTS)], device="cpu")
    for sample in _samples(ref_dir):
        with h5py.File(sample / "flow.hdf5", "r") as f:
            ref = {k: f[k][()] for k in f}
        with hdf5.File(port_dir / sample.name / "flow.hdf5") as f:
            out = {k: np.asarray(f[k]) for k in f.keys()}
        assert sorted(out) == sorted(ref) and len(out) == 12
        for k in ref:
            assert out[k].dtype == np.float32 and out[k].shape == (1, 2, H, W)
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-3)


def test_presave_disp_net_equals_its_composition(data, tmp_path, flow_net):
    """multi_frame_disp.hdf5 with --flow_source net and the default
    OUTPUT_DIR/flownet.msgpack (3 samples, batch 2: the tail padded) equals,
    bit for bit, mf_forward on the same decoded inputs fed flow_all_pairs'
    flow; shape, finiteness, range."""
    settings = load_settings(data / "settings.pkl")
    model = init_fusenet_(FuseNet((H, W), settings.K, 4),
                          jrandom.key(4)).eval()
    out_dir = tmp_path / "out"
    (out_dir / "multi_frame").mkdir(parents=True)
    save_net_params(out_dir / "multi_frame", 0, model)
    (out_dir / "flownet.msgpack").write_bytes(WEIGHTS.read_bytes())
    presave_disp.main(["multi_frame", "--epoch", "0", "--flow_source", "net",
                       "--batch", "2", "--data_dir", str(data),
                       "--output_dir", str(out_dir)], device="cpu")
    samples = _samples(data)
    for lo in range(0, len(samples), 2):
        group = samples[lo:lo + 2]
        reads = [presave_disp._read_sample(s, "multi_frame", "net")
                 for s in group]
        reads += reads[-1:] * (2 - len(reads))
        st = lambda k: torch.from_numpy(np.stack([r[k] for r in reads], 1))
        with torch.inference_mode():
            im = decode_field("im", st("im"))
            amb = decode_field("ambient", st("amb"))
            flow = flow_all_pairs(flow_net, im, amb)
            out = mf_forward(model, lcn_input(im), amb,
                             decode_field("primary_disp", st("primary")),
                             st("R"), st("t"), flow, settings.focal_length,
                             settings.baseline)
            want = to_u16_disp(out).numpy().astype(np.float32) / 256.0
        for k, s in enumerate(group):
            with hdf5.File(s / "multi_frame_disp.hdf5") as f:
                got = np.asarray(f["disp"])
            assert got.shape == (4, 1, H, W) and got.dtype == np.float32
            assert np.isfinite(got).all()
            assert got.min() >= 0 and got.max() <= 128
            np.testing.assert_array_equal(got[:, 0], want[:, k])


@pytest.fixture(scope="module")
def host_batch(data):
    """The wire-encoded batch of the 2 first samples (no flow)."""
    settings = load_settings(data / "settings.pkl")
    ds = TrackDataset(settings, [str(p) for p in _samples(data)],
                      train=False, load_primary=True)
    return encode_batch(collate([ds[0], ds[1]]))


@pytest.mark.parametrize("which", ["train", "eval"])
def test_sf_steps_with_net_flow_match_jax(data, host_batch, flow_net, which):
    """The SF train step's and eval step's components with flow_source
    "net" (the JAX test tests/test_flownet.py::test_flow_source_net_in_graph
    with the trained weights) within rtol 1e-4 of the JAX steps'; the eval
    disparity within one u16 unit."""
    settings = load_settings(data / "settings.pkl")
    net = init_dispnet_(DispNet(max_disp=128.0),
                        jrandom.key(5))
    params = jax.tree.map(jnp.asarray,
                          flax_tree_from_dispnet_state_dict(net.state_dict()))
    flow_params, _ = jax_load_flow_params(WEIGHTS, (H, W))
    ctx = jax_objective.make_loss_context(
        jax_load_settings(data / "settings.pkl"), track_length=4,
        flow_source="net", flow_params=flow_params, flow_in_channels=2)
    opt = optax.adam(1e-4)
    train_step, eval_step, consts = _make_step_fns(
        JaxDispNet(max_disp=128.0), ctx, opt, "single_frame")
    jb = JaxBatch(**host_batch._asdict())
    pctx = make_loss_context(settings, 4, device="cpu", flow_source="net",
                             flow_net=flow_net)
    pb = batch_to_torch(host_batch, "cpu")
    if which == "train":
        _, ref = jax.jit(train_step)(
            JaxTrainState.create(params, opt, jax.random.key(1)), jb,
            jnp.asarray(0.0), consts)
        state = TrainState.create(net, 1e-4, seed=0, device="cpu")
        comps = make_sf_train_step(net, pctx, state)(pb).numpy()
    else:
        ref_disp, ref = jax.jit(eval_step)(params, jb, jnp.asarray(0.0),
                                           consts)
        disp, comps = make_sf_eval_step(net.eval(), pctx)(pb)
        dd = np.abs(disp.numpy().astype(np.int64)
                    - np.asarray(ref_disp).astype(np.int64))
        assert dd.max() <= 1
        comps = comps.numpy()
    assert comps.shape == (6,) and np.isfinite(comps).all()
    np.testing.assert_allclose(comps, np.asarray(ref), rtol=1e-4, atol=0)


def test_mf_step_net_flow_equals_the_step_fed_that_flow():
    """The MF train step with flow_source "net" gives the components and
    the gradients, bit for bit, of the "file" step fed flow_all_pairs' flow
    of the decoded batch as a float32 field."""
    settings = make_settings(32, 24, focal=20.0)
    b = encode_batch(make_track_batch(settings, tl=4, bs=2, seed=3,
                                      disp_range=(2.0, 8.0),
                                      primary_noise=0.5))
    net, _ = load_flow_params(WEIGHTS)
    pb = batch_to_torch(b._replace(flow=None), "cpu")
    dec = decode_batch(pb)
    fed = dec._replace(flow=flow_all_pairs(net, dec.im, dec.ambient))

    def run(batch, **kw):
        model = init_fusenet_(FuseNet((32, 24), settings.K, 4, block_num=1,
                                      channels=8,
                                      compute_dtype=torch.float32),
                              jrandom.key(6))
        state = TrainState.create(model, 1e-4, seed=0, device="cpu")
        comps = make_mf_train_step(model, make_loss_context(
            settings, 4, device="cpu", **kw), state)(batch)
        return comps.numpy(), {k: p.grad.clone()
                               for k, p in model.named_parameters()}

    c_net, g_net = run(pb, flow_source="net", flow_net=net)
    c_file, g_file = run(fed)
    assert c_net.shape == (4,) and np.isfinite(c_net).all()
    np.testing.assert_array_equal(c_net, c_file)
    for k in g_net:
        torch.testing.assert_close(g_net[k], g_file[k], rtol=0, atol=0)


def test_track_server_learned_flow_equals_its_composition(flow_net):
    """infer(flow=None) with a FlowNet: a ragged 3-track request (bucket 4)
    equals, bit for bit, the composition of DIS-SF, flow_all_pairs and
    mf_forward on the same wire-decoded inputs; the three constructors
    agree; a server without a FlowNet raises ValueError as the JAX one."""
    Ht, Wt, n, tl = 32, 24, 3, 4
    settings = make_settings(Ht, Wt, focal=20.0)
    b = make_track_batch(settings, tl=tl, bs=n, seed=7,
                         disp_range=(2.0, 8.0))
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 0))
    im, amb, R, t = mv(b.im), mv(b.ambient), mv(b.R), mv(b.t)
    sf = init_dispnet_(DispNet(), jrandom.key(0)).eval()
    mf = init_fusenet_(FuseNet((Ht, Wt), settings.K, tl, block_num=1,
                               channels=8, compute_dtype=torch.float32),
                       jrandom.key(1)).eval()
    srv = TrackDisparityServer(sf, mf, flow_net, imsize=(Ht, Wt),
                               K=settings.K, max_tracks=4, device="cpu")
    out = srv.infer(im, amb, R, t)
    assert out.shape == (n, tl, Ht, Wt) and np.isfinite(out).all()

    pad = lambda a: np.concatenate([a, a[-1:]])        # bucket 4
    dev = lambda a: torch.from_numpy(encode_unit(np.moveaxis(pad(a), 0, 1)))
    with torch.inference_mode():
        im_d, amb_d = decode_field("im", dev(im)), decode_field("ambient",
                                                              dev(amb))
        ir = lcn_input(im_d)
        flow = flow_all_pairs(flow_net, im_d, amb_d)
        assert flow.dtype == torch.float32
        want = mf_forward(mf, ir, amb_d, sf_forward(sf, ir),
                          torch.from_numpy(np.moveaxis(pad(R), 0, 1).copy()),
                          torch.from_numpy(np.moveaxis(pad(t), 0, 1).copy()),
                          flow, srv.focal, srv.baseline)
        want = to_u16_disp(want).numpy().astype(np.float32) / 256.0
    np.testing.assert_array_equal(out, np.moveaxis(want, 0, 1)[:n])

    with pytest.raises(ValueError, match="no flow provided"):
        TrackDisparityServer(sf, mf, imsize=(Ht, Wt), K=settings.K,
                             device="cpu").infer(im, amb, R, t)


def test_track_server_from_files_with_flow_params(tmp_path, flow_net):
    """from_net_params(..., flow_params_path=) and from_jax_params(...,
    flow_tree) load the same FlowNet and serve the same request as the
    server built from the modules."""
    from depthinspace_tpu_torch.models import (
        flax_tree_from_flownet_state_dict, flax_tree_from_fusenet_state_dict)
    Ht, Wt = 32, 24
    settings = make_settings(Ht, Wt, focal=20.0)
    b = make_track_batch(settings, tl=4, bs=1, seed=8, disp_range=(2.0, 8.0))
    mv = lambda a: np.ascontiguousarray(np.moveaxis(a, 1, 0))
    req = (mv(b.im), mv(b.ambient), mv(b.R), mv(b.t))
    sf = init_dispnet_(DispNet(), jrandom.key(0)).eval()
    mf = init_fusenet_(FuseNet((Ht, Wt), settings.K, 4,
                               compute_dtype=torch.float32),
                       jrandom.key(1)).eval()
    kw = dict(imsize=(Ht, Wt), K=settings.K, compute_dtype=torch.float32,
              device="cpu")
    ref = TrackDisparityServer(sf, mf, flow_net, imsize=(Ht, Wt),
                               K=settings.K, device="cpu").infer(*req)
    for name, model in (("sf", sf), ("mf", mf)):
        (tmp_path / name).mkdir()
        save_net_params(tmp_path / name, 0, model)
    srv = TrackDisparityServer.from_net_params(
        tmp_path / "sf" / "net_0000.params",
        tmp_path / "mf" / "net_0000.params", flow_params_path=WEIGHTS, **kw)
    np.testing.assert_array_equal(srv.infer(*req), ref)
    srv = TrackDisparityServer.from_jax_params(
        flax_tree_from_dispnet_state_dict(sf.state_dict()),
        flax_tree_from_fusenet_state_dict(mf.state_dict()),
        flax_tree_from_flownet_state_dict(flow_net.state_dict()), **kw)
    np.testing.assert_array_equal(srv.infer(*req), ref)


@pytest.mark.parametrize("arch", ["single_frame", "multi_frame"])
def test_workers_train_with_net_flow_from_cli_flags(data, tmp_path, arch):
    """The CLI's flags (--flow_source net, --flow_params, or its default
    OUTPUT_DIR/flownet.msgpack for DIS-MF) through RunConfig into the
    worker: one epoch of 2 steps and a test on a fixture dataset that has no
    flow.hdf5, finite losses, and the log naming the FlowNet."""
    out = tmp_path / "out"
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps({"DATA_DIR": str(data),
                                    "OUTPUT_DIR": str(out)}))
    argv = ["--architecture", arch, "--flow_source", "net", "--cmd",
            "retrain", "--epochs", "1", "--train_batch_size", "1",
            "--test_batch_size", "1", "--max_train_iter", "2",
            "--mf_dtype", "float32"]
    if arch == "single_frame":
        argv += ["--flow_params", str(WEIGHTS)]
    else:
        out.mkdir()
        (out / "flownet.msgpack").write_bytes(WEIGHTS.read_bytes())
    args = parse_args(argv)
    cfg = RunConfig.from_args(args, config_path=str(cfg_path))
    assert cfg.flow_source == "net"
    cfg.num_workers = 1
    worker = (SingleFrameWorker if arch == "single_frame"
              else MultiFrameWorker)
    worker(cfg, device="cpu").do(args.cmd)
    exp = out / arch
    m0 = json.loads((exp / "metrics.json").read_text())["0"]
    n_comps = 6 if arch == "single_frame" else 4
    assert len(m0["train"]["loss"]) == n_comps
    assert np.isfinite(m0["train"]["loss"]).all()
    assert np.isfinite(m0["test"]["0"]["loss"]).all()
    assert "FlowNet provider" in (exp / "train.log").read_text()
    assert (exp / "net_0000.params").exists()
