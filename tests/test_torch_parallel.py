"""The port's data parallelism on the CPU: two gloo processes against the
JAX package's step on a 2-device mesh (``make_mesh(jax.devices()[:2])`` on
the conftest's virtual devices), the batch layout helpers against the JAX
ones, the worker in two ranks against one process, and the server's
replicas.

The 2-process step must be the JAX mesh step: the gradient of the global
batch's loss. Its batch is built so that a wrong reduction shows: samples
4-7 (rank 1's block, or with accum_steps=2 the second global microbatch)
have inconsistent flow on half their rows, so their accepted geometric
mask counts are half of samples 0-3's. Averaging the ranks' own ratios
(what a plain DDP average computes), or chunking each rank's own block
into microbatches, then misses the JAX components by more than the
tolerance, and the tests assert that it does.

DIS-MF follows the MF tests' rule (tests/test_torch_mf.py): FuseNet's
neighbour selection breaks exact ties by the last bit of its geometry,
which the JAX package's jitted graph rounds otherwise than its op-by-op
execution, so the MF steps are held against the JAX mesh step run op by
op (``jax.disable_jit``), with translation-only poses; they are in
tests/test_torch_parallel_mf.py, which xdist runs beside this file.

Each rank runs in a subprocess (this file run as a script) that joins a
``file://`` rendezvous in ``tmp_path`` (no port is shared between xdist
workers), with a 120 s timeout.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from depthinspace_tpu_torch.data import (Batch, batch_to_torch, make_settings,
                                         make_track_batch)
from depthinspace_tpu_torch.models import DispNet, FuseNet

H, W, TL, BS = 32, 24, 4, 8
BLOCKS, CH = 2, 16
CHILD_TIMEOUT_S = 120
# SGD, as tests/test_parallel.py, so that the parameters after one step are
# linear in the gradients; at 1e-3, not its 1e-2: this batch's accepted
# geometric masks give gradients far above those of its random flow, and at
# 1e-2 one FuseNet weight in 476k ended 1.1e-5 from JAX's (2x its atol)
# after one step, from the float summation order of XLA's and oneDNN's
# convolutions, not from the reduction under test
LR = 1e-3


def settings():
    """tests/test_parallel.py's camera: focal 20 px, baseline 0.025."""
    return make_settings(H, W, focal=20.0)


def make_batch(arch: str, bs: int = BS) -> Batch:
    """Synthetic tracks with translation-only poses (R = I) and their rigid
    flow; the second half of the batch gets 7 px more flow on the upper
    half of every frame, which the forward-backward test rejects there."""
    b = make_track_batch(settings(), tl=TL, bs=bs, seed=1,
                         disp_range=(2.0, 12.0), max_angle=0.0,
                         primary_noise=0.5)
    flow = b.flow.copy()
    flow[:, :, bs // 2:, :H // 2, :, 0] += 7.0 * (1 - np.eye(TL))[
        :, :, None, None, None]
    return b._replace(flow=flow, primary_disp=(
        b.primary_disp if arch == "multi_frame" else None))


def metric_inputs(batch: Batch):
    """u16 x256 estimates and GT of the batch for the device metric."""
    rng = np.random.RandomState(1)
    gt = torch.from_numpy(np.round(batch.disp_gt * 256).astype(np.uint16))
    es = torch.from_numpy(np.clip(
        batch.disp_gt * 256 + rng.normal(0, 200, batch.disp_gt.shape), 0,
        65535).astype(np.uint16))
    return es, gt


def port_model(arch: str):
    if arch == "single_frame":
        return DispNet()
    return FuseNet((H, W), settings().K, TL, block_num=BLOCKS, channels=CH)


def run_ranks(tmp_path: Path, name: str, world: int = 2, mode_=None,
              **spec) -> list:
    """Run this file as ``world`` processes, the child ``mode_`` (default
    ``name``), with the rendezvous ``name``; rank r's output file is
    rank<r>_<name> in ``tmp_path``. Fails with a rank's output if one exits
    nonzero or outlives the timeout."""
    mode = mode_ or name
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for r in range(world):
        args = dict(spec, mode=mode, rank=r, world=world,
                    init=f"file://{tmp_path}/rendezvous_{name}",
                    out=str(tmp_path / f"rank{r}_{name}"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, json.dumps(args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} ({name}):\n{out[-4000:]}"
    return [tmp_path / f"rank{r}_{name}" for r in range(world)]


# ---------------------------------------------------------------- children
def _child_step(spec: dict) -> None:
    """One SGD(LR) train step of rank ``rank`` from the converted JAX
    init, the correct one and the two wrong reductions; and the device
    metric of the batch's disparities, each rank counting its block; saved
    to out."""
    from depthinspace_tpu_torch.parallel import (all_gather_batch,
                                                 default_group,
                                                 init_multihost, shard_batch)
    from depthinspace_tpu_torch.utils.metric import StreamingEvalMetric
    from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                              make_mf_train_step,
                                              make_sf_train_step)
    arch, accum = spec["arch"], spec["accum"]
    rank, world = spec["rank"], spec["world"]
    init_multihost(device="cpu", init_method=spec["init"], rank=rank,
                   world_size=world)
    group = default_group()
    batch = Batch(**{k: v for k, v in np.load(spec["batch"]).items()})
    init = torch.load(spec["weights"])
    make_step = (make_sf_train_step if arch == "single_frame"
                 else make_mf_train_step)

    def step(local, grp, k):
        model = port_model(arch)
        model.load_state_dict(init)
        state = TrainState.create(model, seed=0, device="cpu")
        state.optimizer = torch.optim.SGD(model.parameters(), lr=LR)
        ctx = make_loss_context(settings(), TL, device="cpu", group=grp)
        comps = make_step(model, ctx, state, accum_steps=k)(
            batch_to_torch(local, "cpu"))
        return comps.numpy(), model

    comps, model = step(shard_batch(batch, rank, world, accum), group, accum)
    out = {"comps": comps,
           "params": {k: v.numpy() for k, v in model.state_dict().items()},
           # what a per-rank average computes: this rank's own ratios
           "comps_local": step(shard_batch(batch, rank, world), None, 1)[0],
           # each rank chunks its own contiguous block
           "comps_own_chunks": step(shard_batch(batch, rank, world), group,
                                    accum)[0]}
    es, gt = metric_inputs(batch)
    bs = batch.im.shape[1]
    lo, hi = rank * bs // world, (rank + 1) * bs // world
    met = StreamingEvalMetric()
    met.add(es[:, lo:hi], gt[:, lo:hi], hi - lo)
    met.all_reduce(group)
    out["metric"] = met.get()
    out["gathered"] = all_gather_batch(es[:, lo:hi], 1, group).numpy()
    torch.save(out, spec["out"])


def _child_worker(spec: dict) -> None:
    """SingleFrameWorker runs in rank ``rank``, one after the other: each a
    config and a command; rank 1 may write to its own output directory
    (``rank1_output_dir``), its clock read past the deadline (``late``)
    and its max_train_iter differ."""
    from depthinspace_tpu_torch.config import RunConfig
    from depthinspace_tpu_torch.parallel import init_multihost
    from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
    init_multihost(device="cpu", init_method=spec["init"],
                   rank=spec["rank"], world_size=spec["world"])
    if spec["rank"] == 1 and spec.get("late"):
        time.time = lambda: 1e12
    for run in spec["runs"]:
        cfg = RunConfig(**run["cfg"])
        if spec["rank"] == 1:
            cfg.output_dir = Path(run.get("rank1_output_dir",
                                          cfg.output_dir))
            cfg.max_train_iter = run.get("rank1_max_train_iter",
                                         cfg.max_train_iter)
        SingleFrameWorker(cfg, device="cpu").do(run["cmd"])
    Path(spec["out"]).write_text("done")


if __name__ == "__main__":
    torch.set_num_threads(2)
    _spec = json.loads(sys.argv[1])
    sys.path.insert(0, str(Path(__file__).parent.parent))
    {"step": _child_step, "worker": _child_worker}[_spec["mode"]](_spec)
    torch.distributed.destroy_process_group()
    sys.exit(0)


# -------------------------------------------------------------- the tests
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from depthinspace_tpu.data.dataset import Batch as JaxBatch  # noqa: E402
from depthinspace_tpu.models import DispNet as JaxDispNet  # noqa: E402
from depthinspace_tpu.models import FuseNet as JaxFuseNet  # noqa: E402
from depthinspace_tpu.parallel import mesh as jax_mesh  # noqa: E402
from depthinspace_tpu.parallel import multihost as jax_multihost  # noqa: E402
from depthinspace_tpu.train import TrainState as JaxTrainState  # noqa: E402
from depthinspace_tpu.train import build_steps  # noqa: E402
from depthinspace_tpu.train import make_loss_context as jax_ctx  # noqa: E402
from depthinspace_tpu_torch import parallel  # noqa: E402
from depthinspace_tpu_torch.config import RunConfig  # noqa: E402
from depthinspace_tpu_torch.data.fixture import generate_dataset  # noqa: E402
from depthinspace_tpu_torch.models import (  # noqa: E402
    dispnet_state_dict_from_flax, fusenet_state_dict_from_flax)
from depthinspace_tpu_torch.parallel import multihost  # noqa: E402
from depthinspace_tpu_torch.serve import DisparityServer  # noqa: E402
from depthinspace_tpu_torch.train.single_frame import (  # noqa: E402
    SingleFrameWorker)
from depthinspace_tpu_torch.utils.metric import (  # noqa: E402
    StreamingEvalMetric)

RTOL_C, ATOL_C = 2e-4, 1e-6            # tests/test_parallel.py's
RTOL_P, ATOL_P = 5e-4, 5e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_mesh_step(arch: str, accum: int, batch: Batch):
    """The JAX step (SGD(LR)) on a 2-device
    mesh, jitted for DIS-SF and op by op for DIS-MF. Returns (init params
    as numpy, components, params after)."""
    s = settings()
    if arch == "single_frame":
        model = JaxDispNet(max_disp=128.0)
        init_x = (jnp.zeros((1, H, W, 2)),)
    else:
        K = np.asarray(s.K, np.float64)
        model = JaxFuseNet(imsize=(H, W), K=tuple(map(tuple, K.tolist())),
                           track_length=TL, block_num=BLOCKS, channels=CH,
                           max_disp=128.0)
        z = jnp.zeros
        init_x = (z((TL, 1, H, W, 2)), z((TL, 1, H, W, 1)),
                  z((TL, 1, H, W, 1)), jnp.ones((TL, 1, H, W, 1)),
                  jnp.broadcast_to(jnp.eye(3), (TL, 1, 3, 3)), z((TL, 1, 3)),
                  z((TL, TL, 1, H, W, 2)))
    params = model.init(jax.random.key(0), *init_x)
    init_np = jax.tree.map(np.array, params)
    mesh = jax_mesh.make_mesh(jax.devices()[:2])
    opt = optax.sgd(LR)
    state = jax.device_put(JaxTrainState.create(params, opt,
                                                jax.random.key(1)),
                           jax_mesh.replicated(mesh))
    step, _ = build_steps(model, jax_ctx(s, track_length=TL), opt, arch,
                          mesh, accum_steps=accum)
    with (jax.disable_jit() if arch == "multi_frame"
          else contextlib.nullcontext()):
        state, comps = step(state, jax_mesh.put_batch(
            JaxBatch(**batch._asdict()), mesh), jnp.asarray(0.0))
        return (init_np, np.asarray(comps),
                jax.tree.map(np.asarray, jax.device_get(state.params)))


def _to_port(arch, tree):
    if arch == "single_frame":
        return dispnet_state_dict_from_flax(tree)
    return fusenet_state_dict_from_flax(tree, port_model(arch))


def _misses(a, b) -> bool:
    return not np.allclose(a, b, rtol=RTOL_C, atol=ATOL_C)


def check_two_process_step(tmp_path, arch: str, accum: int, bs: int = BS):
    """Two gloo ranks (bs/2 samples each) take one step: their parameters
    are bitwise equal, and components and parameters agree with the JAX
    2-device mesh step within tests/test_parallel.py's tolerances. The
    wrong reductions miss: with accum_steps=1 the mean of the ranks' own
    ratios, with accum_steps=2 each rank chunking its own block. The
    ranks' device histograms sum to one process's."""
    batch = make_batch(arch, bs)
    init_np, c_ref, p_ref = _jax_mesh_step(arch, accum, batch)
    np.savez(tmp_path / "batch.npz", **{k: v for k, v in
                                       batch._asdict().items()
                                       if v is not None})
    torch.save(_to_port(arch, init_np), tmp_path / "init.pt")
    outs = [torch.load(p, weights_only=False) for p in run_ranks(
        tmp_path, "step", arch=arch, accum=accum,
        batch=str(tmp_path / "batch.npz"),
        weights=str(tmp_path / "init.pt"))]
    ref = _to_port(arch, p_ref)
    for k, v in outs[0]["params"].items():
        assert np.array_equal(v, outs[1]["params"][k]), k
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=RTOL_P,
                                   atol=ATOL_P, err_msg=k)
    np.testing.assert_allclose(outs[0]["comps"], c_ref, rtol=RTOL_C,
                               atol=ATOL_C)
    assert np.array_equal(outs[0]["comps"], outs[1]["comps"])
    if accum == 1:
        ddp = (outs[0]["comps_local"] + outs[1]["comps_local"]) / 2
        assert _misses(ddp, c_ref), (ddp, c_ref)
    else:
        assert _misses(outs[0]["comps_own_chunks"], c_ref)
    # the device histogram summed over the ranks, the disparities gathered
    es, gt = metric_inputs(batch)
    met = StreamingEvalMetric()
    met.add(es, gt, bs)
    assert outs[0]["metric"] == outs[1]["metric"] == met.get()
    assert np.array_equal(outs[1]["gathered"], es.numpy())
    shutil.rmtree(tmp_path)             # DispNet's weights: 126 MB a copy


@pytest.mark.parametrize("accum", [1, 2])
def test_two_process_sf_step_matches_the_jax_mesh_step(tmp_path, accum):
    check_two_process_step(tmp_path, "single_frame", accum)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_batch_layout_matches_jax(world, accum):
    """pad_batch against the JAX one on a ragged batch; shard_batch's
    blocks (accum 1) are process_batch_bounds' and the JAX shardings'
    (axis 1, axis 2 for the flow), and with accum k they are each rank's
    block of each of the JAX step's contiguous global chunks."""
    b = make_batch("multi_frame")
    ragged = Batch(**{k: (None if v is None else
                          v[:, :, :5] if k == "flow" else v[:, :5])
                      for k, v in b._asdict().items()})
    got, n = parallel.pad_batch(ragged, world)
    want, n_j = jax_mesh.pad_batch(JaxBatch(**ragged._asdict()), world)
    assert n == n_j == 5
    for k in Batch._fields:
        g, w_ = getattr(got, k), getattr(want, k)
        assert (g is None) == (w_ is None)
        if g is not None:
            assert np.array_equal(g, w_), k
    chunks = BS // accum
    for r in range(world):
        local = parallel.shard_batch(b, r, world, accum)
        lo, hi = parallel.process_batch_bounds(BS, r, world)
        per = chunks // world
        want_idx = np.concatenate([np.arange(j * chunks + r * per,
                                             j * chunks + (r + 1) * per)
                                   for j in range(accum)])
        if accum == 1:
            assert (lo, hi) == (want_idx[0], want_idx[-1] + 1)
        assert np.array_equal(local.im, b.im[:, want_idx])
        assert np.array_equal(local.flow, b.flow[:, :, want_idx])
    assert jax_multihost.process_batch_bounds(BS) == \
        parallel.process_batch_bounds(BS)
    with pytest.raises(ValueError, match="3 processes"):
        parallel.process_batch_bounds(BS, 0, 3)


def test_init_multihost_is_a_noop_without_torchrun(monkeypatch):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_multihost() is False
    assert not torch.distributed.is_initialized()
    assert parallel.is_primary() and parallel.world_size() == 1
    x = torch.arange(4.0)
    assert parallel.all_reduce_sum(x, parallel.default_group()) is x


def test_torchrun_device_is_the_local_rank_card(monkeypatch):
    """Under torchrun a process's card is cuda:LOCAL_RANK, and a LOCAL_RANK
    past the cards raises: no wrapping round, no CPU."""
    from depthinspace_tpu_torch.device import require_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert require_cuda() == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
        require_cuda()


def _worker_cfg(data_dir, out, **kw) -> dict:
    return dict(dict(data_dir=str(data_dir), output_dir=str(out), epochs=2,
                     train_batch_size=4, test_batch_size=3, num_workers=2,
                     device_augment=False, eval_metrics="exact",
                     write_debug_images=False), **kw)


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fixture")
    generate_dataset(d, n_samples=12, imsize=(32, 24), seed=5)
    return d


def _metrics(out) -> dict:
    return json.loads((Path(out) / "single_frame" / "metrics.json")
                      .read_text())


def test_worker_two_ranks_equal_one_process(fixture_dir, tmp_path):
    """SingleFrameWorker with host augmentation on 12 samples (9 train in 2
    global batches of 4; 3 test in a batch of 3, padded to 4 in 2 ranks),
    2 epochs: 2 gloo ranks give one process's metrics.json
    within rtol 1e-4 (the test losses aside: as in the JAX worker, a
    padded batch's loss counts its repeated samples); only rank 0 writes
    (rank 1 is given another output directory, which stays empty); rank
    1's clock past the deadline and its own max_train_iter change
    nothing. Then with device augmentation (a generator per rank) and the
    device metric: a resume in 2 ranks equals the uninterrupted 2-rank
    run."""
    one = tmp_path / "one"          # (no checkpoints: ~1 GB a run)
    SingleFrameWorker(RunConfig(**_worker_cfg(fixture_dir, one,
                                              save_frequency=100)),
                      device="cpu").do("retrain")
    m_one = _metrics(one)

    two = tmp_path / "two"
    run_ranks(tmp_path, "worker", late=True, runs=[dict(
        cfg=_worker_cfg(fixture_dir, two, deadline_ts=time.time() + 1e6),
        cmd="retrain", rank1_output_dir=str(tmp_path / "two_rank1"),
        rank1_max_train_iter=1)])
    exp = two / "single_frame"
    m_two = _metrics(two)
    assert not [p for p in (tmp_path / "two_rank1").rglob("*")
                if p.is_file()]
    assert {"train.log", "metrics.json", "state", "net_0000.params",
            "net_0001.params", "errs.png"} <= {p.name for p in exp.iterdir()}
    assert sorted(m_two) == ["0", "1"] == sorted(m_one)
    for ep in ("0", "1"):
        np.testing.assert_allclose(m_two[ep]["train"]["loss"],
                                   m_one[ep]["train"]["loss"], rtol=1e-4)
        test_one, test_two = m_one[ep]["test"]["0"], m_two[ep]["test"]["0"]
        assert set(test_one) == set(test_two)
        for k, v in test_one.items():
            if k != "loss":
                np.testing.assert_allclose(test_two[k], v, rtol=1e-4,
                                           err_msg=k)
        assert np.isfinite(test_two["loss"]).all()

    aug = dict(device_augment=True, eval_metrics="device")
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    run_ranks(tmp_path, "resume", mode_="worker", runs=[
        dict(cfg=_worker_cfg(fixture_dir, whole, save_frequency=100, **aug),
             cmd="retrain"),
        dict(cfg=_worker_cfg(fixture_dir, resumed, epochs=1, **aug),
             cmd="retrain"),
        dict(cfg=_worker_cfg(fixture_dir, resumed, **aug), cmd="resume")])
    assert "Resumed from epoch 0" in (
        resumed / "single_frame" / "train.log").read_text()
    assert _metrics(resumed) == _metrics(whole)
    shutil.rmtree(tmp_path)             # DispNet's checkpoints: ~2.5 GB


def test_worker_rejects_a_world_that_does_not_divide(fixture_dir, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    monkeypatch.setattr(multihost, "rank", lambda: 0)
    with pytest.raises(ValueError, match="5 does not divide over a world "
                                         "of 2"):
        SingleFrameWorker(RunConfig(**_worker_cfg(
            fixture_dir, tmp_path, train_batch_size=5)), device="cpu")
    with pytest.raises(ValueError, match="use_mesh=False"):
        SingleFrameWorker(RunConfig(**_worker_cfg(
            fixture_dir, tmp_path, use_mesh=False)), device="cpu")


def test_server_replicas_equal_one_device():
    """DisparityServer(devices=["cpu", "cpu"]) answers a ragged 11-image
    request (buckets 8 and 4, one a replica) and a 19-image one (8, 8, 4)
    bit for bit as the one-device server."""
    net = DispNet()
    images = np.random.RandomState(3).rand(19, H, W).astype(np.float32)
    one = DisparityServer(net, imsize=(H, W), max_batch=8, device="cpu")
    two = DisparityServer(net, imsize=(H, W), max_batch=8,
                          devices=["cpu", "cpu"])
    for n in (11, 19, 1):
        assert np.array_equal(two.infer(images[:n]), one.infer(images[:n]))
