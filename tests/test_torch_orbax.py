"""The port's reader of the JAX package's orbax training state
(utils/ocdbt.py, train/orbax_state.py, train/checkpoint.py) against states
that the JAX package's ``StateCheckpointer`` writes here, against
tensorstore's own reading of OCDBT stores, and against the committed
fixture (tests/data/orbax_fixture, scripts/make_orbax_fixture.py); then a
JAX run resumed by the port: its next train step against the JAX step from
the same state, and the port's worker continuing the JAX experiment
directory."""
import json
import random
import re
import shutil
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import tensorstore as ts
import torch

from depthinspace_tpu.data import generate_dataset
from depthinspace_tpu.data.dataset import Batch as JaxBatch
from depthinspace_tpu.models import DispNet as JaxDispNet
from depthinspace_tpu.train import objective as jax_objective
from depthinspace_tpu.train.checkpoint import \
    StateCheckpointer as JaxCheckpointer
from depthinspace_tpu.train.state import TrainState as JaxTrainState
from depthinspace_tpu.train.steps import _make_step_fns
from depthinspace_tpu_torch.config import RunConfig
from depthinspace_tpu_torch.data import (SyntheticSource, batch_to_torch,
                                         make_settings, make_track_batch)
from depthinspace_tpu_torch.models import (DispNet, FuseNet,
                                           dispnet_state_dict_from_flax,
                                           flax_tree_from_dispnet_state_dict,
                                           flax_tree_from_fusenet_state_dict,
                                           init_dispnet_)
from depthinspace_tpu_torch.train import (TrainState, make_loss_context,
                                          make_sf_train_step)
from depthinspace_tpu_torch.train.checkpoint import (StateCheckpointer,
                                                     load_net_params)
from depthinspace_tpu_torch.train.orbax_state import (OrbaxStep,
                                                      is_orbax_step)
from depthinspace_tpu_torch.train.multi_frame import MultiFrameWorker
from depthinspace_tpu_torch.train.single_frame import SingleFrameWorker
from depthinspace_tpu_torch.utils.ocdbt import OcdbtStore
from depthinspace_tpu_torch.utils import jrandom

FIXTURE = Path(__file__).parent / "data" / "orbax_fixture"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dispnet_params():
    """The JAX DispNet's variables (full width) from the port's seeded init
    (flax's initializers run op by op here take seconds longer)."""
    m = init_dispnet_(DispNet(), jrandom.key(0))
    return jax.tree.map(jnp.asarray,
                        flax_tree_from_dispnet_state_dict(m.state_dict()))


def _flat(tree, prefix=()):
    """{dotted path: numpy array} of a JAX pytree of dicts and tuples."""
    if hasattr(tree, "_asdict"):        # optax's NamedTuple states
        tree = tree._asdict()
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (tuple, list)) else None)
    if items is None:
        return {".".join(prefix): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, prefix + (str(k),)))
    return out


def _jax_payload(state):
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "rng_data": jax.random.key_data(state.rng)}


def _fusenet_state(seed, blocks=1, channels=16):
    """A JAX TrainState of a FuseNet's tree (its flax layout taken from the
    port's converter, which tests/test_torch_fusenet.py holds to the flax
    module) with seeded weights, moments, count and step."""
    rng = np.random.default_rng(seed)
    m = FuseNet((32, 24), make_settings(32, 24).K, 4, block_num=blocks,
                channels=channels)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        flax_tree_from_fusenet_state_dict(m.state_dict()))
    st = JaxTrainState.create(params, optax.adam(1e-4),
                              jax.random.key(seed + 1))
    noisy = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), st.opt_state)
    return st.replace(opt_state=noisy, step=jnp.asarray(seed + 3, jnp.int32))


def _assert_tree_equal(got: dict, want: dict):
    flat = _flat(got)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == v.dtype and np.array_equal(flat[k], v), k


def test_full_width_dispnet_state_reads_bit_for_bit(tmp_path,
                                                    dispnet_params):
    """The full-width DispNet (31,595,332 parameters): every leaf of params,
    Adam's mu, nu and count, step and the key's words equal bit for bit to
    the JAX arrays, meta and the host RNG too. Its 380 MB of float32 take
    about a second to read (OrbaxStep.tree: 0.72-0.81 s on an 8-core x86
    CPU); one b-tree
    leaf node holds its 390 keys, so the interior nodes are held by
    test_ocdbt_interior_and_version_tree_nodes."""
    opt = optax.adam(1e-4)
    st = JaxTrainState.create(dispnet_params, opt, jax.random.key(7))
    mu = jax.tree.map(lambda a: a + 0.5, st.opt_state[0].mu)
    st = st.replace(step=jnp.asarray(5, jnp.int32),
                    opt_state=(st.opt_state[0]._replace(
                        mu=mu, count=jnp.asarray(5, jnp.int32)),
                        st.opt_state[1]))
    ck = JaxCheckpointer(tmp_path)
    np.random.seed(123)
    random.seed(321)
    ck.save(3, st, {"simple": 0.5})
    ck.flush()
    ck.close()
    want_np, want_py = np.random.get_state(), random.getstate()
    step = OrbaxStep(tmp_path / "state" / "3")
    t0 = time.perf_counter()
    tree = step.tree()
    seconds = time.perf_counter() - t0
    _assert_tree_equal(tree, _flat(_jax_payload(st)))
    assert sum(a.size for a in _flat(tree["params"]).values()) == 31_595_332
    assert step.meta() == {"epoch": 3, "min_err": {"simple": 0.5}}
    host = step.host_rng()
    assert host["python"] == want_py
    assert all(np.array_equal(a, b) for a, b in zip(host["numpy"], want_np))
    assert seconds < 30, seconds
    shutil.rmtree(tmp_path / "state")      # 116 MB of zstd chunks


def test_fusenet_states_rolling_saves_and_best(tmp_path):
    """FuseNet (1 block x 16 channels) saved at epochs 0 and 1 with
    max_to_keep 1, and a state_set_simple_best directory of epoch 0: the
    port sees epoch [1], reads both bit for bit, and its checkpointer
    restores the newest into a FuseNet (weights, Adam moments and count,
    step, {epoch, min_err}) and the best one alike."""
    states = [_fusenet_state(seed) for seed in range(2)]
    ck = JaxCheckpointer(tmp_path, max_to_keep=1)
    for epoch, st in enumerate(states):
        ck.save(epoch, st, {"simple": 1.0 / (epoch + 1)})
    ck.flush()
    ck.close()
    best = JaxCheckpointer(tmp_path, name="state_set_simple_best",
                           max_to_keep=1)
    best.save(0, states[0], {"simple": 0.5})
    best.close()
    port = StateCheckpointer(tmp_path)
    assert port._epochs() == [1]
    for name, epoch in (("state", 1), ("state_set_simple_best", 0)):
        _assert_tree_equal(OrbaxStep(tmp_path / name / str(epoch)).tree(),
                           _flat(_jax_payload(states[epoch])))
    for name, epoch in (("state", 1), ("state_set_simple_best", 0)):
        m = FuseNet((32, 24), make_settings(32, 24).K, 4, block_num=1,
                    channels=16)
        state = TrainState.create(m, device="cpu")
        _, got_epoch, min_err = StateCheckpointer(tmp_path, name).restore(
            state)
        assert got_epoch == epoch and state.step == epoch + 3
        assert min_err == {"simple": 1.0 / (epoch + 1) if name == "state"
                           else 0.5}
        names = [n for n, _ in m.named_parameters()]
        opt = state.optimizer.state_dict()["state"]
        adam = states[epoch].opt_state[0]
        for key, sd, ref in (
                ("params", m.state_dict(), states[epoch].params),
                ("mu", {n: opt[i]["exp_avg"] for i, n in enumerate(names)},
                 adam.mu),
                ("nu", {n: opt[i]["exp_avg_sq"] for i, n in
                        enumerate(names)}, adam.nu)):
            got = _flat(flax_tree_from_fusenet_state_dict(sd))
            want = _flat(ref)
            assert set(got) == set(want), key
            for k in want:
                assert np.array_equal(got[k], want[k]), (key, k)
        assert all(float(opt[i]["step"]) == float(adam.count)
                   for i in range(len(names)))


def test_ocdbt_interior_and_version_tree_nodes(tmp_path):
    """A store that tensorstore writes with 300-byte nodes and 16-byte
    inline values, one commit per key (200 versions: the manifest lists the
    newest and points at version-tree nodes for the rest): the port walks
    interior nodes down to the leaves, and its keys and values (inline and
    in data files) are tensorstore's."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    for i in range(200):
        kv.write(f"key/{i:05d}/v", b"%d;" % i * (1 + i % 9)).result()
    store = OcdbtStore(tmp_path)
    assert store.height > 1 and store.node_count > 10
    want = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == want
    for k in want:
        assert store.read(k) == kv.read(k).result().value


@pytest.mark.parametrize("order", ["C", "F"])
def test_zarr_chunks_fill_and_dtypes(tmp_path, order):
    """zarr v2 arrays that tensorstore writes into an OCDBT store: a 7x9
    float32 array in 3x4 chunks (edge chunks, one chunk never written: the
    fill value), zstd or uncompressed, C or F order; int32 and uint32; a
    bfloat16 array, widened exactly to float32."""
    from depthinspace_tpu_torch.train.orbax_state import read_zarr_array
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 9)).astype(np.float32)
    want = {}
    for name, dtype, comp, value in (
            ("f", "<f4", {"id": "zstd", "level": 1}, a),
            ("raw", "<f4", None, a),
            ("i", "<i4", {"id": "zstd", "level": 3},
             rng.integers(-9, 9, (7, 9)).astype(np.int32)),
            ("u", "<u4", None, rng.integers(0, 9, (7, 9)).astype(np.uint32)),
            ("bf", "bfloat16", {"id": "zstd", "level": 1},
             a.astype(jnp.bfloat16))):
        arr = ts.open({"driver": "zarr", "kvstore": kv, "path": name,
                       "metadata": {"shape": [7, 9], "chunks": [3, 4],
                                    "dtype": dtype, "order": order,
                                    "compressor": comp, "fill_value": 2}},
                      create=True).result()
        arr[3:, :].write(value[3:, :]).result()    # rows 0-2: never written
        arr[:3, 4:].write(value[:3, 4:]).result()
        expect = arr.read().result()
        want[name] = np.asarray(expect, np.float32 if dtype == "bfloat16"
                                else None)
    store = OcdbtStore(tmp_path)
    assert "f/0.0" not in store and "f/0.1" in store
    for name, w in want.items():
        got = read_zarr_array(store, name)
        assert got.dtype == w.dtype and np.array_equal(got, w), name
    assert (read_zarr_array(store, "f")[:3, :4] == 2).all()


def test_damaged_store_raises(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    kv.write("a", b"1").result()
    man = tmp_path / "manifest.ocdbt"
    blob = bytearray(man.read_bytes())
    blob[20] ^= 1
    man.write_bytes(bytes(blob))
    from depthinspace_tpu_torch.utils.ocdbt import OcdbtError
    with pytest.raises(OcdbtError, match="CRC-32C"):
        OcdbtStore(tmp_path)


def _fixture_crcs(m, state):
    """{leaf: CRC-32} of the restored weights and Adam moments in the flax
    layout, named as expected.npz names them."""
    names = [n for n, _ in m.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    out = {}
    for key, sd in (("params", m.state_dict()),
                    ("mu", {n: opt[i]["exp_avg"] for i, n in
                            enumerate(names)}),
                    ("nu", {n: opt[i]["exp_avg_sq"] for i, n in
                            enumerate(names)})):
        for k, a in _flat(flax_tree_from_fusenet_state_dict(sd),
                          (key,)).items():
            out[k] = zlib.crc32(np.ascontiguousarray(a).tobytes())
    return out


def test_committed_fixture_restores_bit_for_bit():
    """The committed DIS-MF fixture (a JAX worker's state/ after 2 steps,
    FuseNet 1 block x 32 channels): the restored weights equal
    net_0000.params (read by the msgpack reader), and every leaf of the
    weights and Adam's moments, the count and the step match expected.npz."""
    want = np.load(FIXTURE / "expected.npz")
    exp = FIXTURE / "multi_frame"
    assert is_orbax_step(exp / "state" / "0")
    m = FuseNet((64, 56), make_settings(64, 56).K, 4, block_num=1)
    state = TrainState.create(m, device="cpu")
    _, epoch, _ = StateCheckpointer(exp).restore(state)
    assert epoch == 0 and state.step == int(want["step"])
    net = load_net_params(exp / "net_0000.params", m)
    assert all(torch.equal(net[k], v) for k, v in m.state_dict().items())
    got = _fixture_crcs(m, state)
    assert dict(zip(want["names"].tolist(), want["crc32"].tolist())) == got
    opt = state.optimizer.state_dict()["state"]
    assert float(opt[0]["step"]) == float(want["count"])
    assert state.rng == jrandom.wrap_key_data(want["rng_data"])


def _jax_sf(params, settings, batch, TL, n_steps):
    model = JaxDispNet(max_disp=128.0)
    ctx = jax_objective.make_loss_context(settings, track_length=TL,
                                          augment=True)
    opt = optax.adam(1e-4)
    train_step, _, consts = _make_step_fns(model, ctx, opt, "single_frame")
    step = jax.jit(train_step)
    state = JaxTrainState.create(params, opt, jax.random.key(1))
    states, comps = [state], []
    for _ in range(n_steps):
        state, c = step(state, JaxBatch(**batch._asdict()),
                        jnp.asarray(0.0), consts)
        states.append(state)
        comps.append(np.asarray(c))
    return states, comps


def test_resumed_step_matches_the_jax_step_and_the_worker_continues(
        tmp_path, dispnet_params):
    """A JAX DIS-SF run (32x24, tl 4, bs 2, Adam 1e-4, device
    augmentation, from dispnet_params): 2 jitted steps, saved by the JAX
    StateCheckpointer as its worker saves epoch 0. The port restores it
    (the weights equal the JAX ones bit for bit, the key is the JAX
    state's) and takes 2 steps: they draw the JAX third and fourth steps'
    augmentation, so their components equal the JAX steps' within rtol
    1e-4, the limit of tests/test_torch_train.py, and the port's key after
    them is the JAX state's (the fourth step follows Adam's update from the
    restored moments and count: from a fresh Adam it was 3.4e-2 off,
    without augmentation). Then SingleFrameWorker
    --cmd resume on that experiment directory trains epoch 1: metrics.json
    continues at epoch 1 beside the JAX run's epoch 0, the orbax epoch
    stays and the port's state/1/state.pt restores."""
    H, W, TL = 32, 24, 4
    settings = make_settings(H, W)
    batch = make_track_batch(settings, tl=TL, bs=2, seed=1,
                             disp_range=(2.0, 12.0))
    states, comps = _jax_sf(dispnet_params, settings, batch, TL, 4)
    exp = tmp_path / "out" / "single_frame"
    ck = JaxCheckpointer(exp)
    # min_err 0: no epoch beats it, so the worker writes no best state
    ck.save(0, states[2], {"simple": 0.0})
    ck.flush()
    ck.close()
    (exp / "metrics.json").write_text(json.dumps(
        {"0": {"train": {"loss": comps[1].tolist()}}}))

    net = DispNet()
    state = TrainState.create(net, 1e-4, seed=0, device="cpu")
    _, epoch, min_err = StateCheckpointer(exp).restore(state)
    assert (epoch, min_err, state.step) == (0, {"simple": 0.0}, 2)
    words = lambda st: jrandom.wrap_key_data(jax.random.key_data(st.rng))
    assert state.rng == words(states[2])
    p2 = dispnet_state_dict_from_flax(jax.tree.map(np.asarray,
                                                   states[2].params))
    assert all(torch.equal(v, p2[k]) for k, v in net.state_dict().items())
    step = make_sf_train_step(net, make_loss_context(
        settings, TL, device="cpu", augment=True), state)
    tb = batch_to_torch(batch, "cpu")
    for i in (2, 3):
        np.testing.assert_allclose(step(tb).numpy(), comps[i], rtol=1e-4,
                                   atol=0)
    assert state.step == 4 and state.rng == words(states[4])

    d = tmp_path / "ds"
    generate_dataset(d, n_samples=4, imsize=(H, W), seed=3)
    cfg = RunConfig(data_dir=d, output_dir=tmp_path / "out", epochs=2,
                    track_length=TL, train_batch_size=2, test_batch_size=1, max_train_iter=1,
                    num_workers=1, write_debug_images=False)
    SingleFrameWorker(cfg, device="cpu").do("resume")
    log = (exp / "train.log").read_text()
    assert "Resumed from epoch 0" in log
    # the JAX worker's progress and timings lines (utils/gtimer.py)
    assert re.search(r"train e1: 1/\d+: loss=\S+ \| \d\d:\d\d:\d\d / "
                     r"\d\d:\d\d:\d\d", log)
    assert re.search(r"timings: data \S+s \(n=1, .*step \S+s \(n=1, ", log)
    metrics = json.loads((exp / "metrics.json").read_text())
    assert sorted(metrics) == ["0", "1"] and np.isfinite(
        metrics["1"]["train"]["loss"]).all()
    assert is_orbax_step(exp / "state" / "0")
    assert (exp / "state" / "1" / "state.pt").is_file()
    again = TrainState.create(DispNet(), 1e-4, device="cpu")
    assert StateCheckpointer(exp).restore(again)[1] == 1
    # the run's states hold DispNet's full-size weights and moments (~1 GB)
    shutil.rmtree(exp)


def test_mf_worker_resume_builds_the_saved_block_count(tmp_path):
    """MultiFrameWorker resuming a copy of the committed fixture builds
    FuseNet with the one fusion block its _METADATA lists (a fresh state
    has 4, as the JAX CLI builds) and restores it equal to net_0000.params;
    after the port saves its own state.pt there, a resume still builds 1."""
    exp = tmp_path / "out" / "multi_frame"
    shutil.copytree(FIXTURE / "multi_frame", exp)
    worker = MultiFrameWorker(
        RunConfig(data_dir=tmp_path, output_dir=tmp_path / "out",
                  architecture="multi_frame", num_workers=1),
        device="cpu", source=SyntheticSource(make_settings(64, 56), 2,
                                             primary_noise=0.5))
    assert worker.init_state().model.block_num == 4
    assert worker.ckpt.saved_modules() >= {"block0", "predict_disp"}
    state = worker.init_state(resume=True)
    assert state.model.block_num == 1
    assert worker.ckpt.restore(state)[1] == 0
    net = load_net_params(exp / "net_0000.params", state.model)
    assert all(torch.equal(net[k], v)
               for k, v in state.model.state_dict().items())
    worker.ckpt.save(1, state, {"simple": 1.0})
    assert "block1" not in worker.ckpt.saved_modules()
    worker.block_num = 4
    assert worker.init_state(resume=True).model.block_num == 1

def test_rolling_deletion_keeps_orbax_directories(tmp_path):
    """The port's saves after a JAX epoch: max_to_keep counts the port's
    own files, and the JAX package's step directory is never removed."""
    st = _fusenet_state(0)
    ck = JaxCheckpointer(tmp_path)
    ck.save(0, st, {"simple": 1.0})
    ck.flush()
    ck.close()
    m = FuseNet((32, 24), make_settings(32, 24).K, 4, block_num=1,
                channels=16)
    state = TrainState.create(m, device="cpu")
    port = StateCheckpointer(tmp_path, max_to_keep=2)
    assert port.restore(state)[1] == 0
    for epoch in (1, 2, 3):
        port.save(epoch, state, {"simple": 1.0})
    assert port._epochs() == [0, 2, 3]
    assert is_orbax_step(tmp_path / "state" / "0")
    shutil.rmtree(tmp_path / "state" / "2")
    shutil.rmtree(tmp_path / "state" / "3")
    assert port.latest_epoch() == 0
