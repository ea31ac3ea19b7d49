"""Training runtime, port of ``depthinspace_tpu/train/worker.py``: the
experiment directory, the epoch loops, checkpoints and metrics.

The experiment contract is the JAX package's: OUTPUT_DIR/<architecture>/
with train.log, metrics.json (the same keys and nesting), the rolling
state/, state_set_<name>_best/ and net_%04d.params, and the same dataset
splits (synthetic: train = samples[1024:], test = [512:1024], valid =
[:512], or for small sets test = the first quarter; real: every 8th sample
from the 4th is test). ``retrain``, ``resume``, ``retest`` (which evaluates
every epoch it is given, whatever the test frequency) and ``test_init``
behave the same, as do ``max_train_iter``, ``test_samples`` and
``deadline_ts``.

The inputs are the JAX worker's too: every batch is quantized to the
16-bit wire encoding on the host (``data/wire.py``), whether it comes from
HDF5, the wire cache or in-memory samples, and decoded to float32 at the
start of each step; the test metrics score the disparity against the
decoded GT. The wire cache (``data/cache.py``) is read where the JAX worker
reads it (:meth:`Worker.cached_dataset`).

The test metrics take the JAX worker's rule (``--eval_metrics``): the
exact host metrics, or for ``device`` (and ``auto`` on a split of more
than 64 samples) ``utils/metric.py::StreamingEvalMetric``, a histogram on
the device. ``--device_augment False`` augments the training samples on
the host (``data/augment.py``), as the JAX worker does.

Data parallelism (``use_mesh``, on by default as in JAX): under torchrun
every process drives one card (``parallel/multihost.py``), and each step
is the JAX mesh step: ``train_batch_size`` is the global batch, each rank
loads its block of it (with accumulation its block of each global chunk),
the losses are global-batch losses and the gradients are summed over the
ranks (``train/steps.py``). All ranks start from rank 0's state; each
draws its device augmentation from its own generator (seed + rank). Test
batches are padded to the world multiple; the exact metric takes the
disparities gathered to rank 0, the device histogram is summed over the
ranks. Only rank 0 writes train.log, metrics.json, checkpoints and
images; the other ranks log warnings to stderr. The deadline and
max_train_iter are rank 0's. A world that does not divide the batch
raises (the JAX mesh shrinks instead: ``parallel/mesh.py``).

Debug images (``write_debug_images``): rank 0 writes the JAX worker's 2x3
grid of one frame every 256 training batches (train_EEE_BBBB.png) and
every 8 test batches (test_EEE_BBBB.png), and errs.png, the per-epoch
loss curves from metrics.json, after each test epoch, without matplotlib
(``utils/plots.py``; the titles and the legend go to train.log). As in
JAX, a failure there is logged and never stops a run.

Departure: no geo_oor_frac (the JAX warp kernels drop flow beyond
+-max_shift and that metric counts it; this package's flow warp drops
none).
"""

from __future__ import annotations

import datetime
import json
import logging
import random
import socket
import time
from pathlib import Path

import numpy as np
import torch

from ..config import RunConfig
from ..data import (BASE_FIELDS, CachedTrackDataset, DataLoader,
                    SyntheticTrackDataset, TrackDataset, batch_to_torch,
                    decode_batch_np, decode_disp_np, encode_batch,
                    has_wire_cache, load_settings)
from ..data.dataset import SyntheticSource
from ..data.imgproc import write_png
from ..device import resolve_device
from ..parallel import (all_gather_batch, barrier, broadcast_object,
                        check_batch_divides, default_group, replicate_state)
from ..parallel import multihost
from ..utils import metric as metric_lib
from ..utils import plots
from .checkpoint import (StateCheckpointer, load_net_params, net_params_path,
                         save_net_params)
from .objective import make_loss_context
from .state import TrainState


class TestSet:
    def __init__(self, name, dset, test_frequency=1):
        self.name = name
        self.dset = dset
        self.test_frequency = test_frequency


def split_samples(samples: list, data_type: str, test_samples: int = -1):
    """(train, test, valid) sample lists, as the JAX worker splits them."""
    if data_type == "synthetic":
        train, test, valid = samples[2 ** 10:], samples[2 ** 9:2 ** 10], \
            samples[:2 ** 9]
        if not train:                   # small sets (fixtures)
            cut = max(1, len(samples) // 4)
            test, train, valid = samples[:cut], samples[cut:] or samples, []
    else:
        test = samples[4::8]
        train = [p for p in samples if p not in test]
        valid = []
    if test_samples > 0:        # a fixed prefix keeps epochs comparable
        test, valid = test[:test_samples], valid[:test_samples]
    return train, test, valid


class Worker:
    """Base training runtime; the architecture subclass supplies the model
    and the datasets. ``device=None`` is the card; ``source`` replaces the
    dataset directory by in-memory synthetic samples."""

    architecture = "single_frame"

    def __init__(self, cfg: RunConfig, device=None,
                 source: SyntheticSource | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world = multihost.rank(), multihost.world_size()
        if self.world > 1 and not cfg.use_mesh:
            raise ValueError(f"use_mesh=False in a launch of {self.world} "
                             "processes: each would train alone")
        self.group = default_group()
        self.primary = multihost.is_primary()
        self.source = source
        if source is not None:
            self.settings = source.settings
            samples = list(range(source.n_samples))
        else:
            self.settings = load_settings(Path(cfg.data_dir) / "settings.pkl")
            samples = sorted(str(p) for p in Path(cfg.data_dir).glob("0*/"))
        self.imsize = tuple(self.settings.imsize)
        self.train_samples, self.test_samples, self.valid_samples = \
            split_samples(samples, cfg.data_type, cfg.test_samples)

        self.exp_dir = Path(cfg.output_dir) / cfg.architecture
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self._setup_logging()
        self._load_metrics()
        self._init_seed(cfg.seed)
        logging.info(f"device: {self.device}"
                     + (f" ({torch.cuda.get_device_name(self.device)})"
                        if self.device.type == "cuda" else "")
                     + (f"; data parallel over {self.world} processes "
                        f"(rank {self.rank})" if self.group is not None
                        else ""))

        if cfg.flow_source == "rigid" and cfg.data_type != "synthetic":
            raise ValueError("--flow_source rigid needs GT disparity "
                             "(synthetic data)")
        flow_net = None
        if cfg.flow_source == "net":
            from ..tools.train_flow import load_flow_params
            fp_path = Path(cfg.flow_params
                           or Path(cfg.output_dir) / "flownet.msgpack")
            flow_net, flow_ch = load_flow_params(fp_path)
            flow_net.to(self.device)
            logging.info(f"FlowNet provider: {fp_path} ({flow_ch}-channel)")
        self.ctx = make_loss_context(
            self.settings, track_length=cfg.track_length, device=self.device,
            data_type=cfg.data_type, warmup_epochs=cfg.warmup_epochs,
            use_pseudo_gt=cfg.use_pseudo_gt, lcn_radius=cfg.lcn_radius,
            augment=cfg.device_augment, flow_source=cfg.flow_source,
            flow_net=flow_net,
            photometric_pyramid=cfg.photometric_pyramid, group=self.group)
        self.accum_steps = self._resolve_accum()
        check_batch_divides(cfg.train_batch_size, self.world,
                            self.accum_steps)
        if self.accum_steps > 1:
            logging.info(f"gradient accumulation: {self.accum_steps} "
                         "microbatches per optimizer step")
        self.ckpt = StateCheckpointer(self.exp_dir, group=self.group)
        self.current_epoch = 0

    # ------------------------------------------------------------- setup
    def _resolve_accum(self) -> int:
        """0 = auto, the JAX worker's rule on the per-rank batch (its
        per-device batch): 2 microbatches for DIS-MF without remat at bs >=
        4 (even) and >= 512x432 frames, where the JAX graph did not fit a 16
        GiB TPU; 1 otherwise. The card has the memory for one; the rule
        stays so that the same flags compute the same masked-mean statistic
        in both packages."""
        if self.cfg.accum_steps > 0:
            return self.cfg.accum_steps
        bs = self.cfg.train_batch_size // self.world
        H, W = self.imsize
        if (self.architecture == "multi_frame" and not self.cfg.mf_remat
                and bs >= 4 and H * W >= 512 * 432 and bs % 2 == 0):
            return 2
        return 1

    def _setup_logging(self):
        del logging.root.handlers[:]
        if not self.primary:            # warnings to stderr, no train.log
            logging.basicConfig(level=logging.WARNING,
                                handlers=[logging.StreamHandler()])
            return
        logging.basicConfig(
            level=logging.INFO,
            handlers=[logging.FileHandler(str(self.exp_dir / "train.log")),
                      logging.StreamHandler()],
            format="%(relativeCreated)d:%(levelname)s:%(process)d: %(message)s")
        logging.info("=" * 80)
        logging.info(f"Experiment: {self.cfg.architecture} on "
                     f"{socket.gethostname()}")
        logging.info(datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"))
        logging.info("=" * 80)

    def _load_metrics(self):
        self.metric_path = self.exp_dir / "metrics.json"
        self.metric_data = (json.loads(self.metric_path.read_text())
                            if self.metric_path.exists() else {})

    def metric_add_train(self, epoch, key, val):
        d = self.metric_data.setdefault(str(epoch), {}).setdefault("train", {})
        d[str(key)] = val

    def metric_add_test(self, epoch, set_idx, key, val):
        d = (self.metric_data.setdefault(str(epoch), {})
             .setdefault("test", {}).setdefault(str(set_idx), {}))
        d[str(key)] = val

    def metric_save(self):
        if self.primary:
            self.metric_path.write_text(json.dumps(self.metric_data,
                                                   indent=2))

    def _init_seed(self, seed):
        logging.info(f"Set seed to {seed}")
        np.random.seed(seed)
        random.seed(seed)

    # ------------------------------------------------- architecture hooks
    def make_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def cached_dataset(self, paths, train: bool, load_primary: bool = False,
                       load_pseudo_gt: bool = False):
        """The split's wire-cache dataset (``data/cache.py``) where the JAX
        worker reads one: the cache holds every field the split needs, the
        flow is not read from flow.hdf5 (the cache has none) and a train
        split is augmented on the device. None means the HDF5
        ``TrackDataset``; so does a cache that misses a requested sample or
        field, which is logged."""
        if not self.cfg.wire_cache or self.cfg.flow_source == "file":
            return None
        if train and not self.cfg.device_augment:
            return None
        load_sgm = self.cfg.data_type == "real"
        fields = list(BASE_FIELDS)
        fields += ["primary_disp"] if load_primary else []
        fields += ["pseudo_gt"] if load_pseudo_gt else []
        fields += ["sgm_disp"] if load_sgm else []
        if not has_wire_cache(self.cfg.data_dir, fields):
            return None
        names = [Path(p).name for p in paths]
        try:
            dset = CachedTrackDataset(
                self.cfg.data_dir, names, track_length=self.cfg.track_length,
                train=train, load_primary=load_primary,
                load_pseudo_gt=load_pseudo_gt, load_sgm=load_sgm)
        except FileNotFoundError as e:
            logging.info(f"wire cache unusable ({e}); using HDF5 loader")
            return None
        logging.info(f"using wire cache for {'train' if train else 'test'} "
                     f"split ({len(dset)} samples)")
        return dset

    def _dataset(self, samples, train: bool):
        """The split's dataset: the wire cache where
        :meth:`cached_dataset` takes it, else HDF5, with optical flow from
        flow.hdf5 when flow_source is "file" and a train split augmented on
        the host without device augmentation; DIS-MF adds the primary
        disparities, and its test sets alone the pseudo GT; in-memory
        samples when the worker has a source."""
        mf = self.architecture == "multi_frame"
        load_flow = self.cfg.flow_source == "file"
        load_pseudo_gt = self.cfg.use_pseudo_gt and not (mf and train)
        if self.source is not None:
            if self.cfg.use_pseudo_gt or self.cfg.data_type == "real":
                raise ValueError("in-memory synthetic samples carry no "
                                 "pseudo GT and no SGM disparities")
            if not self.cfg.device_augment:
                raise ValueError("in-memory synthetic samples are not "
                                 "augmented on the host: use "
                                 "--device_augment True")
            return SyntheticTrackDataset(
                self.source, samples, track_length=self.cfg.track_length,
                train=train, load_flow=load_flow, load_primary=mf)
        cached = self.cached_dataset(samples, train, load_primary=mf,
                                     load_pseudo_gt=load_pseudo_gt)
        if cached is not None:
            return cached
        return TrackDataset(
            self.settings, samples, train=train,
            data_aug=train and not self.cfg.device_augment,
            track_length=self.cfg.track_length, load_flow=load_flow,
            load_primary=mf, load_pseudo_gt=load_pseudo_gt,
            data_type=self.cfg.data_type)

    def make_train_set(self):
        return self._dataset(self.train_samples, train=True)

    def make_test_sets(self) -> list[TestSet]:
        return [TestSet("simple", self._dataset(self.test_samples,
                                                train=False),
                        test_frequency=self.cfg.test_frequency)]

    def make_train_step(self, state: TrainState):
        raise NotImplementedError

    def make_eval_step(self, model: torch.nn.Module, ctx=None):
        """The eval step on ``ctx`` (None: the worker's)."""
        raise NotImplementedError

    # ---------------------------------------------------------- commands
    def do(self, cmd: str, epoch: int = -1):
        if cmd == "retrain":
            self.train(resume=False)
        elif cmd == "resume":
            self.train(resume=True)
        elif cmd == "retest":
            self.retest(epoch=epoch)
        elif cmd == "test_init":
            self.test(-1, self.make_model().to(self.device),
                      self.make_test_sets())
        else:
            raise ValueError(f"invalid cmd {cmd!r}")

    def init_state(self) -> TrainState:
        """A fresh state; every rank takes rank 0's parameters, and its own
        generator (seed + rank)."""
        state = TrainState.create(self.make_model(), self.cfg.learning_rate,
                                  seed=self.cfg.seed + self.rank,
                                  device=self.device)
        replicate_state(state.model, state.optimizer, self.group)
        return state

    def _loader(self, dset, batch_size, train: bool) -> DataLoader:
        """This rank's part of each global batch as (the wire-encoded host
        batch, its tensors on the device), encoded and copied on the
        loader's thread."""
        device = self.device

        def transform(b):
            enc = encode_batch(b)
            return enc, batch_to_torch(enc, device)
        return DataLoader(dset, batch_size, shuffle=train,
                          num_workers=self.cfg.num_workers, drop_last=train,
                          transform=transform, rank=self.rank,
                          world=self.world,
                          accum=self.accum_steps if train else 1)

    def _save_net_params(self, epoch: int, model) -> None:
        if self.primary:
            path = save_net_params(self.exp_dir, epoch, model)
            logging.info(f"saved network to {path}")
        barrier(self.group)

    # ------------------------------------------------------------- train
    def train(self, resume=True) -> TrainState:
        logging.info("=" * 80)
        logging.info("Start training")
        train_set = self.make_train_set()
        test_sets = self.make_test_sets()
        state = self.init_state()
        train_step = self.make_train_step(state)
        epoch0 = 0
        min_err = {ts.name: 1e9 for ts in test_sets}
        if resume:
            restored = self.ckpt.restore(state)
            if restored is not None:
                _, saved_epoch, saved_min = restored
                replicate_state(state.model, state.optimizer, self.group)
                epoch0 = saved_epoch + 1
                min_err.update(saved_min)
                logging.info(f"Resumed from epoch {saved_epoch}")
        # rank 0's cap: the ranks must run the same number of steps
        self.cfg.max_train_iter = broadcast_object(self.cfg.max_train_iter,
                                                   self.group)

        for epoch in range(epoch0, self.cfg.epochs):
            late = bool(self.cfg.deadline_ts
                        and time.time() > self.cfg.deadline_ts)
            if broadcast_object(late, self.group):
                logging.info(f"deadline reached before epoch {epoch}; "
                             "stopping cleanly")
                break
            self.current_epoch = epoch
            self.train_epoch(epoch, train_step, train_set, state.model)
            errs = self.test(epoch, state.model, test_sets)
            if (epoch + 1) % self.cfg.save_frequency == 0:
                self.ckpt.save(epoch, state, min_err)
                for name, err_list in errs.items():
                    err = sum(err_list)
                    if err < min_err[name]:
                        min_err[name] = err
                        StateCheckpointer(
                            self.exp_dir, name=f"state_set_{name}_best",
                            max_to_keep=1, group=self.group).save(
                                epoch, state, min_err)
                        logging.info(f"new best for test set {name}: "
                                     f"{err:.5f}")
                self._save_net_params(epoch, state.model)
        logging.info("Finished training")
        return state

    def train_epoch(self, epoch, train_step, dset, model=None) -> None:
        """One epoch of ``train_step`` over ``dset``; ``model`` (the one
        the step trains) draws the debug images, None draws none."""
        logging.info("=" * 80)
        logging.info(f"Train epoch {epoch}")
        dset.current_epoch = epoch
        loader = self._loader(dset, self.cfg.train_batch_size, train=True)
        n_batches = len(loader)
        comps_acc, n_done = None, 0
        t_data = t_step = 0.0
        t0 = time.perf_counter()
        for batch_idx, (host, batch) in enumerate(loader):
            if 0 < self.cfg.max_train_iter <= batch_idx:
                break
            t1 = time.perf_counter()
            t_data += t1 - t0
            comps = train_step(batch, epoch)
            comps_acc = comps if comps_acc is None else comps_acc + comps
            n_done += 1
            if (epoch <= 1 and batch_idx < 128) or batch_idx % 16 == 0:
                cvals = comps.cpu().numpy()
                logging.info(
                    f"train e{epoch}: {batch_idx + 1}/{n_batches}: loss="
                    f"{cvals.sum():0.4f}=" + "+".join(f"{c:0.4f}"
                                                      for c in cvals))
                self.callback_train_batch(epoch, batch_idx, model, host,
                                          batch)
            t0 = time.perf_counter()
            t_step += t0 - t1
        logging.info(f"timings: data {t_data:.2f} s, step {t_step:.2f} s "
                     f"over {n_done} steps")
        if comps_acc is None:
            raise RuntimeError(
                f"train epoch produced 0 batches: {len(dset)} samples with "
                f"batch_size={self.cfg.train_batch_size} and drop_last - "
                "reduce --train_batch_size or add data")
        mean_loss = [float(c) / n_done for c in comps_acc.cpu().numpy()]
        self.metric_add_train(epoch, "loss", mean_loss)
        self.metric_save()
        logging.info(f"avg train_loss={sum(mean_loss):0.4f}")

    def callback_train_batch(self, epoch, batch_idx, model, host, batch):
        """The debug image of a training batch every 256 batches (rank 0:
        its block starts with the global batch's first sample), from a
        forward without the group's collectives."""
        if not (self.cfg.write_debug_images and self.primary
                and batch_idx % 256 == 0 and model is not None):
            return
        try:
            step = self.make_eval_step(model, self.ctx._replace(group=None))
            disp0, _ = step(batch, epoch)
            self.write_debug_image(
                self.exp_dir / f"train_{epoch:03d}_{batch_idx:04d}.png",
                decode_disp_np(disp0.cpu().numpy()), host)
        except Exception as e:      # debug images must never stop a run
            logging.warning(f"debug image failed: {e}")

    # -------------------------------------------------------------- test
    def test(self, epoch, model, test_sets):
        errs = {}
        eval_step = self.make_eval_step(model)
        for set_idx, ts in enumerate(test_sets):
            if (epoch + 1) % ts.test_frequency == 0:
                logging.info("=" * 80)
                logging.info(f"testing set {ts.name}")
                errs[ts.name] = self.test_epoch(epoch, set_idx, eval_step,
                                                ts.dset)
        return errs

    def test_epoch(self, epoch, set_idx, eval_step, dset):
        dset.current_epoch = epoch
        loader = self._loader(dset, self.cfg.test_batch_size, train=False)
        # the exact host metrics copy every batch's disparities to the host
        # and keep every per-pixel distance; the device histogram streams
        # the same statistics at wire resolution (the JAX worker's rule)
        mode = self.cfg.eval_metrics
        on_device = mode == "device" or (mode == "auto" and len(dset) > 64)
        if on_device:
            met = metric_lib.StreamingEvalMetric()
        else:
            met = metric_lib.MultipleMetric(
                metric_lib.DistanceMetric(vec_length=1),
                metric_lib.OutlierFractionMetric(
                    vec_length=1, thresholds=[0.1, 0.5, 1, 2, 5]))
        loss_acc, n = None, 0
        for batch_idx, (host, batch) in enumerate(loader):
            disp0, comps = eval_step(batch, epoch)
            # this rank's block starts at rank * bs_local of the global
            # batch, whose first n_valid samples are real
            bs_local = disp0.shape[1]
            n_local = min(max(loader.n_valid(batch_idx)
                              - self.rank * bs_local, 0), bs_local)
            if on_device:
                met.add(disp0, batch.disp_gt, n_local)
            else:
                # u16 x256 against the decoded GT, as the JAX worker, on
                # the global batch gathered from every rank
                es = all_gather_batch(disp0, 1, self.group)
                gt = all_gather_batch(batch.disp_gt, 1, self.group)
                if self.primary:
                    n_valid = loader.n_valid(batch_idx)
                    es = decode_disp_np(es.cpu().numpy())[:, :n_valid]
                    gt = decode_disp_np(gt.cpu().numpy())[:, :n_valid]
                    es = es * (gt > 0)
                    met.add(es.reshape(-1, 1), gt.reshape(-1, 1))
            loss_acc = comps if loss_acc is None else loss_acc + comps
            n += 1
            if batch_idx % 25 == 0:
                logging.info(f"test e{epoch}: {batch_idx + 1}/{len(loader)}: "
                             f"loss={float(comps.sum()):0.4f}")
            if (self.cfg.write_debug_images and self.primary
                    and batch_idx % 8 == 0):
                try:
                    es = decode_disp_np(disp0.cpu().numpy())[:, :n_local]
                    gt = decode_batch_np(host).disp_gt[:, :n_local]
                    self.write_debug_image(
                        self.exp_dir / f"test_{epoch:03d}_{batch_idx:04d}.png",
                        es * (gt > 0), host)
                except Exception as e:
                    logging.warning(f"debug image failed: {e}")
        if on_device:
            met.all_reduce(self.group)
        mean_loss = [float(c) / max(n, 1) for c in loss_acc.cpu().numpy()]
        if self.primary:
            logging.info(f"{met}")
            for k, v in met.items():
                self.metric_add_test(epoch, set_idx, k, v)
        self.metric_add_test(epoch, set_idx, "loss", mean_loss)
        self.metric_save()
        if self.primary:
            try:                       # plots must never stop a run
                self.write_err_img()
            except Exception as e:
                logging.warning(f"errs.png failed: {e}")
        logging.info(f"test epoch {epoch}: avg test_loss={sum(mean_loss):0.4f}")
        return mean_loss

    def write_err_img(self):
        """errs.png: the per-epoch total train loss and each test set's
        total test loss (test<i>) from metrics.json, one polyline each on
        an 800x600 canvas; the legend goes to train.log."""
        series = {}                      # label -> (epochs, losses)
        for ep in sorted(int(e) for e in self.metric_data):
            d = self.metric_data[str(ep)]
            losses = [("train", d.get("train", {}).get("loss"))] + [
                (f"test{i}", td.get("loss"))
                for i, td in d.get("test", {}).items()]
            for label, loss in losses:
                if loss is not None:
                    xs, ys = series.setdefault(label, ([], []))
                    xs.append(ep)
                    ys.append(sum(loss))
        if not series:
            return
        canvas, legend = plots.loss_curves(series)
        path = self.exp_dir / "errs.png"
        write_png(path, canvas)
        logging.info(f"wrote {path}: {legend}")

    def write_debug_image(self, out_path, es, host_batch):
        """The 2x3 grid of the batch's first frame (``utils/plots.py``);
        ``es`` (tl, bs, H, W) float32 px, ``host_batch`` wire-encoded."""
        host_batch = decode_batch_np(host_batch)
        grid, titles = plots.debug_grid(
            host_batch.im[0, 0], host_batch.ambient[0, 0],
            host_batch.disp_gt[0, 0].astype(np.float32), es[0, 0])
        write_png(out_path, grid)
        logging.info(f"wrote debug image {out_path}: "
                     + " | ".join(titles))

    def retest(self, epoch=-1):
        test_sets = self.make_test_sets()
        # an explicit retest evaluates every epoch it is given
        for ts in test_sets:
            ts.test_frequency = 1
        epochs = range(self.cfg.epochs) if epoch < 0 else [epoch]
        model = self.make_model().to(self.device)
        for ep in epochs:
            path = net_params_path(self.exp_dir, ep)
            if path.exists():
                model.load_state_dict(load_net_params(path, model))
                self.test(ep, model, test_sets)
