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

Departures, each because the machinery is not ported: no device mesh (one
card), the exact host metrics for every split size (the JAX package
streams large splits through an on-device accumulator), no debug images or
errs.png, and no geo_oor_frac (this package's flow warp drops no flow
beyond a shift bound).
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
from ..device import resolve_device
from ..utils import metric as metric_lib
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
                        if self.device.type == "cuda" else ""))
        logging.info("eval metrics: exact host metrics for every split "
                     "size (the on-device accumulator is not ported)")

        if not cfg.device_augment:
            raise NotImplementedError(
                "host augmentation (cv2) is not ported; use "
                "--device_augment True")
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
            photometric_pyramid=cfg.photometric_pyramid)
        self.accum_steps = self._resolve_accum()
        if self.accum_steps > 1:
            logging.info(f"gradient accumulation: {self.accum_steps} "
                         "microbatches per optimizer step")
        self.ckpt = StateCheckpointer(self.exp_dir)
        self.current_epoch = 0

    # ------------------------------------------------------------- setup
    def _resolve_accum(self) -> int:
        """0 = auto, the JAX worker's rule (one device): 2 microbatches for
        DIS-MF without remat at bs >= 4 (even) and >= 512x432 frames, where
        the JAX graph did not fit a 16 GiB TPU; 1 otherwise. The card has
        the memory for one; the rule stays so that the same flags compute
        the same masked-mean statistic in both packages."""
        if self.cfg.accum_steps > 0:
            return self.cfg.accum_steps
        bs = self.cfg.train_batch_size
        H, W = self.imsize
        if (self.architecture == "multi_frame" and not self.cfg.mf_remat
                and bs >= 4 and H * W >= 512 * 432 and bs % 2 == 0):
            return 2
        return 1

    def _setup_logging(self):
        del logging.root.handlers[:]
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
        self.metric_path.write_text(json.dumps(self.metric_data, indent=2))

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
        flow.hdf5 when flow_source is "file"; DIS-MF adds the primary
        disparities, and its test sets alone the pseudo GT; in-memory
        samples when the worker has a source."""
        mf = self.architecture == "multi_frame"
        load_flow = self.cfg.flow_source == "file"
        load_pseudo_gt = self.cfg.use_pseudo_gt and not (mf and train)
        if self.source is not None:
            if self.cfg.use_pseudo_gt or self.cfg.data_type == "real":
                raise ValueError("in-memory synthetic samples carry no "
                                 "pseudo GT and no SGM disparities")
            return SyntheticTrackDataset(
                self.source, samples, track_length=self.cfg.track_length,
                train=train, load_flow=load_flow, load_primary=mf)
        cached = self.cached_dataset(samples, train, load_primary=mf,
                                     load_pseudo_gt=load_pseudo_gt)
        if cached is not None:
            return cached
        return TrackDataset(
            self.settings, samples, train=train,
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

    def make_eval_step(self, model: torch.nn.Module):
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
        return TrainState.create(self.make_model(), self.cfg.learning_rate,
                                 seed=self.cfg.seed, device=self.device)

    def _loader(self, dset, batch_size, train: bool) -> DataLoader:
        """Batches as (the wire-encoded host batch, its tensors on the
        device), encoded and copied on the loader's thread."""
        device = self.device

        def transform(b):
            enc = encode_batch(b)
            return enc, batch_to_torch(enc, device)
        return DataLoader(dset, batch_size, shuffle=train,
                          num_workers=self.cfg.num_workers, drop_last=train,
                          transform=transform)

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
                epoch0 = saved_epoch + 1
                min_err.update(saved_min)
                logging.info(f"Resumed from epoch {saved_epoch}")

        for epoch in range(epoch0, self.cfg.epochs):
            if self.cfg.deadline_ts and time.time() > self.cfg.deadline_ts:
                logging.info(f"deadline reached before epoch {epoch}; "
                             "stopping cleanly")
                break
            self.current_epoch = epoch
            self.train_epoch(epoch, train_step, train_set)
            errs = self.test(epoch, state.model, test_sets)
            if (epoch + 1) % self.cfg.save_frequency == 0:
                self.ckpt.save(epoch, state, min_err)
                for name, err_list in errs.items():
                    err = sum(err_list)
                    if err < min_err[name]:
                        min_err[name] = err
                        StateCheckpointer(
                            self.exp_dir, name=f"state_set_{name}_best",
                            max_to_keep=1).save(epoch, state, min_err)
                        logging.info(f"new best for test set {name}: "
                                     f"{err:.5f}")
                path = save_net_params(self.exp_dir, epoch, state.model)
                logging.info(f"saved network to {path}")
        logging.info("Finished training")
        return state

    def train_epoch(self, epoch, train_step, dset) -> None:
        logging.info("=" * 80)
        logging.info(f"Train epoch {epoch}")
        dset.current_epoch = epoch
        loader = self._loader(dset, self.cfg.train_batch_size, train=True)
        n_batches = len(loader)
        comps_acc, n_done = None, 0
        t_data = t_step = 0.0
        t0 = time.perf_counter()
        for batch_idx, (_, batch) in enumerate(loader):
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
        met = metric_lib.MultipleMetric(
            metric_lib.DistanceMetric(vec_length=1),
            metric_lib.OutlierFractionMetric(
                vec_length=1, thresholds=[0.1, 0.5, 1, 2, 5]))
        loss_acc, n = None, 0
        for batch_idx, (host, batch) in enumerate(loader):
            disp0, comps = eval_step(batch, epoch)
            # u16 x256 fixed point against the decoded GT, as the JAX worker
            es = decode_disp_np(disp0.cpu().numpy())
            gt = decode_batch_np(host).disp_gt
            es = es * (gt > 0)
            met.add(es.reshape(-1, 1), gt.reshape(-1, 1))
            loss_acc = comps if loss_acc is None else loss_acc + comps
            n += 1
            if batch_idx % 25 == 0:
                logging.info(f"test e{epoch}: {batch_idx + 1}/{len(loader)}: "
                             f"loss={float(comps.sum()):0.4f}")
        mean_loss = [float(c) / max(n, 1) for c in loss_acc.cpu().numpy()]
        logging.info(f"{met}")
        for k, v in met.items():
            self.metric_add_test(epoch, set_idx, k, v)
        self.metric_add_test(epoch, set_idx, "loss", mean_loss)
        self.metric_save()
        logging.info(f"test epoch {epoch}: avg test_loss={sum(mean_loss):0.4f}")
        return mean_loss

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
