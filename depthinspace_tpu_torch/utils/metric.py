"""Evaluation metrics, port of ``depthinspace_tpu/utils/metric.py``: the
exact host metrics ``DistanceMetric``, ``OutlierFractionMetric`` and
``MultipleMetric`` (numpy; the worker masks the estimates by gt > 0 and
flattens them to N x 1), and ``StreamingEvalMetric``, which accumulates the
same statistics on the device at the wire resolution. Both fill
``metrics.json``'s ``dist2_*`` and ``of{t}`` keys. The host metrics that no
worker uses are here too: ``RelativeDistanceMetric``,
``RotmDistanceMetric``, ``QuaternionDistanceMetric`` (over
``utils/geometry3d.py``'s distances) and ``BinaryAccuracyMetric``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.multihost import all_reduce_sum
from . import geometry3d

# numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Metric:
    def __init__(self, str_prefix=""):
        self.str_prefix = str_prefix
        self.reset()

    def reset(self):
        pass

    def add(self, es, ta, ma=None):
        pass

    def get(self) -> dict:
        return {}

    def items(self):
        return self.get().items()

    def __str__(self):
        return ", ".join(f"{self.str_prefix}{k}={v:.5f}"
                         for k, v in self.get().items())


class MultipleMetric(Metric):
    def __init__(self, *metrics, **kwargs):
        self.metrics = list(metrics)
        super().__init__(**kwargs)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def add(self, es, ta, ma=None):
        for m in self.metrics:
            m.add(es, ta, ma)

    def get(self):
        out = {}
        for m in self.metrics:
            out.update(m.get())
        return out

    def __str__(self):
        return "\n".join(str(m) for m in self.metrics)


class DistanceMetric(Metric):
    """L_p distance over (N, vec_length) arrays with summary statistics."""

    def __init__(self, vec_length=1, p=2, **kwargs):
        self.vec_length = vec_length
        self.p = p
        super().__init__(**kwargs)

    def reset(self):
        self.dists = []

    def add(self, es, ta, ma=None):
        if es.shape != ta.shape or es.ndim != 2 or \
                es.shape[1] != self.vec_length:
            raise ValueError(f"expected Nx{self.vec_length}, got {es.shape}")
        if ma is not None:
            es = es[ma != 0]
            ta = ta[ma != 0]
        self.dists.append(np.linalg.norm(es - ta, ord=self.p, axis=1))

    def get(self):
        d = np.hstack(self.dists)
        n = self.p
        return {
            f"dist{n}_mean": float(np.mean(d)),
            f"dist{n}_std": float(np.std(d)),
            f"dist{n}_median": float(np.median(d)),
            f"dist{n}_q10": float(np.percentile(d, 10)),
            f"dist{n}_q90": float(np.percentile(d, 90)),
            f"dist{n}_min": float(np.min(d)),
            f"dist{n}_max": float(np.max(d)),
        }


class OutlierFractionMetric(DistanceMetric):
    """of{t} = fraction of distances above each threshold t."""

    def __init__(self, thresholds, *args, **kwargs):
        self.thresholds = list(thresholds)
        super().__init__(*args, **kwargs)

    def get(self):
        d = np.hstack(self.dists)
        return {f"of{t}": float((d > t).sum() / d.size)
                for t in self.thresholds}


class RelativeDistanceMetric(Metric):
    """L_p distance normalized by the target norm."""

    def __init__(self, vec_length, p=2, **kwargs):
        self.vec_length = vec_length
        self.p = p
        super().__init__(**kwargs)

    def reset(self):
        self.dists = []

    def add(self, es, ta, ma=None):
        if es.shape != ta.shape or es.ndim != 2 or \
                es.shape[1] != self.vec_length:
            raise ValueError(f"expected Nx{self.vec_length}, got {es.shape}")
        dist = np.linalg.norm(es - ta, ord=self.p, axis=1)
        denom = np.linalg.norm(ta, ord=self.p, axis=1)
        dist = dist / denom
        if ma is not None:
            dist = dist[ma != 0]
        self.dists.append(dist)

    def get(self):
        d = np.hstack(self.dists)
        n = f"rel{self.p}"
        return {f"dist{n}_mean": float(np.mean(d)),
                f"dist{n}_std": float(np.std(d)),
                f"dist{n}_median": float(np.median(d))}


class RotmDistanceMetric(Metric):
    """Rotation-matrix distance: ``identity`` (||I - R_es R_ta^T||_F) or
    ``geodesic`` (the angle)."""

    def __init__(self, type="identity", **kwargs):
        self.type = type
        super().__init__(**kwargs)

    def reset(self):
        self.dists = []

    def add(self, es, ta, ma=None):
        if es.shape != ta.shape or es.ndim != 3 or es.shape[1:] != (3, 3):
            raise ValueError(f"expected Nx3x3, got {es.shape}")
        if self.type == "identity":
            self.dists.append(geometry3d.rotm_distance_identity(es, ta))
        elif self.type == "geodesic":
            self.dists.append(geometry3d.rotm_distance_geodesic(es, ta))
        else:
            raise ValueError(self.type)

    def get(self):
        d = np.hstack(self.dists)
        return {f"rotm_{self.type}_mean": float(np.mean(d)),
                f"rotm_{self.type}_median": float(np.median(d))}


class QuaternionDistanceMetric(Metric):
    """Quaternion distance: ``angle``, ``mineucl`` or ``normdiff``."""

    def __init__(self, type="angle", **kwargs):
        self.type = type
        super().__init__(**kwargs)

    def reset(self):
        self.dists = []

    def add(self, es, ta, ma=None):
        if es.shape != ta.shape or es.ndim != 2 or es.shape[1] != 4:
            raise ValueError(f"expected Nx4, got {es.shape}")
        fn = {"angle": geometry3d.quat_distance_angle,
              "mineucl": geometry3d.quat_distance_mineucl,
              "normdiff": geometry3d.quat_distance_normdiff}[self.type]
        self.dists.append(fn(es, ta))

    def get(self):
        d = np.hstack(self.dists)
        return {f"quat_{self.type}_mean": float(np.mean(d)),
                f"quat_{self.type}_median": float(np.median(d))}


class BinaryAccuracyMetric(Metric):
    """Threshold-swept binary classification metrics: ROC-AUC, PR-AUC, AP
    and accuracies."""

    def __init__(self, thresholds=None, **kwargs):
        self.thresholds = (np.linspace(0, 1, 101)[:-1] if thresholds is None
                           else np.asarray(thresholds))
        super().__init__(**kwargs)

    def reset(self):
        n = len(self.thresholds)
        self.tps = np.zeros(n)
        self.fps = np.zeros(n)
        self.fns = np.zeros(n)
        self.tns = np.zeros(n)

    def add(self, es, ta, ma=None):
        es = np.ravel(es)
        ta = np.ravel(ta)
        if es.shape != ta.shape:
            raise ValueError("shape mismatch")
        if es.min() < 0 or es.max() > 1:
            raise ValueError("estimate must be in [0, 1]")
        es_p = es[ta == 1]
        es_n = es[ta == 0]
        for i, t in enumerate(self.thresholds):
            self.tps[i] += (es_p > t).sum()
            self.fps[i] += (es_n > t).sum()
            self.fns[i] += (es_p <= t).sum()
            self.tns[i] += (es_n <= t).sum()

    def get(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            precis = np.nan_to_num(self.tps / (self.tps + self.fps))
            recall = np.nan_to_num(self.tps / (self.tps + self.fns))
            fprs = np.nan_to_num(self.fps / (self.fps + self.tns))
        precis = np.r_[0, precis, 1]
        recall = np.r_[1, recall, 0]
        fprs = np.r_[1, fprs, 0]
        ret = {
            "auc": float(-_trapezoid(recall, fprs)),
            "prauc": float(-_trapezoid(precis, recall)),
            "ap": float(-(np.diff(recall) * precis[:-1]).sum()),
        }
        acc = (self.tps + self.tns) / np.maximum(
            self.tps + self.tns + self.fps + self.fns, 1)
        for t in np.linspace(0, 1, 11)[1:-1]:
            i = int(np.argmin(np.abs(t - self.thresholds)))
            ret[f"acc{self.thresholds[i]:.2f}"] = float(acc[i])
        return ret


class StreamingEvalMetric:
    """Disparity-error statistics accumulated on the device, for large test
    splits: the host metrics buffer every per-pixel distance (~1.8 GB for a
    512-sample split at 512x432x4) and copy every batch's disparities to
    the host; this keeps an integer histogram of the error on the device,
    and only the histogram (256 KiB) crosses to the host, once, at
    :meth:`get`.

    Inputs are the eval step's u16 x256 disparities and the batch's u16
    x256 GT (wire encoding, ``data/wire.py``; a float32 GT is quantized as
    the wire does), so the error ``|where(gt > 0, es, 0) - gt|`` is an
    integer in 1/256 px and indexes the histogram directly: mean, std,
    min, max and of{t} are those of the host path on the decoded values
    (the mean and std up to the host path's float32 sums), and the
    quantiles are exact order statistics of the quantized errors (the
    host path interpolates between neighbours, <= 1/256 px apart). Counts
    are float32, exact up to 2^24 a bin; padded batch entries past
    ``n_valid`` are not counted. Under data parallelism each rank counts
    its block and :meth:`all_reduce` sums the histograms over the ranks
    (still float32, as the JAX mesh sums its shards)."""

    _SCALE = 256.0
    _BINS = 65536

    def __init__(self, thresholds=(0.1, 0.5, 1, 2, 5)):
        self.thresholds = list(thresholds)
        # for an integer error k (1/256 px), k / 256 > t <=> k > floor(256 t)
        self._thr = [int(v) for v in np.floor(
            np.asarray(self.thresholds, np.float64) * self._SCALE)]
        self.reset()

    def reset(self):
        self._hist = None
        self._over = None

    @torch.no_grad()
    def add(self, es_u16: torch.Tensor, gt: torch.Tensor,
            n_valid: int) -> None:
        """es_u16: (tl, bs, H, W) uint16 x256; gt: the same shape, uint16
        x256 or float32 px, on the same device; the first ``n_valid`` batch
        entries count."""
        if gt.dtype == torch.uint16:
            gt_i = gt[:, :n_valid].to(torch.int32)
        else:
            gt_i = torch.clamp(gt[:, :n_valid] * self._SCALE + 0.5, 0,
                               65535).to(torch.int32)
        es_i = es_u16[:, :n_valid].to(torch.int32)
        err = torch.abs(torch.where(gt_i > 0, es_i, 0) - gt_i)
        counts = torch.bincount(err.reshape(-1), minlength=self._BINS)
        over = torch.stack([counts[t + 1:].sum() for t in self._thr])
        if self._hist is None:
            self._hist = torch.zeros(self._BINS, dtype=torch.float32,
                                     device=counts.device)
            self._over = torch.zeros(len(self._thr), dtype=torch.float32,
                                     device=counts.device)
        self._hist += counts.to(torch.float32)
        self._over += over.to(torch.float32)

    def all_reduce(self, group) -> None:
        """Sum the counts over the ranks of ``group`` (every rank calls it
        once, after its last :meth:`add`)."""
        self._hist = all_reduce_sum(self._hist, group)
        self._over = all_reduce_sum(self._over, group)

    def get(self) -> dict:
        hist = self._hist.cpu().numpy().astype(np.float64)
        over = self._over.cpu().numpy().astype(np.float64)
        count = hist.sum()
        vals = np.arange(self._BINS) / self._SCALE
        mean = float((hist * vals).sum() / count)
        var = float((hist * vals ** 2).sum() / count) - mean ** 2
        nonzero = np.nonzero(hist)[0]
        cum = np.cumsum(hist)

        def quantile(q):
            return float(np.searchsorted(cum, q * count) / self._SCALE)

        out = {
            "dist2_mean": mean,
            "dist2_std": float(np.sqrt(max(var, 0.0))),
            "dist2_median": quantile(0.5),
            "dist2_q10": quantile(0.1),
            "dist2_q90": quantile(0.9),
            "dist2_min": (float(nonzero[0] / self._SCALE) if nonzero.size
                          else 0.0),
            "dist2_max": (float(nonzero[-1] / self._SCALE) if nonzero.size
                          else 0.0),
        }
        for t, o in zip(self.thresholds, over):
            out[f"of{t}"] = float(o / count)
        return out

    def items(self):
        return self.get().items()

    def __str__(self):
        return ", ".join(f"{k}={v:.5f}" for k, v in self.get().items())
