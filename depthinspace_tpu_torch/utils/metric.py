"""Host evaluation metrics, numpy only: the ``DistanceMetric``,
``OutlierFractionMetric`` and ``MultipleMetric`` of
``depthinspace_tpu/utils/metric.py``, which fill ``metrics.json``'s
``dist2_*`` and ``of{t}`` keys. Estimates are masked by gt > 0 and
flattened to N x 1 by the worker. (The JAX package's on-device streaming
accumulator is not ported; these exact host metrics serve every split.)
"""

from __future__ import annotations

import numpy as np


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
