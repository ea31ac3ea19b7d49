"""The port's device metric (``utils/metric.py::StreamingEvalMetric``)
against the JAX package's on the same u16 arrays, on the CPU: ``get()``
equal key for key (the histogram and the over-threshold counts are the
same integers, and ``get`` the same float64 formulas), with a padded tail
batch excluded by ``n_valid`` and a float32 GT quantized as the wire does;
and against the port's exact host metrics on the decoded values (mean,
std, min, max and of{t} within 1e-5, the quantiles within 1/256 px)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from depthinspace_tpu.utils.metric import StreamingEvalMetric as JaxStream
from depthinspace_tpu_torch.utils import metric as M

TL, BS, H, W = 4, 4, 32, 24


def _batches(seed: int, n: int = 3):
    """n batches of (es u16, gt u16, gt f32, n_valid): disparities up to 40
    px, a fifth of the GT invalid (0), the last batch padded (3 of 4)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        es = rng.randint(0, 40 * 256, (TL, BS, H, W)).astype(np.uint16)
        gt = ((rng.rand(TL, BS, H, W).astype(np.float32) * 40)
              * (rng.rand(TL, BS, H, W) > 0.2)).astype(np.float32)
        gt_u16 = np.clip(gt * 256 + 0.5, 0, 65535).astype(np.uint16)
        out.append((es, gt_u16, gt, BS if i < n - 1 else 3))
    return out


@pytest.mark.parametrize("gt_kind", ["u16", "f32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stream_metric_equals_jax(seed, gt_kind):
    port, ref = M.StreamingEvalMetric(), JaxStream()
    for es, gt_u16, gt, n_valid in _batches(seed):
        gt_in = gt_u16 if gt_kind == "u16" else gt
        port.add(torch.from_numpy(es), torch.from_numpy(gt_in), n_valid)
        ref.add(jnp.asarray(es), jnp.asarray(gt_in), n_valid)
    p, r = port.get(), ref.get()
    assert list(p) == list(r)
    for k in r:
        assert p[k] == r[k], (k, p[k], r[k])
    assert str(port) == str(ref)


def test_stream_metric_matches_the_host_metrics():
    port = M.StreamingEvalMetric()
    host = M.MultipleMetric(
        M.DistanceMetric(vec_length=1),
        M.OutlierFractionMetric(vec_length=1, thresholds=[0.1, 0.5, 1, 2, 5]))
    for es, gt_u16, _, n_valid in _batches(2):
        port.add(torch.from_numpy(es), torch.from_numpy(gt_u16), n_valid)
        e = es[:, :n_valid].astype(np.float32) / 256.0
        g = gt_u16[:, :n_valid].astype(np.float32) / 256.0
        host.add((e * (g > 0)).reshape(-1, 1), g.reshape(-1, 1))
    d, h = port.get(), host.get()
    assert set(d) == set(h)
    for k in h:
        tol = 1 / 256 + 1e-9 if ("median" in k or "_q" in k) else 1e-5
        assert abs(d[k] - h[k]) <= tol, (k, d[k], h[k])
    for k in ("dist2_min", "dist2_max", "of0.1", "of0.5", "of1", "of2",
              "of5"):
        assert d[k] == h[k], (k, d[k], h[k])
