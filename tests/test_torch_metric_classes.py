"""The host metric classes no worker uses (utils/metric.py:
RelativeDistanceMetric, RotmDistanceMetric, QuaternionDistanceMetric,
BinaryAccuracyMetric) against the JAX package's, on the same seeded numpy
inputs added in several batches. The same numpy code: results equal."""

import numpy as np
import pytest

from depthinspace_tpu.utils import geometry3d as g3
from depthinspace_tpu.utils import metric as ref
from depthinspace_tpu_torch.utils import metric as port


def _rots(rng, n):
    return np.stack([g3.rotm_from_quat(g3.quat_random(rng=rng))
                     for _ in range(n)])


def _batches(name, rng):
    """Three (es, ta, ma) batches for the metric ``name``."""
    out = []
    for n in (5, 8, 3):
        if name.startswith("rel"):
            ta = rng.normal(size=(n, 3))
            out.append((ta + 0.1 * rng.normal(size=(n, 3)), ta,
                        rng.randint(0, 2, n)))
        elif name.startswith("rotm"):
            out.append((_rots(rng, n), _rots(rng, n), None))
        elif name.startswith("quat"):
            out.append((rng.normal(size=(n, 4)), rng.normal(size=(n, 4)),
                        None))
        else:
            out.append((rng.uniform(0, 1, (n, 7)), rng.randint(0, 2, (n, 7)),
                        None))
    return out


CASES = {
    "rel2": lambda m: m.RelativeDistanceMetric(3, p=2),
    "rel1": lambda m: m.RelativeDistanceMetric(3, p=1),
    "rotm_identity": lambda m: m.RotmDistanceMetric("identity"),
    "rotm_geodesic": lambda m: m.RotmDistanceMetric("geodesic"),
    "quat_angle": lambda m: m.QuaternionDistanceMetric("angle"),
    "quat_mineucl": lambda m: m.QuaternionDistanceMetric("mineucl"),
    "quat_normdiff": lambda m: m.QuaternionDistanceMetric("normdiff"),
    "binary": lambda m: m.BinaryAccuracyMetric(),
    "binary_thresholds": lambda m: m.BinaryAccuracyMetric(
        np.linspace(0, 1, 21)[:-1], str_prefix="val_"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_class_matches_jax_package(name):
    got, want = CASES[name](port), CASES[name](ref)
    for es, ta, ma in _batches(name, np.random.RandomState(len(name))):
        got.add(es, ta, ma)
        want.add(es, ta, ma)
    g = got.get()
    assert g == want.get() and len(g) >= 2
    assert all(np.isfinite(v) for v in g.values())
    assert str(got) == str(want)
    got.reset()
    want.reset()
    es, ta, ma = _batches(name, np.random.RandomState(0))[0]
    got.add(es, ta, ma)
    want.add(es, ta, ma)
    assert got.get() == want.get()


def test_metric_classes_refuse_bad_shapes():
    with pytest.raises(ValueError):
        port.RelativeDistanceMetric(3).add(np.zeros((2, 4)), np.zeros((2, 4)))
    with pytest.raises(ValueError):
        port.RotmDistanceMetric().add(np.zeros((2, 4, 4)), np.zeros((2, 4, 4)))
    with pytest.raises(ValueError):
        port.RotmDistanceMetric("other").add(np.zeros((1, 3, 3)),
                                             np.zeros((1, 3, 3)))
    with pytest.raises(ValueError):
        port.QuaternionDistanceMetric().add(np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(ValueError):
        port.BinaryAccuracyMetric().add(np.array([1.5]), np.array([1]))
    with pytest.raises(ValueError):
        port.BinaryAccuracyMetric().add(np.zeros(3), np.zeros(4))
