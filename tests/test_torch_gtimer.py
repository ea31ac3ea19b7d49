"""The port's timing utilities (utils/gtimer.py) against
depthinspace_tpu/utils/gtimer.py under the same clock readings, and the
profiler trace functions (the worker's "timings:" and ETA lines are held
in tests/test_torch_orbax.py and tests/test_torch_real_e2e.py)."""
import numpy as np
import pytest

import depthinspace_tpu.utils.gtimer as jax_gtimer
import depthinspace_tpu_torch.utils.gtimer as gtimer


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("mod", [gtimer, jax_gtimer])
def test_phase_timer_and_progress_read_as_jax(mod, monkeypatch):
    """The same summary and ETA strings from the same monotonic readings."""
    ticks = [0.0, 0.5, 0.5, 2.0, 2.0, 2.25, 2.25, 4.0]
    monkeypatch.setattr(mod.time, "monotonic", _Clock(ticks))
    sw = mod.PhaseTimer()
    sw.begin("data")
    sw.end("data")
    with sw.phase("step"):
        pass
    sw.begin("data")
    sw.end("data")
    sw.end("never begun")
    assert str(sw) == ("data 0.75s (n=2, avg 375ms, max 500ms); step 1.50s "
                       "(n=1, avg 1500ms, max 1500ms)")
    assert sw.total("data") == 0.75 and sw.total("none") == 0.0
    monkeypatch.setattr(mod.time, "monotonic", _Clock([10.0, 40.0, 70.0]))
    bar = mod.Progress(6)
    assert bar.remaining_str() == "--:--:--"
    bar.step()
    assert (bar.elapsed_str(), bar.remaining_str()) == ("00:00:30",
                                                        "00:02:30")
    bar.step(2)
    assert bar.remaining_str() == "00:01:00"


def test_timed_annotate_and_profiler_trace(tmp_path):
    import torch
    with gtimer.timed("unit test phase"):
        with gtimer.annotate("region"):
            gtimer.start_profiler_trace(tmp_path)
            torch.ones(8).sum()
            gtimer.stop_profiler_trace()
    assert gtimer.GTIMER.total("unit test phase") > 0
    assert list(tmp_path.glob("*.json"))
