"""Timing and progress for the host's epoch loop, port of
``depthinspace_tpu/utils/gtimer.py``.

- ``PhaseTimer``: wall time summed by phase name (count, total, max) on
  the monotonic clock. It does not synchronize the device: a step's time
  is the host's time to issue it until a logging boundary copies a value
  back.
- ``Progress``: elapsed time and a rate-based estimate of what remains.
- ``timed``: a phase of the process-wide ``GTIMER``, summarized at exit.
- ``annotate`` names a region in ``torch.profiler`` traces
  (``record_function``), and ``start_profiler_trace`` /
  ``stop_profiler_trace`` write a trace of the host and, where there is one,
  the card, for TensorBoard or Perfetto.
"""

from __future__ import annotations

import atexit
import contextlib
import time
from dataclasses import dataclass

import torch


@dataclass
class _PhaseStats:
    count: int = 0
    total: float = 0.0
    max: float = 0.0

    def record(self, dt: float):
        self.count += 1
        self.total += dt
        if dt > self.max:
            self.max = dt


class PhaseTimer:
    """Aggregate wall time by phase name: bracket code with ``phase``, or
    call ``begin`` and ``end`` where a span straddles loop iterations (the
    data wait between one batch and the next)."""

    def __init__(self):
        self._stats: dict[str, _PhaseStats] = {}
        self._open: dict[str, float] = {}

    def begin(self, name: str):
        self._open[name] = time.monotonic()

    def end(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self._stats.setdefault(name, _PhaseStats()).record(
                time.monotonic() - t0)

    @contextlib.contextmanager
    def phase(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def total(self, name: str) -> float:
        return self._stats[name].total if name in self._stats else 0.0

    def summary(self) -> str:
        parts = []
        for name, s in self._stats.items():
            mean = s.total / s.count if s.count else 0.0
            parts.append(f"{name} {s.total:.2f}s"
                         f" (n={s.count}, avg {mean * 1e3:.0f}ms,"
                         f" max {s.max * 1e3:.0f}ms)")
        return "; ".join(parts)

    __str__ = summary


class Progress:
    """Elapsed and remaining time of a loop of ``total`` items; remaining =
    items left / the rate of the items finished so far."""

    def __init__(self, total: int):
        self.total = max(int(total), 0)
        self.done = 0
        self._t0 = time.monotonic()
        self._t_last = self._t0

    def step(self, n: int = 1):
        """Mark ``n`` more items finished."""
        self.done += n
        self._t_last = time.monotonic()

    def elapsed(self) -> float:
        return self._t_last - self._t0

    def remaining(self) -> float:
        if self.done <= 0:
            return float("inf")
        rate = self.done / max(self.elapsed(), 1e-9)
        return max(self.total - self.done, 0) / rate

    @staticmethod
    def _hms(seconds: float) -> str:
        if not (seconds < float("inf")):
            return "--:--:--"
        s = int(seconds)
        return f"{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}"

    def elapsed_str(self) -> str:
        return self._hms(self.elapsed())

    def remaining_str(self) -> str:
        return self._hms(self.remaining())


@contextlib.contextmanager
def annotate(name: str):
    """A named region in torch.profiler traces."""
    with torch.profiler.record_function(name):
        yield


class _ProcessTimer(PhaseTimer):
    """The process-wide phase timer, summarized at exit."""

    def report(self):
        if self._stats:
            print(f"[gtimer] {self.summary()}")


GTIMER = _ProcessTimer()
atexit.register(GTIMER.report)


@contextlib.contextmanager
def timed(name: str):
    with GTIMER.phase(name):
        yield


_profiler = None


def start_profiler_trace(logdir: str):
    """Start tracing the host and, where there is one, the card; the trace
    goes to ``logdir`` when :func:`stop_profiler_trace` is called."""
    global _profiler
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)))
    _profiler.start()


def stop_profiler_trace():
    global _profiler
    if _profiler is not None:
        _profiler.stop()
        _profiler = None
