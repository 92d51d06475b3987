"""Tracing and throughput meters.

Counterpart of ``crfconv_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` timeline of the enclosed region (the host's operators,
and the card's kernels where a CUDA device is present) as a Chrome trace
file; ``StepTimer`` reports step time and points/s with warm-up steps
left out.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the enclosed region and write its Chrome trace,
    ``trace_<pid>_<ns>.json``, under ``log_dir`` (default:
    ``crfconv_trace`` in the temporary directory) on the way out, also
    when the region raises."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "crfconv_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Throughput meter: call tick(points) once per step. It reads the
    host's clock: on a CUDA device, synchronise before each ``tick`` so a
    step's kernels are inside its time."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup = warmup_steps
        self.reset()

    def reset(self):
        self._steps = 0
        self._points = 0
        self._t0: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self, points: int = 0):
        now = time.perf_counter()
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = now
            self._points = 0
        elif self._steps > self.warmup:
            self._points += points
        self._last = now

    @property
    def measured_steps(self) -> int:
        return max(self._steps - self.warmup, 0)

    @property
    def seconds(self) -> float:
        if self._t0 is None or self._last is None:
            return 0.0
        return self._last - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.measured_steps / self.seconds if self.seconds > 0 else 0.0

    @property
    def points_per_sec(self) -> float:
        return self._points / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.measured_steps,
            "seconds": round(self.seconds, 3),
            "steps_per_sec": round(self.steps_per_sec, 3),
            "points_per_sec": round(self.points_per_sec, 1),
        }
