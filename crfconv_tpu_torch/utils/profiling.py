"""Tracing and throughput meters.

Counterpart of ``crfconv_tpu/utils/profiling.py``: ``span`` marks a phase
of the program at a layer boundary (serving's request, copy in, pyramid,
forward and restore; a train step's pyramid, forward, loss, backward,
optimizer and metrics); ``tracing`` turns the spans on and yields their
record in memory; ``trace`` captures a ``torch.profiler`` timeline of the
enclosed region (the host's operators, the spans, and the card's kernels
where a CUDA device is present) as a Chrome trace file; ``StepTimer``
reports step time and points/s with warm-up steps left out.

Spans are off by default: then ``span`` is one test of a module-level
variable and returns a shared null context (no CUDA event, no
``record_function``, no allocation, no lock). On, a span opens a
``record_function`` range named ``crfconv_tpu_torch.<name>``, so a
profiler puts it on the device's timeline, and its record holds host
start and end, a pair of CUDA events on the current stream (unless the
record is ranges-only, or there is no CUDA device), its parent span, the
id of its request or step (the outermost span open in its thread) and the
port's kernel launches made while it was open (``cuda_build``).
``bn_fallbacks`` counts the batch norms on CUDA tensors that kept
PyTorch's ops (``ops/batch_norm.py::fallback_reason``). ``crf_steps``
counts the mean-field steps the continuous CRF's fused core ran
(``ops/crf_core.py::crf_core``) while spans were on; off, a core's count
is one test of the same module-level variable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
import time
from typing import Iterator, List, Optional

import torch

from crfconv_tpu_torch import cuda_build

PREFIX = "crfconv_tpu_torch."

# The record that spans go to, or None: spans are off. Set only by
# ``tracing`` (and ``trace``, which enters it).
_RECORD: Optional["Record"] = None
_OFF = contextlib.nullcontext()
# batch norms on CUDA tensors that kept PyTorch's ops
# (``ops/batch_norm.py::fallback_reason``), by reason, since the process
# started
_BN_FALLBACKS: dict = {}


# mean-field steps of the fused continuous-CRF core counted while spans
# were on, since the process started
_CRF_STEPS = 0


def count_crf_steps(steps: int) -> None:
    """Add a fused core's ``steps`` to :func:`crf_steps`, inside
    ``tracing`` only."""
    global _CRF_STEPS
    if _RECORD is not None:
        _CRF_STEPS += steps


def crf_steps() -> int:
    """The mean-field steps the continuous CRF's fused core
    (``ops/crf_core.py``, steps >= 2) ran inside ``tracing`` regions since
    the process started; a difference over a region counts its steps."""
    return _CRF_STEPS


def count_bn_fallback(reason: str) -> None:
    _BN_FALLBACKS[reason] = _BN_FALLBACKS.get(reason, 0) + 1


def bn_fallbacks() -> dict:
    """Batch norms on CUDA tensors that kept PyTorch's ops, by reason
    (``"mask"``, ``"mesh"``, ``"dtype"``, ``"layout"``), since the process
    started; CPU calls count nothing. An MLP whose activation is not in
    ``models/common.py::LEAKY_SLOPES`` still takes the kernels for its
    norm and applies the activation after it, uncounted."""
    return dict(_BN_FALLBACKS)


@dataclasses.dataclass(eq=False)
class SpanRecord:
    """One span: ``root`` is the id of its request or step, ``parent`` the
    span it opened in (None for the outermost), ``events`` its (start,
    end) CUDA events or None, ``launches`` the port's kernel launches
    while it was open."""

    name: str
    parent: Optional["SpanRecord"]
    root: int
    t0_ns: int
    events: Optional[tuple] = None
    t1_ns: int = 0
    launches: int = 0
    children: List["SpanRecord"] = dataclasses.field(default_factory=list)

    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def event_ms(self) -> Optional[float]:
        return None if self.events is None else \
            self.events[0].elapsed_time(self.events[1])

    def self_ms(self) -> float:
        """The span's time outside its children: the CUDA events' time
        between its start, its children's ends and starts, and its end, or
        without events the host's."""
        if self.events is None:
            return (self.t1_ns - self.t0_ns - sum(
                c.t1_ns - c.t0_ns for c in self.children)) * 1e-6
        marks = [self.events[0]]
        for c in self.children:
            marks += c.events
        marks.append(self.events[1])
        return sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2]))


class Record:
    """The spans recorded inside one ``tracing`` region, in the order they
    opened (``spans``)."""

    def __init__(self, events: bool):
        self.events = events
        self.spans: List[SpanRecord] = []
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def totals(self, skip: int = 0) -> dict:
        """For each span name: ``count``, the summed ``event_ms`` (None
        without events), ``host_ms`` and ``self_ms``, and ``launches``,
        over the closed spans, leaving out those of the first ``skip``
        requests or steps. Synchronises the device when there are
        events."""
        if self.events:
            torch.cuda.synchronize()
        out = {}
        for s in self.spans:
            if s.root < skip or not s.t1_ns:
                continue
            t = out.setdefault(s.name, {
                "count": 0, "event_ms": 0.0 if self.events else None,
                "host_ms": 0.0, "self_ms": 0.0, "launches": 0})
            t["count"] += 1
            t["host_ms"] += s.host_ms()
            if self.events:
                t["event_ms"] += s.event_ms()
            t["self_ms"] += s.self_ms()
            t["launches"] += s.launches
        return out


class _Span:
    __slots__ = ("record", "name", "_rf", "_span", "_launched")

    def __init__(self, record: Record, name: str):
        self.record = record
        self.name = name

    def __enter__(self):
        rec = self.record
        stack = rec._stack()
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        parent = stack[-1] if stack else None
        root = next(rec._ids) if parent is None else parent.root
        events = None
        if rec.events:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._launched = cuda_build.total_launches()
        s = SpanRecord(self.name, parent, root, time.perf_counter_ns(),
                       events)
        if parent is not None:
            parent.children.append(s)
        rec.spans.append(s)
        stack.append(s)
        self._span = s
        return s

    def __exit__(self, *exc):
        s = self._span
        s.launches = cuda_build.total_launches() - self._launched
        if s.events is not None:
            s.events[1].record()
        s.t1_ns = time.perf_counter_ns()
        self.record._stack().pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking the phase ``name`` (a layer's name, as
    ``serve.restore`` or ``pyramid``); records only inside ``tracing``."""
    if _RECORD is None:
        return _OFF
    return _Span(_RECORD, name)


@contextlib.contextmanager
def tracing(events: bool = True) -> Iterator[Record]:
    """Turn the spans on for the enclosed region and yield their
    :class:`Record`; nothing is written out. ``events=False`` records
    ranges and host times only (no CUDA event), for a region under a
    profiler. A region inside another records into its own record."""
    global _RECORD
    outer = _RECORD
    _RECORD = Record(events and torch.cuda.is_available())
    try:
        yield _RECORD
    finally:
        _RECORD = outer


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the enclosed region, its spans on (ranges only), and write
    its Chrome trace, ``trace_<pid>_<ns>.json``, under ``log_dir``
    (default: ``crfconv_trace`` in the temporary directory) on the way
    out, also when the region raises."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "crfconv_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with tracing(events=False):
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
