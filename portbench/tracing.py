"""What the traced run reads: spans timed with CUDA events around the
program's layers, the program's kernel-wrapper calls with their least
times, and a short slice under ``torch.profiler``.

Spans are recorded from the benchmark's side only: a wrapper on the
``Predictor`` instance's ``prepare`` and forward pre- and post-hooks on
the model instance. Each span is also a ``record_function`` range, so the
profiled slice can name what the host was doing in each idle gap.
"""

from __future__ import annotations

import re
import sys
import time
import warnings
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from portbench import bounds

CSRC = Path(__file__).resolve().parent.parent / "crfconv_tpu_torch" / "csrc"
COPIES = ("Memcpy", "Memset")


class Spans:
    """CUDA-event spans by name; ``totals_ms()`` after a synchronise. While
    ``enabled`` is False nothing is recorded (the hooks stay in place)."""

    def __init__(self, timed: bool = True):
        self.timed = timed
        self.enabled = True
        self.events = {}
        self._open = {}

    def begin(self, name: str) -> None:
        rf = record_function("portbench." + name)
        rf.__enter__()
        ev = None
        if self.timed and self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._open[name] = (rf, ev)

    def end(self, name: str) -> None:
        rf, ev = self._open.pop(name)
        if ev is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            self.events.setdefault(name, []).append((ev, done))
        rf.__exit__(None, None, None)

    def totals_ms(self) -> dict:
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of the instance attribute ``obj.attr``."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            self.begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.end(name)

        setattr(obj, attr, timed)

    def hook_forward(self, model: torch.nn.Module) -> None:
        model.register_forward_pre_hook(lambda m, a: self.begin("forward"))
        model.register_forward_hook(lambda m, a, o: self.end("forward"))


class KernelRecorder:
    """While entered, every loaded attribute of the program that is one of
    ``bounds.WRAPPERS`` is replaced by a recorder that adds each call's
    least time (``bounds.bound_of``) to ``bound_ms``."""

    def __init__(self):
        self.bound_ms = 0.0
        self.calls = 0
        self._saved = []

    def _recorder(self, name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                self.bound_ms += bounds.bound_of(name, args, out, kwargs)[0]
                self.calls += 1
            return out
        return rec

    def __enter__(self):
        for name, (mod, attr) in bounds.WRAPPERS.items():
            module = sys.modules.get(mod)
            fn = getattr(module, attr, None) if module else None
            if fn is None:
                continue
            rec = self._recorder(name, fn)
            for m in list(sys.modules.values()):
                if not getattr(m, "__name__", "").startswith(
                        "crfconv_tpu_torch"):
                    continue
                for k, v in list(vars(m).items()):
                    if v is fn:
                        self._saved.append((m, k, v))
                        setattr(m, k, rec)
        return self

    def __exit__(self, *exc):
        for m, k, v in reversed(self._saved):
            setattr(m, k, v)
        self._saved.clear()
        return False


def kernel_functions() -> tuple:
    """The ``__global__`` functions of the program's CUDA sources."""
    names = set()
    for f in sorted(CSRC.glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            f.read_text()))
    return tuple(sorted(names))


def _profiled(fn, activities, recorder=None):
    """Run ``fn`` twice under the profiler, the first call as its warm-up
    (the tracer missed device work that started at once), and return the
    second call's events, its wall seconds on the host clock (``fn`` and a
    synchronise) and what ``fn`` returned."""
    got = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as p:
            for step in range(2):
                if recorder is not None:
                    recorder.bound_ms, recorder.calls = 0.0, 0
                time.sleep(0.05)
                t0 = time.perf_counter()
                with record_function("portbench.slice"):
                    got["units"] = fn()
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                got["wall_s"] = time.perf_counter() - t0
                time.sleep(0.05)
                p.step()
        got["events"] = p.events()
    return got


def profile_slice(fn, spans: Spans):
    """The profiled slice: ``fn`` (which returns the requests or steps it
    ran) traced twice over the same requests or steps. The device-only
    trace, whose tracer adds least to the host's time, gives the busy
    time and the launches over the wall time of the same call. The trace
    with the host's operations, during which the kernel wrappers' calls
    are recorded, gives the device operations by time, the program's
    kernels' time against their bounds, and the idle gaps named by the
    benchmark span open on the host. None where the profiler recorded no
    device operation."""
    spans.enabled = False
    recorder = KernelRecorder()
    try:
        lean = _profiled(fn, [ProfilerActivity.CUDA
                              if torch.cuda.is_available()
                              else ProfilerActivity.CPU])
        with recorder:
            host = _profiled(fn, [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA], recorder)
    finally:
        spans.enabled = True
    ops = _device_ops(lean["events"])
    if not ops:
        return None
    busy, _ = _union(ops, min(s for _, s, _ in ops), max(t for _, _, t in ops))
    out = read_host(host["events"], recorder)
    out.update(units=lean["units"], wall_s=lean["wall_s"],
               busy_s=busy * 1e-6,
               launches=sum(not n.startswith(COPIES) for n, _, _ in ops))
    return out


def _device_ops(events):
    """(name, start, end) in µs of every device operation: kernels,
    copies and fills, not the annotations the profiler mirrors there."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def read_host(events, recorder) -> dict:
    """From the trace with the host's operations: the device operations by
    time, the program's kernels' time and their bounds' sum, and the ten
    longest idle gaps of the slice, each named by the innermost benchmark
    span open on the host when it began."""
    from torch.autograd import DeviceType

    host = [(e.name[len("portbench."):], e.time_range.start,
             e.time_range.end) for e in events
            if e.name.startswith("portbench.")
            and e.device_type == DeviceType.CPU]
    slices = [(s, t) for n, s, t in host if n == "slice"]
    ops = _device_ops(events)
    own = re.compile(r"\b(?:" + "|".join(kernel_functions()) + r")\b")
    by_name = {}
    for n, s, t in ops:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    gaps = []
    if slices and ops:
        lo, hi = slices[-1]
        _, gaps = _union([(n, max(s, lo), min(t, hi)) for n, s, t in ops
                          if t > lo and s < hi], lo, hi)
    named = sorted(((_open_span(host, s), (t - s) * 1e-6) for s, t in gaps),
                   key=lambda g: -g[1])
    return {
        "csrc_device_s": sum(t - s for n, s, t in ops
                             if not n.startswith(COPIES)
                             and own.search(n)) * 1e-6,
        "bound_s": recorder.bound_ms * 1e-3,
        "wrapper_calls": recorder.calls,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": named[:10],
    }


def _union(intervals, lo, hi):
    """(covered length, the uncovered gaps) of intervals within [lo, hi]."""
    busy, gaps, cur = 0.0, [], lo
    for _, s, t in sorted(intervals, key=lambda d: d[1]):
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _open_span(host, at):
    """The innermost benchmark span open on the host at time ``at``."""
    best = None
    for n, s, t in host:
        if s <= at <= t and n != "slice" and (best is None
                                              or t - s < best[2] - best[1]):
            best = (n, s, t)
    return best[0] if best else "between spans"
