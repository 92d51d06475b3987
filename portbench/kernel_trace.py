"""Kernel by kernel: the least time of a kernel's wrapper calls
(``bounds.bound_of``) beside its device time, for a roofline share of a
few of the program's kernels.

:func:`bounds_and_time` runs a slice of work once with every call of the
named kernels' wrappers recorded (``KeyedRecorder``, ``tracing.
KernelRecorder``'s wrapping with a sum a kernel), then profiles it as
``tracing._profiled`` does (device only, the second of two calls) and sums
the device time of each kernel's ``__global__`` functions, found by name in
its CUDA source (``SOURCES``).
"""

from __future__ import annotations

import re

import torch
from torch.profiler import ProfilerActivity

from portbench import bounds, tracing

# each kernel of ``bounds.WRAPPERS`` read here: its CUDA source
SOURCES = {"crf_operator": "crf_operator.cu", "crf_iterate": "crf_iterate.cu"}
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")


class KeyedRecorder(tracing.KernelRecorder):
    """``tracing.KernelRecorder`` whose sums are kept a kernel:
    ``by_kernel[name] = [bound ms, calls]`` for each CUDA call."""

    def __init__(self):
        super().__init__()
        self.by_kernel = {}

    def _recorder(self, name, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                t = self.by_kernel.setdefault(name, [0.0, 0])
                t[0] += bounds.bound_of(name, args, out, kwargs)[0]
                t[1] += 1
            return out
        return rec


def functions_of(kernel: str) -> tuple:
    """The ``__global__`` functions of ``kernel``'s CUDA source."""
    return tuple(GLOBAL.findall((tracing.CSRC / SOURCES[kernel]).read_text()))


def bounds_and_time(fn, kernels) -> dict:
    """Over ``fn``'s work (``fn`` returns the requests or steps it ran):
    ``bound_s``, the summed least time of the ``kernels``' wrapper calls,
    ``device_s``, their device time, and ``calls``, the wrapper calls, all
    per request or step. ``device_s`` is 0 where the profiler saw none of
    them (no CUDA device)."""
    rec = KeyedRecorder()
    with rec:
        units = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    bound_ms = sum(rec.by_kernel.get(k, [0.0, 0])[0] for k in kernels)
    calls = sum(rec.by_kernel.get(k, [0.0, 0])[1] for k in kernels)
    own = re.compile(r"\b(?:" + "|".join(
        f for k in kernels for f in functions_of(k)) + r")\b")
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    got = tracing._profiled(fn, [activity])
    device_us = sum(t - s for n, s, t in tracing._device_ops(got["events"])
                    if own.search(n))
    return {"bound_s": bound_ms * 1e-3 / units,
            "device_s": device_us * 1e-6 / got["units"],
            "calls": calls / units}
