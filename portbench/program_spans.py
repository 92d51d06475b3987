"""The program's own spans (``crfconv_tpu_torch.utils.profiling``) read
beside one run of a cell:

    python3 portbench/program_spans.py --workload semantic3d.serve \
        --seed 7 --seconds 51 --trace 1

runs the cell as ``run.py`` does (its result line is printed first) with
the program's spans on: CUDA-event spans over the set-up and the window,
ranges only in the profiled slice. It then prints one more JSON line: the
per-layer metrics that read the spans (``METRICS``, each named
``<metric>.<kind>``), every span's time, self time and launches per
request or step of the window, and with ``--trace 1`` the slice's idle
gaps named by the innermost benchmark or program span open on the host
when each began (a program span as ``program:<name>``) and the idle that
began while a program span was open. ``read`` finds nothing, and
``read_gaps`` names gaps by the benchmark's spans only, in readings of a
program without spans.

The cells' loops (``mixes/``) do not turn the spans on, so a benchmark run
reads none of this; ``read`` is what their readers would call.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import harness, tracing  # noqa: E402

PROGRAM = "crfconv_tpu_torch."   # the program's ranges: PROGRAM + span name
ROOTS = {"serve": "serve.request", "train": "train.step"}
# metric: (the span it reads, None for the request or step itself; field)
METRICS = {
    "copy_in_ms": ("serve.copy_in", "event_ms"),
    "pyramid_span_ms": ("pyramid", "event_ms"),
    "forward_span_ms": ("forward", "event_ms"),
    "backward_ms": ("train.backward", "event_ms"),
    "optimizer_ms": ("train.optimizer", "event_ms"),
    "csrc_launches": (None, "launches"),
}
SKIPPED = {"serve": "warmup_requests", "train": "checked_steps"}


def read(r, metric: str):
    """``metric`` (a name of ``METRICS`` or ``program_idle``) from the
    readings ``r``: ``r.kind``, and ``r.program`` (a span record's
    ``totals()``) or ``r.program_slice`` (``read_gaps``'s), per request or
    step of ``r.kind``. None where the program recorded nothing for it."""
    if metric == "program_idle":
        sl = getattr(r, "program_slice", None)
        if not sl or sl["slice_s"] <= 0:
            return None
        return 100.0 * sl["program_idle_s"] / sl["slice_s"]
    totals = getattr(r, "program", None) or {}
    root = totals.get(ROOTS[r.kind])
    if not root or not root["count"]:
        return None
    span, field = METRICS[metric]
    t = root if span is None else totals.get(span)
    if t is None or t[field] is None:
        return None
    return t[field] / root["count"]


def read_gaps(events) -> dict:
    """From the profiled slice's trace with the host's operations: the ten
    longest idle gaps of its last ``slice`` range, each named by the
    innermost benchmark or program range open on the host when it began
    (``tracing._open_span``'s rule), the idle seconds that began while a
    program range was open, all idle seconds, and the slice's seconds.
    Empty where the trace holds no slice or no device operation."""
    from torch.autograd import DeviceType

    host = []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("portbench."):
            name = e.name[len("portbench."):]
        elif e.name.startswith(PROGRAM):
            name = "program:" + e.name[len(PROGRAM):]
        else:
            continue
        host.append((name, e.time_range.start, e.time_range.end))
    slices = [(s, t) for n, s, t in host if n == "slice"]
    ops = tracing._device_ops(events)
    if not slices or not ops:
        return {}
    lo, hi = slices[-1]
    _, gaps = tracing._union([(n, max(s, lo), min(t, hi)) for n, s, t in ops
                              if t > lo and s < hi], lo, hi)
    program = [(s, t) for n, s, t in host if n.startswith("program:")]
    named = sorted(((tracing._open_span(host, s), (t - s) * 1e-6)
                    for s, t in gaps), key=lambda g: -g[1])
    return {
        "idle_gaps": named[:10],
        "program_idle_s": sum(t - s for s, t in gaps if any(
            a <= s <= b for a, b in program)) * 1e-6,
        "idle_s": sum(t - s for s, t in gaps) * 1e-6,
        "slice_s": (hi - lo) * 1e-6,
    }


@contextlib.contextmanager
def ranges_only_slice(kept: list):
    """While entered, the profiled slice (``tracing._profiled``) records
    the program's spans as ranges only, in a record of its own, and each
    of its traces' events is appended to ``kept`` (the last is the trace
    with the host's operations)."""
    from crfconv_tpu_torch.utils import profiling

    profiled = tracing._profiled

    def ranges_only(fn, activities, recorder=None):
        with profiling.tracing(events=False):
            got = profiled(fn, activities, recorder)
        kept.append(got["events"])
        return got

    tracing._profiled = ranges_only
    try:
        yield
    finally:
        tracing._profiled = profiled


def spans_line(cell, record, kept: list) -> dict:
    """The line printed after the run's result: the metrics, each span per
    request or step of the window, and the slice's gaps."""
    from types import SimpleNamespace

    kind = cell.loop.KIND
    totals = record.totals(skip=cell.mix[SKIPPED[kind]])
    r = SimpleNamespace(kind=kind, program=totals,
                        program_slice=read_gaps(kept[-1]) if kept else {})
    metrics = {}
    for m in list(METRICS) + ["program_idle"]:
        v = read(r, m)
        if v is not None:
            metrics[f"{m}.{kind}"] = v
    root = totals.get(ROOTS[kind])
    n = root["count"] if root else 0
    spans = {name: {"count": t["count"], **{
        f: (None if t[f] is None else t[f] / n)
        for f in ("event_ms", "host_ms", "self_ms", "launches")}}
        for name, t in totals.items()} if n else {}
    return {"program_metrics": metrics, "units": n, "spans": spans,
            "slice": r.program_slice}


def main(argv=None) -> int:
    from crfconv_tpu_torch.utils import profiling
    from portbench import run

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    args, _ = ap.parse_known_args(argv)
    kept = []
    with profiling.tracing() as record, ranges_only_slice(kept):
        rc = run.main(argv)
    if rc == 0:
        cell = harness.load_cell(args.workload)
        print(json.dumps(spans_line(cell, record, kept)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
