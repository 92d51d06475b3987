"""``program_spans.py``: the readers of the program's spans, with and
without a program record; the slice's gaps named by the innermost range,
the benchmark's names unchanged where the program has no ranges, and the
idle that began inside a program span, on hand-made timelines; and a CPU
pass of the serving loop whose profiled slice records the program's
ranges only."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import harness, program_spans, tracing


def _totals(**spans):
    return {name: {"count": c, "event_ms": ms, "host_ms": ms or 0.0,
                   "self_ms": 0.0, "launches": la}
            for name, (c, ms, la) in spans.items()}


def test_readers_find_nothing_without_a_program_record():
    bare = SimpleNamespace(kind="serve")
    for r in (bare, SimpleNamespace(kind="train", program={}),
              SimpleNamespace(kind="serve", program=None,
                              program_slice={})):
        for m in list(program_spans.METRICS) + ["program_idle"]:
            assert program_spans.read(r, m) is None, m
    # spans without CUDA events (a CPU run) give no milliseconds
    cpu = SimpleNamespace(kind="serve", program=_totals(
        **{"serve.request": (2, None, 10), "forward": (2, None, 4)}))
    assert program_spans.read(cpu, "forward_span_ms") is None
    assert program_spans.read(cpu, "csrc_launches") == 5


def test_readers_divide_by_the_requests_or_steps():
    serve = SimpleNamespace(kind="serve", program=_totals(**{
        "serve.request": (4, 140.0, 3276), "serve.copy_in": (4, 26.0, 0),
        "pyramid": (4, 22.0, 84), "forward": (4, 82.0, 3192)}))
    want = {"copy_in_ms": 6.5, "pyramid_span_ms": 5.5,
            "forward_span_ms": 20.5, "csrc_launches": 819.0,
            "backward_ms": None, "optimizer_ms": None}
    for m, v in want.items():
        assert program_spans.read(serve, m) == v, m
    train = SimpleNamespace(kind="train", program=_totals(**{
        "train.step": (2, 494.0, 300), "train.backward": (2, 320.0, 200),
        "train.optimizer": (2, 4.0, 0), "pyramid": (2, 11.0, 60)}))
    assert program_spans.read(train, "backward_ms") == 160.0
    assert program_spans.read(train, "optimizer_ms") == 2.0
    assert program_spans.read(train, "pyramid_span_ms") == 5.5
    assert program_spans.read(train, "copy_in_ms") is None
    sl = SimpleNamespace(kind="train", program_slice={
        "program_idle_s": 0.01, "slice_s": 0.5})
    assert program_spans.read(sl, "program_idle") == pytest.approx(2.0)


def _ev(name, s, t, dev=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=s, end=t),
                           is_user_annotation=False)


def _timeline(program: bool):
    """A slice of 100 µs: a benchmark request 0-90 holding ``prepare``
    10-40; device work 0-10, 20-30, 50-60 and 95-100. With ``program``,
    the program's request 5-85, its pyramid 15-42 and restore 60-80."""
    ev = [_ev("portbench.slice", 0, 100), _ev("portbench.request", 0, 90),
          _ev("portbench.prepare", 10, 40), _ev("aten::mm", 0, 100)]
    ev += [_ev(f"k{i}", s, t, DeviceType.CUDA)
           for i, (s, t) in enumerate([(0, 10), (20, 30), (50, 60),
                                       (95, 100)])]
    if program:
        ev += [_ev("crfconv_tpu_torch.serve.request", 5, 85),
               _ev("crfconv_tpu_torch.pyramid", 15, 42),
               _ev("crfconv_tpu_torch.serve.restore", 60, 80)]
    return ev


def test_without_program_ranges_the_gaps_keep_the_benchmarks_names():
    events = _timeline(program=False)
    rec = SimpleNamespace(bound_ms=0.0, calls=0)
    got = program_spans.read_gaps(events)
    assert got["idle_gaps"] == tracing.read_host(events, rec)["idle_gaps"]
    assert [n for n, _ in got["idle_gaps"]] == ["request", "prepare",
                                                "prepare"]
    assert got["program_idle_s"] == 0.0


def test_a_gap_is_named_by_the_innermost_program_range():
    got = program_spans.read_gaps(_timeline(program=True))
    # gaps 30-50 (in pyramid), 60-95 (in restore), 10-20 (in prepare:
    # shorter than the program's request, which also holds it)
    assert [n for n, _ in got["idle_gaps"]] == [
        "program:serve.restore", "program:pyramid", "prepare"]
    assert [s for _, s in got["idle_gaps"]] == pytest.approx(
        [35e-6, 20e-6, 10e-6])
    # every gap began inside the program's request (5-85)
    assert got["program_idle_s"] == pytest.approx(65e-6)
    assert got["idle_s"] == pytest.approx(65e-6)
    assert got["slice_s"] == pytest.approx(100e-6)


def test_idle_outside_the_program_is_not_the_programs():
    ev = _timeline(program=True)
    ev = [e for e in ev if e.name != "crfconv_tpu_torch.serve.request"]
    got = program_spans.read_gaps(ev)
    # 10-20 began in no program range; 30-50 and 60-95 did
    assert got["program_idle_s"] == pytest.approx(55e-6)
    assert program_spans.read_gaps(ev[:3]) == {}     # no device operation


def test_a_cpu_pass_records_the_window_and_a_ranges_only_slice():
    from crfconv_tpu_torch.utils import profiling

    torch.set_num_threads(2)
    kept = []
    small = {"batch_size": 1, "sample_num": 1024}
    few = {"pool": 2, "rooms": 2, "checked_requests": 1,
           "warmup_requests": 1, "profiled_requests": 1}
    with profiling.tracing() as record, \
            program_spans.ranges_only_slice(kept):
        cell, out = harness.measure("semantic3d.serve", 2**31 + 5, 0.05,
                                    True, "cpu", overrides=small,
                                    mix_overrides=few)
    assert tracing._profiled.__name__ == "_profiled"
    assert len(kept) == 2     # the device-only trace, the host's
    names = {e.name for e in kept[-1]}
    assert "crfconv_tpu_torch.serve.request" in names
    assert "crfconv_tpu_torch.pyramid" in names
    line = program_spans.spans_line(cell, record, kept)
    # the window's requests only: the warm-up and the slice's are not in it
    assert line["units"] == out["attempted"] >= 1
    assert line["spans"]["pyramid"]["count"] == out["attempted"]
    assert line["program_metrics"] == {"csrc_launches.serve": 0.0}
    assert line["slice"] == {}      # no device operation on the CPU
