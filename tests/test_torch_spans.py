"""The port's spans (``utils/profiling.py``) on the CPU: off, a span makes
no CUDA event and no profiler range; on, a ``Predictor`` request and a
train step give the same bits as off and record each layer's span under
its request or step, with self times and counts that add up; the spans'
ranges reach ``torch.profiler`` and ``profiling.trace``'s file; the port's
kernel launches are counted inside the span that made them."""

from __future__ import annotations

import copy
import glob

import numpy as np
import pytest
import torch

from crfconv_tpu_torch import PointConvResNet, Predictor, RawBatch, cuda_build
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.train.train_state import TrainState, make_train_step
from crfconv_tpu_torch.utils import profiling
from tests.test_torch_ops import few_torch_threads  # noqa: F401

N = 1024
MODE = NeighborMode("windowed", knn_exact=False)
SERVE = {"serve.copy_in", "pyramid", "forward", "serve.restore"}
STEP = {"pyramid", "forward", "train.loss", "train.backward",
        "train.optimizer", "train.metrics"}


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(5)
    return (rng.random((1, N, 3)).astype(np.float32),
            rng.random((1, N, 4)).astype(np.float32),
            rng.integers(0, 5, (1, N)))


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return PointConvResNet(5, 4, layers=(8, 16, 32, 64, 128), device="cpu")


def _request(model, cloud):
    pos, feats, _ = cloud
    return Predictor(model, MODE, device="cpu").predict_logits(pos, feats)


def _step(model, cloud):
    """One train step on a copy of ``model``: its outputs and parameters."""
    pos, feats, y = cloud
    state = TrainState.create(copy.deepcopy(model), lr=0.01)
    raw = RawBatch(pos=torch.as_tensor(pos), x=torch.as_tensor(feats),
                   y=torch.as_tensor(y))
    out = make_train_step(MODE)(state, raw, torch.Generator().manual_seed(3))
    return out, [p.detach() for p in state.model.parameters()]


def _tree(rec, root_name):
    """{root id: the names of that root's children} after checking that
    every span lies under its root's id."""
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == [root_name] * len(roots)
    for s in rec.spans:
        if s.parent is not None:
            assert s.root == s.parent.root and s.parent.t1_ns
    return {r.root: {c.name for c in r.children} for r in roots}


def test_off_a_span_makes_no_event_and_no_range(monkeypatch, model, cloud):
    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling._RECORD is None
    assert profiling.span("forward") is profiling.span("pyramid")
    _request(model, cloud)
    _step(model, cloud)


def test_outputs_are_the_same_bits_with_tracing_on(model, cloud):
    off = _request(model, cloud)
    off_step, off_params = _step(model, cloud)
    with profiling.tracing() as rec:
        on = _request(model, cloud)
        on_step, on_params = _step(model, cloud)
    assert rec.spans
    assert torch.equal(off, on)
    for k in ("loss", "confusion"):
        assert torch.equal(off_step[k], on_step[k]), k
    for a, b in zip(off_params, on_params):
        assert torch.equal(a, b)


def test_a_request_and_a_step_nest_their_layers(model, cloud):
    with profiling.tracing() as rec:
        for _ in range(2):
            _request(model, cloud)
    assert _tree(rec, "serve.request") == {0: SERVE, 1: SERVE}
    with profiling.tracing() as rec:
        _step(model, cloud)
    assert _tree(rec, "train.step") == {0: STEP}


def test_totals_count_the_calls_and_self_time_is_not_negative(model, cloud):
    with profiling.tracing() as rec:
        for _ in range(3):
            _request(model, cloud)
    tot = rec.totals()
    assert set(tot) == SERVE | {"serve.request"}
    for name, t in tot.items():
        assert t["count"] == 3, name
        assert t["event_ms"] is None     # no CUDA device here
        assert 0 <= t["self_ms"] <= t["host_ms"], name
    req = tot["serve.request"]
    inside = sum(tot[n]["host_ms"] for n in SERVE)
    assert req["self_ms"] == pytest.approx(req["host_ms"] - inside)
    assert set(rec.totals(skip=2)) == set(tot)
    assert rec.totals(skip=2)["pyramid"]["count"] == 1
    assert all(s.self_ms() >= 0 for s in rec.spans)


def test_launches_are_counted_in_the_open_span():
    k = cuda_build.Kernel("probe", "probe.cu", "probe", [])
    with profiling.tracing() as rec:
        k._count(0, "probe")
        with profiling.span("outer"):
            k._count(0, "probe")
            k._count(cuda_build.NOTHING_LAUNCHED, "probe")
            with profiling.span("inner"):
                k._count(0, "probe")
    tot = rec.totals()
    assert (tot["outer"]["launches"], tot["inner"]["launches"]) == (2, 1)
    assert k.launches == 3


def test_spans_are_ranges_under_the_profiler(model, cloud, tmp_path):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with profiling.tracing(events=False) as rec:
            _request(model, cloud)
    names = {e.name for e in prof.events()}
    want = {profiling.PREFIX + n for n in SERVE | {"serve.request"}}
    assert want <= names and not rec.events
    with profiling.trace(str(tmp_path)):
        _request(model, cloud)
    assert profiling._RECORD is None
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    text = open(path).read()
    assert all(f'"{n}"' in text for n in want)


def test_a_region_inside_another_records_apart():
    with profiling.tracing() as outer:
        with profiling.span("a"):
            with profiling.tracing(events=False) as inner:
                with profiling.span("b"):
                    pass
        with profiling.span("c"):
            pass
    assert [s.name for s in outer.spans] == ["a", "c"]
    assert [(s.name, s.parent) for s in inner.spans] == [("b", None)]
    assert [s.root for s in outer.spans] == [0, 1]
