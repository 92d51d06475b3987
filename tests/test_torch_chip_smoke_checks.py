"""The profiler check of chip_smoke.py's kernel phases, on fake profiler
rows: a phase fails where the profiler recorded fewer launches of the
kernel's own device functions than the phase made calls. Copies, fills
and PyTorch's kernels do not count; a kernel that launches several
functions a call passes with more. Also the device functions it reads
from each kernel's sources; and the data phases' checks on the CPU: the
host pyramid's invariants (column 0 self, indices in range, dilation only
where asked), the bit-equality of two batches, the synthetic rooms'
surfaces and the leaky-ReLU backward's launches a ShapeNet exact step; and
the driver phases' checks: a vote result (an empty one fails), sampler
draws compared bit for bit, recorded calls held against the plain version
(bf16 calls widened; a narrow result that is not the float32 one rounded
fails), the instrumented Trainer's launch checks (a run a step short of
its launches fails; an eval batch is checked as it runs) and its val
confusion against the labelled points, and the driver's overhead a step
(resolved only where the spreads part)."""

from __future__ import annotations

import collections
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# K5's phase of two calls, one run: (name, ms, launches a run)
FILL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>>", 0.002, 3.0)
COPY = ("Memcpy DtoD (Device -> Device)", 0.001, 2.0)


@pytest.fixture
def failures():
    chip_smoke.FAILURES.clear()
    yield chip_smoke.FAILURES
    chip_smoke.FAILURES.clear()


@pytest.mark.parametrize("rows,launches,ok", [
    # short: the profiler saw one of two calls; a fill and a copy do not
    # make up for it
    ([("void point_conv_kernel<32>(PcArgs)", 1.0016, 1.0), FILL, COPY],
     1.0, False),
    # exact: one launch a call, at two widths
    ([("void point_conv_kernel<32>(PcArgs)", 0.99, 1.0),
      ("void point_conv_kernel<16>(PcArgs)", 0.85, 1.0), COPY], 2.0, True),
    # more functions than calls (a kernel of several functions a call)
    ([("void point_conv_kernel<16>(PcArgs)", 0.85, 2.0),
      ("void point_conv_kernel<32>(PcArgs)", 0.99, 1.0), FILL], 3.0, True),
])
def test_profiled_launches_check(failures, rows, launches, ok):
    got = chip_smoke.check_profiled_launches(
        "point_conv_fused_strided (semantic3d serve)", rows,
        ("point_conv_kernel",), 2)
    assert got == launches
    assert (not failures) == ok
    if not ok:
        assert "fewer than its 2 calls" in failures[0]


def test_profiled_launches_count_own_functions_only():
    """A reverse step of K11 launches three functions; another kernel's
    function of a similar name does not count."""
    rows = [("void crf_bwd_rows_kernel(float const*)", 0.1, 44.0),
            ("void outer_partials_kernel<8>(float const*)", 0.1, 44.0),
            ("void segment_sum_kernel(float const*)", 0.1, 44.0),
            ("void crf_bwd_rows_kernel_probe(float const*)", 0.1, 9.0),
            FILL]
    functions = chip_smoke.kernel_functions("crf_iterate_bwd")
    assert chip_smoke.profiled_launches(rows, functions) == 132.0


@pytest.mark.parametrize("name,functions", [
    ("point_conv_fused_infer", ("point_conv_kernel",)),
    ("point_conv_fused_strided", ("point_conv_kernel",)),
    ("crf_neighbor_dot", ("crf_neighbor_dot_kernel", "crf_neighbor_dot_sum")),
    ("crf_iterate_bwd", ("crf_bwd_rows_kernel", "outer_partials_kernel",
                         "segment_sum_kernel", "tile_inverse_kernel")),
])
def test_kernel_functions_from_sources(name, functions):
    """The __global__ functions of a kernel's source and its headers."""
    assert chip_smoke.kernel_functions(name) == functions


def test_every_kernel_has_device_functions():
    for name in chip_smoke.REPLACES:
        assert chip_smoke.kernel_functions(name), name


def _shapenet_batch(dilations, n=256):
    from crfconv_tpu_torch.data.pipeline import build_pyramid, make_batch

    rng = np.random.default_rng(0)
    pos = rng.random((2, n, 3), dtype=np.float32)
    scales = build_pyramid(pos, (32, 16, 8, 8, 8), (4, 2, 2, 2, 2), k_up=3,
                           dilations=dilations, rng=rng)
    return make_batch(rng.random((2, n, 6), dtype=np.float32),
                      rng.integers(0, 50, (2, n)), scales,
                      category=np.array([3, 15]), device="cpu")


def _knn(pos, k):
    from crfconv_tpu_torch.ops.knn_host import knn_batch

    return knn_batch(pos, pos, k)


@pytest.mark.parametrize("dilations", [(1, 2, 4, 2, 1), (1, 1, 1, 1, 1)])
def test_pyramid_checks_pass(failures, dilations):
    out = chip_smoke.pyramid_checks(_shapenet_batch(dilations).scales,
                                    (32, 16, 8, 8, 8), dilations, _knn)
    assert not failures
    assert out["self_share"] == 1.0 and out["in_range"]
    assert [s > 0 for s in out["outside_knn"]] == [d > 1 for d in dilations]


@pytest.mark.parametrize("fault", ["self", "range", "undilated", "dilated"])
def test_pyramid_checks_fail(failures, fault):
    """A pyramid that breaks one invariant fails its check: column 0 not
    self, an index past its scale, a scale that should be dilated and is
    not, a scale dilated where it should not be."""
    dil = (1, 2, 4, 2, 1)
    batch = _shapenet_batch((1, 1, 4, 2, 1) if fault == "undilated" else dil)
    scales = list(batch.scales)
    s0 = scales[0]
    if fault == "self":
        nbr = s0.neighbor_idx.clone()
        nbr[1, 7, 0] = nbr[1, 7, 1]
        scales[0] = s0._replace(neighbor_idx=nbr)
    if fault == "range":
        up = s0.up_idx.clone()
        up[0, 3, 2] = s0.sub_idx.shape[1]
        scales[0] = s0._replace(up_idx=up)
    expect_dil = (1, 2, 4, 2, 2) if fault == "dilated" else dil
    chip_smoke.pyramid_checks(scales, (32, 16, 8, 8, 8), expect_dil, _knn)
    assert len(failures) == 1, failures
    assert {"self": "column 0", "range": "outside its scale",
            "undilated": "scale 1", "dilated": "scale 4"}[fault] in failures[0]


def test_batches_equal():
    a, b = _shapenet_batch(None), _shapenet_batch(None)
    assert chip_smoke.batches_equal(a, b)
    nbr = b.scales[2].neighbor_idx.clone()
    nbr[0, 0, 1] += 1
    scales = list(b.scales)
    scales[2] = scales[2]._replace(neighbor_idx=nbr)
    assert not chip_smoke.batches_equal(a, b._replace(scales=tuple(scales)))
    assert not chip_smoke.batches_equal(a, b._replace(x=b.x.double()))


def test_box_surface():
    rng = np.random.default_rng(1)
    p, face = chip_smoke.box_surface(rng, (0, 0, 0), (6.0, 5.0, 3.0), 60000)
    lo, hi = np.zeros(3), np.array([6.0, 5.0, 3.0])
    on = np.isclose(p, lo) | np.isclose(p, hi)
    assert on.any(axis=1).all()
    assert np.allclose(p[face == 4, 2], 0) and np.allclose(p[face == 5, 2], 3)
    # faces drawn by area: the floor holds 30 of the 126 square metres
    assert abs((face == 4).mean() - 30 / 126) < 0.01


@contextlib.contextmanager
def card_dispatch(calls: collections.Counter):
    """The CPU taking the card's path through the batch norms (K16's
    dispatch with CUDA tensors: the wrappers then run their plain
    versions), counting each K15 and K16 wrapper's calls in ``calls``."""
    from crfconv_tpu_torch.ops import activation, batch_norm

    def counted(name, fn):
        return lambda *a: calls.update([name]) or fn(*a)

    reason = batch_norm.fallback_reason
    mp = pytest.MonkeyPatch()
    mp.setattr(batch_norm, "fallback_reason",
               lambda *a: None if reason(*a) == "cpu" else reason(*a))
    for module, name in ((activation, "leaky_relu_bwd"),
                         (batch_norm, "batch_norm_stats"),
                         (batch_norm, "batch_norm_apply"),
                         (batch_norm, "batch_norm_bwd")):
        mp.setattr(module, name, counted(name, getattr(module, name)))
    try:
        yield
    finally:
        mp.undo()


def test_shapenet_exact_launches_counted_on_the_cpu():
    """SHAPENET_EXACT_PER_STEP: the K15 and K16 calls of one exact-regime
    CRFSegNet_Part train step on the host pyramid (a CPU step under the
    card's dispatch; the wrapper counts a launch on the card where it is
    called)."""
    from crfconv_tpu_torch import (
        CRFSegNet_Part, NeighborMode, TrainState, make_train_step,
    )

    model = CRFSegNet_Part(50, 6, steps=10, device="cpu")
    calls = collections.Counter()
    with card_dispatch(calls):
        make_train_step(NeighborMode("exact"), windowed=False)(
            TrainState.create(model, lr=0.01), _shapenet_batch(
                (1, 2, 4, 2, 1)))
    assert chip_smoke.SHAPENET_EXACT_PER_STEP == dict(calls)


@pytest.mark.parametrize("path", ["flagship", "scannet", "discrete"])
def test_step_launches_counted_on_the_cpu(path):
    """The K15 and K16 launches of a train step and of an eval forward in
    chip_smoke's tables (EXPECTED_PER_STEP, SCANNET_PER_STEP,
    DISCRETE_PER_STEP and the exact regime's requests): the calls of a
    small CPU step and forward of each model under the card's dispatch.
    The eval forward's batch norms are all the model's; on the card each
    K3 or K5 call folds two of the flagship's."""
    import torch

    from crfconv_tpu_torch import (
        BaselineDiscreteCRFSegNet, CRFSegNet, PointConvResNet, RawBatch,
        TrainState, make_train_step,
    )
    from crfconv_tpu_torch.train.train_state import (
        TRAIN_MODE, build_windowed_batch,
    )

    gen = torch.Generator().manual_seed(0)
    model, step_table, eval_table = {
        "flagship": (lambda: PointConvResNet(13, 6, use_crf=True, steps=1,
                                             device="cpu", generator=gen),
                     chip_smoke.EXPECTED_PER_STEP,
                     chip_smoke.EXACT_PER_REQUEST),
        "scannet": (lambda: CRFSegNet(20, 6, steps=2, device="cpu",
                                      generator=gen),
                    chip_smoke.SCANNET_PER_STEP,
                    chip_smoke.SCANNET_EXACT_PER_REQUEST),
        "discrete": (lambda: BaselineDiscreteCRFSegNet(
            20, 6, steps=2, device="cpu", generator=gen),
            chip_smoke.DISCRETE_PER_STEP,
            chip_smoke.DISCRETE_EXACT_PER_REQUEST),
    }[path]
    model = model()
    rng = np.random.default_rng(0)
    raw = RawBatch(pos=torch.as_tensor(rng.random((2, 1024, 3),
                                                  dtype=np.float32)),
                   x=torch.as_tensor(rng.random((2, 1024, 6),
                                                dtype=np.float32)),
                   y=torch.as_tensor(rng.integers(0, 13, (2, 1024))))
    names = ("leaky_relu_bwd", "batch_norm_stats", "batch_norm_apply",
             "batch_norm_bwd")
    calls = collections.Counter()
    with card_dispatch(calls):
        make_train_step(TRAIN_MODE)(TrainState.create(model, lr=0.01), raw,
                                    torch.Generator().manual_seed(1))
    assert dict(calls) == {k: step_table[k] for k in names}
    calls.clear()
    batch = build_windowed_batch(raw, torch.Generator().manual_seed(2),
                                 mode=TRAIN_MODE)
    model.eval()
    with card_dispatch(calls), torch.no_grad():
        model(batch, TRAIN_MODE)
    assert dict(calls) == {"batch_norm_apply":
                           eval_table["batch_norm_apply"]}


@pytest.mark.parametrize("res,ok", [
    ({"sub_mIoU": 0.2, "full_mIoU": 0.3, "Overall Acc": 0.9,
      "full_IoUs": [0.3]}, True),
    ({}, False),                                     # no coverage: empty
    ({"sub_mIoU": 0.2, "full_mIoU": 0.3}, False),    # no accuracy
    ({"sub_mIoU": 1.2, "full_mIoU": 0.3, "Overall Acc": 0.9}, False),
    ({"sub_mIoU": float("nan"), "full_mIoU": 0.3, "Overall Acc": 0.9},
     False),
])
def test_vote_result_ok(res, ok):
    assert chip_smoke.vote_result_ok(res) == ok


def test_samples_equal():
    a = [{"pos": np.arange(6.0).reshape(2, 3), "point_idx": np.arange(2)}]
    b = [{k: v.copy() for k, v in a[0].items()}]
    assert chip_smoke.samples_equal(a, b)
    b[0]["point_idx"][1] = 7
    assert not chip_smoke.samples_equal(a, b)
    assert not chip_smoke.samples_equal(a, a + a)


def _leaky_calls(dtype):
    import torch

    g = torch.Generator().manual_seed(0)
    x = (torch.rand((4, 64, 8), generator=g) - 0.5).to(dtype)
    dy = torch.rand((4, 64, 8), generator=g).to(dtype)
    return {"leaky_relu_bwd": [((x, dy, 0.1), {})]}


@pytest.fixture
def no_sync(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


@pytest.mark.parametrize("narrow", [False, True])
def test_hold_calls(failures, no_sync, narrow):
    """Recorded calls held against the plain version: float32 calls as
    recorded, bf16 ones widened, their narrow result the float32 one
    rounded."""
    import torch

    from crfconv_tpu_torch.ops import activation

    sites = {"leaky_relu_bwd": (activation, "leaky_relu_bwd",
                                activation.leaky_relu_bwd,
                                activation.leaky_relu_bwd_plain)}
    path = f"hold test {narrow}"
    chip_smoke.hold_calls(path, sites, _leaky_calls(
        torch.bfloat16 if narrow else torch.float32))
    assert not failures
    held = chip_smoke.HELD["leaky_relu_bwd"].pop(path)
    assert held["calls"] == 1 and held["narrow_calls"] == int(narrow)


def test_hold_calls_fail(failures, no_sync):
    """A kernel whose bf16 result is not its float32 result rounded, and
    one that disagrees with the plain version, fail."""
    import torch

    from crfconv_tpu_torch.ops import activation

    def off_when_narrow(x, g, slope):
        out = activation.leaky_relu_bwd_plain(x, g, slope)
        return out + 1 if out.dtype == torch.bfloat16 else out

    sites = {"leaky_relu_bwd": (activation, "leaky_relu_bwd",
                                off_when_narrow,
                                activation.leaky_relu_bwd_plain)}
    chip_smoke.hold_calls("hold fail", sites, _leaky_calls(torch.bfloat16))
    assert len(failures) == 1 and "not its float32 result rounded" in \
        failures[0]
    failures.clear()
    sites["leaky_relu_bwd"] = (activation, "leaky_relu_bwd",
                               lambda x, g, s: g,
                               activation.leaky_relu_bwd_plain)
    chip_smoke.hold_calls("hold fail", sites, _leaky_calls(torch.float32))
    assert failures and "not bit-equal" in failures[0]
    chip_smoke.HELD["leaky_relu_bwd"].pop("hold fail")


class _Event:
    """torch.cuda.Event's timing on the host clock, for the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def host_events(monkeypatch, no_sync):
    import torch

    monkeypatch.setattr(torch.cuda, "Event", _Event)


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    from tests.test_data import _make_s3dis_raw

    root = str(tmp_path_factory.mktemp("s3dis"))
    _make_s3dis_raw(root, n_rooms=2, n_pts=600)
    return root


def _probed(rooms, tmp_path, eval_launches):
    from crfconv_tpu_torch.train.config import S3DISConfig

    cls = chip_smoke.probed_trainer(
        "probe test", chip_smoke.train_call_sites(), chip_smoke.call_sites(),
        eval_launches)
    cfg = S3DISConfig(root=rooms, grid_size=0.2, sample_num=256,
                      batch_size=2, epochs=1, train_samples_per_epoch=4,
                      val_samples_per_epoch=2, layers=(8, 16, 32, 64, 128),
                      checkpoint_dir=str(tmp_path))
    tr = cls(cfg, device="cpu")
    assert cls.made == [tr]
    return tr


def test_probed_trainer_step_launches(failures, host_events, rooms, tmp_path,
                                      monkeypatch):
    """The instrumented Trainer's launch checks: on the CPU a wrapper counts
    no launch. A step (here under the card's dispatch) reads no counts (its
    timed window holds the step alone): the run's counts are checked after
    it, and a run a step short of K15's 10 launches fails. An eval batch expected to launch fails as
    it runs; expecting none passes. The first step's kernel calls are
    recorded, an epoch over placed batches gives one event ms a step, and
    a val epoch's confusion sums to the labelled points of its batches."""
    from crfconv_tpu_torch import cuda_build

    monkeypatch.setattr(chip_smoke, "LAUNCHES",
                        {k: {} for k in chip_smoke.REPLACES})
    monkeypatch.setattr(chip_smoke, "UNITS", {})
    tr = _probed(rooms, tmp_path, chip_smoke.TWO_VIEW_PER_EVAL)
    batch = next(iter(tr.train_loader))
    cuda_build.reset_launch_counts()
    with card_dispatch(collections.Counter()):
        tr._train_step(tr.state, batch, tr.rng)
    assert not failures
    assert len(tr.probe["calls"]["step"]["leaky_relu_bwd"]) == 10
    chip_smoke.record_launches("probe test", cuda_build.launch_counts(),
                               chip_smoke.S3DIS_LOADER_PER_STEP, 1, "steps")
    assert any("0 launches of leaky_relu_bwd in 1 steps, expected 10" in f
               for f in failures)
    failures.clear()
    tr._eval_batch(batch)
    assert len(failures) == 1 and "an eval batch launched" in failures[0]
    failures.clear()

    tr = _probed(rooms, tmp_path, {})
    tr.train_one_epoch(0)
    tr.val_one_epoch(0)
    assert not failures
    assert len(tr.probe["losses"]) == 2 and len(tr.probe["epoch_ms"]) == 1
    assert tr.probe["val_labelled"] == tr.probe["val_confusion"] == [
        2 * 256.0]
    chip_smoke.trainer_checks("probe test", tr, {
        k: len(v) for k, v in tr.probe["calls"]["step"].items()}, {
        k: len(v) for k, v in tr.probe["calls"]["eval"].items()})
    # no checkpoint was written: the last check fails alone
    assert len(failures) == 1 and "latest" in failures[0]
    # an epoch over batches placed beforehand: one event ms a step
    loader = tr.train_loader
    tr.train_loader = [batch, batch, batch]
    tr.train_one_epoch(1)
    tr.train_loader = loader
    assert len(chip_smoke.step_event_ms(tr.probe, 1)) == 3


@pytest.mark.parametrize("trainer,plain,resolved", [
    # the medians part by 5 ms, and so do the interquartile ranges
    ([160.0, 160.5, 161.0, 159.5, 160.2], [154.0, 155.0, 154.5, 155.2], True),
    # the same 5 ms between the medians, inside a spread of +-20 ms
    ([140.0, 160.0, 180.0, 150.0, 170.0], [135.0, 155.0, 175.0, 165.0],
     False),
])
def test_step_overhead(trainer, plain, resolved):
    """The driver's overhead a step: the difference of the medians, called
    resolved only where the two sides' interquartile ranges part."""
    got = chip_smoke.step_overhead(trainer, plain)
    assert got["overhead_ms"] == pytest.approx(
        np.median(trainer) - np.median(plain))
    assert got["resolved"] is resolved
    assert got["trainer"]["n"] == len(trainer)
    assert (got["plain"]["min"], got["plain"]["max"]) == (min(plain),
                                                          max(plain))
