"""The profiler check of chip_smoke.py's kernel phases, on fake profiler
rows: a phase fails where the profiler recorded fewer launches of the
kernel's own device functions than the phase made calls. Copies, fills
and PyTorch's kernels do not count; a kernel that launches several
functions a call passes with more. Also the device functions it reads
from each kernel's sources; and the data phases' checks on the CPU: the
host pyramid's invariants (column 0 self, indices in range, dilation only
where asked), the bit-equality of two batches, the synthetic rooms'
surfaces and the leaky-ReLU backward's launches a ShapeNet exact step."""

from __future__ import annotations

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


def test_shapenet_exact_launches_counted_on_the_cpu():
    """SHAPENET_EXACT_PER_STEP: the leaky ReLU's backward calls of one
    exact-regime CRFSegNet_Part train step on the host pyramid (a CPU
    step; the wrapper counts a launch on the card where it is called)."""
    from crfconv_tpu_torch import (
        CRFSegNet_Part, NeighborMode, TrainState, make_train_step,
    )
    from crfconv_tpu_torch.ops import activation

    model = CRFSegNet_Part(50, 6, steps=10, device="cpu")
    calls = []
    bwd = activation.leaky_relu_bwd
    mp = pytest.MonkeyPatch()
    mp.setattr(activation, "leaky_relu_bwd",
               lambda *a: calls.append(1) or bwd(*a))
    try:
        make_train_step(NeighborMode("exact"), windowed=False)(
            TrainState.create(model, lr=0.01), _shapenet_batch(
                (1, 2, 4, 2, 1)))
    finally:
        mp.undo()
    assert chip_smoke.SHAPENET_EXACT_PER_STEP == {"leaky_relu_bwd":
                                                  len(calls)}
