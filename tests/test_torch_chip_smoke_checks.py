"""The profiler check of chip_smoke.py's kernel phases, on fake profiler
rows: a phase fails where the profiler recorded fewer launches of the
kernel's own device functions than the phase made calls. Copies, fills
and PyTorch's kernels do not count; a kernel that launches several
functions a call passes with more. Also the device functions it reads
from each kernel's sources."""

from __future__ import annotations

import sys
from pathlib import Path

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
