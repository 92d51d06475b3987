"""The window geometry the kernel wrappers share
(``ops/windowed.py::_geometry``): cached per (m_out, n_src, tile, pad,
device), so only a shape's first call builds the starts and copies them to
the device. On the CPU; a second device is the meta device."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crfconv_tpu_torch.ops import windowed


@pytest.mark.parametrize("m,n,tile,pad", [
    (8192, 8192, 64, 128),      # the flagship's finest scale
    (16384, 65536, 64, 128),    # a strided Semantic3D call
    (1100, 1100, 64, 128),      # ragged last tile
    (100, 400, 32, 600),        # another tile and pad
])
def test_geometry_is_cached_and_equals_window_starts(m, n, tile, pad):
    cpu = torch.device("cpu")
    first = windowed._geometry(m, n, tile, pad, cpu)
    again = windowed._geometry(m, n, tile, pad, torch.device("cpu"))
    assert again[0] is first[0]
    starts, width, front = windowed.window_starts(m, n, tile, pad)
    assert first[0].dtype == torch.int32 and first[0].device == cpu
    np.testing.assert_array_equal(first[0].numpy(), starts)
    assert first[1:] == (width, front)


def test_geometry_entries_per_shape_and_device():
    cpu, meta = torch.device("cpu"), torch.device("meta")
    base = windowed._geometry(4096, 4096, 64, 128, cpu)
    for other in [(4096, 16384, 64, 128), (2048, 4096, 64, 128),
                  (4096, 4096, 32, 128), (4096, 4096, 64, 256)]:
        got = windowed._geometry(*other, cpu)
        assert got[0] is not base[0]
        starts, width, front = windowed.window_starts(*other)
        np.testing.assert_array_equal(got[0].numpy(), starts)
        assert got[1:] == (width, front)
    on_meta = windowed._geometry(4096, 4096, 64, 128, meta)
    assert on_meta[0] is not base[0] and on_meta[0].device == meta
    assert on_meta[0].shape == base[0].shape and on_meta[1:] == base[1:]
    assert windowed._geometry(4096, 4096, 64, 128, meta)[0] is on_meta[0]
    assert windowed._geometry(4096, 4096, 64, 128, cpu)[0] is base[0]
