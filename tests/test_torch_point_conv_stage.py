"""The rows a K3/K5 block stages (``ops/conv.py::stage_rows``), on the CPU.

The kernel (``csrc/point_conv.cuh``) gives a block ``block_points(h,
passes)`` consecutive output points, clamps their indices into their tiles'
windows (a point past m repeats the last one) and stages the source rows
from the least to the greatest of them; ``stage_rows`` sizes its shared
memory from the windows of the block's first and last tile. Here every
block's clamped indices must span at most ``stage_rows`` rows, same-scale
and at stride 4, at one and two passes, at Semantic3D's and the flagship's
sizes, with a ragged last tile and a cloud smaller than a window; the
bound is reached where indices clamp to both window edges.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crfconv_tpu_torch.ops import conv, windowed


def _block_spans(idx: np.ndarray, n: int, h: int, passes: int) -> int:
    """The most rows a block stages, as the kernel forms them: from the
    least to the greatest of its points' clamped indices
    (window.cuh::window_row; a point past m repeats the last one)."""
    b, m, k = idx.shape
    starts, width, front = windowed.window_starts(m, n)
    lo = (starts[np.arange(m) // windowed.TILE] - front)[None, :, None]
    rows = np.clip(idx, lo, lo + width - 1)
    pb = conv.block_points(h, passes)
    nb = -(-m // pb)
    rows = np.pad(rows, ((0, 0), (0, nb * pb - m), (0, 0)), mode="edge")
    rows = rows.reshape(b, nb, pb * k)
    return int((rows.max(-1) - rows.min(-1) + 1).max())


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("m,n,h", [
    (65536, 65536, 8),      # Semantic3D conv1_1, conv1_2
    (16384, 16384, 16),     # conv2_2
    (4096, 4096, 32),       # conv3_2
    (16384, 65536, 16),     # conv2_1, stride 4
    (4096, 16384, 32),      # conv3_1, stride 4
    (8192, 8192, 8),        # the flagship's conv1
    (1100, 1100, 8), (1100, 1100, 16), (1100, 1100, 32),   # ragged tiles
    (275, 1100, 16), (17, 65, 8),                          # ragged, stride 4
    (100, 100, 8), (100, 100, 32), (25, 100, 16),   # smaller than a window
])
def test_clamped_rows_fit_the_staged_rows(m, n, h, passes):
    rng = np.random.default_rng(m + n + h)
    cap = conv.stage_rows(m, n, h, passes)
    # indices far outside every window: each clamps to its window's edges
    far = rng.integers(-2 * n - 1000, 3 * n + 1000, (1, m, 16))
    assert _block_spans(far, n, h, passes) == cap
    # indices near each point's center, some outside the cloud
    centers = (np.arange(m) * (n / m)).astype(np.int64)[None, :, None]
    near = centers + rng.integers(-300, 300, (2, m, 16))
    assert _block_spans(near, n, h, passes) <= cap


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("m,n,h", [(2000, 2000, 8), (500, 2000, 16),
                                   (500, 2000, 32)])
def test_window_knn_rows_fit_the_staged_rows(m, n, h, passes):
    """The main path's indices (the in-window kNN, same-scale and
    bipartite) lie within the rows their blocks stage."""
    rng = np.random.default_rng(n + h)
    pos = torch.as_tensor(rng.random((1, n, 3), dtype=np.float32))
    pos = torch.take_along_dim(
        pos, windowed.morton_order(pos)[..., None], dim=1)
    query = None if m == n else pos[:, :: n // m].contiguous()
    idx = windowed.window_knn_plain(pos, 16, query).numpy()
    assert _block_spans(idx, n, h, passes) <= conv.stage_rows(m, n, h,
                                                              passes)


def test_block_points_match_the_kernel():
    """256 threads, four columns each, at the padded width 8, 16 or 32,
    once a pass."""
    assert [conv.block_points(h) for h in (1, 8, 9, 16, 17, 32)] == [
        128, 128, 64, 64, 32, 32]
    assert conv.block_points(8, 2) == 256


@pytest.mark.parametrize("h,blocks,passes", [
    (8, 8192, 2),    # Semantic3D's conv1 (B16 x 65536)
    (32, 2048, 2),   # its conv3_1 and conv3_2
    (8, 512, 1),     # the flagship's conv1 (B8 x 8192): one wave
    (16, 1583, 1), (16, 1584, 2),
])
def test_block_passes(h, blocks, passes):
    """Two passes a block where the grid keeps two waves of three blocks
    an SM on 132 SMs, else one."""
    assert conv.block_passes(h, blocks, 132) == passes
