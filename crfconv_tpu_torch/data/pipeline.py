"""Multiscale index-pyramid construction: the host pyramid of the input
pipeline and the exact regime's device pyramid.

Counterpart of ``crfconv_tpu/data/pipeline.py``. For each of
``num_scales`` levels: a self-inclusive kNN ``neighbor_idx [B, N, K]``,
the points subsampled by ``ratio`` (random, one choice shared across the
batch, or farthest-point), ``sub_idx`` (the chosen rows of neighbor_idx)
and the ``k_up`` nearest chosen points of every point (``up_idx``), then
the same on the subsampled positions. Two functions build it:

  * :func:`build_pyramid`: numpy on the host, the kNN by ``ops/knn_host``
    (the native KD-tree or scipy), optionally dilated; it feeds the
    loader (``data/loader.py``), and :func:`make_batch` places its arrays
    on the device.
  * :func:`build_pyramid_device`: on the device, the exact kNN by
    ``knn_bruteforce`` (kernel K6 selecting). Points keep their input
    order (no Morton sort), so the exact regime gathers with plain index
    gathers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import PointBatch, ScaleData
from crfconv_tpu_torch.ops import knn_host
from crfconv_tpu_torch.ops.neighbors import knn_bruteforce

# Pyramid constants of the flagship ("big") path
BIG_KERNEL_SIZES = (16, 16, 16, 16, 16)
BIG_RATIOS = (4, 4, 4, 4, 2)


# --------------------------------------------------------------------------
# the host pyramid
# --------------------------------------------------------------------------


def knn_search(support: np.ndarray, query: np.ndarray, k: int,
               backend: str = "native") -> np.ndarray:
    """Batched exact kNN on the host -> int32 ``[B, M, k]``
    (``ops/knn_host.knn_batch``)."""
    return knn_host.knn_batch(support, query, k, backend)


def _fps_indices(pos: np.ndarray, n_samples: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Farthest-point sampling of one cloud ``[N, 3]`` -> ``[n_samples]``,
    starting from a point drawn from ``rng``."""
    n = pos.shape[0]
    sel = np.empty(n_samples, dtype=np.int64)
    sel[0] = rng.integers(n)
    d = np.sum((pos - pos[sel[0]]) ** 2, axis=1)
    for i in range(1, n_samples):
        sel[i] = int(np.argmax(d))
        nd = np.sum((pos - pos[sel[i]]) ** 2, axis=1)
        np.minimum(d, nd, out=d)
    return sel


def _dilate(neighbor_idx: np.ndarray, k: int, dilation: int,
            rng: np.random.Generator) -> np.ndarray:
    """k of the k * dilation nearest: column 0 (the point itself) kept,
    the other k - 1 columns drawn from ``rng`` among all k * dilation."""
    if dilation <= 1:
        return neighbor_idx[..., :k]
    B, N, KD = neighbor_idx.shape
    cols = rng.integers(0, KD, size=(B, N, k - 1))
    picked = np.take_along_axis(neighbor_idx, cols, axis=2)
    return np.concatenate([neighbor_idx[..., :1], picked], axis=2)


def build_pyramid(
    pos: np.ndarray,
    kernel_sizes: Sequence[int] = BIG_KERNEL_SIZES,
    ratios: Sequence[int] = BIG_RATIOS,
    *,
    k_up: int = 1,
    dilations: Optional[Sequence[int]] = None,
    method: str = "random",
    rng: Optional[np.random.Generator] = None,
    backend: str = "native",
) -> Tuple[ScaleData, ...]:
    """pos [B, N, 3] -> the multiscale pyramid on the host (numpy arrays,
    indices int32).

    ``dilations`` gives each scale's kNN dilation (k of the k * d
    nearest, :func:`_dilate`); ``method`` is ``"random"`` or ``"fps"``;
    ``rng`` draws the subsampling and the dilation; ``backend`` names the
    kNN's (``ops/knn_host``).
    """
    if rng is None:
        rng = np.random.default_rng()
    if method not in ("random", "fps"):
        raise ValueError(f"unknown subsampling method {method!r}")
    num_scales = len(kernel_sizes)
    dilations = dilations or [1] * num_scales
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    scales = []
    for s in range(num_scales):
        k, dil = kernel_sizes[s], dilations[s]
        neighbor_idx = knn_search(pos, pos, min(k * dil, pos.shape[1]),
                                  backend)
        neighbor_idx = _dilate(neighbor_idx, k, dil, rng)
        sample_num = max(pos.shape[1] // ratios[s], 1)
        if method == "random":
            # one permutation shared across the batch
            choice = rng.permutation(pos.shape[1])[:sample_num]
            sub_pos = pos[:, choice]
            sub_idx = neighbor_idx[:, choice]
        else:
            sub_pos = np.empty((pos.shape[0], sample_num, 3), np.float32)
            sub_idx = np.empty(
                (pos.shape[0], sample_num, neighbor_idx.shape[2]), np.int32
            )
            for b in range(pos.shape[0]):
                c = _fps_indices(pos[b], sample_num, rng)
                sub_pos[b] = pos[b, c]
                sub_idx[b] = neighbor_idx[b, c]
        up_idx = knn_search(sub_pos, pos, k_up, backend)
        scales.append(ScaleData(
            pos=pos,
            neighbor_idx=neighbor_idx.astype(np.int32),
            sub_idx=sub_idx.astype(np.int32),
            up_idx=up_idx.astype(np.int32),
        ))
        pos = sub_pos
    return tuple(scales)


def to_device(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, converted to ``dtype`` there.
    To a CUDA device it is copied from pinned host memory without blocking
    the host, on the current stream; on the CPU it shares the array's
    memory where no conversion is asked for."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    elif device.type != "cpu":
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def make_batch(
    x: np.ndarray,
    y: Optional[np.ndarray],
    scales: Tuple[ScaleData, ...],
    point_idx: Optional[np.ndarray] = None,
    cloud_idx: Optional[np.ndarray] = None,
    category: Optional[np.ndarray] = None,
    device="cuda",
) -> PointBatch:
    """A host pyramid and its features as a :class:`PointBatch` on
    ``device``: features and positions float32; labels, ids and the
    pyramid's indices int64 (converted on the device after an int32 copy,
    so that no gather in the step converts them)."""

    def put(a, dtype):
        return None if a is None else to_device(a, device, dtype)

    return PointBatch(
        x=put(x, torch.float32),
        y=put(y, torch.int64),
        scales=tuple(
            ScaleData(
                pos=put(s.pos, torch.float32),
                neighbor_idx=put(s.neighbor_idx, torch.int64),
                sub_idx=put(s.sub_idx, torch.int64),
                up_idx=put(s.up_idx, torch.int64),
            )
            for s in scales
        ),
        point_idx=put(point_idx, torch.int64),
        cloud_idx=put(cloud_idx, torch.int64),
        category=put(category, torch.int64),
    )


def synthetic_batch(
    batch_size: int = 2,
    num_points: int = 1024,
    in_channels: int = 6,
    n_classes: int = 13,
    kernel_sizes: Sequence[int] = BIG_KERNEL_SIZES,
    ratios: Sequence[int] = BIG_RATIOS,
    *,
    k_up: int = 1,
    seed: int = 0,
    with_category: bool = False,
    device="cuda",
) -> PointBatch:
    """Random clouds and their host pyramid, for tests and benchmarks."""
    rng = np.random.default_rng(seed)
    pos = rng.random((batch_size, num_points, 3), dtype=np.float32)
    feats = rng.random((batch_size, num_points, in_channels),
                       dtype=np.float32)
    y = rng.integers(0, n_classes, size=(batch_size, num_points))
    scales = build_pyramid(pos, kernel_sizes, ratios, k_up=k_up, rng=rng)
    category = (rng.integers(0, 16, size=(batch_size,)) if with_category
                else None)
    return make_batch(feats, y, scales, category=category, device=device)


# --------------------------------------------------------------------------
# the exact regime's device pyramid
# --------------------------------------------------------------------------


def build_pyramid_device(
    pos,
    kernel_sizes: Sequence[int] = BIG_KERNEL_SIZES,
    ratios: Sequence[int] = BIG_RATIOS,
    *,
    k_up: int = 1,
    generator: Optional[torch.Generator] = None,
    choices: Optional[Sequence] = None,
    device="cuda",
) -> Tuple[ScaleData, ...]:
    """pos [B, N, 3] -> the multiscale pyramid, built on ``device``.

    Scale s keeps the first ``n // ratios[s]`` points of one random
    permutation of its n points, shared across the batch, drawn from
    ``generator`` (default: a generator seeded with 0 on ``device``)
    unless ``choices`` gives each scale's kept points. ``neighbor_idx`` is
    the self-inclusive kNN(min(kernel_sizes[s], n)), ``sub_idx`` its rows
    of the kept points, ``up_idx`` the ``k_up`` nearest kept points of
    every point.
    """
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    if choices is None and generator is None:
        generator = torch.Generator(device=pos.device).manual_seed(0)
    scales = []
    for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
        n = pos.shape[1]
        neighbor_idx = knn_bruteforce(pos, pos, min(k, n))
        sample_num = max(n // r, 1)
        if choices is not None:
            choice = torch.as_tensor(np.array(choices[s]), dtype=torch.int64,
                                     device=pos.device)
        else:
            choice = torch.randperm(
                n, generator=generator, device=generator.device,
            )[:sample_num].to(pos.device)
        sub_pos = pos[:, choice].contiguous()
        sub_idx = neighbor_idx[:, choice].contiguous()
        up_idx = knn_bruteforce(sub_pos, pos, k_up)
        scales.append(ScaleData(pos, neighbor_idx, sub_idx, up_idx))
        pos = sub_pos
    return tuple(scales)
