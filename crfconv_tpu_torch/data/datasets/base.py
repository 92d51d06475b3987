"""Shared dataset scaffolding.

Counterpart of ``crfconv_tpu/data/datasets/base.py``.

``ProcessedDataset`` gives every dataset the reference's
raw → processed one-time conversion contract (torch_geometric
InMemoryDataset.process() semantics) without the torch dependency:
``process()`` runs once when the processed directory is missing.

``split_blocks`` is the common 2-D sliding-window block cropper used by
the S3DIS/ScanNet/NPM3D block pipelines (reference
datasets/s3dis_dataset.py:134-169, scannet_dataset.py:79-115,
npm3d_dataset.py:98-141): windows of ``block_size`` advanced by
``stride``, points collected with ``padding`` slack, blocks dropped when
too small or when too few points fall in the un-padded core.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


class ProcessedDataset:
    def __init__(self, root: str):
        self.root = root
        self.raw_dir = os.path.join(root, "raw")
        self.processed_dir = os.path.join(root, "processed")
        if not self._processed_exists():
            os.makedirs(self.processed_dir, exist_ok=True)
            self.process()
            self._mark_processed()

    @property
    def processed_marker(self) -> str:
        return os.path.join(self.processed_dir, ".complete")

    def _processed_exists(self) -> bool:
        return os.path.exists(self.processed_marker)

    def _mark_processed(self):
        with open(self.processed_marker, "w") as f:
            f.write("ok\n")

    def process(self):  # pragma: no cover - overridden
        raise NotImplementedError


def split_blocks(
    xyz: np.ndarray,
    block_size: float,
    stride: float,
    padding: float,
    min_point_num: int,
    proportion: float = 0.02,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (indices, core_mask) per retained block.

    indices: point indices inside the padded window; core_mask: bool per
    retained point marking membership in the un-padded core window.
    """
    limit = xyz.max(axis=0) - xyz.min(axis=0)
    base = xyz.min(axis=0)
    num_x = int(np.ceil(max(limit[0] - block_size, 0) / stride)) + 1
    num_y = int(np.ceil(max(limit[1] - block_size, 0) / stride)) + 1
    for i in range(num_x):
        for j in range(num_y):
            xbeg = base[0] + i * stride
            ybeg = base[1] + j * stride
            cond = (
                (xyz[:, 0] >= xbeg - padding)
                & (xyz[:, 0] <= xbeg + block_size + padding)
                & (xyz[:, 1] >= ybeg - padding)
                & (xyz[:, 1] <= ybeg + block_size + padding)
            )
            if cond.sum() < min_point_num:
                continue
            idx = np.nonzero(cond)[0]
            bxyz = xyz[idx]
            core = (
                (bxyz[:, 0] >= xbeg)
                & (bxyz[:, 0] <= xbeg + block_size)
                & (bxyz[:, 1] >= ybeg)
                & (bxyz[:, 1] <= ybeg + block_size)
            )
            if core.sum() / core.shape[0] < proportion:
                continue
            yield idx, core


def fixed_size_choice(
    n: int, target: int, rng: np.random.Generator
) -> np.ndarray:
    """Indices selecting exactly ``target`` of ``n`` points: a random
    subset when n >= target, else all points plus random duplicates
    (FixedPoints-with-duplicates semantics)."""
    if n >= target:
        return rng.permutation(n)[:target]
    extra = rng.integers(0, n, size=target - n)
    return np.concatenate([np.arange(n), extra])
