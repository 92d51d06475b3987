"""ScanNet block dataset from the official pickles.

Counterpart of ``crfconv_tpu/data/datasets/scannet.py``.

Reference: datasets/scannet_dataset.py:11-130.  Raw layout:
``raw/scannet_train.pickle`` / ``raw/scannet_test.pickle``, each a pair of
pickled lists (per-room xyz arrays, per-room label arrays).  Labels are
shifted by −1 so 0 (unannotated) becomes −1 = ignore_index; rooms are cut
into 1.5 m blocks with stride 1.0.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from crfconv_tpu_torch.data.datasets.base import (
    ProcessedDataset,
    fixed_size_choice,
    split_blocks,
)


class ScanNetDataset(ProcessedDataset):
    def __init__(
        self,
        root: str,
        train: bool = True,
        num_points: int = 8192,
        sample_per_epoch: int = -1,
    ):
        self.block_size = 1.5
        self.stride = 1.0
        self.padding = 0.2
        self.min_point_num = 200
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        super().__init__(root)
        d = os.path.join(self.processed_dir, "train" if train else "test")
        self.filelist = sorted(
            os.path.join(d, f) for f in os.listdir(d)
        ) if os.path.isdir(d) else []

    def _process_split(self, pickle_path: str, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        with open(pickle_path, "rb") as f:
            xyz_all = pickle.load(f, encoding="latin1")
            labels_all = pickle.load(f, encoding="latin1")
        for room_idx, xyz in enumerate(xyz_all):
            xyz = np.asarray(xyz, np.float32)
            labels = np.asarray(labels_all[room_idx], np.int64) - 1  # 0→-1
            xyz = xyz - xyz.min(axis=0)
            limit = np.maximum(xyz.max(axis=0), 1e-6)
            xyz_norm = xyz / limit
            count = 0
            for idx, core in split_blocks(
                xyz, self.block_size, self.stride, self.padding,
                self.min_point_num,
            ):
                np.savez_compressed(
                    os.path.join(
                        out_dir, f"room_{room_idx:04d}_{count:06d}.npz"
                    ),
                    pos=xyz[idx],
                    x=xyz_norm[idx].astype(np.float32),
                    y=labels[idx].astype(np.int32),
                    mask=core.astype(np.int8),
                    indices=idx.astype(np.int64),
                )
                count += 1

    def process(self):
        self._process_split(
            os.path.join(self.raw_dir, "scannet_train.pickle"),
            os.path.join(self.processed_dir, "train"),
        )
        self._process_split(
            os.path.join(self.raw_dir, "scannet_test.pickle"),
            os.path.join(self.processed_dir, "test"),
        )

    def __len__(self):
        return (
            self.sample_per_epoch
            if self.sample_per_epoch > 0
            else len(self.filelist)
        )

    def get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        if idx is None or self.sample_per_epoch > 0:
            idx = int(rng.integers(len(self.filelist)))
        blob = np.load(self.filelist[idx])
        sel = fixed_size_choice(blob["pos"].shape[0], self.num_points, rng)
        return {
            "pos": blob["pos"][sel],
            "x": blob["x"][sel],
            "y": blob["y"][sel].astype(np.int64),
            "point_idx": blob["indices"][sel],
            "cloud_idx": np.int64(idx),
        }
