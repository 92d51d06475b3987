"""NPM3D / Paris-Lille-3D block dataset.

Counterpart of ``crfconv_tpu/data/datasets/npm3d.py``.

Reference: datasets/npm3d_dataset.py:16-170.  Raw layout: PLY scans with
(x, y, z, reflectance[, class]) vertex properties plus ``trainval.txt`` /
``test.txt`` listing cloud names.  Labels shift by −1 so 0 (unclassified)
becomes −1 = ignore; 5 m blocks; features = block-bottom-centered xyz +
intensity/255.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from crfconv_tpu_torch.data.datasets.base import (
    ProcessedDataset,
    fixed_size_choice,
    split_blocks,
)
from crfconv_tpu_torch.data.ply import read_ply


class NPM3DDataset(ProcessedDataset):
    def __init__(
        self,
        root: str,
        train: bool = True,
        num_points: int = 8192,
        sample_per_epoch: int = -1,
    ):
        self.block_size = 5.0
        self.stride = 3.0
        self.padding = 0.5
        self.min_point_num = 200
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        super().__init__(root)
        d = os.path.join(
            self.processed_dir, "trainval" if train else "test"
        )
        self.filelist = sorted(
            os.path.join(d, f) for f in os.listdir(d)
        ) if os.path.isdir(d) else []

    def _split_list(self, name: str):
        p = os.path.join(self.raw_dir, name)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [line.strip() for line in f if line.strip()]

    def _process_split(self, names, out_name: str, labeled: bool):
        out_dir = os.path.join(self.processed_dir, out_name)
        os.makedirs(out_dir, exist_ok=True)
        for filename in names:
            data = read_ply(os.path.join(self.raw_dir, filename + ".ply"))
            xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(
                np.float32
            )
            ref = data.get("reflectance", np.zeros(xyz.shape[0], np.float32))
            labels = (
                data["class"].astype(np.int64) - 1 if labeled else None
            )
            xyz = xyz - xyz.min(axis=0)
            intensity = (np.asarray(ref, np.float32) / 255.0).reshape(-1, 1)
            count = 0
            for idx, core in split_blocks(
                xyz, self.block_size, self.stride, self.padding,
                self.min_point_num,
            ):
                bxyz = xyz[idx]
                bmin = bxyz.min(axis=0, keepdims=True)
                bmax = bxyz.max(axis=0, keepdims=True)
                center = (bmin + bmax) / 2
                center[0, -1] = bmin[0, -1]  # align to block bottom center
                feat = np.concatenate(
                    [bxyz - center, intensity[idx]], axis=-1
                ).astype(np.float32)
                out = {
                    "pos": bxyz,
                    "x": feat,
                    "mask": core.astype(np.int8),
                    "indices": idx.astype(np.int64),
                }
                if labels is not None:
                    out["y"] = labels[idx].astype(np.int32)
                np.savez_compressed(
                    os.path.join(out_dir, f"{filename}_{count:06d}.npz"),
                    **out,
                )
                count += 1

    def process(self):
        self._process_split(self._split_list("trainval.txt"), "trainval", True)
        self._process_split(self._split_list("test.txt"), "test", False)

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
        out = {
            "pos": blob["pos"][sel],
            "x": blob["x"][sel],
            "point_idx": blob["indices"][sel],
            "cloud_idx": np.int64(idx),
        }
        out["y"] = (
            blob["y"][sel].astype(np.int64)
            if "y" in blob
            else np.zeros(sel.shape[0], np.int64)
        )
        return out
