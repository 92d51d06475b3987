"""S3DIS datasets: whole-room possibility regime + block regime.

Counterpart of ``crfconv_tpu/data/datasets/s3dis.py``.

Reference: datasets/s3dis_dataset.py.  Raw layout (both regimes):
``raw/Area_{k}_anno.txt`` lists room annotation directories (relative to
``raw/Stanford3dDataset_v1.2_Aligned_Version``), each containing
``<class>_<i>.txt`` files of ``x y z r g b`` rows.

* :class:`S3DISRoom` — RandLA-Net regime (s3dis_dataset.py:186-379):
  grid-subsample each room at ``grid_size``, persist sub-cloud +
  full→sub projection indices, sample fixed-size KNN crops with the
  possibility sampler.
* :class:`S3DISBlockDataset` — 1 m-block regime (s3dis_dataset.py:28-183).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from crfconv_tpu_torch.data.datasets.base import (
    ProcessedDataset,
    fixed_size_choice,
    split_blocks,
)
from crfconv_tpu_torch.data.ply import read_ply, write_ply
from crfconv_tpu_torch.data.sampler import PossibilitySampler
from crfconv_tpu_torch.ops.subsample import grid_subsample

CLASS_NAMES = {
    "ceiling": 0, "floor": 1, "wall": 2, "beam": 3, "column": 4,
    "window": 5, "door": 6, "table": 7, "chair": 8, "sofa": 9,
    "bookcase": 10, "board": 11, "clutter": 12,
}

DATA_DIR = "Stanford3dDataset_v1.2_Aligned_Version"


def _load_room(anno_path: str):
    """Concatenate one room's per-class annotation files → xyz, rgb, y.
    Each file is parsed by numpy in float64 (the JAX package reads it with
    pandas), then cast to float32."""
    points, labels = [], []
    for f in sorted(glob.glob(os.path.join(anno_path, "*.txt"))):
        label = os.path.basename(f).split("_")[0]
        if label not in CLASS_NAMES:
            label = "clutter"
        cls_points = np.loadtxt(f, dtype=np.float64, ndmin=2)
        points.append(cls_points)
        labels.append(
            np.full(cls_points.shape[0], CLASS_NAMES[label], np.int32)
        )
    pts = np.concatenate(points, axis=0)
    y = np.concatenate(labels, axis=0)
    xyz = pts[:, 0:3].astype(np.float32)
    xyz -= xyz.min(axis=0)
    rgb = pts[:, 3:6].astype(np.float32)
    return xyz, rgb, y


class S3DISRoom(ProcessedDataset):
    """Whole-room grid-subsampled clouds + possibility sampling."""

    def __init__(
        self,
        root: str,
        test_area: int = 5,
        grid_size: float = 0.04,
        num_points: int = 8192,
        sample_per_epoch: int = 800,
        train: bool = True,
        seed: int = 0,
    ):
        assert test_area in [1, 2, 3, 4, 5, 6]
        self.test_area = f"Area_{test_area}"
        self.grid_size = grid_size
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        self.train = train
        self.label_values = np.sort(list(CLASS_NAMES.values()))
        super().__init__(root)

        self.input_points: List[np.ndarray] = []
        self.input_rgb: List[np.ndarray] = []
        self.input_labels: List[np.ndarray] = []
        self.input_names: List[str] = []
        self.val_proj: List[np.ndarray] = []
        self.val_labels: List[np.ndarray] = []
        self._load_processed()

        self.sampler = PossibilitySampler(
            self.input_points,
            num_points,
            labels=self.input_labels,
            center_xy_only=False,
            seed=seed,
        )

    @property
    def sampled_dir(self):
        return os.path.join(self.processed_dir, "sampled")

    def process(self):
        os.makedirs(self.sampled_dir, exist_ok=True)
        from scipy.spatial import cKDTree

        for area_file in sorted(
            glob.glob(os.path.join(self.raw_dir, "Area_*_anno.txt"))
        ):
            with open(area_file) as f:
                anno_paths = [line.strip() for line in f if line.strip()]
            for rel in anno_paths:
                anno_path = os.path.join(self.raw_dir, DATA_DIR, rel)
                parts = rel.split("/")
                name = parts[-3] + "_" + parts[-2] if len(parts) >= 3 else \
                    parts[0] + "_" + os.path.basename(rel)
                xyz, rgb, y = _load_room(anno_path)
                sub_xyz, sub_rgb, sub_y = grid_subsample(
                    xyz, rgb, y.astype(np.int32), self.grid_size
                )
                write_ply(
                    os.path.join(self.sampled_dir, name + ".ply"),
                    [sub_xyz, (sub_rgb / 255.0).astype(np.float32),
                     sub_y.astype(np.int32)],
                    ["x", "y", "z", "r", "g", "b", "class"],
                )
                proj_idx = cKDTree(sub_xyz).query(xyz, k=1, workers=-1)[1]
                np.savez_compressed(
                    os.path.join(self.sampled_dir, name + "_proj.npz"),
                    proj_idx=proj_idx.astype(np.int32),
                    labels=y.astype(np.int32),
                )

    def _load_processed(self):
        for f in sorted(glob.glob(os.path.join(self.sampled_dir, "*.ply"))):
            name = os.path.basename(f)[:-4]
            in_test = self.test_area in name
            if self.train and in_test:
                continue
            if not self.train and not in_test:
                continue
            data = read_ply(f)
            self.input_points.append(
                np.stack([data["x"], data["y"], data["z"]], axis=1)
            )
            self.input_rgb.append(
                np.stack([data["r"], data["g"], data["b"]], axis=1).astype(
                    np.float32
                )
            )
            self.input_labels.append(data["class"].astype(np.int64))
            self.input_names.append(name)
            if not self.train:
                blob = np.load(
                    os.path.join(self.sampled_dir, name + "_proj.npz")
                )
                self.val_proj.append(blob["proj_idx"])
                self.val_labels.append(blob["labels"])

    # sampler state exposure for vote-based testing
    @property
    def min_possibility(self):
        return self.sampler.min_possibility

    def __len__(self):
        return (
            self.sample_per_epoch
            if self.sample_per_epoch > 0
            else len(self.input_points)
        )

    def get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        s = self.sampler.sample()
        s["rgb"] = self.input_rgb[int(s["cloud_idx"])][s["point_idx"]]
        return s


class S3DISRoomDataset:
    """Train/test pair with the flagship pyramid constants
    (kernel_size [16]*5, ratio [4,4,4,4,2] — s3dis_dataset.py:392-393)."""

    def __init__(
        self,
        root: str,
        test_area: int = 5,
        grid_size: float = 0.04,
        num_points: int = 8192,
        train_sample_per_epoch: int = 800,
        test_sample_per_epoch: int = 100,
        seed: int = 0,
    ):
        self.kernel_size = (16, 16, 16, 16, 16)
        self.ratio = (4, 4, 4, 4, 2)
        self.train_set = S3DISRoom(
            root, test_area, grid_size, num_points,
            train_sample_per_epoch, train=True, seed=seed,
        )
        self.test_set = S3DISRoom(
            root, test_area, grid_size, num_points,
            test_sample_per_epoch, train=False, seed=seed + 1,
        )


class S3DISBlockDataset(ProcessedDataset):
    """1 m-block crops (reference S3DISDataset, s3dis_dataset.py:28-183)."""

    def __init__(
        self,
        root: str,
        train: bool = True,
        test_area: int = 5,
        num_points: int = 4096,
        sample_per_epoch: int = -1,
    ):
        self.block_size = 1.0
        self.stride = 0.5
        self.padding = 0.1
        self.min_point_num = 100
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        super().__init__(root)
        areas = [f"Area_{i}" for i in range(1, 7)]
        keep = (
            [a for a in areas if a != f"Area_{test_area}"]
            if train
            else [f"Area_{test_area}"]
        )
        self.filelist = []
        for a in keep:
            d = os.path.join(self.processed_dir, a)
            if os.path.isdir(d):
                self.filelist += sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                )

    def process(self):
        for area_file in sorted(
            glob.glob(os.path.join(self.raw_dir, "Area_*_anno.txt"))
        ):
            area = os.path.basename(area_file).replace("_anno.txt", "")
            out_dir = os.path.join(self.processed_dir, area)
            os.makedirs(out_dir, exist_ok=True)
            with open(area_file) as f:
                anno_paths = [line.strip() for line in f if line.strip()]
            for room_idx, rel in enumerate(anno_paths):
                xyz, rgb, y = _load_room(
                    os.path.join(self.raw_dir, DATA_DIR, rel)
                )
                limit = np.maximum(xyz.max(axis=0), 1e-6)
                rgb_n = rgb / 255.0
                xyz_n = xyz / limit
                count = 0
                for idx, core in split_blocks(
                    xyz, self.block_size, self.stride, self.padding,
                    self.min_point_num,
                ):
                    np.savez_compressed(
                        os.path.join(
                            out_dir, f"room_{room_idx:02d}_{count:06d}.npz"
                        ),
                        pos=xyz[idx],
                        x=np.concatenate(
                            [rgb_n[idx], xyz_n[idx]], axis=-1
                        ).astype(np.float32),
                        y=y[idx].astype(np.int32),
                        mask=core.astype(np.int8),
                        indices=idx.astype(np.int64),
                    )
                    count += 1

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
        n = blob["pos"].shape[0]
        sel = fixed_size_choice(n, self.num_points, rng)
        return {
            "pos": blob["pos"][sel],
            "x": blob["x"][sel],
            "y": blob["y"][sel].astype(np.int64),
            "point_idx": blob["indices"][sel],
            "cloud_idx": np.int64(idx),
        }
