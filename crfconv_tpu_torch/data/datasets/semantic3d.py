"""Semantic3D whole-cloud dataset.

Counterpart of ``crfconv_tpu/data/datasets/semantic3d.py``.

Reference: datasets/semantic3d_dataset.py:184-576.  Raw layout:
``raw/txt/<cloud>.txt`` (x y z intensity r g b rows) with
``<cloud>.labels`` present for training clouds.  process() runs the
two-stage grid subsample (0.01 m normalization, then ``grid_size``),
persists sub-clouds + full→sub projection indices; sampling uses the
class-weighted possibility sampler; the KPConv/RandLA split table
assigns training clouds to train/val.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

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
    "unlabeled": 0, "man-made terrain": 1, "natural terrain": 2,
    "high vegetation": 3, "low vegetation": 4, "buildings": 5,
    "hard scape": 6, "scanning artefacts": 7, "cars": 8,
}

# KPConv / RandLA-Net train-val split (semantic3d_dataset.py:205-207)
ALL_SPLITS = [0, 1, 4, 5, 3, 4, 3, 0, 1, 2, 3, 4, 2, 0, 5]
VAL_SPLIT = 1

# benchmark-server submission name map (semantic3d_dataset.py:241-260)
ASCII_FILES = {
    "MarketplaceFeldkirch_Station4_rgb_intensity-reduced.ply": "marketsquarefeldkirch4-reduced.labels",
    "sg27_station10_rgb_intensity-reduced.ply": "sg27_10-reduced.labels",
    "sg28_Station2_rgb_intensity-reduced.ply": "sg28_2-reduced.labels",
    "StGallenCathedral_station6_rgb_intensity-reduced.ply": "stgallencathedral6-reduced.labels",
    "birdfountain_station1_xyz_intensity_rgb.ply": "birdfountain1.labels",
    "castleblatten_station1_intensity_rgb.ply": "castleblatten1.labels",
    "castleblatten_station5_xyz_intensity_rgb.ply": "castleblatten5.labels",
    "marketplacefeldkirch_station1_intensity_rgb.ply": "marketsquarefeldkirch1.labels",
    "marketplacefeldkirch_station4_intensity_rgb.ply": "marketsquarefeldkirch4.labels",
    "marketplacefeldkirch_station7_intensity_rgb.ply": "marketsquarefeldkirch7.labels",
    "sg27_station10_intensity_rgb.ply": "sg27_10.labels",
    "sg27_station3_intensity_rgb.ply": "sg27_3.labels",
    "sg27_station6_intensity_rgb.ply": "sg27_6.labels",
    "sg27_station8_intensity_rgb.ply": "sg27_8.labels",
    "sg28_station2_intensity_rgb.ply": "sg28_2.labels",
    "sg28_station5_xyz_intensity_rgb.ply": "sg28_5.labels",
    "stgallencathedral_station1_intensity_rgb.ply": "stgallencathedral1.labels",
    "stgallencathedral_station3_intensity_rgb.ply": "stgallencathedral3.labels",
    "stgallencathedral_station6_intensity_rgb.ply": "stgallencathedral6.labels",
}


def _read_txt(path: str, dtype) -> np.ndarray:
    """A whitespace-separated text table → [rows, columns] of ``dtype``,
    parsed by numpy (the JAX package reads it with pandas)."""
    return np.loadtxt(path, dtype=dtype, ndmin=2)


class Semantic3D(ProcessedDataset):
    def __init__(
        self,
        root: str,
        split: str = "train",
        grid_size: float = 0.06,
        num_points: int = 65536,
        sample_per_epoch: int = 100,
        seed: int = 0,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.grid_size = grid_size
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        self.label_values = np.sort(list(CLASS_NAMES.values()))
        self.label_to_idx = {int(l): i for i, l in enumerate(self.label_values)}
        self.ascii_files = dict(ASCII_FILES)
        super().__init__(root)

        # resolve files per split (train clouds have .labels companions)
        names = sorted(
            os.path.basename(f)[:-4]
            for f in glob.glob(os.path.join(self.raw_dir, "txt", "*.txt"))
        )
        train_names = [
            n
            for n in names
            if os.path.exists(os.path.join(self.raw_dir, "txt", n + ".labels"))
        ]
        test_names = [n for n in names if n not in train_names]
        val_names = [
            n
            for i, n in enumerate(train_names)
            if ALL_SPLITS[i % len(ALL_SPLITS)] == VAL_SPLIT
        ]
        train_names = [n for n in train_names if n not in val_names]
        self.cloud_names = {
            "train": train_names, "val": val_names, "test": test_names
        }[split]
        self.val_files = list(self.cloud_names)

        self.input_points: List[np.ndarray] = []
        self.input_rgb: List[np.ndarray] = []
        self.input_labels: List[np.ndarray] = []
        self.test_proj: List[np.ndarray] = []
        self.test_labels: List[np.ndarray] = []
        self._load_processed()

        class_weight = None
        if split != "test" and self.input_labels:
            # dense per-label frequencies (the reference's np.unique counts
            # under-size the table when a label value is absent,
            # semantic3d_dataset.py:277-278 — rebuilt with bincount)
            counts = np.bincount(
                np.hstack(self.input_labels).astype(np.int64),
                minlength=len(self.label_values),
            ).astype(np.float64)
            class_weight = counts / counts.sum()

        self.sampler = PossibilitySampler(
            self.input_points,
            num_points,
            labels=self.input_labels if split != "test" else None,
            class_weight=class_weight,
            center_xy_only=True,
            seed=seed,
        )

    @property
    def sampled_dir(self):
        return os.path.join(self.processed_dir, "sampled")

    @property
    def reduced_dir(self):
        return os.path.join(self.processed_dir, "original_reduced")

    @property
    def min_possibility(self):
        return self.sampler.min_possibility

    def process(self):
        from scipy.spatial import cKDTree

        os.makedirs(self.sampled_dir, exist_ok=True)
        os.makedirs(self.reduced_dir, exist_ok=True)
        for pc_path in sorted(
            glob.glob(os.path.join(self.raw_dir, "txt", "*.txt"))
        ):
            name = os.path.basename(pc_path)[:-4]
            pc = _read_txt(pc_path, np.float32)
            xyz = pc[:, :3].astype(np.float32)
            rgb = pc[:, 4:7].astype(np.float32)
            label_path = pc_path[:-4] + ".labels"
            if os.path.exists(label_path):
                labels = _read_txt(label_path, np.int32).reshape(-1)
                # normalize training clouds to the 0.01 m test resolution
                xyz, rgb, labels = grid_subsample(xyz, rgb, labels, 0.01)
                write_ply(
                    os.path.join(self.reduced_dir, name + ".ply"),
                    [xyz, rgb.astype(np.uint8), labels.astype(np.int32)],
                    ["x", "y", "z", "r", "g", "b", "class"],
                )
                sub_xyz, sub_rgb, sub_labels = grid_subsample(
                    xyz, rgb, labels, self.grid_size
                )
                write_ply(
                    os.path.join(self.sampled_dir, name + ".ply"),
                    [sub_xyz, (sub_rgb / 255.0).astype(np.float32),
                     sub_labels.astype(np.int32)],
                    ["x", "y", "z", "r", "g", "b", "class"],
                )
            else:
                labels = np.zeros(xyz.shape[0], np.int32)
                write_ply(
                    os.path.join(self.reduced_dir, name + ".ply"),
                    [xyz, rgb.astype(np.uint8)],
                    ["x", "y", "z", "r", "g", "b"],
                )
                sub_xyz, sub_rgb = grid_subsample(xyz, rgb, None, self.grid_size)
                write_ply(
                    os.path.join(self.sampled_dir, name + ".ply"),
                    [sub_xyz, (sub_rgb / 255.0).astype(np.float32)],
                    ["x", "y", "z", "r", "g", "b"],
                )
            proj_idx = cKDTree(sub_xyz).query(xyz, k=1, workers=-1)[1]
            np.savez_compressed(
                os.path.join(self.sampled_dir, name + "_proj.npz"),
                proj_idx=proj_idx.astype(np.int32),
                labels=labels,
            )

    def _load_processed(self):
        for name in self.cloud_names:
            data = read_ply(os.path.join(self.sampled_dir, name + ".ply"))
            self.input_points.append(
                np.stack([data["x"], data["y"], data["z"]], axis=1)
            )
            self.input_rgb.append(
                np.stack([data["r"], data["g"], data["b"]], axis=1).astype(
                    np.float32
                )
            )
            if self.split != "test":
                self.input_labels.append(data["class"].astype(np.int64))
            if self.split in ("val", "test"):
                blob = np.load(
                    os.path.join(self.sampled_dir, name + "_proj.npz")
                )
                self.test_proj.append(blob["proj_idx"])
                self.test_labels.append(blob["labels"])

    def __len__(self):
        return (
            self.sample_per_epoch
            if self.sample_per_epoch > 0
            else len(self.input_points)
        )

    def get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        s = self.sampler.sample()
        ci = int(s["cloud_idx"])
        s["rgb"] = self.input_rgb[ci][s["point_idx"]]
        if self.split == "test":
            s["y"] = np.zeros(s["pos"].shape[0], np.int64)
        return s


class Semantic3DBlockDataset(ProcessedDataset):
    """5 m-block crops of Semantic3D clouds (reference block regime,
    datasets/semantic3d_dataset.py:52-158): sliding windows of 5 m with
    stride 3 m and 0.5 m padding, blocks dropped below 500 points or a
    2% un-padded core; per-block features are the block-bottom-center-
    normalized xyz concatenated with rgb/255.

    Raw layout matches :class:`Semantic3D` (``raw/txt/<cloud>.txt`` with
    ``.labels`` companions for the labeled clouds); an optional
    ``grid_size`` pre-subsample bounds per-block point counts (the
    reference's external pts→ply converter used 0.03 m).  Labels are
    stored raw (0 = unlabeled); train with ``label_offset=1`` exactly as
    the whole-cloud regime — equivalent to the reference's stored ``y-1``.
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        num_points: int = 8192,
        sample_per_epoch: int = -1,
        grid_size: float = 0.0,
    ):
        assert split in ("train", "val", "test")
        self.split = split
        self.block_size = 5.0
        self.stride = 3.0
        self.padding = 0.5
        self.proportion = 0.02
        self.min_point_num = 500
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch
        self.grid_size = grid_size
        super().__init__(root)

        d = os.path.join(self.processed_dir, "blocks", split)
        self.filelist = (
            sorted(os.path.join(d, f) for f in os.listdir(d))
            if os.path.isdir(d)
            else []
        )

    def process(self):
        names = sorted(
            os.path.basename(f)[:-4]
            for f in glob.glob(os.path.join(self.raw_dir, "txt", "*.txt"))
        )
        labeled = [
            n
            for n in names
            if os.path.exists(os.path.join(self.raw_dir, "txt", n + ".labels"))
        ]
        val_names = {
            n
            for i, n in enumerate(labeled)
            if ALL_SPLITS[i % len(ALL_SPLITS)] == VAL_SPLIT
        }
        cloud_counter = {"train": 0, "val": 0, "test": 0}
        for name in names:
            if name in labeled:
                split = "val" if name in val_names else "train"
            else:
                split = "test"
            # position of the cloud within ITS split: vote accumulators
            # are keyed by (cloud_idx, point_idx), so blocks of the same
            # cloud must share one cloud_idx (the block file's index would
            # scatter one cloud's votes across accumulators)
            cloud_pos = cloud_counter[split]
            cloud_counter[split] += 1
            out_dir = os.path.join(self.processed_dir, "blocks", split)
            os.makedirs(out_dir, exist_ok=True)
            pc = _read_txt(os.path.join(self.raw_dir, "txt", name + ".txt"),
                           np.float32)
            xyz = pc[:, :3].astype(np.float32)
            rgb = pc[:, 4:7].astype(np.float32)
            if split != "test":
                y = _read_txt(
                    os.path.join(self.raw_dir, "txt", name + ".labels"),
                    np.int32,
                ).reshape(-1)
            else:
                y = np.zeros(xyz.shape[0], np.int32)
            if self.grid_size > 0:
                xyz, rgb, y = grid_subsample(xyz, rgb, y, self.grid_size)
            xyz = xyz - xyz.min(axis=0)
            rgb_n = rgb / 255.0
            indices = np.arange(xyz.shape[0], dtype=np.int64)
            count = 0
            for idx, core in split_blocks(
                xyz, self.block_size, self.stride, self.padding,
                self.min_point_num, self.proportion,
            ):
                bxyz = xyz[idx]
                bmin = bxyz.min(axis=0)
                bmax = bxyz.max(axis=0)
                center = (bmin + bmax) / 2
                center[2] = bmin[2]  # block-bottom centering (ref :141-143)
                np.savez_compressed(
                    os.path.join(out_dir, f"{name}_{count:06d}.npz"),
                    pos=bxyz,
                    x=np.concatenate(
                        [bxyz - center, rgb_n[idx]], axis=-1
                    ).astype(np.float32),
                    y=y[idx].astype(np.int32),
                    mask=core.astype(np.int8),
                    indices=indices[idx],
                    cloud_idx=np.int64(cloud_pos),
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
            # source-cloud index (shared by all blocks of one cloud) so
            # (cloud_idx, point_idx)-keyed vote accumulators merge votes
            # from overlapping blocks; pre-r3 processed data lacks the
            # field and falls back to the block-file index
            "cloud_idx": np.int64(
                blob["cloud_idx"] if "cloud_idx" in blob else idx
            ),
        }


class Semantic3DWholeDataset:
    """train/val/test triplet (reference semantic3d_dataset.py:463-576)."""

    def __init__(
        self,
        root: str,
        grid_size: float = 0.06,
        num_points: int = 65536,
        train_sample_per_epoch: int = 8000,
        test_sample_per_epoch: int = 1600,
        seed: int = 0,
    ):
        self.kernel_size = (16, 16, 16, 16, 16)
        self.ratio = (4, 4, 4, 4, 2)
        self.train_set = Semantic3D(
            root, "train", grid_size, num_points, train_sample_per_epoch,
            seed=seed,
        )
        self.val_set = Semantic3D(
            root, "val", grid_size, num_points, test_sample_per_epoch,
            seed=seed + 1,
        )
        self.test_set = Semantic3D(
            root, "test", grid_size, num_points, test_sample_per_epoch,
            seed=seed + 2,
        )
