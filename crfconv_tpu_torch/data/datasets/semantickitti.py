"""SemanticKITTI sequential LiDAR dataset.

Counterpart of ``crfconv_tpu/data/datasets/semantickitti.py``.

Reference: datasets/semantickitti_dataset.py:11-122.  Raw layout:
``raw/sequences/<seq>/velodyne/*.bin`` float32 (x, y, z, remission) scans
with ``labels/*.label`` uint32 companions (semantic label in the low 16
bits, instance id in the high 16 — :77-83), and
``raw/semantic-kitti.yaml`` providing the 25→19 ``learning_map`` and the
train/valid/test sequence split.  Frames are read directly from the raw
files (no conversion pass needed — the .bin format is already dense).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from crfconv_tpu_torch.data.datasets.base import fixed_size_choice

# Official SemanticKITTI split (from the dataset's semantic-kitti.yaml);
# used as the fallback when the yaml is not present alongside the data.
DEFAULT_SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "valid": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
}

# Official 25→19 learning_map (the dataset's semantic-kitti.yaml),
# shipped as the fallback so a missing yaml can never silently pass raw
# labels (0..259) through unmapped (reference relies on the yaml,
# semantickitti_dataset.py:69-75).
# 0 = unlabeled/ignore after the remap; moving classes fold into their
# static counterparts.
DEFAULT_LEARNING_MAP = {
    0: 0, 1: 0,                       # unlabeled, outlier
    10: 1, 252: 1,                    # car (+moving)
    11: 2,                            # bicycle
    15: 3,                            # motorcycle
    18: 4, 258: 4,                    # truck (+moving)
    13: 5, 16: 5, 20: 5,              # bus/on-rails/other-vehicle
    256: 5, 257: 5, 259: 5,           #   (+moving variants)
    30: 6, 254: 6,                    # person (+moving)
    31: 7, 253: 7,                    # bicyclist (+moving)
    32: 8, 255: 8,                    # motorcyclist (+moving)
    40: 9, 60: 9,                     # road, lane-marking
    44: 10,                           # parking
    48: 11,                           # sidewalk
    49: 12,                           # other-ground
    50: 13,                           # building
    51: 14,                           # fence
    52: 0,                            # other-structure -> ignore
    70: 15,                           # vegetation
    71: 16,                           # trunk
    72: 17,                           # terrain
    80: 18,                           # pole
    81: 19,                           # traffic-sign
    99: 0,                            # other-object -> ignore
}


def _build_lut(remap: Dict[int, int]) -> np.ndarray:
    lut = np.zeros(max(remap.keys()) + 100, dtype=np.int32)
    lut[list(remap.keys())] = list(remap.values())
    return lut


def load_config(yaml_path: str) -> Tuple[np.ndarray, Dict[str, List[int]]]:
    """learning_map LUT + split from semantic-kitti.yaml."""
    import yaml

    with open(yaml_path) as f:
        data = yaml.safe_load(f)
    return _build_lut(data["learning_map"]), data["split"]


class SemanticKITTIDataset:
    def __init__(
        self,
        root: str,
        sequences: str = "train",
        num_points: int = 65536,
        sample_per_epoch: int = -1,
    ):
        self.root = root
        self.raw_dir = os.path.join(root, "raw")
        self.num_points = num_points
        self.sample_per_epoch = sample_per_epoch

        yaml_path = os.path.join(self.raw_dir, "semantic-kitti.yaml")
        if os.path.exists(yaml_path):
            self.lut, self.split = load_config(yaml_path)
        else:
            # default learning_map, never raw pass-through
            self.lut, self.split = (
                _build_lut(DEFAULT_LEARNING_MAP),
                DEFAULT_SPLIT,
            )
        self.num_classes = int(self.lut.max())

        if sequences in ("train", "val", "valid", "test"):
            key = "valid" if sequences == "val" else sequences
            seq_ids = [f"{i:02d}" for i in self.split[key]]
        else:
            seq_ids = [sequences]

        self.filelist: List[str] = []
        self.frame_seq: List[str] = []   # sequence id per filelist entry
        self.sequences: List[str] = []
        for seq in seq_ids:
            frames = sorted(
                glob.glob(
                    os.path.join(
                        self.raw_dir, "sequences", seq, "velodyne", "*.bin"
                    )
                )
            )
            if frames:
                self.sequences.append(seq)
            self.filelist += frames
            self.frame_seq += [seq] * len(frames)

    @staticmethod
    def load_scan(path: str) -> Tuple[np.ndarray, np.ndarray]:
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        return scan[:, :3], scan[:, 3]

    @staticmethod
    def load_labels(path: str) -> Tuple[np.ndarray, np.ndarray]:
        labels = np.fromfile(path, dtype=np.uint32).reshape(-1)
        sem = labels & 0xFFFF
        inst = labels >> 16
        return sem, inst

    def __len__(self):
        return (
            self.sample_per_epoch
            if self.sample_per_epoch > 0
            else len(self.filelist)
        )

    def frames_of(self, seq: str) -> List[int]:
        """Filelist indices of one sequence, in temporal (file) order —
        the unit of the per-sequence streaming eval protocol."""
        return [i for i, s in enumerate(self.frame_seq) if s == seq]

    def get_frame(self, idx: int):
        """One FULL scan (no subsampling) for streaming eval; same field
        layout as get_sample."""
        path = self.filelist[idx]
        points, remission = self.load_scan(path)
        y = self._frame_labels(path, points.shape[0])
        return {
            "pos": points,
            "x": np.concatenate(
                [points, remission[:, None]], axis=-1
            ).astype(np.float32),
            "y": y,
            "cloud_idx": np.int64(idx),
            "sequence": self.frame_seq[idx],
        }

    def _frame_labels(self, scan_path: str, n: int) -> np.ndarray:
        label_path = scan_path.replace("velodyne", "labels").replace(
            ".bin", ".label"
        )
        if not os.path.exists(label_path):
            return np.zeros(n, np.int64)
        sem, _ = self.load_labels(label_path)
        if sem.max(initial=0) >= self.lut.shape[0]:
            raise ValueError(
                f"{label_path}: raw semantic label {int(sem.max())} "
                f"exceeds the learning_map range ({self.lut.shape[0]}) — "
                "corrupt labels or a stale semantic-kitti.yaml"
            )
        y = self.lut[sem].astype(np.int64)
        if y.max(initial=0) > self.num_classes:
            raise ValueError(
                f"{label_path}: mapped label {int(y.max())} exceeds "
                f"num_classes={self.num_classes}"
            )
        return y

    def get_sample(self, rng: np.random.Generator, idx: Optional[int] = None):
        if idx is None or self.sample_per_epoch > 0:
            idx = int(rng.integers(len(self.filelist)))
        path = self.filelist[idx]
        points, remission = self.load_scan(path)
        y = self._frame_labels(path, points.shape[0])
        sel = fixed_size_choice(points.shape[0], self.num_points, rng)
        return {
            "pos": points[sel],
            "x": np.concatenate(
                [points[sel], remission[sel, None]], axis=-1
            ).astype(np.float32),
            "y": y[sel],
            "point_idx": sel.astype(np.int64),
            "cloud_idx": np.int64(idx),
        }
