"""Experiment configuration.

The port's own copy of ``crfconv_tpu/train/config.py`` (numpy and
dataclasses only): the per-dataset settings of the reference
(configure.py:50-182) and the per-class point counts that give the
cross-entropy class weights (configure.py:31-47).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# Per-class point counts (reference configure.py:34-43).
NUM_PER_CLASS = {
    "S3DIS": np.array(
        [3370714, 2856755, 4919229, 318158, 375640, 478001, 974733,
         650464, 791496, 88727, 1284130, 229758, 2272837],
        dtype=np.int64,
    ),
    "Semantic3D": np.array(
        [5181602, 5012952, 6830086, 1311528, 10476365, 946982, 334860,
         269353],
        dtype=np.int64,
    ),
    "SemanticKITTI": np.array(
        [55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
         240942562, 17294618, 170599734, 6369672, 230413074, 101130274,
         476491114, 9833174, 129609852, 4506626, 1168181],
        dtype=np.int64,
    ),
}


def get_class_weights(dataset: str) -> Optional[np.ndarray]:
    """1 / (class frequency + 0.02) CE weights (configure.py:44-47)."""
    if dataset not in NUM_PER_CLASS:
        return None
    n = NUM_PER_CLASS[dataset].astype(np.float64)
    freq = n / n.sum()
    return (1.0 / (freq + 0.02)).astype(np.float32)


@dataclasses.dataclass
class Config:
    """Base experiment config (defaults follow the reference)."""

    dataset: str = ""
    root: str = ""
    model_name: str = "PointConvBig"
    mode: str = "train"              # 'train' | 'test'
    use_crf: bool = True
    steps: int = 1
    in_channels: int = 6
    num_classes: int = 13
    ignore_index: int = -1
    label_offset: int = 0            # y -> y - offset before the loss
    grid_size: float = 0.04
    sample_num: int = 8192
    batch_size: int = 8
    epochs: int = 100
    lr: float = 1e-2
    momentum: float = 0.95
    weight_decay: float = 1e-4
    gamma: float = 0.95
    train_samples_per_epoch: int = 800
    val_samples_per_epoch: int = 800
    test_smooth: float = 0.95        # vote running-mean smoothing
    # vote convergence: a vote round "counts" when the minimum
    # possibility grew by this much (reference differentiates: +4 for
    # Semantic3D trainval.py:194, +1 for S3DIS trainval.py:267)
    vote_delta: float = 1.0
    # pyramid
    num_scales: int = 5
    kernel_sizes: Tuple[int, ...] = (16, 16, 16, 16, 16)
    ratios: Tuple[int, ...] = (4, 4, 4, 4, 2)
    k_up: int = 1
    dilations: Optional[Tuple[int, ...]] = None
    sample_method: str = "random"
    # neighbour regime, 'windowed' or 'exact' (dense kNN), and the window
    # kNN's selection (packed key unless exact); the accuracy studies
    # behind these defaults are recorded in crfconv_tpu/train/config.py
    neighbor_regime: str = "windowed"
    windowed_knn_exact: bool = False
    # per-step random curve orientation at train time (windowed regime)
    curve_jitter: bool = False
    # eval-time orientation ensemble: softmax averaged over this many
    # fixed curve orientations (1 = single view)
    eval_views: int = 2
    # encoder channel plan of the big family (None = 32/64/128/256/512)
    layers: Optional[Tuple[int, ...]] = None
    # (data, points) mesh for point-sharded training (None = one device)
    spatial_mesh: Optional[Tuple[int, int]] = None
    # compute dtype for model matmuls: 'float32' or 'bfloat16'
    compute_dtype: str = "float32"
    # stop when val mIoU has not improved for this many epochs (None = all)
    early_stop_patience: Optional[int] = None
    # split each eval batch into chunks of this size (0 = off)
    eval_microbatch: int = 0
    # checkpointing
    checkpoint_dir: str = "checkpoints"
    model_path: Optional[str] = None
    # parallelism
    data_axis: str = "data"

    @property
    def class_weights(self) -> Optional[np.ndarray]:
        return get_class_weights(self.dataset)

    @property
    def prefix(self) -> str:
        return (
            f"{self.model_name}_on_{self.dataset}_bs_{self.batch_size}"
            f"_epochs_{self.epochs}"
        )


@dataclasses.dataclass
class ShapeNetConfig(Config):
    """ShapeNet part segmentation (configure.py:50-70)."""

    dataset: str = "ShapeNet"
    model_name: str = "CRFSegNet_Part"
    steps: int = 10
    num_classes: int = 50
    in_channels: int = 6             # pos + normals
    sample_num: int = 2048
    batch_size: int = 16
    gamma: float = 0.1 ** 0.02
    label_offset: int = 0
    k_up: int = 3
    kernel_sizes: Tuple[int, ...] = (32, 16, 8, 8, 8)
    ratios: Tuple[int, ...] = (4, 2, 2, 2, 2)
    dilations: Optional[Tuple[int, ...]] = (1, 2, 4, 2, 1)


@dataclasses.dataclass
class S3DISConfig(Config):
    """S3DIS Area-5 room pipeline (configure.py:73-107)."""

    dataset: str = "S3DIS"
    model_name: str = "PointConvBig"
    use_crf: bool = True
    steps: int = 1
    grid_size: float = 0.04
    sample_num: int = 8192
    num_classes: int = 13
    batch_size: int = 8
    train_samples_per_epoch: int = 800
    val_samples_per_epoch: int = 800
    test_area: int = 5
    test_smooth: float = 0.95


@dataclasses.dataclass
class ScanNetConfig(Config):
    """ScanNet (configure.py:109-130)."""

    dataset: str = "ScanNet"
    model_name: str = "CRFSegNet"
    steps: int = 10
    sample_num: int = 8192
    num_classes: int = 20
    ignore_index: int = -1
    label_offset: int = 1            # 0 = unannotated -> -1
    batch_size: int = 16
    gamma: float = 0.1 ** 0.02
    k_up: int = 3


@dataclasses.dataclass
class Semantic3DConfig(Config):
    """Semantic3D whole-cloud pipeline (configure.py:133-158)."""

    dataset: str = "Semantic3D"
    model_name: str = "PointConvBig"
    use_crf: bool = True
    steps: int = 1
    grid_size: float = 0.06
    sample_num: int = 65536
    num_classes: int = 8
    ignore_index: int = -1
    label_offset: int = 1            # labels 1..8, 0 unlabeled
    batch_size: int = 16
    train_samples_per_epoch: int = 8000
    val_samples_per_epoch: int = 1600
    gamma: float = 0.1 ** 0.02
    test_smooth: float = 0.98
    vote_delta: float = 4.0          # trainval.py:194


@dataclasses.dataclass
class NPM3DConfig(Config):
    """Paris-Lille-3D (configure.py:161-182)."""

    dataset: str = "Paris-Lille-3D"
    model_name: str = "CRFSegNet"
    steps: int = 10
    sample_num: int = 8192
    num_classes: int = 9
    ignore_index: int = -1
    label_offset: int = 1            # 0 = unclassified -> -1
    batch_size: int = 16
    in_channels: int = 4             # xyz + intensity
    k_up: int = 3


@dataclasses.dataclass
class SemanticKITTIConfig(Config):
    """SemanticKITTI sequential LiDAR."""

    dataset: str = "SemanticKITTI"
    model_name: str = "PointConvBig"
    use_crf: bool = True
    steps: int = 1
    grid_size: float = 0.06
    sample_num: int = 65536
    num_classes: int = 19
    ignore_index: int = -1
    label_offset: int = 1            # 0 = unlabeled -> -1 after remap
    in_channels: int = 4             # xyz + remission
    batch_size: int = 8


CONFIGS = {
    "ShapeNet": ShapeNetConfig,
    "S3DIS": S3DISConfig,
    "ScanNet": ScanNetConfig,
    "Semantic3D": Semantic3DConfig,
    "Paris-Lille-3D": NPM3DConfig,
    "NPM3D": NPM3DConfig,
    "SemanticKITTI": SemanticKITTIConfig,
}
