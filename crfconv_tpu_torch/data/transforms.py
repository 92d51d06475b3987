"""Host-side point-cloud augmentations.

Counterpart of ``crfconv_tpu/data/transforms.py``.

Numpy counterparts of the torch_points3d transform pipeline the reference
composes at trainval.py:27-42: RandomRotate(z, ±180°), anisotropic
random scale [0.8, 1.2], x-axis random symmetry, Gaussian jitter
(σ=0.001), random RGB drop (p=0.2), then feature assembly x = [pos, rgb].
Transforms operate on a dict sample {'pos', 'rgb'/'feat', 'y', ...} and
compose with :class:`Compose`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

Sample = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms: Sequence[Callable[[Sample, np.random.Generator], Sample]]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomRotate:
    """Rotate positions about an axis by U(−degrees, +degrees)."""

    def __init__(self, degrees: float = 180.0, axis: int = 2):
        self.degrees = degrees
        self.axis = axis

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        theta = np.deg2rad(rng.uniform(-self.degrees, self.degrees))
        c, si = np.cos(theta), np.sin(theta)
        i, j = [d for d in range(3) if d != self.axis]
        rot = np.eye(3, dtype=np.float32)
        rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -si, si, c
        s = dict(s)
        s["pos"] = s["pos"] @ rot.T
        return s


class RandomScaleAnisotropic:
    """Per-axis random scale in [lo, hi] (torch_points3d semantics)."""

    def __init__(self, scales=(0.8, 1.2)):
        self.lo, self.hi = scales

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        scale = rng.uniform(self.lo, self.hi, size=(3,)).astype(np.float32)
        s = dict(s)
        s["pos"] = s["pos"] * scale
        return s


class RandomSymmetry:
    """Mirror each enabled axis with probability 0.5."""

    def __init__(self, axis=(True, False, False)):
        self.axis = axis

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        s = dict(s)
        pos = s["pos"]
        for d, enabled in enumerate(self.axis):
            if enabled and rng.random() < 0.5:
                pos = pos.copy()
                pos[:, d] = -pos[:, d]
        s["pos"] = pos
        return s


class RandomNoise:
    """Additive Gaussian jitter on positions."""

    def __init__(self, sigma: float = 0.001, clip: Optional[float] = 0.05):
        self.sigma = sigma
        self.clip = clip

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        noise = rng.normal(0.0, self.sigma, size=s["pos"].shape)
        if self.clip is not None:
            noise = np.clip(noise, -self.clip, self.clip)
        s = dict(s)
        s["pos"] = (s["pos"] + noise).astype(np.float32)
        return s


class DropFeature:
    """Zero a named feature with probability p (DropFeature('rgb', 0.2))."""

    def __init__(self, drop_proba: float = 0.2, feature_name: str = "rgb"):
        self.p = drop_proba
        self.name = feature_name

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        if self.name in s and rng.random() < self.p:
            s = dict(s)
            s[self.name] = np.zeros_like(s[self.name])
        return s


class AddFeatsByKeys:
    """Assemble the model input x by concatenating named fields.

    Reference: AddFeatsByKeys(feat_names=['pos','rgb']) → x = [pos, rgb]
    (trainval.py:33-36).
    """

    def __init__(self, feat_names: Sequence[str] = ("pos", "rgb")):
        self.feat_names = list(feat_names)

    def __call__(self, s: Sample, rng: np.random.Generator) -> Sample:
        s = dict(s)
        feats = [np.atleast_2d(s[k].T).T.astype(np.float32) for k in self.feat_names]
        s["x"] = np.concatenate(feats, axis=-1)
        return s


def default_train_transform() -> Compose:
    """The reference's Semantic3D/S3DIS training augmentation stack."""
    return Compose([
        RandomRotate(degrees=180, axis=2),
        RandomScaleAnisotropic(scales=(0.8, 1.2)),
        RandomSymmetry(axis=(True, False, False)),
        RandomNoise(sigma=0.001),
        DropFeature(drop_proba=0.2, feature_name="rgb"),
        AddFeatsByKeys(feat_names=("pos", "rgb")),
    ])


def default_test_transform() -> Compose:
    return Compose([AddFeatsByKeys(feat_names=("pos", "rgb"))])
