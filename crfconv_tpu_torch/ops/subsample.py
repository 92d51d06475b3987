"""Voxel-grid subsampling on the host (ahead-of-time preprocessing).

Counterpart of ``crfconv_tpu/ops/subsample.py``: one point an occupied
voxel, the barycentre, with features averaged and the majority label (ties
to the smaller label). The backend is named by the caller: ``"native"``
(the default: ``native/src/crfconv_native.cpp``, built on first use; a
failed build raises) or ``"numpy"`` (:func:`grid_subsample_numpy`, the
same semantics up to the order of the voxels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

BACKENDS = ("native", "numpy")


def grid_subsample_numpy(
    points: np.ndarray,
    features: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    grid_size: float = 0.1,
):
    """Vectorised numpy version; voxels in ascending key order."""
    points = np.asarray(points, np.float32)
    mn = points.min(axis=0)
    origin = np.floor(mn / grid_size) * grid_size
    ijk = np.floor((points - origin) / grid_size).astype(np.int64)
    nx = int(ijk[:, 0].max()) + 1
    ny = int(ijk[:, 1].max()) + 1
    key = ijk[:, 0] + nx * ijk[:, 1] + nx * ny * ijk[:, 2]

    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    nvox = uniq.shape[0]

    sums = np.zeros((nvox, 3), np.float64)
    np.add.at(sums, inv, points)
    out = [(sums / counts[:, None]).astype(np.float32)]
    if features is not None:
        features = np.asarray(features, np.float32)
        fsums = np.zeros((nvox, features.shape[1]), np.float64)
        np.add.at(fsums, inv, features)
        out.append((fsums / counts[:, None]).astype(np.float32))
    if labels is not None:
        labels = np.asarray(labels).reshape(-1).astype(np.int64)
        # the majority label a voxel: count (voxel, label) pairs
        lab_vals, lab_inv = np.unique(labels, return_inverse=True)
        pair = inv * lab_vals.shape[0] + lab_inv
        pair_uniq, pair_counts = np.unique(pair, return_counts=True)
        vox_of_pair = pair_uniq // lab_vals.shape[0]
        lab_of_pair = pair_uniq % lab_vals.shape[0]
        # ties to the smaller label: sort by (voxel, count desc, label asc)
        # and take each voxel's first row
        order = np.lexsort((lab_of_pair, -pair_counts, vox_of_pair))
        first = np.unique(vox_of_pair[order], return_index=True)[1]
        out.append(lab_vals[lab_of_pair[order][first]].astype(np.int32))
    return out[0] if len(out) == 1 else tuple(out)


def grid_subsample(
    points: np.ndarray,
    features: Optional[np.ndarray] = None,
    labels: Optional[np.ndarray] = None,
    grid_size: float = 0.1,
    backend: str = "native",
):
    """Voxel-grid subsample -> points [, features] [, labels]."""
    if backend == "numpy":
        return grid_subsample_numpy(points, features, labels, grid_size)
    if backend != "native":
        raise ValueError(f"unknown subsample backend {backend!r}, not in "
                         f"{BACKENDS}")
    from crfconv_tpu_torch.ops import native_build

    return native_build.grid_subsample(points, features, labels, grid_size)
