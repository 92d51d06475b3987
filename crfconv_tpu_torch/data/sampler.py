"""Possibility-based spatial sampler (RandLA-Net regime).

Counterpart of ``crfconv_tpu/data/sampler.py``.

Stateful host-side sampler over a collection of sub-sampled clouds: each
draw crops ``num_points`` nearest neighbors around the least-visited
point of the least-visited cloud, then increases the "possibility" of the
cropped points by a distance-weighted (optionally class-weighted) delta so
successive draws cover the clouds evenly.  Reference:
datasets/s3dis_dataset.py:343-379 and semantic3d_dataset.py:423-460.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from scipy.spatial import cKDTree


class PossibilitySampler:
    def __init__(
        self,
        clouds: List[np.ndarray],
        num_points: int,
        *,
        labels: Optional[List[np.ndarray]] = None,
        class_weight: Optional[np.ndarray] = None,
        center_xy_only: bool = True,
        noise_scale: float = 0.35,
        seed: int = 0,
    ):
        """Args:
          clouds: list of [N_i, 3] float32 sub-cloud positions.
          num_points: crop size (pads with duplicates when a cloud is short).
          labels: optional per-cloud label arrays (enables class weighting).
          class_weight: optional [L] frequency weights for the delta
                        (Semantic3D variant, semantic3d_dataset.py:446-449).
          center_xy_only: subtract the pick point in x/y only (Semantic3D)
                          or fully (S3DIS: False).
        """
        self.clouds = [np.asarray(c, np.float32) for c in clouds]
        self.trees = [cKDTree(c) for c in self.clouds]
        self.num_points = num_points
        self.labels = labels
        self.class_weight = class_weight
        self.center_xy_only = center_xy_only
        self.noise_scale = noise_scale
        self.rng = np.random.default_rng(seed)
        # random initial possibility, as the reference
        self.possibility = [
            self.rng.standard_normal(c.shape[0]) * 1e-3 for c in self.clouds
        ]
        self.min_possibility = [float(p.min()) for p in self.possibility]

    def sample(self) -> Dict[str, np.ndarray]:
        """Draw one crop → dict(pos, point_idx, cloud_idx [, y])."""
        cloud_idx = int(np.argmin(self.min_possibility))
        points = self.clouds[cloud_idx]
        pick_idx = int(np.argmin(self.possibility[cloud_idx]))
        pick_point = points[pick_idx : pick_idx + 1].copy()
        pick_point += self.rng.normal(
            scale=self.noise_scale, size=pick_point.shape
        ).astype(np.float32)

        k = min(self.num_points, points.shape[0])
        _, query_idx = self.trees[cloud_idx].query(pick_point[0], k=k)
        query_idx = np.atleast_1d(query_idx)
        self.rng.shuffle(query_idx)

        query_xyz = points[query_idx].copy()
        if self.center_xy_only:
            query_xyz[:, 0:2] -= pick_point[:, 0:2]
        else:
            query_xyz -= pick_point

        # possibility update: distance-weighted, optionally class-weighted
        dists = np.sum(
            np.square(points[query_idx] - pick_point), axis=1
        ).astype(np.float32)
        delta = np.square(1 - dists / max(dists.max(), 1e-12))
        if self.class_weight is not None and self.labels is not None:
            delta = delta * self.class_weight[
                self.labels[cloud_idx][query_idx]
            ]
        self.possibility[cloud_idx][query_idx] += delta
        self.min_possibility[cloud_idx] = float(
            self.possibility[cloud_idx].min()
        )

        # pad short clouds by re-drawing valid points (reference FixedPoints
        # with allow_duplicates, s3dis_dataset.py:376-377)
        if k < self.num_points:
            extra = self.rng.integers(0, k, size=self.num_points - k)
            sel = np.concatenate([np.arange(k), extra])
            query_xyz = query_xyz[sel]
            query_idx = query_idx[sel]

        out = {
            "pos": query_xyz.astype(np.float32),
            "point_idx": query_idx.astype(np.int64),
            "cloud_idx": np.int64(cloud_idx),
        }
        if self.labels is not None:
            out["y"] = self.labels[cloud_idx][query_idx].astype(np.int64)
        return out

    # ------------------------------------------------------------------
    # checkpointable state: a resume must replay the same crop schedule,
    # and the possibility arrays and the RNG are the schedule
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "possibility": [p.copy() for p in self.possibility],
            "min_possibility": list(self.min_possibility),
            "rng_state": self.rng.bit_generator.state,
        }

    def load_state_dict(self, state: dict) -> None:
        assert len(state["possibility"]) == len(self.possibility), (
            "sampler state does not match this dataset's cloud count"
        )
        self.possibility = [
            np.asarray(p, np.float64) for p in state["possibility"]
        ]
        self.min_possibility = [float(m) for m in state["min_possibility"]]
        self.rng.bit_generator.state = state["rng_state"]
