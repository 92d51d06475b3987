"""Batch containers for the multiscale point pyramid.

Counterpart of ``crfconv_tpu/data/batch.py``: the same NamedTuples, of
tensors. Index semantics (int32, padded to a fixed K):

  * ``neighbor_idx [B, N_s, K]``: kNN of each scale-s point within scale
    s; column 0 is the point itself.
  * ``sub_idx [B, N_{s+1}, K]``: for each scale-(s+1) point, its K
    neighbours in scale s (strided convs).
  * ``up_idx [B, N_s, 1]``: each scale-s point's nearest scale-(s+1)
    point (decoder upsampling).
  * ``pos [B, N_s, 3]``: positions at scale s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class ScaleData(NamedTuple):
    """Per-scale slice of the multiscale pyramid."""

    pos: torch.Tensor
    neighbor_idx: torch.Tensor
    sub_idx: Optional[torch.Tensor] = None
    up_idx: Optional[torch.Tensor] = None


class RawBatch(NamedTuple):
    """A batch before its pyramid is built (on the device, by
    ``train.train_state.build_windowed_batch``)."""

    pos: torch.Tensor                         # [B, N, 3]
    x: torch.Tensor                           # [B, N, C_in]
    y: Optional[torch.Tensor] = None          # [B, N]
    point_idx: Optional[torch.Tensor] = None  # [B, N] original-cloud ids
    cloud_idx: Optional[torch.Tensor] = None  # [B]
    category: Optional[torch.Tensor] = None   # [B]


class PointBatch(NamedTuple):
    """A dense batch of fixed-size point clouds plus its index pyramid."""

    x: torch.Tensor                     # [B, N, C_in] features
    y: Optional[torch.Tensor]           # [B, N] labels (None at inference)
    scales: Tuple[ScaleData, ...]
    point_idx: Optional[torch.Tensor] = None  # [B, N] original-cloud ids
    cloud_idx: Optional[torch.Tensor] = None  # [B]
    category: Optional[torch.Tensor] = None   # [B]


def batch_size_of(batch) -> int:
    """The clouds of a RawBatch or PointBatch."""
    return int(batch.x.shape[0])


def slice_batch(batch, i: int, m: int):
    """Clouds [i, i + m) of a RawBatch or PointBatch (the pyramid's
    tensors included)."""
    def cut(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return v[i:i + m]
        return tuple(ScaleData(*map(cut, s)) for s in v)   # the scales

    return type(batch)(*map(cut, batch))
