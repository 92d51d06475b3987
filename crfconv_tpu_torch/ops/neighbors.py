"""Dense neighbour-index primitives and the gather regime.

Counterpart of ``crfconv_tpu/ops/neighbors.py``. The JAX package keeps the
regime in a process-wide dict; here it is a :class:`NeighborMode` value that
callers pass to the model and the Predictor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from crfconv_tpu_torch.ops.windowed import PAD, TILE, windowed_gather


@dataclasses.dataclass(frozen=True)
class NeighborMode:
    """Gather regime.

    ``mode`` "exact" gathers with a plain index gather; "windowed" needs a
    Morton-sorted, window-consistent pyramid (``build_pyramid_windowed``)
    and gathers through the windowed kernel. ``knn_exact`` selects exact
    kNN selection; False is the packed-key selection, the serving default.
    """

    mode: str = "exact"
    tile: int = TILE
    pad: int = PAD
    knn_exact: bool = True

    def __post_init__(self):
        if self.mode not in ("exact", "windowed"):
            raise ValueError(f"unknown neighbour mode {self.mode!r}")

    @property
    def windowed(self) -> bool:
        return self.mode == "windowed"


def gather_neighbors(
    x: torch.Tensor, idx: torch.Tensor, mode: NeighborMode
) -> torch.Tensor:
    """x [B, N, F], idx [B, M, K] -> [B, M, K, F]."""
    if mode.windowed:
        return windowed_gather(x, idx, mode.tile, mode.pad)
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, M, K, x.shape[-1])


def upsample_nearest(
    x: torch.Tensor, up_idx: torch.Tensor, mode: NeighborMode
) -> torch.Tensor:
    """1-NN upsample: x [B, S, F], up_idx [B, N, 1] -> [B, N, F]."""
    return gather_neighbors(x, up_idx, mode)[:, :, 0]


def masked_softmax(
    logits: torch.Tensor, mask: Optional[torch.Tensor] = None, dim: int = -1
) -> torch.Tensor:
    """Softmax with an optional validity mask: masked slots get exactly 0,
    and a fully masked row is all zeros (not NaN)."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, neg)
    z = z - z.amax(dim=dim, keepdim=True).detach()
    e = torch.where(mask, torch.exp(z), 0.0)
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.clamp(denom, min=torch.finfo(logits.dtype).tiny)


def remove_self_loop(neighbor_idx: torch.Tensor) -> torch.Tensor:
    """Drop neighbour column 0 (the query itself); contiguous, as the
    kernels take it."""
    return neighbor_idx[:, :, 1:].contiguous()


def knn_interpolate(
    x: torch.Tensor,
    pos_src: torch.Tensor,
    pos_dst: torch.Tensor,
    up_idx: torch.Tensor,
    mode: NeighborMode,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Inverse-squared-distance weighted k-NN interpolation, coarse to fine:
    x [B, S, F], pos_src [B, S, 3], pos_dst [B, N, 3], up_idx [B, N, k]
    (the k nearest coarse points) -> [B, N, F]."""
    nx = gather_neighbors(x, up_idx, mode)                 # [B, N, k, F]
    npos = gather_neighbors(pos_src, up_idx, mode)         # [B, N, k, 3]
    d2 = (pos_dst[:, :, None, :] - npos).square().sum(dim=-1)
    w = 1.0 / torch.clamp(d2, min=eps)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bnk,bnkf->bnf", w, nx)
