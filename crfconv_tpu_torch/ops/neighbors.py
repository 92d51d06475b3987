"""Dense neighbour-index primitives, the gather regime and the exact
regime's device kNN.

Counterpart of ``crfconv_tpu/ops/neighbors.py``. The JAX package keeps the
regime in a process-wide dict; here it is a :class:`NeighborMode` value that
callers pass to the model and the Predictor.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, select_min_k, windowed_gather,
)

# f32 elements of one (batch, query tile) distance block: the reference's
# tile rule (a ~128 MB block)
KNN_TILE_ELEMENTS = 128 * 1024 * 1024 // 4
# Bytes of distance blocks that one K6 launch selects over; a larger call is
# cut into chunks of (batch, query tile) blocks, a launch each. Every call
# at S3DIS's B8 x 8192 and ScanNet's B16 x 8192 fits: the largest, the
# kNN(32) of B16 x 8192 points, is exactly 4 GiB.
KNN_BLOCK_BUDGET = 1 << 32


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
    """x [B, N, F], idx [B, M, K] -> [B, M, K, F]. Under a point-sharded
    step (``ops/spatial_state.py``) the windowed gather runs on this rank's
    rows, halo-exchanged (``parallel/spatial_forward.py``)."""
    if mode.windowed:
        if spatial_state.point_ctx() is not None:
            from crfconv_tpu_torch.parallel.spatial_forward import (
                spatial_gather,
            )

            return spatial_gather(x, idx, mode)
        return windowed_gather(x, idx, mode.tile, mode.pad)
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K, 1).long().expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, M, K, x.shape[-1])


def upsample_nearest(
    x: torch.Tensor, up_idx: torch.Tensor, mode: NeighborMode
) -> torch.Tensor:
    """1-NN upsample: x [B, S, F], up_idx [B, N, 1] -> [B, N, F]."""
    return gather_neighbors(x, up_idx, mode)[:, :, 0]


def max_pool_neighbors(
    x: torch.Tensor, idx: torch.Tensor, mode: NeighborMode,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Strided max-pool: x [B, N, F], idx [B, S, K] -> [B, S, F], the max
    over each output point's K neighbours; ``mask`` [B, S, K] (bool) drops
    the invalid slots (a fully masked row gives the dtype's lowest
    value)."""
    n = gather_neighbors(x, idx, mode)                   # [B, S, K, F]
    if mask is not None:
        n = torch.where(mask[..., None], n, torch.finfo(x.dtype).min)
    return n.amax(dim=2)


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


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 over the last axis, summed x, y, then z."""
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 (no TF32) inside, whatever the
    process has set; restored after. A process that set its precision
    through the per-backend setting (``torch.backends.cuda.matmul.
    fp32_precision``) cannot read the global one, and keeps to its own."""
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:
        m = torch.backends.cuda.matmul
        prev = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = prev
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def knn_bruteforce(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    *,
    tile: Optional[int] = None,
    exact: bool = True,
) -> torch.Tensor:
    """Batched kNN by brute force: support [B, N, 3], query [B, M, 3] ->
    [B, M, k] int32 indices into N, ascending distance, ties to the lowest
    index (so column 0 is the query itself when query is support).

    Counterpart of ``crfconv_tpu/ops/neighbors.py::knn_bruteforce``: the
    queries are cut into tiles (the reference's rule: a ~128 MB block of
    tile x N distances, at most 4096 rows, zero-padded to a whole tile),
    each block is |q|^2 - 2 q.s + |s|^2 in that association, its cross term
    in full float32 (a TF32 product moves the self-distance off 0 and
    breaks column 0 == self), and kernel K6 selects. Blocks that fit
    KNN_BLOCK_BUDGET together go to one K6 launch.

    ``exact=False`` (the reference's ``approx_max_k``, recall >= a target)
    takes the exact selection too, which meets any recall target.
    """
    del exact
    B, N, _ = support.shape
    M = query.shape[1]
    if tile is None:
        tile = max(min(KNN_TILE_ELEMENTS // max(N, 1), M, 4096), 8)
    tile = min(tile, M)
    nt = -(-M // tile)
    q = F.pad(query, (0, 0, 0, nt * tile - M)).reshape(B * nt, tile, 3)
    q_sq = _sq_norm(q)                                   # [B * nt, tile]
    s_sq = _sq_norm(support)                             # [B, N]
    per_launch = max(KNN_BLOCK_BUDGET // (tile * N * 4), 1)
    out = []
    for i0 in range(0, B * nt, per_launch):
        i1 = min(i0 + per_launch, B * nt)
        b_of = torch.arange(i0, i1, device=support.device) // nt
        with _full_f32_matmul():
            # |q|^2 + (-2) cross rounds once, as |q|^2 - 2 cross (the scale
            # by -2 is exact); then + |s|^2
            d = torch.baddbmm(q_sq[i0:i1, :, None], q[i0:i1],
                              support[b_of].transpose(1, 2), alpha=-2.0)
        d.add_(s_sq[b_of][:, None, :])
        out.append(select_min_k(d[None], k)[0])
        del d
    idx = torch.cat(out).reshape(B, nt * tile, k)
    return idx[:, :M].contiguous()
