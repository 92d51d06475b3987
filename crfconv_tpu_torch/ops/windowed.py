"""Windowed neighbourhood regime: window geometry, the window-clamped
gather (kernel K1), the in-window kNN (kernel K2) and the device-side
pyramid builder.

Counterpart of ``crfconv_tpu/ops/windowed.py``. Points are sorted by
Morton code, so spatial neighbours are index neighbours; every 64-row
output tile searches and gathers only inside its candidate window of the
sorted source (``window_starts``), which the builder and the gather share.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import WINDOW_KNN, WINDOWED_GATHER
from crfconv_tpu_torch.data.batch import ScaleData
from crfconv_tpu_torch.ops._launch import check, on_cuda, ptr, stream
from crfconv_tpu_torch.ops.morton import morton_order

TILE = 64      # output rows per window tile
PAD = 128      # extra candidate rows on each side of a tile
# Packed-key selection is used up to this window width (wider windows
# select exactly), as in the reference's dispatch.
PACKED_MAX_WIDTH = 1024


def window_starts(m_out: int, n_src: int, tile: int = TILE, pad: int = PAD):
    """Window geometry shared by the builder and the gather.

    Returns (starts, width, front): output tile t's candidate window
    covers source rows [starts[t] - front, starts[t] - front + width) in
    unpadded coordinates, i.e. rows [starts[t], starts[t] + width) of a
    source padded with `front` rows up front.  ``front = pad + tile``
    includes one tile of slack so strided sub_idx (neighbor lists built at
    the fine scale, gathered at the coarse scale) stays in-window.
    """
    nt = -(-m_out // tile)
    stride = n_src / m_out  # src rows per output row
    front = pad + tile
    starts = np.round(np.arange(nt) * tile * stride).astype(np.int64)
    starts = (starts // 8) * 8
    width = int(np.ceil(tile * stride)) + 2 * front + 8
    width = -(-width // 128) * 128
    return starts, width, front


def _pad_src(x: torch.Tensor, front: int, width: int, starts, value=0.0):
    """Pad the source [B, N, F] so every window slice is in range."""
    need = int(starts[-1]) + width
    return F.pad(
        x, (0, 0, front, max(need - x.shape[1] - front, 0)), value=value
    )


@functools.lru_cache(maxsize=256)
def _geometry(m_out: int, n_src: int, tile: int, pad: int, device):
    """(int32 starts on ``device``, width, front), cached per shape."""
    starts, width, front = window_starts(m_out, n_src, tile, pad)
    return torch.as_tensor(starts.astype(np.int32), device=device), width, front


def check_window_consistency(
    idx: np.ndarray, n_src: int, tile: int = TILE, pad: int = PAD
) -> float:
    """Fraction of indices inside their tile's window (1.0 = consistent)."""
    idx = np.asarray(idx)
    M = idx.shape[1]
    starts, width, front = window_starts(M, n_src, tile, pad)
    nt = starts.shape[0]
    idx_p = np.pad(idx, ((0, 0), (0, nt * tile - M), (0, 0)))
    rel = (
        idx_p.reshape(idx.shape[0], nt, tile, -1)
        + front
        - starts[None, :, None, None]
    )
    valid = (rel >= 0) & (rel < width)
    valid = valid.reshape(idx.shape[0], nt * tile, -1)[:, :M]
    return float(valid.mean())


# ---------------------------------------------------------------------------
# K1: windowed gather
# ---------------------------------------------------------------------------


def windowed_gather(
    x: torch.Tensor, idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Window-clamped neighbour gather: x [B, N, F] f32, idx [B, M, K]
    int32 -> [B, M, K, F].

    Each index is clamped into its output tile's window; a clamped row
    outside [0, N) reads zero. For window-consistent indices (as
    ``window_knn`` makes them) this is the exact gather x[b, idx].
    """
    if not on_cuda(x, idx):
        return windowed_gather_plain(x, idx, tile, pad)
    check(x, "x", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    B, N, Fd = x.shape
    if idx.shape[0] != B:
        raise ValueError(f"batch {idx.shape[0]} != {B}")
    M, K = idx.shape[1], idx.shape[2]
    starts, width, front = _geometry(M, N, tile, pad, x.device)
    out = torch.empty((B, M, K, Fd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        WINDOWED_GATHER(
            ptr(x), ptr(idx), ptr(starts), ptr(out), B, N, M, K, Fd, tile,
            width, front, stream(x.device),
        )
    return out


def windowed_gather_plain(
    x: torch.Tensor, idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`windowed_gather`."""
    B, N, Fd = x.shape
    M, K = idx.shape[1], idx.shape[2]
    starts, width, front = window_starts(M, N, tile, pad)
    xp = _pad_src(x, front, width, starts)
    row_start = torch.as_tensor(starts, device=x.device).repeat_interleave(
        tile
    )[:M]
    rel = (idx.long() + front - row_start[None, :, None]).clamp(0, width - 1)
    rows = (row_start[None, :, None] + rel).reshape(B, M * K)
    b_ix = torch.arange(B, device=x.device)[:, None]
    return xp[b_ix, rows].reshape(B, M, K, Fd)


# ---------------------------------------------------------------------------
# K2: in-window kNN
# ---------------------------------------------------------------------------


def window_knn(
    pos: torch.Tensor,
    k: int,
    query_pos: Optional[torch.Tensor] = None,
    tile: int = TILE,
    pad: int = PAD,
    exact: bool = True,
) -> torch.Tensor:
    """kNN restricted to each tile's candidate window.

    Same-scale search (query_pos None) pins each query's own row to
    column 0. Bipartite search takes query_pos [B, M, 3], Morton-ordered
    like pos. ``exact`` orders by distance with ties to the lowest index;
    otherwise by the packed key (distances within ~2^-13 relative tie).

    Returns [B, M, k] int32 global source indices, ascending distance.
    """
    q = pos if query_pos is None else query_pos
    if not on_cuda(pos, q):
        return window_knn_plain(pos, k, query_pos, tile, pad, exact)
    check(pos, "pos", torch.float32, 3)
    check(q, "query_pos", torch.float32, 3)
    B, M, _ = q.shape
    N = pos.shape[1]
    if pos.shape[0] != B or pos.shape[2] != 3 or q.shape[2] != 3:
        raise ValueError(f"pos {tuple(pos.shape)}, query {tuple(q.shape)}")
    starts, width, front = _geometry(M, N, tile, pad, pos.device)
    if not 0 < k <= width:
        raise ValueError(f"k={k} outside (0, window width {width}]")
    out = torch.empty((B, M, k), dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        WINDOW_KNN(
            ptr(q), ptr(pos), ptr(starts), ptr(out), B, M, N, k, tile, width,
            front, int(query_pos is None), int(exact), stream(pos.device),
        )
    return out


def _select_key(d: torch.Tensor, exact: bool) -> torch.Tensor:
    """int64 key (k32 << 32) + column whose order is the selection order:
    k32 is the order-preserving int32 image of d, with its low 11 bits
    cleared in packed mode."""
    bits = (d + 0.0).view(torch.int32)        # + 0.0 turns -0 into +0
    k32 = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    if not exact:
        k32 = k32 & -2048
    cols = torch.arange(d.shape[-1], device=d.device)
    return k32.to(torch.int64) * (1 << 32) + cols


def window_knn_plain(
    pos: torch.Tensor,
    k: int,
    query_pos: Optional[torch.Tensor] = None,
    tile: int = TILE,
    pad: int = PAD,
    exact: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_knn`, with the kernel's
    distance association, elementwise (no matmul)."""
    q = pos if query_pos is None else query_pos
    B, M, _ = q.shape
    N = pos.shape[1]
    starts, width, front = window_starts(M, N, tile, pad)
    nt = starts.shape[0]
    dev = pos.device
    qp = F.pad(q, (0, 0, 0, nt * tile - M), value=1e9).reshape(B, nt, tile, 3)
    xp = _pad_src(pos, front, width, starts, value=2e9)
    st = torch.as_tensor(starts, device=dev)
    win = xp[:, st[:, None] + torch.arange(width, device=dev)]  # [B,nt,W,3]
    qx, qy, qz = (c[..., None] for c in qp.unbind(-1))         # [B,nt,T,1]
    wx, wy, wz = (c[:, :, None, :] for c in win.unbind(-1))    # [B,nt,1,W]
    qn = (qx * qx + qy * qy) + qz * qz
    wn = (wx * wx + wy * wy) + wz * wz
    cross = (qx * wx + qy * wy) + qz * wz
    d = (qn - 2.0 * cross) + wn                                # [B,nt,T,W]
    if query_pos is None:
        rows = torch.arange(nt * tile, device=dev).reshape(nt, tile)
        self_j = rows + front - st[:, None]
        cols = torch.arange(width, device=dev)
        d = d.masked_fill(cols == self_j[..., None], float("-inf"))
    rel = torch.topk(
        _select_key(d, exact), k, dim=-1, largest=False, sorted=True
    ).indices
    idx = (rel + (st - front)[None, :, None, None]).clamp(0, N - 1)
    return idx.reshape(B, nt * tile, k)[:, :M].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------


def build_pyramid_windowed(
    pos,
    kernel_sizes: Sequence[int] = (16, 16, 16, 16, 16),
    ratios: Sequence[int] = (4, 4, 4, 4, 2),
    *,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[Sequence] = None,
    tile: int = TILE,
    pad: int = PAD,
    knn_exact: bool = True,
    curve_rot=None,
    device="cuda",
) -> Tuple[torch.Tensor, Tuple[ScaleData, ...]]:
    """Morton sort + per-scale in-window kNN, on ``device``.

    Subsampling is stratified: scale s keeps row ``i * r + offsets[s][i]``
    of each block of r consecutive sorted rows, one offset vector per
    scale shared across the batch. The offsets are drawn from
    ``generator`` (default: a generator seeded with 0 on ``device``)
    unless ``offsets`` gives them.

    ``curve_rot`` ([3, 3]) rotates the coordinates fed to the Morton code
    only. ``knn_exact`` selects exact kNN selection; otherwise the packed
    key is used wherever the window is at most PACKED_MAX_WIDTH wide.

    Returns (order, scales): ``order`` [B, N] int64 is the Morton
    permutation to apply to features (pos is already sorted).
    """
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    if offsets is None and generator is None:
        generator = torch.Generator(device=pos.device).manual_seed(0)
    order = morton_order(pos, rot=curve_rot)
    pos = torch.take_along_dim(pos, order[..., None], dim=1)

    def knn(src, k, query=None):
        m = src.shape[1] if query is None else query.shape[1]
        _, width, _ = window_starts(m, src.shape[1], tile, pad)
        exact = knn_exact or width > PACKED_MAX_WIDTH
        return window_knn(src, k, query, tile, pad, exact)

    scales = []
    for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
        n = pos.shape[1]
        neighbor_idx = knn(pos, min(k, n))
        sample_num = max(n // r, 1)
        if offsets is not None:
            off = offsets[s]
            if isinstance(off, np.ndarray):   # may be a read-only view
                off = off.copy()
            off = torch.as_tensor(off)
        else:
            off = torch.randint(
                0, r, (sample_num,), generator=generator,
                device=generator.device,
            )
        choice = torch.arange(sample_num, device=pos.device) * r
        choice = torch.clamp(choice + off.to(pos.device).long(), max=n - 1)
        sub_pos = pos[:, choice].contiguous()
        sub_idx = neighbor_idx[:, choice].contiguous()
        up_idx = knn(sub_pos, 1, query=pos)
        scales.append(ScaleData(pos, neighbor_idx, sub_idx, up_idx))
        pos = sub_pos
    return order, tuple(scales)
