"""Windowed neighbourhood regime: window geometry, the window-clamped
gather (kernel K1), the in-window kNN (kernel K2) and the device-side
pyramid; and the k-min selection over a distance block (kernel K6)
that the exact regime's kNN (``ops/neighbors.py::knn_bruteforce``) runs.

Counterpart of ``crfconv_tpu/ops/windowed.py``. Points are sorted by
Morton code, so spatial neighbours are index neighbours; every 64-row
output tile searches and gathers only inside its candidate window of the
sorted source (``window_starts``), which the builder and the gather share.
"""

from __future__ import annotations

import functools
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import (
    SELECT_MIN_K, WINDOW_KNN, WINDOWED_GATHER, WINDOWED_GATHER_BWD,
    WINDOWED_WEIGHTED_REDUCE,
)
from crfconv_tpu_torch.data.batch import ScaleData
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, float32_io, launch_on, on_cuda, ptr, raw_stream,
    stream,
)
from crfconv_tpu_torch.ops.morton import morton_order
from crfconv_tpu_torch.utils import profiling

# K1's, K2's and K8's arguments, packed as int64s (cuda_build)
_pack13 = struct.Struct("13q").pack
_pack14 = struct.Struct("14q").pack
_pack16 = struct.Struct("16q").pack

TILE = 64      # output rows per window tile
PAD = 128      # extra candidate rows on each side of a tile
# Packed-key selection is used up to this window width (wider windows
# select exactly), as in the reference's dispatch; it is also the widest
# row K6's packed key (10 column bits) takes.
PACKED_MAX_WIDTH = 1024
# The coordinate of a source row outside the cloud in the in-window kNN
# (K2 reads it there too): farther than any point, so never a neighbour
# while a window holds k points of the cloud.
FAR_PAD = 2e9


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
    """(int32 starts on ``device``, width, front), cached per (m_out, n_src,
    tile, pad, device): only a shape's first call runs ``window_starts``
    and copies the starts to the device; every later call returns the same
    tensor, which no caller writes. ``device`` is a tensor's device, so the
    CPU and each CUDA device (by its index) have entries of their own."""
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


@float32_io("x")
def windowed_gather(
    x: torch.Tensor, idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Window-clamped neighbour gather: x [B, N, F] f32, idx [B, M, K]
    int32 -> [B, M, K, F].

    Each index is clamped into its output tile's window; a clamped row
    outside [0, N) reads zero. For window-consistent indices (as
    ``window_knn`` makes them) this is the exact gather x[b, idx].
    Differentiable in x: the backward is :func:`windowed_gather_bwd`
    (kernel K8), the exact transpose, for every geometry. Where no
    gradient is needed the gather runs without the autograd Function. A
    narrower float x is gathered as float32 and returned in its dtype.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _WindowedGather.apply(x, idx, tile, pad)
    return _windowed_gather_launch(x, idx, tile, pad)


class _WindowedGather(torch.autograd.Function):
    """K1 forward, K8 backward (counterpart of the custom VJP of
    ``crfconv_tpu/ops/windowed.py::windowed_gather``)."""

    @staticmethod
    def forward(ctx, x, idx, tile, pad):
        ctx.save_for_backward(idx)
        ctx.geometry = (x.shape[1], tile, pad)
        return _windowed_gather_launch(x, idx, tile, pad)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, tile, pad = ctx.geometry
        dx = windowed_gather_bwd(g, idx, n, tile, pad)
        return dx, None, None, None


def _windowed_gather_launch(x, idx, tile, pad):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if not on_cuda(x, idx):
        return windowed_gather_plain(x, idx, tile, pad)
    check_no_grad("windowed_gather", x)
    check(x, "x", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    B, N, Fd = x.shape
    if idx.shape[0] != B:
        raise ValueError(f"batch {idx.shape[0]} != {B}")
    M, K = idx.shape[1], idx.shape[2]
    dev = x.device
    starts, width, front = _geometry(M, N, tile, pad, dev)
    out = torch.empty((B, M, K, Fd), dtype=x.dtype, device=dev)
    launch_on(dev, WINDOWED_GATHER, _pack13(
        x.data_ptr(), idx.data_ptr(), starts.data_ptr(), out.data_ptr(), B,
        N, M, K, Fd, tile, width, front, raw_stream(dev)))
    return out


def windowed_gather_plain(
    x: torch.Tensor, idx: torch.Tensor, tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`windowed_gather`."""
    B, N, Fd = x.shape
    M, K = idx.shape[1], idx.shape[2]
    starts, width, front = window_starts(M, N, tile, pad)
    xp = _pad_src(x, front, width, starts)   # zero rows outside [0, N)
    rows = (_clamped_rows(idx, N, tile, pad) + front).reshape(B, M * K)
    b_ix = torch.arange(B, device=x.device)[:, None]
    return xp[b_ix, rows].reshape(B, M, K, Fd)


def _clamped_rows(idx: torch.Tensor, n_src: int, tile: int, pad: int):
    """The source row (in [B, M, K], unpadded, possibly outside [0, N))
    that the window clamp assigns to each index."""
    M = idx.shape[1]
    starts, width, front = window_starts(M, n_src, tile, pad)
    row_start = torch.as_tensor(starts, device=idx.device).repeat_interleave(
        tile
    )[:M][None, :, None]
    rel = (idx.long() + front - row_start).clamp(0, width - 1)
    return row_start - front + rel


# ---------------------------------------------------------------------------
# K8: windowed gather backward (the gather's transpose)
# ---------------------------------------------------------------------------


@float32_io("g")
def windowed_gather_bwd(
    g: torch.Tensor, idx: torch.Tensor, n_src: int,
    tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Transpose of :func:`windowed_gather`: g [B, M, K, F] f32, idx
    [B, M, K] int32 -> dx [B, n_src, F], dx[b, row(idx)] += g[b, m, k].

    ``row`` is the window clamp of the forward; slots whose clamped row
    lies outside [0, n_src) are dropped. Each row's terms are added in
    ascending slot order from +0.0, the order of the plain version's
    ``index_add_`` on the CPU: the kernel is bit-equal to it and
    deterministic. g may be a slice of a wider tensor's last dimension; a
    narrower float g is summed in float32 and dx returned in its dtype.
    """
    if not on_cuda(g, idx):
        return windowed_gather_bwd_plain(g, idx, n_src, tile, pad)
    check_no_grad("windowed_gather_bwd", g)
    check(idx, "idx", torch.int32, 3)
    if g.dtype != torch.float32 or g.dim() != 4:
        raise TypeError(f"g: expected float32 [B, M, K, F], got {g.dtype} "
                        f"{tuple(g.shape)}")
    B, M, K, Fd = g.shape
    if idx.shape != (B, M, K):
        raise ValueError(f"g {tuple(g.shape)}, idx {tuple(idx.shape)}")
    rows, ld = g, Fd
    if not g.is_contiguous():
        rows = g.flatten(0, 2)   # a view where g's rows are evenly spaced
        if Fd > 1 and rows.stride(1) != 1:
            rows = rows.contiguous()
        ld = rows.stride(0) if rows.shape[0] > 1 else Fd
    dev = g.device
    starts, width, front = _geometry(M, n_src, tile, pad, dev)
    # scratch: the tiles' slots sorted by window row (B * M * K), then each
    # tile's run offset per window row (B * tiles * (width + 1))
    n_order = B * M * K
    scratch = torch.empty(n_order + B * starts.shape[0] * (width + 1),
                          dtype=torch.int32, device=dev)
    dx = torch.empty((B, n_src, Fd), dtype=g.dtype, device=dev)
    order = scratch.data_ptr()
    launch_on(dev, WINDOWED_GATHER_BWD, _pack16(
        rows.data_ptr(), idx.data_ptr(), starts.data_ptr(), order,
        order + 4 * n_order, dx.data_ptr(), B, n_src, M, K, Fd, ld, tile,
        width, front, raw_stream(dev)))
    return dx


@float32_io("g")
def windowed_gather_bwd_plain(
    g: torch.Tensor, idx: torch.Tensor, n_src: int,
    tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`windowed_gather_bwd`."""
    B, M, K, Fd = g.shape
    rows = _clamped_rows(idx, n_src, tile, pad)
    keep = (rows >= 0) & (rows < n_src)
    flat = torch.arange(B, device=g.device)[:, None, None] * n_src + rows.clamp(
        0, n_src - 1
    )
    src = torch.where(keep[..., None], g, torch.zeros((), dtype=g.dtype,
                                                      device=g.device))
    dx = torch.zeros((B * n_src, Fd), dtype=g.dtype, device=g.device)
    dx.index_add_(0, flat.reshape(-1), src.reshape(-1, Fd))
    return dx.reshape(B, n_src, Fd)


# ---------------------------------------------------------------------------
# K7: weighted gather-reduce (the train-path point-conv contraction)
# ---------------------------------------------------------------------------


@float32_io("x")
def weighted_gather_reduce(
    x: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
) -> torch.Tensor:
    """out_i = sum_k u_ik * x_idx(i,k): x [B, N, H], u [B, M, K, H],
    idx [B, M, K] int32 (K1's clamp semantics) -> [B, M, H].

    Differentiable in x and u (counterpart of the custom VJP of
    ``crfconv_tpu/ops/windowed.py::weighted_gather_reduce``): the forward
    is K7, which also keeps the gathered neighbours xg; the backward is
    du = xg * g and dx = K8(u * g). Narrower floats run in float32 and the
    result takes x's dtype.
    """
    return _WeightedGatherReduce.apply(x, u, idx, tile, pad)


class _WeightedGatherReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u, idx, tile, pad):
        out, xg = windowed_weighted_reduce(x, u, idx, tile, pad)
        ctx.save_for_backward(u, xg, idx)
        ctx.geometry = (x.shape[1], tile, pad)
        return out

    @staticmethod
    def backward(ctx, g):
        u, xg, idx = ctx.saved_tensors
        n, tile, pad = ctx.geometry
        gb = g[:, :, None, :]
        du = xg * gb if ctx.needs_input_grad[1] else None
        dx = None
        if ctx.needs_input_grad[0]:
            dx = windowed_gather_bwd((u * gb).contiguous(), idx, n, tile, pad)
        return dx, du, None, None, None


@float32_io("x")
def windowed_weighted_reduce(
    x: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
):
    """Kernel K7: (out [B, M, H], xg [B, M, K, H]) with xg the window-clamped
    gather of x and out = sum_k u * xg. Not differentiable; the autograd
    front is :func:`weighted_gather_reduce`. Narrower floats run in
    float32, the outputs in x's dtype."""
    if not on_cuda(x, u, idx):
        return windowed_weighted_reduce_plain(x, u, idx, tile, pad)
    check_no_grad("windowed_weighted_reduce", x, u)
    check(x, "x", torch.float32, 3)
    check(u, "u", torch.float32, 4)
    check(idx, "idx", torch.int32, 3)
    B, N, H = x.shape
    M, K = idx.shape[1], idx.shape[2]
    if idx.shape[0] != B or u.shape != (B, M, K, H):
        raise ValueError(
            f"x {tuple(x.shape)}, u {tuple(u.shape)}, idx {tuple(idx.shape)}"
        )
    starts, width, front = _geometry(M, N, tile, pad, x.device)
    out = torch.empty((B, M, H), dtype=x.dtype, device=x.device)
    xg = torch.empty_like(u)
    with torch.cuda.device(x.device):
        WINDOWED_WEIGHTED_REDUCE(
            ptr(x), ptr(u), ptr(idx), ptr(starts), ptr(out), ptr(xg), B, N,
            M, K, H, tile, width, front, stream(x.device),
        )
    return out, xg


@float32_io("x")
def windowed_weighted_reduce_plain(
    x: torch.Tensor, u: torch.Tensor, idx: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
):
    """Plain PyTorch version of :func:`windowed_weighted_reduce`
    (differentiable by autograd). It sums over k in the kernel's order,
    k ascending with no fused multiply-add, so the two are bit-equal."""
    xg = windowed_gather_plain(x, idx, tile, pad)
    out = u[:, :, 0] * xg[:, :, 0]
    for j in range(1, idx.shape[2]):
        out = out + u[:, :, j] * xg[:, :, j]
    return out, xg


# ---------------------------------------------------------------------------
# K2: in-window kNN
# ---------------------------------------------------------------------------


@float32_io()
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
    The keys are distinct, so the kernel's indices are the plain version's
    bit for bit.

    Returns [B, M, k] int32 global source indices, ascending distance.
    Positions in a narrower float are searched in float32.
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
    dev = pos.device
    out = torch.empty((B, M, k), dtype=torch.int32, device=dev)
    launch_on(dev, WINDOW_KNN, _pack14(
        q.data_ptr(), pos.data_ptr(), starts.data_ptr(), out.data_ptr(), B, M,
        N, k, tile, width, front, int(query_pos is None), int(exact),
        raw_stream(dev)))
    return out


def _order_bits(d: torch.Tensor) -> torch.Tensor:
    """The order-preserving int32 image of float32 d: bits ^ 0x7FFFFFFF
    where the sign bit is set (-0.0 orders just below +0.0)."""
    bits = d.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _select_key(d: torch.Tensor, exact: bool) -> torch.Tensor:
    """int64 key (k32 << 32) + column whose order is the selection order:
    k32 is the order-preserving int32 image of d, with its low 11 bits
    cleared in packed mode."""
    k32 = _order_bits(d + 0.0)                # + 0.0 turns -0 into +0
    if not exact:
        k32 = k32 & -2048
    cols = torch.arange(d.shape[-1], device=d.device)
    return k32.to(torch.int64) * (1 << 32) + cols


@float32_io()
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
    xp = _pad_src(pos, front, width, starts, value=FAR_PAD)
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
# K6: k-min selection over a distance block
# ---------------------------------------------------------------------------


@float32_io()     # a narrower float orders as its float32 image
def select_min_k(d: torch.Tensor, k: int, exact: bool = True) -> torch.Tensor:
    """Columns of the k smallest entries of each row, ascending: d [B, nt,
    rows, width] f32 -> [B, nt, rows, k] int32.

    ``exact`` orders by the 64-bit key (o(d) << 32) | column, o the
    order-preserving int32 image of d: the result is
    ``lax.top_k(-d, k)[1]`` bit for bit (-0.0 before +0.0, ties to the
    lowest column, no repeated column even where a row has fewer than k
    finite entries). Otherwise the key is the int32 (o(d) & -1024) |
    column (distances within ~2^-13 relative tie), for width <= 1024.
    """
    width = d.shape[-1]
    if not 0 < k <= width:
        raise ValueError(f"k={k} outside (0, width {width}]")
    if not exact and width > PACKED_MAX_WIDTH:
        raise ValueError(
            f"packed selection takes width <= {PACKED_MAX_WIDTH}, got {width}")
    if not on_cuda(d):
        return select_min_k_plain(d, k, exact)
    check(d, "d", torch.float32, 4)
    out = torch.empty(d.shape[:-1] + (k,), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        SELECT_MIN_K(ptr(d), ptr(out), d.numel() // width, width, k,
                     int(exact), stream(d.device))
    return out


def _min_k_key(d: torch.Tensor, exact: bool) -> torch.Tensor:
    """K6's selection key: int64 (o << 32) + column, or int32 (o & -1024)
    | column in packed mode."""
    o = _order_bits(d)
    if not exact:
        return (o & -1024) | torch.arange(d.shape[-1], dtype=torch.int32,
                                           device=d.device)
    key = o.to(torch.int64)
    del o
    return key.mul_(1 << 32).add_(torch.arange(d.shape[-1], device=d.device))


@float32_io()
def select_min_k_plain(d: torch.Tensor, k: int,
                       exact: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`select_min_k`: ``torch.topk`` over
    the same keys, which are distinct, so the order is unique."""
    key = _min_k_key(d, exact)
    return torch.topk(key, k, dim=-1, largest=False,
                      sorted=True).indices.to(torch.int32)


# ---------------------------------------------------------------------------
# pyramid
# ---------------------------------------------------------------------------


def window_knn_auto(src, k, query=None, tile: int = TILE, pad: int = PAD,
                    knn_exact: bool = True) -> torch.Tensor:
    """``window_knn`` with the pyramid's selection rule: exact selection
    when ``knn_exact`` is set or the window is wider than
    PACKED_MAX_WIDTH, else the packed key."""
    m = src.shape[1] if query is None else query.shape[1]
    _, width, _ = window_starts(m, src.shape[1], tile, pad)
    exact = knn_exact or width > PACKED_MAX_WIDTH
    return window_knn(src, k, query, tile, pad, exact)


def build_pyramid_windowed(
    pos,
    kernel_sizes: Sequence[int] = (16, 16, 16, 16, 16),
    ratios: Sequence[int] = (4, 4, 4, 4, 2),
    *,
    k_up: int = 1,
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
    ``k_up`` is the number of columns of each scale's ``up_idx`` (the
    nearest coarse points of each fine point).

    Returns (order, scales): ``order`` [B, N] int64 is the Morton
    permutation to apply to features (pos is already sorted).
    """
    with profiling.span("pyramid"):
        pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
        if offsets is None and generator is None:
            generator = torch.Generator(device=pos.device).manual_seed(0)
        order = morton_order(pos, rot=curve_rot)
        pos = torch.take_along_dim(pos, order[..., None], dim=1)

        scales = []
        for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
            n = pos.shape[1]
            neighbor_idx = window_knn_auto(pos, min(k, n), None, tile, pad,
                                           knn_exact)
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
            up_idx = window_knn_auto(sub_pos, k_up, pos, tile, pad, knn_exact)
            scales.append(ScaleData(pos, neighbor_idx, sub_idx, up_idx))
            pos = sub_pos
        return order, tuple(scales)
