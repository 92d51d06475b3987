"""The windowed neighbour pyramid, worked out from the positions and the
subsampling offsets.

The semantics of the program's windowed regime, written out plainly:
points are sorted by their 30-bit Morton code (10 bits an axis over the
cloud's bounding box, a stable sort); every 64-row output tile searches
only its candidate window of the sorted source; a same-scale search pins
each point itself to column 0; candidates are ordered by the squared
distance |q|^2 - 2 q.s + |s|^2 (in that association, elementwise) with the
low 11 bits of its order-preserving integer image cleared ("packed" keys,
distances within ~2^-13 relative tie) and ties to the lowest column, or by
the full key where the window is wider than 1024 rows; scale s keeps row
``i * r + offsets[s][i]`` of each block of r sorted rows.

Clouds are searched one at a time, so the distance blocks of a 65,536
point cloud stay a few hundred MB.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

TILE = 64
PAD = 128
PACKED_MAX_WIDTH = 1024
FAR = 2e9          # the coordinate of a window row outside the cloud
BITS = 10


def window_starts(m_out: int, n_src: int, tile: int = TILE, pad: int = PAD):
    """(starts, width, front): output tile t searches source rows
    [starts[t] - front, starts[t] - front + width)."""
    nt = -(-m_out // tile)
    stride = n_src / m_out
    front = pad + tile
    starts = np.round(np.arange(nt) * tile * stride).astype(np.int64)
    starts = (starts // 8) * 8
    width = int(np.ceil(tile * stride)) + 2 * front + 8
    width = -(-width // 128) * 128
    return starts, width, front


def _spread(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(pos: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> the stable permutation [B, N] into Morton order."""
    mn = pos.amin(dim=-2, keepdim=True)
    span = torch.clamp(pos.amax(dim=-2, keepdim=True) - mn, min=1e-9)
    q = torch.clamp((pos - mn) / span * (2**BITS - 1), 0,
                    2**BITS - 1).to(torch.int64)
    code = (_spread(q[..., 0]) | (_spread(q[..., 1]) << 1)
            | (_spread(q[..., 2]) << 2))
    return torch.argsort(code, dim=-1, stable=True)


def _keys(d: torch.Tensor, packed: bool) -> torch.Tensor:
    bits = (d + 0.0).view(torch.int32)
    k32 = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    if packed:
        k32 = k32 & -2048
    cols = torch.arange(d.shape[-1], device=d.device)
    return k32.to(torch.int64) * (1 << 32) + cols


def _knn_cloud(src, query, k, same, tile, pad):
    """One cloud: src [N, 3], query [M, 3] -> [M, k] int64."""
    M, N = query.shape[0], src.shape[0]
    starts, width, front = window_starts(M, N, tile, pad)
    nt = starts.shape[0]
    dev = src.device
    q = F.pad(query, (0, 0, 0, nt * tile - M), value=1e9).reshape(nt, tile, 3)
    need = int(starts[-1]) + width
    sp = F.pad(src, (0, 0, front, max(need - N - front, 0)), value=FAR)
    st = torch.as_tensor(starts, device=dev)
    win = sp[st[:, None] + torch.arange(width, device=dev)]      # [nt, W, 3]
    qx, qy, qz = (c[..., None] for c in q.unbind(-1))
    wx, wy, wz = (c[:, None, :] for c in win.unbind(-1))
    d = (((qx * qx + qy * qy) + qz * qz) - 2.0 * ((qx * wx + qy * wy)
                                                 + qz * wz)
         + ((wx * wx + wy * wy) + wz * wz))
    if same:
        rows = torch.arange(nt * tile, device=dev).reshape(nt, tile)
        self_col = rows + front - st[:, None]
        d = d.masked_fill(torch.arange(width, device=dev) == self_col[..., None],
                          float("-inf"))
    packed = width <= PACKED_MAX_WIDTH
    rel = torch.topk(_keys(d, packed), k, dim=-1, largest=False,
                     sorted=True).indices
    idx = (rel + (st - front)[:, None, None]).clamp(0, N - 1)
    return idx.reshape(nt * tile, k)[:M]


def window_knn(src, k, query=None, tile=TILE, pad=PAD):
    """[B, N, 3] (and [B, M, 3] queries) -> [B, M, k] int64 indices, the
    query itself first in a same-scale search."""
    same = query is None
    q = src if same else query
    return torch.stack([_knn_cloud(src[b], q[b], k, same, tile, pad)
                        for b in range(src.shape[0])])


def build(pos, offsets, kernel_sizes, ratios, k_up, tile=TILE, pad=PAD):
    """Positions [B, N, 3] and the offsets of every scale -> (order [B, N],
    scales): each scale a dict of its sorted ``pos``, same-scale
    ``nbr`` [B, n, k], the kept rows' ``sub`` [B, n / r, k] and ``up``
    [B, n, k_up], the nearest kept points of each point."""
    order = morton_order(pos)
    pos = torch.take_along_dim(pos, order[..., None], dim=1)
    scales = []
    for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
        n = pos.shape[1]
        nbr = window_knn(pos, min(k, n), None, tile, pad)
        keep = max(n // r, 1)
        choice = torch.arange(keep, device=pos.device) * r
        choice = torch.clamp(choice + offsets[s].to(pos.device).long(),
                             max=n - 1)
        sub_pos = pos[:, choice]
        up = window_knn(sub_pos, k_up, pos, tile, pad)
        scales.append({"pos": pos, "nbr": nbr, "sub": nbr[:, choice],
                       "up": up})
        pos = sub_pos
    return order, scales


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, F], idx [B, M, K] -> [B, M, K, F]."""
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K, 1).expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, M, K, x.shape[-1])
