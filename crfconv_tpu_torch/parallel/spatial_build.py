"""Point-sharded windowed pyramid construction.

Counterpart of ``crfconv_tpu/parallel/spatial_build.py``.
:func:`build_pyramid_windowed_spatial` builds, on each rank of a point
group, its span of the pyramid that ``ops/windowed.py::
build_pyramid_windowed`` builds whole, bit for bit (the same indices from
the same subsampling offsets):

  * the same-scale in-window kNN (K2) runs on the rank's span extended by
    one halo of positions from each neighbour; the outer halo of the
    group's two end ranks holds the far pad of the unsharded search
    (``ops/windowed.py::FAR_PAD``), and the kept rows' indices are made
    global by the frame's offset;
  * the stratified 1/r subsampling draws its offsets exactly as the
    unsharded builder (from the same generator, in the same order, or
    injected), and each rank keeps the picks inside its span;
  * the 1-NN up-link (the fine points' nearest coarse points) exchanges
    both frames; where the fine halo exceeds a span the search gathers its
    (small) operands whole;
  * below the sharding policy's cut (``spatial_forward.
    choose_sharded_scales``) the scales are built whole on every rank from
    one all-gather of the cut-over scale.

So a point-sharded request runs Morton sort -> this build -> the
point-sharded forward (``spatial_forward.make_spatial_forward``), which
expects exactly this placement.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import ScaleData
from crfconv_tpu_torch.ops.windowed import FAR_PAD, window_knn_auto
from crfconv_tpu_torch.parallel.spatial import exchange_halo
from crfconv_tpu_torch.parallel.spatial_forward import (
    _halo_pair, all_gather_points, choose_sharded_scales,
)

# the subsampling ratios of build_pyramid_windowed's scales (its default)
RATIOS = (4, 4, 4, 4, 2)


def _mask_outer_halo(x_e: torch.Tensor, h: int, mesh,
                     value: float) -> torch.Tensor:
    """The outer halo rows of the group's end ranks (exchanged zeros) set
    to ``value``, the unsharded builder's pad there."""
    x_e = x_e.clone()
    if mesh.rank == 0:
        x_e[:, :h] = value
    if mesh.rank == mesh.world - 1:
        x_e[:, -h:] = value
    return x_e


def _knn_local(pos_l, k: int, *, ns_g: int, mesh, mode, query_l=None,
               nt_g: Optional[int] = None) -> torch.Tensor:
    """The in-window kNN (``window_knn_auto``, the pyramid's selection
    rule) of this rank's rows on halo-extended frames: [B, Lt, k] global
    source indices, bit-equal to the unsharded search's rows. Same-scale
    (pins the row itself to column 0) where ``query_l`` is None, else the
    bipartite search of ``query_l`` (a frame of ``nt_g`` rows in all) in
    ``pos_l``."""
    tile, pad = mode.tile, mode.pad
    if query_l is None:
        h_t = h_s = _halo_pair(ns_g, ns_g, tile, pad)[0]
        nt_g = ns_g
    else:
        h_t, h_s = _halo_pair(nt_g, ns_g, tile, pad)
    ls_local, lt_local = ns_g // mesh.world, nt_g // mesh.world
    if h_t > lt_local or h_s > ls_local:
        # deep scales: the operands are small, search them whole
        pos_f = all_gather_points(pos_l, mesh)
        q_f = None if query_l is None else all_gather_points(query_l, mesh)
        idx = window_knn_auto(pos_f, k, q_f, tile, pad, mode.knn_exact)
        return idx[:, mesh.rank * lt_local:(mesh.rank + 1) * lt_local]
    pos_e = _mask_outer_halo(exchange_halo(pos_l, h_s, mesh), h_s, mesh,
                             FAR_PAD)
    q_e = None if query_l is None else _mask_outer_halo(
        exchange_halo(query_l, h_t, mesh), h_t, mesh, FAR_PAD)
    idx_e = window_knn_auto(pos_e, k, q_e, tile, pad, mode.knn_exact)
    idx = idx_e[:, h_t:h_t + lt_local].long()
    offset = mesh.rank * ls_local - h_s
    return (idx + offset).clamp(0, ns_g - 1).to(torch.int32).contiguous()


def pyramid_lengths(n: int, ratios: Sequence[int] = RATIOS) -> list:
    """The point counts of the pyramid's scales and of its last
    subsampling: n, max(n // r0, 1), ..."""
    out = [n]
    for r in ratios:
        out.append(max(out[-1] // r, 1))
    return out


def spatial_pyramid_scales(n: int, ndev: int, tile: int, pad: int,
                           ratios: Sequence[int] = RATIOS) -> set:
    """The lengths :func:`build_pyramid_windowed_spatial` shards: the
    policy's, each with its parent scale sharded too (a scale's positions
    are picked from its parent's span)."""
    lens = pyramid_lengths(n, ratios)
    sharded = choose_sharded_scales(set(lens), ndev, tile, pad)
    for i, m in enumerate(lens):
        if m in sharded and i > 0 and lens[i - 1] not in sharded:
            sharded.discard(m)
    return sharded


def build_pyramid_windowed_spatial(
    pos,
    mesh,
    kernel_sizes: Sequence[int] = (16, 16, 16, 16, 16),
    ratios: Sequence[int] = RATIOS,
    *,
    k_up: int = 1,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[Sequence] = None,
    mode=None,
) -> Tuple[ScaleData, ...]:
    """This rank's part of ``build_pyramid_windowed``'s scales, built on
    the point group of ``mesh`` (a Mesh, or a SpatialMesh's points).

    ``pos`` [B, N, 3] is the whole Morton-sorted cloud (unlike the
    unsharded builder, the sort is the caller's), on the rank's device.
    The subsampling offsets come from ``generator`` (default: one seeded
    with 0 on pos's device) unless ``offsets`` gives them, as there.
    Returns the scales: a sharded scale's tensors are this rank's span of
    its rows (its indices global), a replicated scale's are whole; sub_idx
    follows the coarser scale, up_idx the finer. ``mode`` (windowed) gives
    the geometry and the kNN selection; every rank of the group must call
    this together.
    """
    from crfconv_tpu_torch.parallel.sharding import point_mesh
    from crfconv_tpu_torch.parallel.spatial_forward import _check_mode

    mode = _check_mode(mode, "the point-sharded pyramid")
    mesh = point_mesh(mesh)
    tile, pad, exact = mode.tile, mode.pad, mode.knn_exact
    pos = torch.as_tensor(pos, dtype=torch.float32)
    if offsets is None and generator is None:
        generator = torch.Generator(device=pos.device).manual_seed(0)
    ndev, p = mesh.world, mesh.rank
    n0 = int(pos.shape[1])

    # every scale's picks, drawn as the unsharded builder draws them
    choices = []
    n = n0
    for s, r in enumerate(ratios):
        sample_num = max(n // r, 1)
        if offsets is not None:
            off = offsets[s]
            if isinstance(off, np.ndarray):   # may be a read-only view
                off = off.copy()
            off = torch.as_tensor(off)
        else:
            off = torch.randint(0, r, (sample_num,), generator=generator,
                                device=generator.device)
        ch = torch.arange(sample_num, device=pos.device) * r
        choices.append(torch.clamp(ch + off.to(pos.device).long(),
                                   max=n - 1))
        n = sample_num
    sharded = spatial_pyramid_scales(n0, ndev, tile, pad, ratios)

    scales = []
    cur = n0
    pl = pos
    if cur in sharded:
        loc = cur // ndev
        pl = pos[:, p * loc:(p + 1) * loc].contiguous()
    for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
        if cur not in sharded:
            break
        sample_num = int(choices[s].shape[0])
        loc_len = cur // ndev
        nidx = _knn_local(pl, min(k, cur), ns_g=cur, mesh=mesh, mode=mode)
        if sample_num in sharded:
            m = sample_num // ndev
            ch = choices[s][p * m:(p + 1) * m] - p * loc_len
            if ch.numel() and (int(ch.min()) < 0 or int(ch.max()) >= loc_len):
                raise ValueError(f"scale {s}'s picks leave rank {p}'s span")
            sub_pos = pl[:, ch].contiguous()
            sub_idx = nidx[:, ch].contiguous()
            up = _knn_local(sub_pos, k_up, ns_g=sample_num, nt_g=cur,
                            mesh=mesh, mode=mode, query_l=pl)
        else:
            # the cut-over: this (small) scale gathered once; everything
            # coarser is built whole on every rank
            p_full = all_gather_points(pl, mesh)
            nidx_full = all_gather_points(nidx, mesh)
            sub_pos = p_full[:, choices[s]].contiguous()
            sub_idx = nidx_full[:, choices[s]].contiguous()
            up_full = window_knn_auto(sub_pos, k_up, p_full, tile, pad,
                                      exact)
            up = up_full[:, p * loc_len:(p + 1) * loc_len].contiguous()
        scales.append(ScaleData(pl, nidx, sub_idx, up))
        pl = sub_pos
        cur = sample_num

    # the replicated tail: the unsharded builder's steps
    for s in range(len(scales), len(ratios)):
        nidx = window_knn_auto(pl, min(kernel_sizes[s], cur), None, tile,
                               pad, exact)
        sub_pos = pl[:, choices[s]].contiguous()
        sub_idx = nidx[:, choices[s]].contiguous()
        up = window_knn_auto(sub_pos, k_up, pl, tile, pad, exact)
        scales.append(ScaleData(pl, nidx, sub_idx, up))
        pl = sub_pos
        cur = int(choices[s].shape[0])
    return tuple(scales)
