"""Halo-exchange point sharding of the whole windowed forward.

Counterpart of ``crfconv_tpu/parallel/spatial_forward.py``.
:func:`make_spatial_forward` runs an unmodified model on this rank's span
of a point-sharded batch: a frame context (``ops/spatial_state.py``) tells
every windowed operation which point-axis lengths are sharded, and they
route here:

  * ``ops/neighbors.py::gather_neighbors`` (every point-axis gather: the
    same-scale and strided convs, the residual pool, the upsample, the CRF
    guidance) becomes exchange -> K1 on the extended frame -> trim
    (:func:`spatial_gather`);
  * ``ops/crf.py``'s mean fields become the chunked halo iterations of
    ``parallel/spatial.py`` (K9-K13 on the extended frames);
  * the eval-mode fused point conv (K3, K5) and the fused CRF similarity
    (K4) run on the halo-extended frame and are trimmed.

The window geometry is affine (``window_starts``: start t = round(t * tile
* stride) // 8 * 8, tile * stride integral for the pyramid's ratios), so
extending both frames in proportion, the source by h_s = h_t * stride,
translates every window by the frame's offset: the kept rows' windows on
the extended frame are their global windows, and a gather there is the
global gather, bit for bit.

Scale policy (:func:`choose_sharded_scales`): a scale is sharded where its
span is a multiple of the tile and holds at least one same-scale halo;
coarser scales are held whole on every rank. An operation whose one side is
replicated slices or all-gathers that (small) side; where a halo would
exceed a span (an upsample out of a tiny replicated scale) the operation
gathers its operands whole (:func:`_all_gather_replicated`, whose backward
returns each rank's gradient of a span to the span's owner, summed).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.windowed import window_starts


# ---------------------------------------------------------------------------
# halo geometry
# ---------------------------------------------------------------------------


def _halo_pair(nt_global: int, ns_global: int, tile: int, pad: int):
    """(h_t, h_s): the target and source halo rows of a windowed gather
    between frames of ``nt_global`` target and ``ns_global`` source rows.
    h_s >= the window width keeps every kept row's window inside the
    extended source; h_t is the least multiple of the tile with h_s = h_t *
    stride integral."""
    _, width, _ = window_starts(nt_global, ns_global, tile, pad)
    stride = ns_global / nt_global
    h_t = int(math.ceil(width / (tile * stride))) * tile
    h_s = h_t * stride
    if abs(h_s - round(h_s)) > 1e-9:
        raise ValueError(f"no integral source halo for {nt_global} <- "
                         f"{ns_global} rows at tile {tile}")
    return h_t, int(round(h_s))


def same_scale_halo(tile: int, pad: int) -> int:
    return _halo_pair(1024, 1024, tile, pad)[0]


# ---------------------------------------------------------------------------
# the replicated all-gather
# ---------------------------------------------------------------------------


def all_gather_points(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's span [B, L, ...] concatenated on the point axis in rank
    order -> [B, P * L, ...] (no gradient). Gloo gathers through the
    host."""
    import torch.distributed as dist

    if mesh.world == 1:
        return x
    src = x.detach().contiguous()
    if mesh.backend == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=1).to(x.device)


class _AllGatherReplicated(torch.autograd.Function):
    """All-gather whose backward sums every rank's gradient of the whole
    and keeps this rank's span (each rank used its own copy)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[1]
        return all_gather_points(x, mesh)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        mesh, n = ctx.mesh, ctx.n
        if mesh.world > 1:
            g = g.contiguous()
            t = g.cpu() if mesh.backend == "gloo" else g.clone()
            dist.all_reduce(t, group=mesh.group)
            g = t.to(g.device)
        return g[:, mesh.rank * n:(mesh.rank + 1) * n].contiguous(), None


def _all_gather_replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole of a sharded tensor on every rank, differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGatherReplicated.apply(x, mesh)
    return all_gather_points(x, mesh)


# ---------------------------------------------------------------------------
# frame-aware operations (called from the hooks in ops/ and models/)
# ---------------------------------------------------------------------------


def _frame(ctx, seen: int, what: str):
    fr = ctx["frames"].get(seen)
    if fr is None:
        raise KeyError(
            f"point-sharded forward: {what} has point-axis length {seen}, "
            f"which is no frame of the pyramid {sorted(ctx['frames'])}")
    return fr


def _extend_source(x, src_sh: bool, h_s: int, ls_local: int, mesh):
    """A source frame extended by ``h_s`` rows a side around this rank's
    span of ``ls_local`` rows: exchanged where the source is sharded, else
    sliced from the whole (zero-padded) source."""
    from crfconv_tpu_torch.parallel.spatial import exchange_halo

    if src_sh:
        return exchange_halo(x, h_s, mesh)
    xp = F.pad(x, (0,) * (2 * (x.dim() - 2)) + (h_s, h_s))
    start = mesh.rank * ls_local
    return xp[:, start:start + ls_local + 2 * h_s]


def _plan(ctx, x_len: int, idx_len: int, tile: int, pad: int, what: str):
    """(src_sh, ns_g, tgt_sh, nt_g, h_t, h_s, ls_local, feasible) of a
    gather from a frame of length ``x_len`` into one of ``idx_len`` rows on
    this rank."""
    ndev = ctx["points"].world
    src_sh, ns_g = _frame(ctx, x_len, what + " source")
    tgt_sh, nt_g = _frame(ctx, idx_len, what + " target")
    h_t, h_s = _halo_pair(nt_g, ns_g, tile, pad)
    ls_local = ns_g // ndev
    feasible = (tgt_sh and h_t <= idx_len and ns_g % ndev == 0
                and (not src_sh or h_s <= ls_local))
    return src_sh, ns_g, tgt_sh, nt_g, h_t, h_s, ls_local, feasible


def spatial_gather(x: torch.Tensor, idx: torch.Tensor, mode):
    """The windowed gather of a point-sharded step: x [B, Ls, F] and idx
    [B, Lt, K] (global source indices) as this rank holds them ->
    [B, Lt, K, F], this rank's rows of the unsharded gather."""
    from crfconv_tpu_torch.ops.windowed import windowed_gather
    from crfconv_tpu_torch.parallel.spatial import rebase

    ctx = spatial_state.point_ctx()
    mesh = ctx["points"]
    tile, pad = mode.tile, mode.pad
    src_sh, _, tgt_sh, _, h_t, h_s, ls_local, feasible = _plan(
        ctx, x.shape[1], idx.shape[1], tile, pad, "gather")
    with spatial_state.suspend():
        if not tgt_sh:
            if src_sh:   # a replicated target of a sharded source
                x = _all_gather_replicated(x, mesh)
            return windowed_gather(x, idx, tile, pad)
        lt = idx.shape[1]
        if not feasible:
            # the whole operation on every rank (tiny coarse scales only)
            if src_sh:
                x = _all_gather_replicated(x, mesh)
            out = windowed_gather(x, all_gather_points(idx, mesh), tile, pad)
            return out[:, mesh.rank * lt:(mesh.rank + 1) * lt]
        x_e = _extend_source(x, src_sh, h_s, ls_local, mesh)
        idx_e = rebase(idx, h_t, mesh, ls_local, h_s)
        return windowed_gather(x_e, idx_e, tile, pad)[:, h_t:-h_t]


def spatial_point_conv_fused(x, pos, sub_pos, idx, extra, folded, mode):
    """The eval-mode fused point conv (K3, or K5 with its residual rider
    where ``extra`` is given) of a point-sharded forward: exchange -> the
    kernel on the extended frame -> trim. Returns its output (and the
    pooled rider) in this rank's rows, or None where the halo is
    infeasible (the caller takes the unfused gathers)."""
    from crfconv_tpu_torch.ops.conv import (
        point_conv_fused_infer, point_conv_fused_strided,
    )
    from crfconv_tpu_torch.parallel.spatial import exchange_halo, rebase

    ctx = spatial_state.point_ctx()
    mesh = ctx["points"]
    tile, pad = mode.tile, mode.pad
    w0, a0, c0, w1, a1, c1 = folded
    src_sh, _, tgt_sh, _, h_t, h_s, ls_local, feasible = _plan(
        ctx, x.shape[1], idx.shape[1], tile, pad, "fused conv")

    def run(x_, pos_, sub_pos_, idx_, extra_):
        if extra_ is None:
            return point_conv_fused_infer(x_.contiguous(), pos_, idx_, w0,
                                          a0, c0, w1, a1, c1, tile, pad)
        return point_conv_fused_strided(
            x_.contiguous(), pos_, sub_pos_, idx_, extra_.contiguous(), w0,
            a0, c0, w1, a1, c1, tile, pad)

    with spatial_state.suspend():
        if not tgt_sh:
            if src_sh:
                x = _all_gather_replicated(x, mesh)
                pos = _all_gather_replicated(pos, mesh)
                if extra is not None:
                    extra = _all_gather_replicated(extra, mesh)
            return run(x, pos, sub_pos, idx, extra)
        if not feasible:
            return None
        ext = lambda a: _extend_source(a, src_sh, h_s, ls_local, mesh)
        idx_e = rebase(idx, h_t, mesh, ls_local, h_s)
        sub_e = None if sub_pos is None else exchange_halo(sub_pos, h_t, mesh)
        out = run(ext(x), ext(pos).contiguous(), sub_e, idx_e,
                  None if extra is None else ext(extra))
        if extra is None:
            return out[:, h_t:-h_t]
        o, r = out
        return o[:, h_t:-h_t], r[:, h_t:-h_t]


def spatial_crf_similarity(y, z, idx, mode):
    """The fused CRF similarity and first message (K4) of a point-sharded
    forward: exchange -> the kernel on the extended frame -> trim.
    Same-scale (h_t = h_s). Returns (msg, s) in this rank's rows, or None
    where the halo is infeasible."""
    from crfconv_tpu_torch.ops.crf_sim import crf_similarity_message
    from crfconv_tpu_torch.parallel.spatial import exchange_halo, rebase

    ctx = spatial_state.point_ctx()
    mesh = ctx["points"]
    tile, pad = mode.tile, mode.pad
    sh, n_g = _frame(ctx, y.shape[1], "CRF similarity")
    with spatial_state.suspend():
        if not sh:
            return crf_similarity_message(y.contiguous(), z.contiguous(), idx,
                                          tile, pad)
        local = y.shape[1]
        h, _ = _halo_pair(n_g, n_g, tile, pad)
        if h > local or n_g % mesh.world:
            return None
        y_e = exchange_halo(y.contiguous(), h, mesh)
        z_e = exchange_halo(z.contiguous(), h, mesh)
        idx_e = rebase(idx, h, mesh, local, h)
        msg, s = crf_similarity_message(y_e, z_e, idx_e, tile, pad)
        return msg[:, h:-h], s[:, h:-h]


def _local_chunk_plan(ctx, n: int, steps: int, mode, what: str):
    from crfconv_tpu_torch.parallel.spatial import _chunk_plan

    j, h = _chunk_plan(steps, n, mode.tile, mode.pad)
    if h > n:
        raise ValueError(
            f"the point-sharded {what}'s halo of {h} rows exceeds the span "
            f"of {n}: the sharding policy should have replicated this scale")
    return j, h


def crf_mean_field_ctx(z, s, neighbor_idx, c, steps: int, mode):
    """``ops/crf.py::crf_mean_field`` under a point-sharded context: the
    chunked halo iteration on a sharded frame, the unsharded iteration on a
    replicated one."""
    from crfconv_tpu_torch.ops.crf import crf_mean_field
    from crfconv_tpu_torch.parallel.spatial import _crf_local_chunks

    ctx = spatial_state.point_ctx()
    sharded, _ = _frame(ctx, z.shape[1], "CRF state")
    if not sharded:
        with spatial_state.suspend():
            return crf_mean_field(z, s, neighbor_idx, c, steps, mode)
    j, h = _local_chunk_plan(ctx, z.shape[1], steps, mode, "CRF")
    return _crf_local_chunks(z, s, neighbor_idx, c, steps=steps, j=j, h=h,
                             mesh=ctx["points"], mode=mode)


def discrete_crf_update_ctx(p, unary, w, neighbor_idx, compat, steps: int,
                            mode):
    """``ops/crf.py::discrete_crf_update`` under a point-sharded context
    (its mask already applied to w)."""
    from crfconv_tpu_torch.ops.crf import discrete_crf_update
    from crfconv_tpu_torch.parallel.spatial import _discrete_local_chunks

    ctx = spatial_state.point_ctx()
    fr = ctx["frames"].get(p.shape[1])
    if fr is None or not fr[0]:
        with spatial_state.suspend():
            return discrete_crf_update(p, unary, w, neighbor_idx, compat,
                                       steps, mode)
    j, h = _local_chunk_plan(ctx, p.shape[1], steps, mode, "discrete CRF")
    return _discrete_local_chunks(p, unary, w, neighbor_idx, compat,
                                  steps=steps, j=j, h=h, mesh=ctx["points"],
                                  mode=mode)


# ---------------------------------------------------------------------------
# the policy and the entry points
# ---------------------------------------------------------------------------


def _point_axis_lengths(obj) -> set:
    """The point-axis lengths (dim 1 of every tensor or array of two or
    more dimensions) in a batch, a nested tuple, list or dict of them, or
    the lengths themselves (ints)."""
    if obj is None:
        return set()
    if isinstance(obj, int):
        return {obj}
    if hasattr(obj, "shape") and hasattr(obj, "ndim"):
        return {int(obj.shape[1])} if obj.ndim >= 2 else set()
    if isinstance(obj, dict):
        obj = obj.values()
    out = set()
    for v in obj:
        out |= _point_axis_lengths(v)
    return out


def choose_sharded_scales(batch, ndev: int, tile: int, pad: int) -> set:
    """The longest prefix of the point-axis lengths (descending) that can
    be sharded over ``ndev`` ranks: each span a multiple of the tile and at
    least one same-scale halo, and no span equal to another frame's length
    on a rank (the frame table is keyed by the lengths the operations
    see)."""
    lens = sorted(_point_axis_lengths(batch), reverse=True)
    h_same = same_scale_halo(tile, pad)

    def eligible(n):
        return (n % ndev == 0 and (n // ndev) % tile == 0
                and n // ndev >= h_same)

    for cut in range(len(lens), -1, -1):
        sharded = set(lens[:cut])
        if not all(eligible(n) for n in sharded):
            continue
        keys = [n // ndev for n in sharded] + [
            n for n in lens if n not in sharded]
        if len(keys) == len(set(keys)):
            return sharded
    return set()


def frames_of(lengths, sharded, ndev: int) -> dict:
    """{length on a rank: (sharded, global length)}."""
    return {(n // ndev if n in sharded else n): (n in sharded, n)
            for n in lengths}


def spatial_context(mesh, frames: dict) -> dict:
    """The frame context (``ops/spatial_state.py``) of a point-sharded step
    over ``mesh``: a point group's Mesh, or a SpatialMesh (batch x points)."""
    from crfconv_tpu_torch.parallel.sharding import SpatialMesh

    if isinstance(mesh, SpatialMesh):
        return {"data": mesh.world, "frames": frames, "points": mesh.points,
                "stats": mesh.world if mesh.data is not None
                else mesh.points, "batch": mesh.data}
    return {"data": mesh, "frames": frames, "points": mesh, "stats": mesh,
            "batch": None}


def _check_mode(mode, what: str):
    from crfconv_tpu_torch.ops.neighbors import NeighborMode

    mode = NeighborMode("windowed") if mode is None else mode
    if not mode.windowed:
        raise ValueError(f"{what} needs the windowed neighbour regime")
    return mode


def make_spatial_forward(model, mesh, example_batch, mode=None):
    """A point-sharded eval forward of an unmodified model over ``mesh`` (a
    point group's Mesh, or a SpatialMesh).

    ``example_batch`` is the global batch (or the set of its point-axis
    lengths): the sharded scales follow :func:`choose_sharded_scales` on
    it. Returns ``(fn, info)``: ``fn(batch)`` runs ``model(batch, mode)``
    in eval mode without gradients on this rank's part of a batch
    (``shard_points``, ``build_pyramid_windowed_spatial``) with every
    windowed operation halo-exchanged, and returns this rank's rows of the
    output; ``info`` names the sharded and replicated scales. Every rank of
    the point group must call ``fn`` together."""
    from crfconv_tpu_torch.parallel.sharding import point_mesh

    mode = _check_mode(mode, "the point-sharded forward")
    pts = point_mesh(mesh)
    lengths = _point_axis_lengths(example_batch)
    sharded = choose_sharded_scales(lengths, pts.world, mode.tile, mode.pad)
    ctx = spatial_context(mesh, frames_of(lengths, sharded, pts.world))

    def fn(batch):
        model.eval()
        with torch.inference_mode(), spatial_state.activate(ctx):
            return model(batch, mode)

    fn.context = ctx
    info = {
        "sharded_scales": sorted(sharded, reverse=True),
        "replicated_scales": sorted(lengths - sharded, reverse=True),
        "same_scale_halo": same_scale_halo(mode.tile, mode.pad),
    }
    return fn, info


def forward_spatial(model, batch, mesh, mode=None):
    """One point-sharded forward of a global ``batch``: this rank's part of
    it through :func:`make_spatial_forward`, the output gathered whole on
    every rank of the point group (a tensor, or a tuple of them)."""
    from crfconv_tpu_torch.parallel.sharding import point_mesh, shard_points

    mode = _check_mode(mode, "the point-sharded forward")
    fn, info = make_spatial_forward(model, mesh, batch, mode)
    out = fn(shard_points(batch, mesh, set(info["sharded_scales"]),
                          mode.tile, mode.pad))
    n = int(batch.x.shape[1])
    pts = point_mesh(mesh)

    def whole(t):
        return all_gather_points(t, pts) if n in info["sharded_scales"] else t

    return tuple(map(whole, out)) if isinstance(out, tuple) else whole(out)
