"""Halo exchange over a point group, and the point-sharded CRF mean field.

Counterpart of ``crfconv_tpu/parallel/spatial.py``. The JAX package runs
the CRF decoder on each device's span of the points inside one
``shard_map``; here each rank of a point group (``parallel/sharding.py``,
one process a rank) runs the same code on its own span:

  * rank p holds the contiguous span [p * L, (p + 1) * L) of a cloud's
    L * P Morton-sorted rows;
  * one mean-field step reads neighbours only inside a point's candidate
    window (at most one window width of rows either way,
    ``ops/windowed.py::window_starts``), so J steps depend on J widths;
  * before a chunk of J steps the rank takes H = J * width rows (rounded
    up to 128) of state from each neighbour (:func:`exchange_halo`, a
    point-to-point send and receive a side), runs the chunk on the
    extended block [H | L | H] through the same kernels as one process,
    and keeps the center L rows, whose dependency cones stayed inside.

Same-scale window geometry is translation invariant in steps of ``tile``,
so the global neighbour indices, rebased by this rank's offset ``p * L -
H`` and clipped to the block, stay window-consistent there; a kept row's
cone never reaches the outermost halo rows, and the indices never point
outside the cloud, so the zeros at the cloud's two ends are never read.
"""

from __future__ import annotations

from typing import Optional

import torch

from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.windowed import window_starts


def _halo_rows(steps: int, tile: int, pad: int) -> int:
    """The halo of ``steps`` mean-field steps: steps window widths (a width
    does not depend on the length), rounded up to 128 rows."""
    width = window_starts(128, 128, tile, pad)[1]
    return -(-(steps * width) // 128) * 128


def _sendrecv(mesh, to_left: torch.Tensor, to_right: torch.Tensor):
    """Send ``to_left`` to the previous rank of the point group and
    ``to_right`` to the next; returns (from_left, from_right), what they
    sent this way, zeros at the group's two ends. Every rank's two tensors
    have one shape. Under gloo the rows pass through the host."""
    import torch.distributed as dist

    p, n = mesh.rank, mesh.world
    dev = to_left.device
    host = mesh.backend == "gloo" and dev.type != "cpu"

    def staged(t):
        t = t.contiguous()
        return t.cpu() if host else t

    to_left, to_right = staged(to_left), staged(to_right)
    from_left = torch.zeros_like(to_right)
    from_right = torch.zeros_like(to_left)
    ops = []
    if p > 0:
        peer = mesh.global_rank(p - 1)
        ops += [dist.P2POp(dist.isend, to_left, peer, mesh.group),
                dist.P2POp(dist.irecv, from_left, peer, mesh.group)]
    if p < n - 1:
        peer = mesh.global_rank(p + 1)
        ops += [dist.P2POp(dist.isend, to_right, peer, mesh.group),
                dist.P2POp(dist.irecv, from_right, peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left.to(dev), from_right.to(dev)


def _exchange(x: torch.Tensor, h: int, mesh) -> torch.Tensor:
    if mesh.world == 1:
        zero = x.new_zeros((x.shape[0], h) + tuple(x.shape[2:]))
        return torch.cat([zero, x, zero], dim=1)
    left, right = _sendrecv(mesh, x[:, :h], x[:, -h:])
    return torch.cat([left, x, right], dim=1)


class _ExchangeHalo(torch.autograd.Function):
    """The halo exchange and its transpose: each halo's cotangent goes back
    to the rank that owns its rows and is added into them."""

    @staticmethod
    def forward(ctx, x, h, mesh):
        ctx.h, ctx.mesh = h, mesh
        return _exchange(x, h, mesh)

    @staticmethod
    def backward(ctx, g):
        h, mesh = ctx.h, ctx.mesh
        dx = g[:, h:-h].clone()
        if mesh.world > 1:
            from_left, from_right = _sendrecv(mesh, g[:, :h], g[:, -h:])
            dx[:, :h] += from_left
            dx[:, -h:] += from_right
        return dx, None, None


def exchange_halo(x: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """This rank's rows [B, L, ...] -> [B, h + L + h, ...]: the previous
    rank's last h rows, the rows, the next rank's first h rows (zeros past
    the group's ends; a group of one pads with zeros). ``h`` <= L.
    Differentiable in x (the backward sends each halo's gradient back to
    its owner, where it is added)."""
    if not 0 < h <= x.shape[1]:
        raise ValueError(f"halo {h} outside (0, {x.shape[1]}] rows")
    if torch.is_grad_enabled() and x.requires_grad:
        return _ExchangeHalo.apply(x, h, mesh)
    return _exchange(x, h, mesh)


def rebase(idx_l, h: int, mesh, n_src_local: int,
           h_src: int) -> torch.Tensor:
    """Global source indices of this rank's rows, halo-exchanged by ``h``
    rows and rebased onto a source block of ``n_src_local + 2 h_src`` rows
    that starts at global row ``rank * n_src_local - h_src``, clipped into
    it."""
    offset = mesh.rank * n_src_local - h_src
    e = exchange_halo(idx_l, h, mesh).long() - offset
    return e.clamp(0, n_src_local + 2 * h_src - 1).to(torch.int32)


def _chunk_plan(steps: int, local: int, tile: int, pad: int,
                halo_steps: Optional[int] = None):
    """(j, h): the steps a chunk takes and its halo; the largest j (at
    most ``halo_steps``, default ``steps``) whose two halos fit inside the
    span."""
    j = steps if halo_steps is None else halo_steps
    while j > 1 and 2 * _halo_rows(j, tile, pad) >= local:
        j -= 1
    return j, _halo_rows(j, tile, pad)


def _crf_local_chunks(z_l, s_l, idx_l, c, *, steps, j, h, mesh, mode):
    """The continuous CRF on this rank's span in chunks of ``j`` steps:
    exchange h rows of state, run the chunk on [h | L | h] (the unary
    stays the exchanged z, the chunk restarts from the current state),
    keep the center L rows."""
    from crfconv_tpu_torch.ops.crf import crf_mean_field

    local = z_l.shape[1]
    z_e = exchange_halo(z_l, h, mesh)
    s_e = exchange_halo(s_l, h, mesh)
    idx_e = rebase(idx_l, h, mesh, local, h)
    x_e = z_e
    done = 0
    with spatial_state.suspend():
        while done < steps:
            take = min(j, steps - done)
            if done:
                x_e = exchange_halo(x_e[:, h:-h], h, mesh)
            x_e = crf_mean_field(z_e, s_e, idx_e, c, take, mode,
                                 x0=x_e if done else None)
            done += take
    return x_e[:, h:-h]


def _discrete_local_chunks(p_l, u_l, w_l, idx_l, compat, *, steps, j, h,
                           mesh, mode):
    """The discrete CRF (CRF-as-RNN) on this rank's span in chunks, as
    :func:`_crf_local_chunks` (one step reaches one window width)."""
    from crfconv_tpu_torch.ops.crf import discrete_crf_update

    local = p_l.shape[1]
    u_e = exchange_halo(u_l, h, mesh)
    w_e = exchange_halo(w_l, h, mesh)
    idx_e = rebase(idx_l, h, mesh, local, h)
    q_e = exchange_halo(p_l, h, mesh)
    done = 0
    with spatial_state.suspend():
        while done < steps:
            take = min(j, steps - done)
            if done:
                q_e = exchange_halo(q_e[:, h:-h], h, mesh)
            q_e = discrete_crf_update(q_e, u_e, w_e, idx_e, compat, take,
                                      mode)
            done += take
    return q_e[:, h:-h]


def crf_mean_field_spatial(
    z: torch.Tensor,
    s: torch.Tensor,
    neighbor_idx: torch.Tensor,
    c: torch.Tensor,
    mesh,
    steps: int = 1,
    mode=None,
    halo_steps: Optional[int] = None,
) -> torch.Tensor:
    """The continuous CRF mean field (``ops/crf.py::crf_mean_field``) of a
    point-sharded cloud: z [B, L, H], s [B, L, K] and neighbor_idx
    [B, L, K] (global indices into the cloud's L * P rows) are this rank's
    span of the point group ``mesh``; returns x, this rank's span.

    ``halo_steps`` chunks the iteration: the halos are exchanged every J
    steps, H = J * width rows, trading messages for redundant work at the
    span's ends. Default: one chunk where two halos fit in the span, else
    the largest J that does.
    """
    from crfconv_tpu_torch.ops.neighbors import NeighborMode
    from crfconv_tpu_torch.parallel.sharding import point_mesh

    mesh = point_mesh(mesh)
    mode = NeighborMode("windowed") if mode is None else mode
    local = z.shape[1]
    if local % mode.tile:
        raise ValueError(f"the span of {local} rows is not a multiple of "
                         f"the tile {mode.tile}")
    j, h = _chunk_plan(steps, local, mode.tile, mode.pad, halo_steps)
    if 2 * h >= local:
        raise ValueError(f"a halo of {h} rows twice exceeds the span of "
                         f"{local}: more points a rank, or fewer halo steps")
    return _crf_local_chunks(z, s, neighbor_idx, c, steps=steps, j=j, h=h,
                             mesh=mesh, mode=mode)
