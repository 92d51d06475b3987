"""CRF mean-field math on dense neighbourhoods.

Counterpart of ``crfconv_tpu/ops/crf.py``. The continuous Gaussian CRF:
given unary features z and a Gaussian similarity s over K neighbours,
iterate

    x <- (z + (S x) C)(I + C)^-1,   C = c^T c.

In the windowed regime at steps >= 2 :func:`crf_mean_field` runs the fused
core (``ops/crf_core.py``: kernels K9-K12 on CUDA tensors, their plain
versions on CPU tensors), as the JAX package dispatches to its fused Pallas
kernels; every other case runs the scan here, differentiable by autograd.
At steps = 1 the first message comes from the fused similarity kernel
(``msg0``, serving) or from the gathered neighbours (``neighbors0``), and
no iteration is left.

The discrete CRF (CRF-as-RNN over class probabilities),
:func:`discrete_crf_update`, iterates q <- softmax(-u - (sum_j w_ij q_j) C)
the same way: the fused core (``ops/discrete_core.py``, kernels K9, K12,
K13 and K14) in the windowed regime at steps >= 2, else the scan here.
"""

from __future__ import annotations

from typing import Optional

import torch

from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops._launch import widen
from crfconv_tpu_torch.ops.crf_core import compat_products, crf_core
from crfconv_tpu_torch.ops.discrete_core import discrete_core
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, masked_softmax,
)


def gaussian_similarity(
    y: torch.Tensor,
    neighbor_idx: torch.Tensor,
    mode: NeighborMode,
    mask: Optional[torch.Tensor] = None,
    neighbors: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax_K(-|y_i - y_j|^2): y [B, N, H], neighbor_idx [B, N, K]
    (self removed), optional validity mask [B, N, K] -> [B, N, K]; masked
    slots get 0, a fully masked row is all zeros."""
    if neighbors is None:
        neighbors = gather_neighbors(y, neighbor_idx, mode)
    d = y[:, :, None, :] - neighbors
    return masked_softmax(-(d * d).sum(dim=-1), mask, dim=2)


def crf_mean_field(
    z: torch.Tensor,
    s: torch.Tensor,
    neighbor_idx: torch.Tensor,
    c: torch.Tensor,
    steps: int,
    mode: NeighborMode,
    neighbors0: Optional[torch.Tensor] = None,
    msg0: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``steps`` mean-field iterations from x = z, or from ``x0`` where it
    is given (the unary stays z: a chunk of the halo-exchanged iteration,
    ``parallel/spatial.py``, restarts from the state it was handed).

    ``neighbors0`` ([B, N, K, H]) are the pre-gathered neighbours of z;
    ``msg0`` ([B, N, H]) is the pre-reduced first message sum_k s_k z_j.
    Either saves the scan's first gather. The fused core (windowed, steps
    >= 2) recomputes every message from (s, idx) and ignores both, as the
    JAX package's fused path does. Under a point-sharded step
    (``ops/spatial_state.py``) the iteration runs in halo-exchanged chunks
    on this rank's rows (``parallel/spatial_forward.py``), which drop both.
    """
    if mode.windowed and spatial_state.point_ctx() is not None:
        from crfconv_tpu_torch.parallel.spatial_forward import (
            crf_mean_field_ctx,
        )

        return crf_mean_field_ctx(z, s, neighbor_idx, c, steps, mode)
    if mode.windowed and steps >= 2:
        # the fused core runs in at least float32 (a bfloat16 z is widened,
        # as the JAX package's fused path does) and returns z's dtype
        _, inv, M = compat_products(c)
        zf = widen(z)
        zp = zf @ inv.to(zf.dtype)
        start = zf if x0 is None else widen(x0)
        return crf_core(start, zp, s, neighbor_idx, M.to(zf.dtype), steps,
                        mode.tile, mode.pad).to(z.dtype)
    C, inv, _ = compat_products(c)
    C = C.to(z.dtype)
    inv = inv.to(z.dtype)

    def apply(msg):
        return (z + msg @ C) @ inv

    def update(neigh):
        return apply(torch.einsum("bnk,bnkh->bnh", s, neigh))

    x = z if x0 is None else x0
    remaining = steps
    if msg0 is not None and steps > 0:
        x = apply(msg0.to(z.dtype))
        remaining -= 1
    elif neighbors0 is not None and steps > 0:
        x = update(neighbors0)
        remaining -= 1
    for _ in range(remaining):
        x = update(gather_neighbors(x, neighbor_idx, mode))
    return x


def discrete_crf_update(
    p: torch.Tensor,
    unary: torch.Tensor,
    w: torch.Tensor,
    neighbor_idx: torch.Tensor,
    compat: torch.Tensor,
    steps: int,
    mode: NeighborMode,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``steps`` CRF-as-RNN mean-field iterations from q = p:

        q <- softmax(-u - (sum_j w_ij q_j) C),

    p, unary [B, N, L], edge weights w [B, N, K], neighbor_idx [B, N, K],
    compat C [L, L], optional neighbour validity mask [B, N, K] (masked
    weights are zeroed first) -> q [B, N, L]. The windowed regime at steps
    >= 2 runs the fused core, as the JAX package's dispatch does; under a
    point-sharded step on a sharded frame the iteration runs in
    halo-exchanged chunks on this rank's rows (``parallel/spatial.py``)."""
    if mask is not None:
        w = torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                             device=w.device))
    if mode.windowed and spatial_state.point_ctx() is not None:
        from crfconv_tpu_torch.parallel.spatial_forward import (
            discrete_crf_update_ctx,
        )

        return discrete_crf_update_ctx(p, unary, w, neighbor_idx, compat,
                                       steps, mode)
    if mode.windowed and steps >= 2:
        return discrete_core(p, unary, w, neighbor_idx, compat, steps,
                             mode.tile, mode.pad)
    return _discrete_scan(p, unary, w, neighbor_idx, compat, steps, mode)


def _discrete_scan(p, unary, w, neighbor_idx, compat, steps, mode):
    """The mean-field loop through the neighbour gather, differentiable by
    autograd."""
    q = p
    for _ in range(steps):
        msg = torch.einsum("bnk,bnkl->bnl", w,
                           gather_neighbors(q, neighbor_idx, mode))
        q = torch.softmax(-unary - msg @ compat, dim=-1)
    return q
