"""Continuous Gaussian CRF mean-field math on dense neighbourhoods.

Counterpart of ``crfconv_tpu/ops/crf.py``: given unary features z and a
Gaussian similarity s over K neighbours, iterate

    x <- (z + (S x) C)(I + C)^-1,   C = c^T c.

In the windowed regime at steps >= 2 :func:`crf_mean_field` runs the fused
core (``ops/crf_core.py``: kernels K9-K12 on CUDA tensors, their plain
versions on CPU tensors), as the JAX package dispatches to its fused Pallas
kernels; every other case runs the scan here, differentiable by autograd.
At steps = 1 the first message comes from the fused similarity kernel
(``msg0``, serving) or from the gathered neighbours (``neighbors0``), and
no iteration is left.
"""

from __future__ import annotations

from typing import Optional

import torch

from crfconv_tpu_torch.ops.crf_core import compat_products, crf_core
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
) -> torch.Tensor:
    """``steps`` mean-field iterations from x = z.

    ``neighbors0`` ([B, N, K, H]) are the pre-gathered neighbours of z;
    ``msg0`` ([B, N, H]) is the pre-reduced first message sum_k s_k z_j.
    Either saves the scan's first gather. The fused core (windowed, steps
    >= 2) recomputes every message from (s, idx) and ignores both, as the
    JAX package's fused path does.
    """
    if mode.windowed and steps >= 2:
        _, inv, M = compat_products(c)
        zp = z @ inv.to(z.dtype)
        return crf_core(z, zp, s, neighbor_idx, M.to(z.dtype), steps,
                        mode.tile, mode.pad)
    C, inv, _ = compat_products(c)
    C = C.to(z.dtype)
    inv = inv.to(z.dtype)

    def apply(msg):
        return (z + msg @ C) @ inv

    def update(neigh):
        return apply(torch.einsum("bnk,bnkh->bnh", s, neigh))

    x = z
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
