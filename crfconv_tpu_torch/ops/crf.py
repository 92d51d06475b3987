"""Continuous Gaussian CRF mean-field math on dense neighbourhoods.

Counterpart of ``crfconv_tpu/ops/crf.py``: given unary features z and a
Gaussian similarity s over K neighbours, iterate

    x <- (z + (S x) C)(I + C)^-1,   C = c^T c.

Only the scan form is here, differentiable by autograd. On the GPU the
model runs at steps=1, where the first message comes from the fused
similarity kernel (``msg0``, serving) or from the gathered neighbours
(``neighbors0``, training) and no iteration is left; steps >= 2 there
needs the fused CRF iterate kernels, which come with a later slice of the
port (ROADMAP.md, slice 4).
"""

from __future__ import annotations

from typing import Optional

import torch

from crfconv_tpu_torch.ops.neighbors import NeighborMode, gather_neighbors


def gaussian_similarity(
    y: torch.Tensor,
    neighbor_idx: torch.Tensor,
    mode: NeighborMode,
    neighbors: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax_K(-|y_i - y_j|^2): y [B, N, H], neighbor_idx [B, N, K]
    (self removed) -> [B, N, K]."""
    if neighbors is None:
        neighbors = gather_neighbors(y, neighbor_idx, mode)
    d = y[:, :, None, :] - neighbors
    return torch.softmax(-(d * d).sum(dim=-1), dim=2)


def _spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a small SPD matrix via Cholesky, in at least float32."""
    m = m.to(torch.promote_types(m.dtype, torch.float32))
    chol = torch.linalg.cholesky_ex(m).L
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    inv_l = torch.linalg.solve_triangular(chol, eye, upper=False)
    return inv_l.T @ inv_l


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
    Either saves the first step's gather.
    """
    if z.is_cuda and steps >= 2:
        raise NotImplementedError(
            "CRF steps >= 2 on the GPU needs the fused CRF iterate kernels "
            "(crf_pallas), which come with slice 4 of the port"
        )
    h = z.shape[-1]
    C = c.T @ c
    inv = _spd_inverse(torch.eye(h, dtype=C.dtype, device=C.device) + C)
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
