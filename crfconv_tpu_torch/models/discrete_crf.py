"""Discrete CRF head over class probabilities (CRF-as-RNN).

Counterpart of ``crfconv_tpu/models/discrete_crf.py`` (reference
models/discrete_crf_conv.py): ``NUM_KERNELS`` learned Gaussian kernels over
the input features give edge weights w_ij = sum_k W_k exp(-|e_ik - e_jk|^2)
with e_ik = f_i F_k; neighbours farther than ``RADIUS`` are masked, and the
mean field q <- softmax(-u - (sum_j w_ij q_j) C) runs from q = p with
u = -log p and the label compatibility C (the identity at first). The
edge weights are plain PyTorch, as the JAX package computes them in XLA;
the loop is ``ops/crf.py::discrete_crf_update``. An optional point-validity
mask ([B, N], bool) drops the edges from and to invalid points. Parameter
names follow the flax tree (``F``, ``W``, ``C``; ``convert.from_flax``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from crfconv_tpu_torch.ops.crf import discrete_crf_update
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, remove_self_loop,
)

# the kernels' count and embedding width, and the neighbourhood's radius,
# as every net of the JAX package builds the head
NUM_KERNELS = 5
HIDDEN_FEATURES = 64
RADIUS = 0.2


class DiscreteCRFConv(nn.Module):
    """The discrete CRF over L classes guided by D-wide raw features."""

    def __init__(self, n_classes: int, feat_features: int, steps: int,
                 device=None):
        super().__init__()
        self.steps = steps
        self.F = nn.Parameter(torch.empty(
            NUM_KERNELS, feat_features, HIDDEN_FEATURES, device=device))
        self.W = nn.Parameter(torch.empty(NUM_KERNELS, 1, device=device))
        self.C = nn.Parameter(torch.empty(n_classes, n_classes, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """F ~ U[0, 1) drawn on the CPU from ``generator`` (flax's
        ``uniform(scale=1)``), W = 1 / NUM_KERNELS, C = I."""
        self.F.copy_(torch.rand(self.F.shape, generator=generator))
        self.W.fill_(1.0 / self.W.shape[0])
        self.C.copy_(torch.eye(self.C.shape[0]))

    def forward(
        self,
        pos: torch.Tensor,             # [B, N, 3]
        p: torch.Tensor,               # [B, N, L] input probabilities
        f: torch.Tensor,               # [B, N, D] raw guidance features
        neighbor_idx: torch.Tensor,    # [B, N, K] self-inclusive kNN
        mode: NeighborMode,
        mask: Optional[torch.Tensor] = None,   # [B, N] point validity
    ) -> torch.Tensor:
        nidx = remove_self_loop(neighbor_idx)
        u = -torch.log(torch.clamp(p, min=1e-12))
        B, N = p.shape[:2]
        kk, _, hh = self.F.shape
        emb = torch.einsum("bnd,kdh->bnkh", f, self.F)        # [B, N, Kk, H]
        flat = emb.reshape(B, N, kk * hh).contiguous()
        emb_n = gather_neighbors(flat, nidx, mode)            # [B, N, Kn, KkH]
        diff = emb[:, :, None] - emb_n.reshape(B, N, -1, kk, hh)
        w = torch.exp(-(diff * diff).sum(dim=-1))             # [B, N, Kn, Kk]
        del emb_n, diff
        w = (w @ self.W)[..., 0]                              # [B, N, Kn]
        npos = gather_neighbors(pos, nidx, mode)
        d2 = (pos[:, :, None, :] - npos).square().sum(dim=-1)
        nmask = d2 <= RADIUS * RADIUS
        if mask is not None:
            valid_n = gather_neighbors(mask.to(pos.dtype)[..., None], nidx,
                                       mode)[..., 0] != 0
            nmask = nmask & valid_n & mask[:, :, None]
        return discrete_crf_update(
            p, u, w, nidx, self.C, self.steps, mode, mask=nmask,
        )
