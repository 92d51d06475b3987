"""Continuous Gaussian CRF decoder block.

Counterpart of ``crfconv_tpu/models/crf_conv.py::ContinuousCRFConv``: unary
MLP on coarse features, pairwise MLP on skip features, 1-NN upsample,
Gaussian similarity over the K spatial neighbours, the mean-field loop
with C = c^T c, then an output MLP and concat-fusion with the skip
features.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from crfconv_tpu_torch.models.common import MLP, leaky_relu01
from crfconv_tpu_torch.ops.crf import crf_mean_field, gaussian_similarity
from crfconv_tpu_torch.ops.crf_sim import crf_similarity_message, sim_eligible
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, remove_self_loop, upsample_nearest,
)


class ContinuousCRFConv(nn.Module):
    """Dense continuous Gaussian CRF decoder (the framework's core op)."""

    def __init__(
        self, unary_features: int, pairwise_features: int,
        out_features: int, steps: int = 1, device=None,
    ):
        super().__init__()
        hidden = out_features // 4
        self.hidden = hidden
        self.steps = steps
        self.unary_nn_0 = MLP(unary_features, hidden, leaky_relu01, device=device)
        self.unary_nn_1 = MLP(hidden, hidden, None, device=device)
        self.pairwise_nn_0 = MLP(
            pairwise_features, hidden, leaky_relu01, device=device
        )
        self.pairwise_nn_1 = MLP(hidden, hidden, None, device=device)
        self.c = nn.Parameter(torch.eye(hidden, device=device))
        self.out_nn = MLP(hidden, out_features, leaky_relu01, device=device)
        self.fusion_nn = MLP(
            out_features + pairwise_features, out_features, leaky_relu01,
            device=device,
        )

    def forward(
        self,
        unary: torch.Tensor,         # [B, S, F_unary] coarse features
        pairwise: torch.Tensor,      # [B, N, F_pair] skip features
        up_idx: torch.Tensor,        # [B, N, 1]
        neighbor_idx: torch.Tensor,  # [B, N, K] self-inclusive kNN
        mode: NeighborMode,
    ) -> torch.Tensor:
        nidx = remove_self_loop(neighbor_idx)
        x = self.unary_nn_1(self.unary_nn_0(unary))
        y = self.pairwise_nn_1(self.pairwise_nn_0(pairwise))
        x = upsample_nearest(x, up_idx[..., :1], mode)       # [B, N, hidden]

        if sim_eligible(self.training, self.hidden, nidx.shape[1],
                        mode.windowed):
            # fused setup: similarity softmax and first message in one pass
            msg0, s = crf_similarity_message(
                y.contiguous(), x.contiguous(), nidx, mode.tile, mode.pad
            )
            x = crf_mean_field(x, s, nidx, self.c, self.steps, mode, msg0=msg0)
        else:
            # one gather of [y, z]: guidance and first message share indices
            g = gather_neighbors(torch.cat([y, x], dim=-1), nidx, mode)
            yn, zn = g[..., : self.hidden], g[..., self.hidden:]
            s = gaussian_similarity(y, nidx, mode, neighbors=yn)
            x = crf_mean_field(
                x, s, nidx, self.c, self.steps, mode, neighbors0=zn
            )

        x = self.out_nn(x)
        return self.fusion_nn(torch.cat([x, pairwise], dim=-1))
