"""Continuous Gaussian CRF decoder blocks.

Counterparts of ``crfconv_tpu/models/crf_conv.py``. ``ContinuousCRFConv``
(the flagship's): unary MLP on coarse features, pairwise MLP on skip
features, 1-NN upsample, Gaussian similarity over the K spatial
neighbours, the mean-field loop with C = c^T c, then an output MLP and
concat-fusion with the skip features. ``GuideCRFConv`` (the small
family's): linear + batch-norm unary and pairwise heads, the similarity
with a radius mask, the same loop (both inside the span ``crf``), a
leaky-ReLU output.
``EdgeListContinuousCRFConv``: the reference's edge-list CRF block on one
cloud, its edges padded to dense neighbour lists (``edges_to_padded``); no
model uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from crfconv_tpu_torch.models.common import MLP, leaky_relu001, leaky_relu01
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.crf import crf_mean_field, gaussian_similarity
from crfconv_tpu_torch.ops.crf_sim import crf_similarity_message, sim_eligible
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, remove_self_loop, upsample_nearest,
)
from crfconv_tpu_torch.utils import profiling


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

        sim = None
        if sim_eligible(self.training, self.hidden, nidx.shape[1],
                        mode.windowed):
            if spatial_state.point_ctx() is None:
                # fused setup: similarity softmax and first message in one
                # pass
                sim = crf_similarity_message(
                    y.contiguous(), x.contiguous(), nidx, mode.tile,
                    mode.pad)
            else:
                # point-sharded: the kernel on the halo-extended frame
                # (parallel/spatial_forward.py); its message goes unused by
                # the chunked iteration; None where the halo is infeasible
                from crfconv_tpu_torch.parallel.spatial_forward import (
                    spatial_crf_similarity,
                )

                sim = spatial_crf_similarity(y, x, nidx, mode)
        if sim is not None:
            msg0, s = sim
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


class GuideCRFConv(nn.Module):
    """The small family's continuous CRF on kNN indices, with neighbours
    farther than ``radius`` masked out of the similarity softmax (the
    reference's radius graph). An optional point-validity mask ([B, N],
    bool: padded clouds' padding False) keeps the heads' batch statistics
    to the valid points and masks invalid neighbours out of the softmax,
    as the JAX block does."""

    def __init__(
        self, unary_features: int, pairwise_features: int,
        out_features: int, steps: int, radius: float, device=None,
    ):
        super().__init__()
        self.steps = steps
        self.radius = radius
        self.unary = MLP(unary_features, out_features, None, device=device)
        self.pairwise = MLP(pairwise_features, out_features, leaky_relu001,
                            device=device)
        self.c = nn.Parameter(torch.eye(out_features, device=device))

    def forward(
        self,
        x: torch.Tensor,             # [B, N, F_x] features to refine
        y: torch.Tensor,             # [B, N, F_y] guidance features
        pos: torch.Tensor,           # [B, N, 3]
        neighbor_idx: torch.Tensor,  # [B, N, K] self-inclusive kNN
        mode: NeighborMode,
        mask: Optional[torch.Tensor] = None,  # [B, N] point validity
    ) -> torch.Tensor:
        nidx = remove_self_loop(neighbor_idx)
        xh = self.unary(x, mask)
        yh = self.pairwise(y, mask)
        with profiling.span("crf"):
            npos = gather_neighbors(pos, nidx, mode)
            d2 = (pos[:, :, None, :] - npos).square().sum(dim=-1)
            nmask = d2 <= self.radius * self.radius
            if mask is not None:
                valid_n = gather_neighbors(mask.to(pos.dtype)[..., None],
                                           nidx, mode)[..., 0] > 0.5
                nmask = nmask & valid_n
            s = gaussian_similarity(yh, nidx, mode, mask=nmask)
            x = crf_mean_field(xh, s, nidx, self.c, self.steps, mode)
        return leaky_relu001(x)


def edges_to_padded(
    edge_index: torch.Tensor, num_nodes: int, max_degree: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge list [2, E] (rows: destination i, source j) -> dense neighbour
    lists [num_nodes, max_degree] int32 and their validity mask (bool).

    A destination's edges fill its slots in edge order (a stable sort by
    destination); edges beyond ``max_degree`` are dropped, and empty slots
    hold 0 with the mask False. Destinations must lie in [0, num_nodes).
    """
    i, j = edge_index[0].long(), edge_index[1]
    if i.numel() and (int(i.min()) < 0 or int(i.max()) >= num_nodes):
        raise ValueError(f"edge destinations outside [0, {num_nodes})")
    i_s, order = torch.sort(i, stable=True)
    j_s = j[order].to(torch.int32)
    starts = torch.searchsorted(
        i_s, torch.arange(num_nodes, dtype=i_s.dtype, device=i_s.device))
    rank = torch.arange(i_s.shape[0], device=i_s.device) - starts[i_s]
    keep = rank < max_degree
    slot = (i_s * max_degree + rank)[keep]     # distinct: (i, rank) pairs
    nbr = torch.zeros(num_nodes * max_degree, dtype=torch.int32,
                      device=i_s.device)
    nbr[slot] = j_s[keep]
    mask = torch.zeros(num_nodes * max_degree, dtype=torch.bool,
                       device=i_s.device)
    mask[slot] = True
    return (nbr.reshape(num_nodes, max_degree),
            mask.reshape(num_nodes, max_degree))


class EdgeListContinuousCRFConv(nn.Module):
    """The reference's edge-list continuous Gaussian CRF block on one cloud
    (x [N, C_u] unary input, y [N, C_p] guidance, pos [N, 3] for N,
    edge_index [2, E] of (destination, source) rows): linear + batch-norm
    unary and pairwise heads, the masked similarity and the mean-field loop
    of the exact regime over the padded edges (a batch of one), then an
    output MLP and concat-fusion with y. ``hidden_channels`` defaults to
    ``out_channels // 4``, ``out_channels`` to ``pairwise_channels``. Weights
    are drawn from ``generator`` (default: seeded with 0) with
    torch.nn.Linear's init, batch norms at identity, c at the identity."""

    def __init__(
        self, unary_channels: int, pairwise_channels: int,
        hidden_channels: Optional[int] = None,
        out_channels: Optional[int] = None, steps: int = 1,
        max_degree: int = 32, *, device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        out_c = pairwise_channels if out_channels is None else out_channels
        hidden = out_c // 4 if hidden_channels is None else hidden_channels
        dev = torch.device(device)
        self.unary_channels = unary_channels
        self.pairwise_channels = pairwise_channels
        self.steps = steps
        self.max_degree = max_degree
        self.unary_net = MLP(unary_channels, hidden, None, device=dev)
        self.pairwise_net = MLP(pairwise_channels, hidden, None, device=dev)
        self.c = nn.Parameter(torch.eye(hidden, device=dev))
        self.mlp = MLP(hidden, out_c, leaky_relu001, device=dev)
        self.fusion_net = MLP(out_c + pairwise_channels, out_c,
                              leaky_relu001, device=dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in (self.unary_net, self.pairwise_net, self.mlp,
                  self.fusion_net):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor, pos: torch.Tensor,
                edge_index: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.unary_channels:
            raise ValueError(f"x has {x.shape[-1]} channels, expected "
                             f"{self.unary_channels}")
        if y.shape[-1] != self.pairwise_channels:
            raise ValueError(f"y has {y.shape[-1]} channels, expected "
                             f"{self.pairwise_channels}")
        nbr, mask = edges_to_padded(edge_index, pos.shape[0], self.max_degree)
        exact = NeighborMode("exact")
        xu = self.unary_net(x)[None]
        s_feat = self.pairwise_net(y)[None]
        s = gaussian_similarity(s_feat, nbr[None], exact, mask=mask[None])
        out = crf_mean_field(xu, s, nbr[None], self.c, self.steps, exact)[0]
        out = self.mlp(out)
        return self.fusion_net(torch.cat([out, y], dim=-1))
