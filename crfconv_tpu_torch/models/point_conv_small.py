"""Depthwise-separable point-conv family (the reference's "small" models).

Counterpart of ``crfconv_tpu/models/point_conv_small.py``: a 5-stage
``DSPointConv`` encoder over the same index pyramid as the flagship, and two
decoders, k-NN interpolation with plain linear layers (``SmallBaselineNet``)
or with a continuous CRF after each interpolation (``SmallCRFNet``).
Module names follow the flax tree (``convert.from_flax``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models.common import MLP, leaky_relu001
from crfconv_tpu_torch.models.crf_conv import GuideCRFConv
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, knn_interpolate,
)

CHANNELS = (32, 64, 128, 256, 512)
# (scale, channels) of the four decoder stages, coarse to fine
DECODER = ((4, 256), (3, 128), (2, 64), (1, 32))
# the reference's radius graph (r = 0.2), as kNN + a radius mask
RADIUS = 0.2


class DSPointConv(nn.Module):
    """Depthwise-separable point convolution: an MLP on the relative
    positions gives depthwise weights, the messages w * h_j are summed over
    the K neighbours, pointwise MLPs before and after, and a residual that
    is max-pooled over the neighbourhood in the strided case."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        hidden = features // 4
        self.hidden = hidden
        self.mlp2 = MLP(in_features, hidden, leaky_relu001, device=device)
        self.mlp4 = (
            MLP(in_features, features, None, device=device)
            if in_features != features else None
        )
        self.mlp1_0 = MLP(3, hidden, leaky_relu001, device=device)
        self.mlp1_1 = MLP(hidden, hidden, None, device=device)
        self.mlp3 = MLP(hidden, features, None, device=device)

    def forward(
        self,
        x: torch.Tensor,                # [B, N, F_in]
        pos: torch.Tensor,              # [B, N, 3]
        neighbor_idx: torch.Tensor,     # [B, M, K] self-inclusive kNN
        mode: NeighborMode,
        sub_pos: Optional[torch.Tensor] = None,   # [B, M, 3] if strided
    ) -> torch.Tensor:
        h = self.mlp2(x)
        # one gather of [pos, h] (+ x for the strided residual pool)
        parts = [pos, h] if sub_pos is None else [pos, h, x]
        g = gather_neighbors(torch.cat(parts, dim=-1), neighbor_idx, mode)
        hn = g[..., 3 : 3 + self.hidden]
        residual = x if sub_pos is None else g[..., 3 + self.hidden:].amax(2)
        if self.mlp4 is not None:
            residual = self.mlp4(residual)
        center = pos if sub_pos is None else sub_pos
        rel = center[:, :, None, :] - g[..., :3]
        w = self.mlp1_1(self.mlp1_0(rel))
        h = self.mlp3((w * hn).sum(dim=2))
        return leaky_relu001(h + residual)


class SmallEncoder(nn.Module):
    """Five stages of two DSPointConvs (the first strided from the second
    stage on); returns the features of every scale, 32 to 512 channels."""

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        cin = in_channels
        for stage, ch in enumerate(CHANNELS):
            setattr(self, f"conv{stage + 1}_1", DSPointConv(cin, ch, device))
            setattr(self, f"conv{stage + 1}_2", DSPointConv(ch, ch, device))
            cin = ch

    def forward(self, batch: PointBatch, mode: NeighborMode
                ) -> Tuple[torch.Tensor, ...]:
        ms = batch.scales
        feats = []
        x = batch.x
        for stage in range(len(CHANNELS)):
            c1 = getattr(self, f"conv{stage + 1}_1")
            c2 = getattr(self, f"conv{stage + 1}_2")
            if stage == 0:
                x = c1(x, ms[0].pos, ms[0].neighbor_idx, mode)
            else:
                s = stage - 1
                x = c1(x, ms[s].pos, ms[s].sub_idx, mode,
                       sub_pos=ms[stage].pos)
            x = c2(x, ms[stage].pos, ms[stage].neighbor_idx, mode)
            feats.append(x)
        return tuple(feats)


class SmallBaselineNet(nn.Module):
    """Encoder + k-NN interpolation and linear decoder; [B, N, 64]
    (decoder 32 concatenated with the finest encoder features)."""

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        self.encoder = SmallEncoder(in_channels, device)
        cin = CHANNELS[-1]
        for i, ch in DECODER:
            setattr(self, f"lin{i}", MLP(cin, ch, leaky_relu001, device=device))
            if i > 1:
                setattr(self, f"fusion{i - 1}",
                        MLP(ch + CHANNELS[i - 1], ch, leaky_relu001,
                            device=device))
            cin = ch

    def forward(self, batch: PointBatch, mode: NeighborMode) -> torch.Tensor:
        ms = batch.scales
        feats = self.encoder(batch, mode)
        h = feats[4]
        for i, _ in DECODER:
            h = knn_interpolate(h, ms[i].pos, ms[i - 1].pos, ms[i - 1].up_idx,
                                mode)
            h = getattr(self, f"lin{i}")(h)
            if i > 1:
                h = getattr(self, f"fusion{i - 1}")(
                    torch.cat([h, feats[i - 1]], dim=-1)
                )
        return torch.cat([h, feats[0]], dim=-1)


class SmallCRFNet(nn.Module):
    """Encoder + a continuous-CRF decoder (GuideCRFConv after each k-NN
    interpolation, guided by the skip features, neighbours beyond
    ``RADIUS`` masked); [B, N, 64]."""

    def __init__(self, in_channels: int, steps: int = 1, device=None):
        super().__init__()
        self.encoder = SmallEncoder(in_channels, device)
        cin = CHANNELS[-1]
        for i, ch in DECODER:
            setattr(self, f"deconv{i}", GuideCRFConv(
                cin, CHANNELS[i - 1], ch, steps, RADIUS, device=device,
            ))
            if i > 1:
                setattr(self, f"fusion{i - 1}",
                        MLP(ch + CHANNELS[i - 1], ch, leaky_relu001,
                            device=device))
            cin = ch

    def forward(self, batch: PointBatch, mode: NeighborMode) -> torch.Tensor:
        ms = batch.scales
        feats = self.encoder(batch, mode)
        h = feats[4]
        for i, _ in DECODER:
            h = knn_interpolate(h, ms[i].pos, ms[i - 1].pos, ms[i - 1].up_idx,
                                mode)
            guide = feats[i - 1]
            h = getattr(self, f"deconv{i}")(
                h, guide, ms[i - 1].pos, ms[i - 1].neighbor_idx, mode
            )
            if i > 1:
                h = getattr(self, f"fusion{i - 1}")(
                    torch.cat([h, guide], dim=-1)
                )
        return torch.cat([h, feats[0]], dim=-1)
