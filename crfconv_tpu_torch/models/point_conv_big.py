"""Point-convolution U-Net, the flagship model family.

Counterpart of ``crfconv_tpu/models/point_conv_big.py``: a 5-stage encoder
of bottleneck residual point-conv blocks over a 1/4-rate index pyramid, a
decoder of continuous-CRF (or plain upsampling) blocks, and an MLP
classifier. Module names follow the flax tree (``convert.from_flax``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models.common import (
    MLP, dropout, leaky_relu001, leaky_relu01,
)
from crfconv_tpu_torch.models.crf_conv import ContinuousCRFConv
from crfconv_tpu_torch.ops.conv import (
    fold_bn, fused_eligible, point_conv_fused_infer, point_conv_fused_strided,
    train_fused_eligible,
)
from crfconv_tpu_torch.ops.neighbors import (
    NeighborMode, gather_neighbors, upsample_nearest,
)
from crfconv_tpu_torch.ops.windowed import weighted_gather_reduce


def _folded(mlp: MLP):
    bn = mlp.bn
    return fold_bn(mlp.weight, bn.scale, bn.bias, bn.mean, bn.var, bn.epsilon)


class PointConv(nn.Module):
    """Point convolution with MLP-generated depthwise neighbour weights on
    the relative positions p_i - p_j. Same-scale when ``sub_pos`` is None,
    strided otherwise."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.d_model = d_model
        self.weight_nn_0 = MLP(3, d_model, leaky_relu01, device=device)
        self.weight_nn_1 = MLP(d_model, d_model, None, device=device)

    def forward(
        self,
        x: torch.Tensor,                # [B, N, F] fine-scale features
        pos: torch.Tensor,              # [B, N, 3]
        neighbor_idx: torch.Tensor,     # [B, M, K] indices into N
        mode: NeighborMode,
        sub_pos: Optional[torch.Tensor] = None,  # [B, M, 3]
        extra: Optional[torch.Tensor] = None,    # [B, N, E] rider
    ):
        if fused_eligible(
            self.training, self.d_model, neighbor_idx.shape[1], mode.windowed,
            sub_pos is not None, extra is not None,
        ):
            w0, a0, c0 = _folded(self.weight_nn_0)
            w1, a1, c1 = _folded(self.weight_nn_1)
            if sub_pos is None:
                return point_conv_fused_infer(
                    x.contiguous(), pos, neighbor_idx, w0, a0, c0, w1, a1,
                    c1, mode.tile, mode.pad,
                )
            # strided, with the residual max-pooled over the same
            # neighbours in the same pass
            return point_conv_fused_strided(
                x.contiguous(), pos, sub_pos, neighbor_idx,
                extra.contiguous(), w0, a0, c0, w1, a1, c1, mode.tile,
                mode.pad,
            )
        if sub_pos is None and train_fused_eligible(
            self.training, self.d_model, neighbor_idx.shape[1],
            neighbor_idx.shape[2], mode.windowed, mode.tile,
        ):
            # train: the weight MLP keeps its batch statistics here; the
            # gather of x and the sum over K run fused (K7, backward K8)
            nbr = gather_neighbors(pos, neighbor_idx, mode)   # [B, N, K, 3]
            rel = pos[:, :, None, :] - nbr
            w = self.weight_nn_1(self.weight_nn_0(rel))       # [B, N, K, d]
            return weighted_gather_reduce(
                x.contiguous(), w.contiguous(), neighbor_idx, mode.tile,
                mode.pad,
            )
        # one gather for [pos, x(, extra)]
        d = x.shape[-1]
        parts = [pos, x] if extra is None else [pos, x, extra]
        g = gather_neighbors(torch.cat(parts, dim=-1), neighbor_idx, mode)
        center = pos if sub_pos is None else sub_pos
        rel = center[:, :, None, :] - g[..., :3]              # [B, M, K, 3]
        w = self.weight_nn_1(self.weight_nn_0(rel))           # [B, M, K, d]
        out = (w * g[..., 3 : 3 + d]).sum(dim=2)
        if extra is None:
            return out
        # rider: the residual max-pooled over the same neighbours
        return out, g[..., 3 + d :].amax(dim=2)


class ResNetBBlock(nn.Module):
    """Bottleneck residual block: lin_in -> PointConv -> lin_out +
    shortcut. The strided variant max-pools the residual over sub_idx."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        hidden = features // 4
        self.shortcut = (
            MLP(in_features, features, None, device=device)
            if in_features != features else None
        )
        self.lin_in = MLP(in_features, hidden, leaky_relu01, device=device)
        self.point_conv = PointConv(hidden, device=device)
        self.lin_out = MLP(hidden, features, None, device=device)

    def forward(self, x, pos, neighbor_idx, mode: NeighborMode, sub_pos=None):
        residual = x if self.shortcut is None else self.shortcut(x)
        h = self.lin_in(x)
        if sub_pos is not None:
            h, residual = self.point_conv(
                h, pos, neighbor_idx, mode, sub_pos=sub_pos, extra=residual
            )
        else:
            h = self.point_conv(h, pos, neighbor_idx, mode)
        h = self.lin_out(h)
        return leaky_relu001(h + residual)


class Upsampling(nn.Module):
    """Non-CRF decoder block: 1-NN upsample, lin, concat-fuse with skip."""

    def __init__(self, down_features: int, skip_features: int,
                 up_features: int, out_features: int, device=None):
        super().__init__()
        self.lin = MLP(down_features, up_features, leaky_relu01, device=device)
        self.fusion = MLP(
            skip_features + up_features, out_features, leaky_relu01,
            device=device,
        )

    def forward(self, x_down, x_up, up_idx, neighbor_idx, mode: NeighborMode):
        del neighbor_idx
        x = self.lin(upsample_nearest(x_down, up_idx[..., :1], mode))
        return self.fusion(torch.cat([x_up, x], dim=-1))


class PointConvResNet(nn.Module):
    """The flagship encoder-decoder segmentation network.

    Weights are drawn from ``generator`` (default: seeded with 0) with
    torch.nn.Linear's init; the classifier's bias starts at zero (flax's
    ``nn.Dense``) and batch norms at identity. The model is built on
    ``device``.
    """

    def __init__(
        self,
        n_classes: int,
        in_channels: int = 6,
        use_crf: bool = True,
        steps: int = 1,
        layers: Sequence[int] = (32, 64, 128, 256, 512),
        dropout_rate: float = 0.5,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        L = tuple(layers)
        dev = torch.device(device)
        self.conv1_1 = ResNetBBlock(in_channels, L[0], dev)
        self.conv1_2 = ResNetBBlock(L[0], L[0], dev)
        self.conv2_1 = ResNetBBlock(L[0], L[1], dev)
        self.conv2_2 = ResNetBBlock(L[1], L[1], dev)
        self.conv3_1 = ResNetBBlock(L[1], L[2], dev)
        self.conv3_2 = ResNetBBlock(L[2], L[2], dev)
        self.conv4_1 = ResNetBBlock(L[2], L[3], dev)
        self.conv4_2 = ResNetBBlock(L[3], L[3], dev)
        self.conv5_1 = ResNetBBlock(L[3], L[4], dev)
        self.conv5_2 = ResNetBBlock(L[4], L[4], dev)

        def deconv(down, skip):
            if use_crf:
                return ContinuousCRFConv(down, skip, skip, steps, device=dev)
            return Upsampling(down, skip, skip, skip, device=dev)

        self.deconv4 = deconv(L[4], L[3])
        self.deconv3 = deconv(L[3], L[2])
        self.deconv2 = deconv(L[2], L[1])
        self.deconv1 = deconv(L[1], L[0])
        self.classifier_0 = MLP(L[0], L[0] * 4, leaky_relu01, device=dev)
        self.dropout_rate = dropout_rate
        self.classifier_1 = MLP(L[0] * 4, n_classes, None, use_bn=False,
                                device=dev)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, MLP):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.classifier_1.bias.zero_()

    def forward(
        self, batch: PointBatch, mode: NeighborMode = NeighborMode(),
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Logits [B, N, n_classes]. In training, dropout draws its mask
        from ``dropout_generator`` (on the batch's device)."""
        ms = batch.scales
        x = batch.x
        x1 = self.conv1_1(x, ms[0].pos, ms[0].neighbor_idx, mode)
        x1 = self.conv1_2(x1, ms[0].pos, ms[0].neighbor_idx, mode)
        x2 = self.conv2_1(x1, ms[0].pos, ms[0].sub_idx, mode, ms[1].pos)
        x2 = self.conv2_2(x2, ms[1].pos, ms[1].neighbor_idx, mode)
        x3 = self.conv3_1(x2, ms[1].pos, ms[1].sub_idx, mode, ms[2].pos)
        x3 = self.conv3_2(x3, ms[2].pos, ms[2].neighbor_idx, mode)
        x4 = self.conv4_1(x3, ms[2].pos, ms[2].sub_idx, mode, ms[3].pos)
        x4 = self.conv4_2(x4, ms[3].pos, ms[3].neighbor_idx, mode)
        x5 = self.conv5_1(x4, ms[3].pos, ms[3].sub_idx, mode, ms[4].pos)
        x5 = self.conv5_2(x5, ms[4].pos, ms[4].neighbor_idx, mode)

        x = self.deconv4(x5, x4, ms[3].up_idx, ms[3].neighbor_idx, mode)
        x = self.deconv3(x, x3, ms[2].up_idx, ms[2].neighbor_idx, mode)
        x = self.deconv2(x, x2, ms[1].up_idx, ms[1].neighbor_idx, mode)
        x = self.deconv1(x, x1, ms[0].up_idx, ms[0].neighbor_idx, mode)

        x = self.classifier_0(x)
        if self.training:
            x = dropout(x, self.dropout_rate, dropout_generator)
        return self.classifier_1(x)  # [B, N, n_classes] logits
