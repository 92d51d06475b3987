"""Segmentation networks of the small family.

Counterpart of ``crfconv_tpu/models/segnets.py`` for the two single-head
nets: a feature net (``models/point_conv_small.py``) and a classifier
(Dense -> ReLU -> Dense) with a log-softmax output. Module names follow the
flax tree (``convert.from_flax``). The part-segmentation and discrete-CRF
nets are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models.common import MLP
from crfconv_tpu_torch.models.point_conv_small import (
    SmallBaselineNet, SmallCRFNet,
)
from crfconv_tpu_torch.ops.neighbors import NeighborMode


class _Classifier(nn.Module):
    """Dense(hidden) -> ReLU -> Dense(n_classes)."""

    def __init__(self, in_features: int, hidden: int, n_classes: int,
                 device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden, device=device)
        self.fc2 = nn.Linear(hidden, n_classes, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Weights U(+-1/sqrt(fan_in)) drawn on the CPU from ``generator``;
        biases zero, as flax's ``nn.Dense`` starts them."""
        for fc in (self.fc1, self.fc2):
            bound = 1.0 / math.sqrt(fc.in_features)
            r = torch.rand(fc.weight.shape, generator=generator)
            fc.weight.copy_((2 * r - 1) * bound)
            fc.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class _SmallSegNet(nn.Module):
    """Feature net + classifier; log-probabilities [B, N, n_classes]. The
    small family has no dropout: ``dropout_generator`` is accepted, as the
    train step passes it, and not used."""

    def _init(self, feature: nn.Module, n_classes: int, device,
              generator: Optional[torch.Generator]) -> None:
        self.feature = feature
        self.classifier = _Classifier(64, 128, n_classes, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (MLP, _Classifier)):
                m.reset_parameters(generator)

    def forward(
        self, batch: PointBatch, mode: NeighborMode = NeighborMode(),
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        del dropout_generator
        x = self.classifier(self.feature(batch, mode))
        return torch.log_softmax(x, dim=-1)


class BaselineSegNet(_SmallSegNet):
    """The small baseline net (k-NN interpolation decoder) + classifier."""

    def __init__(self, n_classes: int, in_channels: int = 6, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        self._init(SmallBaselineNet(in_channels, dev), n_classes, dev,
                   generator)


class CRFSegNet(_SmallSegNet):
    """The small continuous-CRF net + classifier. Weights are drawn from
    ``generator`` (default: seeded with 0) with torch.nn.Linear's init,
    the classifier's biases at zero, batch norms at identity and each CRF's
    compatibility c at the identity."""

    def __init__(self, n_classes: int, in_channels: int = 6, steps: int = 1,
                 *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        self._init(SmallCRFNet(in_channels, steps, device=dev), n_classes,
                   dev, generator)
