"""Segmentation networks of the small family.

Counterpart of ``crfconv_tpu/models/segnets.py``: a feature net
(``models/point_conv_small.py``) and a classifier (Dense -> ReLU -> Dense)
with a log-softmax output. The single-head nets (``BaselineSegNet``,
``CRFSegNet``) return log p; the discrete-CRF nets
(``BaselineDiscreteCRFSegNet``, ``DualCRFSegNet``) run a discrete CRF
(``models/discrete_crf.py``) over the predicted probabilities and return
(log p, log q) for the two-head loss. Module names follow the flax tree
(``convert.from_flax``). The part-segmentation net is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.models.common import MLP
from crfconv_tpu_torch.models.discrete_crf import DiscreteCRFConv
from crfconv_tpu_torch.models.point_conv_small import (
    SmallBaselineNet, SmallCRFNet,
)
from crfconv_tpu_torch.ops import windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode

# the discrete CRF's neighbourhood: the reference's radius_graph(r = 0.2,
# max_num_neighbors = 32) as kNN(32) plus the radius mask in DiscreteCRFConv
DISCRETE_CRF_K = 32


def _discrete_crf_idx(pos: torch.Tensor, mode: NeighborMode) -> torch.Tensor:
    """Self-inclusive kNN(32) at the finest scale, rebuilt per forward as
    the reference rebuilds its graph, window-consistent in the windowed
    regime (K2, with the pyramid's selection rule)."""
    if not mode.windowed:
        raise NotImplementedError(
            "the exact regime's device kNN (knn_bruteforce) is not ported")
    return windowed.window_knn_auto(
        pos, min(DISCRETE_CRF_K, pos.shape[1]), tile=mode.tile, pad=mode.pad,
        knn_exact=mode.knn_exact,
    )


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
              generator: Optional[torch.Generator],
              hidden: int = 128) -> None:
        self.feature = feature
        self.classifier = _Classifier(64, hidden, n_classes, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (MLP, _Classifier, DiscreteCRFConv)):
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


class _DiscreteSegNet(_SmallSegNet):
    """Feature net + classifier (hidden 256) + a discrete CRF over the
    predicted probabilities; (log p, log q), each [B, N, n_classes]."""

    def _init_discrete(self, feature: nn.Module, n_classes: int,
                       in_channels: int, steps: int, device,
                       generator: Optional[torch.Generator]) -> None:
        self.crf = DiscreteCRFConv(n_classes, in_channels, steps=steps,
                                   device=device)
        self._init(feature, n_classes, device, generator, hidden=256)

    def forward(
        self, batch: PointBatch, mode: NeighborMode = NeighborMode(),
        dropout_generator: Optional[torch.Generator] = None,
    ):
        del dropout_generator
        p = torch.softmax(self.classifier(self.feature(batch, mode)), dim=-1)
        pos = batch.scales[0].pos
        q = self.crf(pos, p, batch.x, _discrete_crf_idx(pos, mode), mode)
        return (torch.log(torch.clamp(p, min=1e-12)),
                torch.log(torch.clamp(q, min=1e-12)))


class BaselineDiscreteCRFSegNet(_DiscreteSegNet):
    """The small baseline net + classifier + discrete CRF, (log p, log q).
    Weights as :class:`CRFSegNet`'s; the CRF's kernels F ~ U[0, 1), W =
    1/5 and C = I."""

    def __init__(self, n_classes: int, in_channels: int = 6, steps: int = 1,
                 *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        self._init_discrete(SmallBaselineNet(in_channels, dev), n_classes,
                            in_channels, steps, dev, generator)


class DualCRFSegNet(_DiscreteSegNet):
    """The small continuous-CRF net + classifier + discrete CRF, both CRFs
    at ``steps`` mean-field steps; (log p, log q)."""

    def __init__(self, n_classes: int, in_channels: int = 6, steps: int = 1,
                 *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        self._init_discrete(SmallCRFNet(in_channels, steps, device=dev),
                            n_classes, in_channels, steps, dev, generator)
