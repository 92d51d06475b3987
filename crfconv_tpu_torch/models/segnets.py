"""Segmentation networks of the small family.

Counterpart of ``crfconv_tpu/models/segnets.py``: a feature net
(``models/point_conv_small.py``) and a classifier (Dense -> ReLU -> Dense)
with a log-softmax output. The single-head nets (``BaselineSegNet``,
``CRFSegNet``) return log p; the discrete-CRF nets
(``BaselineDiscreteCRFSegNet``, ``DualCRFSegNet``) run a discrete CRF
(``models/discrete_crf.py``) over the predicted probabilities and return
(log p, log q) for the two-head loss. ``CRFSegNet_Part`` (ShapeNet part
segmentation) joins a one-hot of each cloud's object category to every
point's features before its classifier. Module names follow the flax tree
(``convert.from_flax``).
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
from crfconv_tpu_torch.ops import spatial_state, windowed
from crfconv_tpu_torch.ops.neighbors import NeighborMode, knn_bruteforce

# the discrete CRF's neighbourhood: the reference's radius_graph(r = 0.2,
# max_num_neighbors = 32) as kNN(32) plus the radius mask in DiscreteCRFConv
DISCRETE_CRF_K = 32
# ShapeNet's object categories, one-hot before CRFSegNet_Part's classifier
NUM_SHAPENET_CATEGORIES = 16


def _discrete_crf_idx(pos: torch.Tensor, mode: NeighborMode) -> torch.Tensor:
    """Self-inclusive kNN(32) at the finest scale, rebuilt per forward as
    the reference rebuilds its graph: window-consistent in the windowed
    regime (K2, with the pyramid's selection rule), else the exact kNN
    (``knn_bruteforce``, K6 selecting). Under a point-sharded step a
    sharded frame's kNN runs halo-exchanged on this rank's rows and returns
    global indices (``parallel/spatial_build.py``)."""
    k = min(DISCRETE_CRF_K, pos.shape[1])
    if not mode.windowed:
        return knn_bruteforce(pos, pos, k)
    fr = spatial_state.frame(pos.shape[1])
    if fr is not None and fr[0]:
        from crfconv_tpu_torch.parallel.spatial_build import _knn_local

        ctx = spatial_state.point_ctx()
        return _knn_local(pos, min(DISCRETE_CRF_K, fr[1]), ns_g=fr[1],
                          mesh=ctx["points"], mode=mode)
    return windowed.window_knn_auto(
        pos, k, tile=mode.tile, pad=mode.pad, knn_exact=mode.knn_exact,
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
        # bare Denses in the JAX model: the input promoted to the weights'
        # dtype whatever the compute dtype
        x = x.to(torch.promote_types(x.dtype, self.fc1.weight.dtype))
        return self.fc2(F.relu(self.fc1(x)))


class _SmallSegNet(nn.Module):
    """Feature net + classifier; log-probabilities [B, N, n_classes]. The
    small family has no dropout: ``dropout_generator`` is accepted, as the
    train step passes it, and not used."""

    def _init(self, feature: nn.Module, n_classes: int, device,
              generator: Optional[torch.Generator],
              hidden: int = 128, in_features: int = 64) -> None:
        self.feature = feature
        self.classifier = _Classifier(in_features, hidden, n_classes, device)
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


def category_one_hot(category: torch.Tensor, n: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """[B] category ids -> [B, n] one-hot rows; an id outside [0, n) gives
    a row of zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` raises)."""
    ids = torch.arange(n, device=category.device)
    return (category.long()[:, None] == ids).to(dtype)


class CRFSegNet_Part(_SmallSegNet):
    """ShapeNet part segmentation: the small continuous-CRF net, a one-hot
    of each cloud's object category (``batch.category`` [B], 16 categories)
    joined to every point's 64 features, and a classifier of hidden width
    256 over the 80. Weights as :class:`CRFSegNet`'s."""

    def __init__(self, n_classes: int = 50, in_channels: int = 6,
                 steps: int = 1, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        self._init(SmallCRFNet(in_channels, steps, device=dev), n_classes,
                   dev, generator, hidden=256,
                   in_features=64 + NUM_SHAPENET_CATEGORIES)

    def forward(
        self, batch: PointBatch, mode: NeighborMode = NeighborMode(),
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        del dropout_generator
        if batch.category is None:
            raise ValueError("CRFSegNet_Part needs batch.category, the "
                             "object category of each cloud")
        x = self.feature(batch, mode)
        onehot = category_one_hot(batch.category.to(x.device),
                                  NUM_SHAPENET_CATEGORIES, x.dtype)
        onehot = onehot[:, None, :].expand(*x.shape[:2], -1)
        x = self.classifier(torch.cat([x, onehot], dim=-1))
        return torch.log_softmax(x, dim=-1)


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
