"""Shared model building blocks.

Counterpart of ``crfconv_tpu/models/common.py``: ``MLP`` is Linear (bias
iff no batch norm) -> batch norm -> activation. Parameter and buffer names
follow the flax tree (``convert.from_flax``). Only the eval path of the
batch norm is here; train-mode statistics come with the train-step slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), the big-family activation."""
    return F.leaky_relu(x, negative_slope=0.1)


def leaky_relu001(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01), torch's default slope, on the residual adds."""
    return F.leaky_relu(x, negative_slope=0.01)


class MaskedBatchNorm(nn.Module):
    """Batch norm over all leading axes, eval mode: normalises with the
    running statistics, y = (x - mean) / sqrt(var + eps) * scale + bias."""

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode batch statistics come with the train-step slice "
                "of the port; call .eval()"
            )
        y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
        return y * self.scale + self.bias


class MLP(nn.Module):
    """Linear (bias iff no batch norm) -> batch norm -> activation."""

    def __init__(
        self,
        in_features: int,
        features: int,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        use_bn: bool = True,
        device=None,
    ):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device)
        )
        self.bias = (
            None if use_bn
            else nn.Parameter(torch.empty(features, device=device))
        )
        self.bn = MaskedBatchNorm(features, device=device) if use_bn else None
        self.activation = activation

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch.nn.Linear's init, U(+-1/sqrt(fan_in)), drawn on the CPU
        from ``generator``."""
        bound = 1.0 / math.sqrt(self.in_features)
        for p in (self.weight, self.bias):
            if p is not None:
                r = torch.rand(p.shape, generator=generator)
                p.copy_((2 * r - 1) * bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x, self.weight, self.bias)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x
