"""Shared model building blocks.

Counterpart of ``crfconv_tpu/models/common.py``: ``MLP`` is Linear (bias
iff no batch norm) -> batch norm -> activation. Parameter and buffer names
follow the flax tree (``convert.from_flax``). The batch norm has no
validity mask: that belongs to point-sharded training, not ported yet.

The compute dtype (``set_compute_dtype``, ``compute_dtype_scope``) is the
dtype of every MLP's product, as flax's ``nn.Dense(dtype=...)`` of the JAX
package: ``torch.bfloat16`` runs the products in bfloat16 on bfloat16
copies of the float32 parameters; None (the default) keeps float32. Batch
statistics stay in at least float32 and the kernels run in float32 whatever
the activations' dtype (they cast on the way in and out).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crfconv_tpu_torch.ops.activation import leaky_relu

BN_MOMENTUM = 0.9   # running stats: ra = 0.9 * ra + 0.1 * batch, as flax

# The dtype of the MLPs' products (None: float32); read at each forward.
_COMPUTE = {"dtype": None}


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    """None -> float32 products; torch.bfloat16 -> bfloat16 products."""
    _COMPUTE["dtype"] = dtype


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE["dtype"]


@contextlib.contextmanager
def compute_dtype_scope(dtype: Optional[torch.dtype]):
    """:func:`set_compute_dtype` for the block; the previous dtype is
    restored on exit, an exception included."""
    prev = _COMPUTE["dtype"]
    _COMPUTE["dtype"] = dtype
    try:
        yield
    finally:
        _COMPUTE["dtype"] = prev


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), the big-family activation (flax's gradient at 0)."""
    return leaky_relu(x, 0.1)


def leaky_relu001(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01), torch's default slope, on the residual adds (flax's
    gradient at 0)."""
    return leaky_relu(x, 0.01)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (on x's device): keeps each
    element with probability 1 - rate, scaled by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MaskedBatchNorm(nn.Module):
    """Batch norm over all leading axes, y = (x - mean) / sqrt(var + eps) *
    scale + bias.

    Train mode normalises with the biased batch statistics (in at least
    float32) and updates the running statistics the flax way,
    ``ra = BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * batch``, with the unbiased
    variance; eval mode normalises with the running statistics.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
            return (y * self.scale + self.bias).to(x.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = (xf - mean).square().mean(dim=dims)
        with torch.no_grad():
            count = float(x.numel() // x.shape[-1])
            unbiased = var * count / max(count - 1.0, 1.0)
            m = BN_MOMENTUM
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class MLP(nn.Module):
    """Linear (bias iff no batch norm) -> batch norm -> activation.

    The product runs in the compute dtype where one is set (input, weight
    and bias cast to it), as flax's ``nn.Dense(dtype=...)``; with
    ``scoped=False`` it runs in the promoted dtype of input and weight, as
    a bare ``nn.Dense`` (the flagship's classifier_1)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        use_bn: bool = True,
        device=None,
        scoped: bool = True,
    ):
        super().__init__()
        self.in_features = in_features
        self.scoped = scoped
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
        dtype = _COMPUTE["dtype"] if self.scoped else None
        if dtype is None:
            dtype = torch.promote_types(x.dtype, self.weight.dtype)
        x = F.linear(x.to(dtype), self.weight.to(dtype),
                     None if self.bias is None else self.bias.to(dtype))
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x
