"""Shared model building blocks.

Counterpart of ``crfconv_tpu/models/common.py``: ``MLP`` is Linear (bias
iff no batch norm) -> batch norm -> activation. Parameter and buffer names
follow the flax tree (``convert.from_flax``). The batch norm takes an
optional point-validity mask, and under a data-parallel or point-sharded
step (``ops/spatial_state.py``) reduces its statistics over every rank's
rows; dropout then draws its mask at the global batch's shape.

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

from crfconv_tpu_torch.ops import batch_norm, spatial_state
from crfconv_tpu_torch.ops.activation import leaky_relu
from crfconv_tpu_torch.utils import profiling

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


# the activations a batch norm's pass applies, by their slope; an MLP with
# any other activation (a partial or a lambda of leaky_relu too) applies it
# after the norm, as a pass of its own that counts as no fallback
LEAKY_SLOPES = {leaky_relu01: 0.1, leaky_relu001: 0.01}


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (on x's device): keeps each
    element with probability 1 - rate, scaled by 1 / (1 - rate).

    Under a data-parallel step of ``world`` ranks the mask is drawn at the
    global batch's shape ``[world * B, ...]`` and rank r keeps rows
    ``[r * B, (r + 1) * B)``, as the JAX package's global program draws it:
    every rank's generator, seeded alike, stays in step with a one-process
    run on the whole batch. Under a point-sharded step a sharded frame's
    mask is drawn at the global point length too, and this rank keeps its
    span of the points."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    n = x.shape[1] if x.dim() >= 2 else None
    world, rank, span = spatial_state.dropout_layout(n)
    b = x.shape[0]
    shape = (world * b,) + tuple(x.shape[1:])
    if span is not None:     # a sharded frame: the mask of every point
        shape = shape[:1] + (span[1],) + shape[2:]
    keep = torch.rand(shape, generator=generator,
                      device=x.device)[rank * b:(rank + 1) * b]
    if span is not None:
        keep = keep[:, span[0]:span[0] + n]
    return torch.where(keep >= rate, x / (1.0 - rate), torch.zeros_like(x))


def _all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks; its backward sums the
    gradient over the ranks (each rank's loss reaches every rank's
    statistics)."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=mesh.group)


class MaskedBatchNorm(nn.Module):
    """Batch norm over all leading axes, y = (x - mean) / sqrt(var + eps) *
    scale + bias.

    Train mode normalises with the biased batch statistics (in at least
    float32) and updates the running statistics the flax way,
    ``ra = BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * batch``, with the unbiased
    variance; eval mode normalises with the running statistics.

    ``mask`` ([...], bool, the leading axes of x) keeps the statistics to
    the valid rows. Under a data-parallel step of more than one rank the
    statistics are those of every rank's rows, in JAX's two-pass form: the
    count and the sum are all-reduced, then the sum of squared deviations
    from the global mean (the one-pass sum of squares would cancel in
    float32). Under a point-sharded step they are those of every rank
    holding a part of the frame's rows, in JAX's one-pass form there (one
    all-reduce of the count, the sum and the sum of squares). The
    all-reduces are differentiable, and the running statistics, updated
    from the global ones, stay equal on every rank.
    With no mask and no such step the statistics are today's local ones.

    A leaky ReLU of slope ``slope`` may follow the norm. Float32 CUDA
    tensors take the kernels of ``ops/batch_norm.py`` (K16: the norm and
    the activation in one pass each way), in training where there is no
    mask and no such step; every other call takes PyTorch's ops below, and
    a CUDA one counts in ``profiling.bn_fallbacks()`` under its reason.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                slope: Optional[float] = None) -> torch.Tensor:
        why = batch_norm.fallback_reason(x, mask, self.training, self.scale,
                                         self.bias, self.mean, self.var)
        if why is None:
            return batch_norm.batch_norm_act(
                x, self.scale, self.bias, self.mean, self.var, self.epsilon,
                slope, self.training, BN_MOMENTUM)
        if x.is_cuda:
            profiling.count_bn_fallback(why)
        y = self._norm(x, mask)
        return y if slope is None else leaky_relu(y, slope)

    def _norm(self, x: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.training:
            invstd = torch.rsqrt(self.var + self.epsilon)
            return batch_norm.normalize(x, self.mean, invstd, self.scale,
                                        self.bias).to(x.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(x.dim() - 1))
        mesh, one_pass = spatial_state.stats_mesh(
            x.shape[1] if x.dim() >= 2 else None)
        if one_pass:
            mean, var, count = self._one_pass_stats(xf, dims, mask, mesh)
        elif mask is None and mesh is None:
            mean, var = batch_norm.batch_stats(xf, dims)
            count = float(x.numel() // x.shape[-1])
        else:
            mean, var, count = self._global_stats(xf, dims, mask, mesh)
        batch_norm.update_running(self.mean, self.var, mean, var, count,
                                  BN_MOMENTUM)
        invstd = torch.rsqrt(var + self.epsilon)
        return batch_norm.normalize(x, mean, invstd, self.scale,
                                    self.bias).to(x.dtype)

    @staticmethod
    def _one_pass_stats(xf, dims, mask, mesh):
        """(mean, biased variance, count) of a point-sharded step's frame:
        JAX's one all-reduce of (sum, sum of squares, count) over
        ``mesh``."""
        if mask is None:
            count = xf.new_tensor(float(xf.numel() // xf.shape[-1]))
            s1 = xf.sum(dim=dims)
            s2 = xf.square().sum(dim=dims)
        else:
            m = mask.to(xf.dtype)[..., None]
            count = m.sum()
            s1 = (xf * m).sum(dim=dims)
            s2 = (xf.square() * m).sum(dim=dims)
        both = _all_reduce(torch.cat([s1, s2, count[None]]), mesh)
        f = s1.shape[0]
        count = both[-1].detach().clamp_min(1.0)
        mean = both[:f] / count
        var = (both[f:2 * f] / count - mean.square()).clamp_min(0.0)
        return mean, var, count

    @staticmethod
    def _global_stats(xf, dims, mask, mesh):
        """(mean, biased variance, count) over the rows that ``mask`` keeps
        (all where it is None), of every rank of ``mesh`` (this rank's where
        it is None): JAX's masked two-pass statistics."""
        if mask is None:
            m = None
            count = xf.new_tensor(float(xf.numel() // xf.shape[-1]))
            s1 = xf.sum(dim=dims)
        else:
            m = mask.to(xf.dtype)[..., None]
            count = m.sum()
            s1 = (xf * m).sum(dim=dims)
        if mesh is not None:
            both = _all_reduce(torch.cat([s1, count[None]]), mesh)
            s1, count = both[:-1], both[-1].detach()
        count = count.clamp_min(1.0)
        mean = s1 / count
        d2 = (xf - mean).square()
        s2 = (d2 if m is None else d2 * m).sum(dim=dims)
        if mesh is not None:
            s2 = _all_reduce(s2, mesh)
        return mean, s2 / count, count


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

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: the rows' validity for the batch norm's statistics."""
        dtype = _COMPUTE["dtype"] if self.scoped else None
        if dtype is None:
            dtype = torch.promote_types(x.dtype, self.weight.dtype)
        x = F.linear(x.to(dtype), self.weight.to(dtype),
                     None if self.bias is None else self.bias.to(dtype))
        if self.bn is not None:
            slope = LEAKY_SLOPES.get(self.activation)
            if slope is not None:   # the norm's pass applies it
                return self.bn(x, mask, slope)
            x = self.bn(x, mask)
        if self.activation is not None:
            x = self.activation(x)
        return x
