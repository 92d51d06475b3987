"""The leaky ReLU with flax's gradient.

flax's ``nn.leaky_relu`` (``crfconv_tpu/models/common.py``) is
``where(x >= 0, x, slope * x)``: its gradient at exactly 0 is 1, where
torch's ``leaky_relu`` takes the slope. The forward here is torch's; the
backward is the kernel ``csrc/leaky_relu_bwd.cu`` (one launch, as torch's
own backward), which replaces no TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import LEAKY_RELU_BWD
from crfconv_tpu_torch.ops._launch import launch_on, on_cuda, raw_stream


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``F.leaky_relu(x, slope)`` whose gradient is 1 at x >= 0 and
    ``slope`` below, as flax's."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _LeakyReLU.apply(x, slope)
    return F.leaky_relu(x, negative_slope=slope)


class _LeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, negative_slope=slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return leaky_relu_bwd(x, g, ctx.slope), None


def leaky_relu_bwd(x: torch.Tensor, g: torch.Tensor,
                   slope: float) -> torch.Tensor:
    """dx = g where x >= 0, else g * slope: the kernel on CUDA tensors
    (float32), the plain version on CPU tensors. g may be a slice of a
    wider tensor's last dimension (it is read in place)."""
    if not on_cuda(x, g):
        return leaky_relu_bwd_plain(x, g, slope)
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"leaky_relu_bwd: float32 only, got {x.dtype}, "
                        f"{g.dtype}")
    if x.shape != g.shape:
        raise ValueError(f"x {tuple(x.shape)}, g {tuple(g.shape)}")
    x = x.contiguous()
    f = x.shape[-1] if x.dim() and x.numel() else 1
    rows, ld = g, f
    if not g.is_contiguous():
        rows = g.reshape(-1, f)   # a view where g's rows are evenly spaced
        if f > 1 and rows.stride(1) != 1:
            rows = rows.contiguous()
        ld = rows.stride(0) if rows.shape[0] > 1 else f
    dx = torch.empty_like(x)
    launch_on(x.device, LEAKY_RELU_BWD, x.data_ptr(), rows.data_ptr(),
              dx.data_ptr(), x.numel() // f, f, ld, slope,
              raw_stream(x.device))
    return dx


def leaky_relu_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                         slope: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`leaky_relu_bwd`."""
    return torch.where(x >= 0, g, g * slope)
