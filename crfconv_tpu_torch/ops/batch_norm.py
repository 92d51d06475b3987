"""An MLP's batch norm and the leaky ReLU after it, one pass each way
(kernel K16, ``csrc/batch_norm_act.cu``).

    z = (x - mean) * invstd * scale + bias,   y = leaky(z) or z

over x [rows, F] (float32, contiguous). Training normalises with the
batch's mean and biased variance and updates the running statistics in
place, ``ra = keep * ra + (1 - keep) * batch`` with the unbiased variance;
eval normalises with the running statistics. The leaky ReLU's gradient is
flax's (1 at z >= 0, the slope below, as ``ops/activation.py``).

Each wrapper launches its kernel on CUDA tensors and takes its plain
version on CPU tensors: ``batch_stats``, ``update_running`` and
``normalize``, which ``models/common.py::MaskedBatchNorm`` runs where the
kernels do not take the call, and the backward in closed form. :func:`batch_norm_act` is the autograd front; the backward
saves x, the batch's mean and invstd, and recomputes z. Which calls take
this path is ``models/common.py``'s dispatch (:func:`fallback_reason`).
"""

from __future__ import annotations

import struct
from typing import Optional

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import (
    BATCH_NORM_APPLY, BATCH_NORM_BWD, BATCH_NORM_STATS,
)
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops._launch import (
    launch_on, on_cuda, raw_stream, row_view, sm_count,
)

# csrc/batch_norm_act.cu's StatsArgs, ApplyArgs and BwdArgs
_pack_stats = struct.Struct("10q3d").pack
_pack_apply = struct.Struct("12q2d").pack
_pack_bwd = struct.Struct("18qd").pack

THREADS = 256       # a block's threads
BLOCKS_PER_SM = 8   # resident blocks of THREADS on one SM
MIN_ROWS = 16       # rows a thread of a reduction takes at least
APPLY_WAVES = 2     # waves of resident blocks an elementwise pass launches


def chunks_of(rows: int, f: int, sms: int) -> int:
    """Row chunks of a reduction pass over [rows, f] (its grid's height):
    one wave of resident blocks over the grid's strips of columns, each
    thread taking at least MIN_ROWS rows."""
    v = f // 4 if f % 4 == 0 else f
    s = min(v, THREADS)
    strips = -(-v // s)
    per_chunk = THREADS // s * MIN_ROWS
    return max(1, min(-(-rows // per_chunk), BLOCKS_PER_SM * sms // strips))


def _check(x: torch.Tensor, *vecs: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: float32 [rows, F] contiguous, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (x.shape[1],) or \
                not v.is_contiguous():
            raise ValueError(f"per-channel vector: float32 [{x.shape[1]}], "
                             f"got {v.dtype} {tuple(v.shape)}")


def batch_norm_stats(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, eps: float, keep: float):
    """(mean, invstd) of x's rows, the variance biased; updates the running
    statistics in place (``keep * ra + (1 - keep) * batch``, the variance
    unbiased). The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if not on_cuda(x, running_mean, running_var):
        return batch_norm_stats_plain(x, running_mean, running_var, eps, keep)
    _check(x, running_mean, running_var)
    rows, f = x.shape
    chunks = chunks_of(rows, f, sm_count(x.device.index))
    part = torch.empty((3, chunks, f), device=x.device)
    mean = torch.empty(f, device=x.device)
    invstd = torch.empty(f, device=x.device)
    launch_on(x.device, BATCH_NORM_STATS, _pack_stats(
        x.data_ptr(), part.data_ptr(), chunks, rows, f, mean.data_ptr(),
        invstd.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
        raw_stream(x.device), eps, keep, 1.0 - keep))
    return mean, invstd


@torch.no_grad()
def batch_norm_stats_plain(x, running_mean, running_var, eps: float,
                           keep: float):
    """Plain PyTorch version of :func:`batch_norm_stats`."""
    mean, var = batch_stats(x, (0,))
    update_running(running_mean, running_var, mean, var, float(x.shape[0]),
                   keep)
    return mean, torch.rsqrt(var + eps)


def batch_stats(x: torch.Tensor, dims: tuple):
    """(mean, biased variance) of x over ``dims``, in two passes (the
    one-pass sum of squares would cancel in float32)."""
    mean = x.mean(dim=dims)
    return mean, (x - mean).square().mean(dim=dims)


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, count,
                   keep: float) -> None:
    """``ra = keep * ra + (1 - keep) * batch`` in place, the variance made
    unbiased by the rows' ``count`` (a float, or a tensor of a global
    count)."""
    if isinstance(count, float):
        unbiased = var * count / max(count - 1.0, 1.0)
    else:
        unbiased = var * count / (count - 1.0).clamp_min(1.0)
    running_mean.copy_(keep * running_mean + (1 - keep) * mean)
    running_var.copy_(keep * running_var + (1 - keep) * unbiased)


def normalize(x: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The norm's affine, ``(x - mean) * invstd * scale + bias``."""
    return (x - mean) * invstd * scale + bias


def batch_norm_apply(x: torch.Tensor, mean: torch.Tensor, s2: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, eps: float,
                     slope: Optional[float], s2_is_var: bool) -> torch.Tensor:
    """y = leaky((x - mean) * invstd * scale + bias) (no activation where
    ``slope`` is None); ``s2`` is invstd, or the variance whose
    ``rsqrt(s2 + eps)`` is invstd where ``s2_is_var``."""
    if not on_cuda(x, mean, s2, scale, bias):
        return batch_norm_apply_plain(x, mean, s2, scale, bias, eps, slope,
                                      s2_is_var)
    _check(x, mean, s2, scale, bias)
    y = torch.empty_like(x)
    launch_on(x.device, BATCH_NORM_APPLY, _pack_apply(
        x.data_ptr(), y.data_ptr(), mean.data_ptr(), s2.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), x.shape[0], x.shape[1],
        int(s2_is_var), int(slope is not None),
        APPLY_WAVES * BLOCKS_PER_SM * sm_count(x.device.index),
        raw_stream(x.device), eps, 0.0 if slope is None else slope))
    return y


def batch_norm_apply_plain(x, mean, s2, scale, bias, eps: float,
                           slope: Optional[float], s2_is_var: bool):
    """Plain PyTorch version of :func:`batch_norm_apply`."""
    invstd = torch.rsqrt(s2 + eps) if s2_is_var else s2
    y = normalize(x, mean, invstd, scale, bias)
    return y if slope is None else F.leaky_relu(y, negative_slope=slope)


def batch_norm_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                   invstd: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, slope: Optional[float], batch: bool):
    """(dx, dscale, dbias) of y = leaky(z) given its gradient g: with
    g' = g where z >= 0, g * slope below, dbias = sum g', dscale = sum g' *
    xhat and dx = scale * invstd * (g' - dbias / n - xhat * dscale / n)
    where the statistics are the batch's (``batch``), scale * invstd * g'
    where they are fixed. g may be a slice of a wider tensor's last
    dimension (read in place)."""
    if not on_cuda(x, g, mean, invstd, scale, bias):
        return batch_norm_bwd_plain(x, g, mean, invstd, scale, bias, slope,
                                    batch)
    _check(x, mean, invstd, scale, bias)
    if g.dtype != torch.float32 or g.shape[-1] != x.shape[1] or \
            g.numel() != x.numel():
        raise ValueError(f"g: float32 like x {tuple(x.shape)}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    rows, f = x.shape
    g, ldg = row_view(g, f)
    chunks = chunks_of(rows, f, sm_count(x.device.index))
    part = torch.empty((2, chunks, f), device=x.device)
    dx = torch.empty_like(x)
    dscale = torch.empty(f, device=x.device)
    dbias = torch.empty(f, device=x.device)
    launch_on(x.device, BATCH_NORM_BWD, _pack_bwd(
        x.data_ptr(), g.data_ptr(), ldg, dx.data_ptr(), part.data_ptr(),
        chunks, rows, f, mean.data_ptr(), invstd.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), dscale.data_ptr(),
        dbias.data_ptr(), int(batch), int(slope is not None),
        APPLY_WAVES * BLOCKS_PER_SM * sm_count(x.device.index),
        raw_stream(x.device), 0.0 if slope is None else slope))
    return dx, dscale, dbias


def batch_norm_bwd_plain(x, g, mean, invstd, scale, bias,
                         slope: Optional[float], batch: bool):
    """Plain PyTorch version of :func:`batch_norm_bwd`."""
    g = g.reshape(x.shape)
    xh = (x - mean) * invstd
    if slope is not None:
        g = torch.where(xh * scale + bias >= 0, g, g * slope)
    dbias = g.sum(dim=0)
    dscale = (g * xh).sum(dim=0)
    if batch:
        n = x.shape[0]
        g = g - dbias / n - xh * (dscale / n)
    return scale * invstd * g, dscale, dbias


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, eps, slope,
                training, keep):
        if training:
            mean, invstd = batch_norm_stats(x, running_mean, running_var,
                                            eps, keep)
        else:   # the running statistics as they are now
            mean, invstd = running_mean.clone(), torch.rsqrt(running_var + eps)
        ctx.save_for_backward(x, mean, invstd, scale, bias)
        ctx.slope, ctx.training = slope, training
        return batch_norm_apply(x, mean, invstd, scale, bias, eps, slope,
                                False)

    @staticmethod
    def backward(ctx, g):
        x, mean, invstd, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = batch_norm_bwd(x, g, mean, invstd, scale, bias,
                                           ctx.slope, ctx.training)
        return dx, dscale, dbias, None, None, None, None, None, None


def batch_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   eps: float, slope: Optional[float], training: bool,
                   keep: float) -> torch.Tensor:
    """The batch norm of x [..., F] over its leading axes and the leaky
    ReLU of ``slope`` after it (none where ``slope`` is None), in training
    with the batch's statistics (the running ones updated in place), else
    with the running ones. Differentiable in x, scale and bias."""
    rows = x.reshape(-1, x.shape[-1])
    if training or torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad):
        y = _BatchNormAct.apply(rows, scale, bias, running_mean, running_var,
                                eps, slope, training, keep)
    else:   # eval without a graph: one launch, invstd from the variance
        y = batch_norm_apply(rows, running_mean, running_var, scale, bias,
                             eps, slope, True)
    return y.reshape(x.shape)


def fallback_reason(x: torch.Tensor, mask: Optional[torch.Tensor],
                    training: bool, *params: torch.Tensor) -> Optional[str]:
    """The dispatch of ``MaskedBatchNorm``: None where the kernels take the
    call (float32 CUDA tensors, x contiguous and, in training, no mask and
    no data-parallel or point-sharded step's global statistics), else why
    PyTorch's ops keep it: ``"mask"``, ``"mesh"``, ``"dtype"`` (a narrower
    compute dtype), ``"layout"`` (x empty or strided) or ``"cpu"``. A mask
    and a mesh change only the batch's statistics: eval, which normalises
    with the running ones, ignores both."""
    if training:
        if mask is not None:
            return "mask"
        mesh, one_pass = spatial_state.stats_mesh(
            x.shape[1] if x.dim() >= 2 else None)
        if mesh is not None or one_pass:
            return "mesh"
    if any(t.dtype != torch.float32 for t in (x, *params)):
        return "dtype"
    if x.numel() == 0 or not x.is_contiguous():
        return "layout"
    if not all(t.is_cuda for t in (x, *params)):
        return "cpu"
    return None
