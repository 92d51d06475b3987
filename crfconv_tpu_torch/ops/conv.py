"""Fused eval-mode point convolution (kernel K3) and the batch-norm fold.

Counterpart of ``crfconv_tpu/ops/conv_pallas.py::point_conv_fused_infer``:

    out_i = sum_k  u(p_i - p_j) * x_j,
    u(r)  = a1 * (leaky_0.1(a0 * (r W0) + c0) W1) + c1,

for the same-scale case, with each eval-mode batch norm folded into an
affine (a, c) pair by :func:`fold_bn`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import POINT_CONV_FUSED_INFER
from crfconv_tpu_torch.ops._launch import check, on_cuda, ptr, stream
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, _geometry, windowed_gather_plain,
)

# Widest hidden width and smallest row count routed to the kernel, as in
# the reference's dispatch (conv_pallas.FUSED_MAX_H, FUSED_MIN_ROWS).
FUSED_MAX_H = 32
FUSED_MIN_ROWS = 4096
BN_EPS = 1e-5


def fused_eligible(training: bool, hidden: int, n_rows: int,
                   windowed: bool) -> bool:
    """A same-scale eval PointConv runs fused in the windowed regime for
    hidden <= FUSED_MAX_H and at least FUSED_MIN_ROWS rows."""
    return (
        not training and windowed and hidden <= FUSED_MAX_H
        and n_rows >= FUSED_MIN_ROWS
    )


def fold_bn(weight, scale, bias, mean, var, eps: float = BN_EPS):
    """Linear weight [out, in] followed by eval batch norm -> (W [in, out],
    a, c) with bn(x W) = a * (x W) + c."""
    a = scale / torch.sqrt(var + eps)
    return weight.t().contiguous(), a, bias - mean * a


def point_conv_fused_infer(
    x, pos, idx, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
) -> torch.Tensor:
    """x [B, N, H], pos [B, N, 3], idx [B, N, K] int32 (K1's clamp
    semantics), w0 [3, H], w1 [H, H], a*/c* [H] -> [B, N, H]."""
    if not on_cuda(x, pos, idx, w0, a0, c0, w1, a1, c1):
        return point_conv_fused_infer_plain(
            x, pos, idx, w0, a0, c0, w1, a1, c1, tile, pad, slope
        )
    B, N, H = x.shape
    check(x, "x", torch.float32, 3)
    check(pos, "pos", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    if pos.shape != (B, N, 3) or idx.shape[:2] != (B, N):
        raise ValueError(
            f"x {tuple(x.shape)}, pos {tuple(pos.shape)}, idx {tuple(idx.shape)}"
        )
    if H > FUSED_MAX_H:
        raise ValueError(f"hidden width {H} > {FUSED_MAX_H}")
    for name, t, shape in (
        ("w0", w0, (3, H)), ("w1", w1, (H, H)), ("a0", a0, (H,)),
        ("c0", c0, (H,)), ("a1", a1, (H,)), ("c1", c1, (H,)),
    ):
        check(t, name, torch.float32, len(shape))
        if t.shape != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    K = idx.shape[2]
    starts, width, front = _geometry(N, N, tile, pad, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        POINT_CONV_FUSED_INFER(
            ptr(x), ptr(pos), ptr(idx), ptr(starts), ptr(w0), ptr(a0),
            ptr(c0), ptr(w1), ptr(a1), ptr(c1), ptr(out), B, N, K, H, tile,
            width, front, float(slope), stream(x.device),
        )
    return out


def point_conv_fused_infer_plain(
    x, pos, idx, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`point_conv_fused_infer`."""
    g = windowed_gather_plain(torch.cat([pos, x], dim=-1), idx, tile, pad)
    rel = pos[:, :, None, :] - g[..., :3]                   # [B, N, K, 3]
    t = F.leaky_relu(a0 * (rel @ w0) + c0, negative_slope=slope)
    u = a1 * (t @ w1) + c1                                  # [B, N, K, H]
    return (u * g[..., 3:]).sum(dim=2)
