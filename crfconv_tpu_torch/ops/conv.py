"""Fused eval-mode point convolutions (kernels K3 and K5), the batch-norm
fold and the dispatch guards of the fused point-conv paths.

Counterpart of ``crfconv_tpu/ops/conv_pallas.py``:

    out_i = sum_k  u(c_i - p_j) * x_j,
    u(r)  = a1 * (leaky_0.1(a0 * (r W0) + c0) W1) + c1,

with each eval-mode batch norm folded into an affine (a, c) pair by
:func:`fold_bn`. :func:`point_conv_fused_infer` (K3) is the same-scale case,
each point its own center c_i = p_i. :func:`point_conv_fused_strided` (K5)
is the strided case: the centers are the coarse points, the neighbours fine
points, and the block's residual rider is max-pooled over the same
neighbours in the same pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import (
    POINT_CONV_FUSED_INFER, POINT_CONV_FUSED_STRIDED,
)
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, on_cuda, ptr, stream,
)
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, _geometry, windowed_gather_plain,
)

# Widest hidden width and smallest row count routed to the kernel, as in
# the reference's dispatch (conv_pallas.FUSED_MAX_H, FUSED_MIN_ROWS).
FUSED_MAX_H = 32
FUSED_MIN_ROWS = 4096
BN_EPS = 1e-5


def fused_eligible(training: bool, hidden: int, n_rows: int,
                   windowed: bool, strided: bool, rider: bool) -> bool:
    """An eval PointConv runs fused in the windowed regime for hidden <=
    FUSED_MAX_H and at least FUSED_MIN_ROWS output rows: same-scale without
    a rider (K3), or strided with the residual rider (K5); no block emits a
    strided call without one."""
    return (
        not training and windowed and strided == rider
        and hidden <= FUSED_MAX_H and n_rows >= FUSED_MIN_ROWS
    )


def train_fused_eligible(training: bool, hidden: int, n_rows: int, k: int,
                         windowed: bool, tile: int) -> bool:
    """A same-scale train PointConv contracts through the fused weighted
    gather-reduce (``ops/windowed.py::weighted_gather_reduce``, kernel K7)
    in the windowed regime for hidden <= FUSED_MAX_H, K a multiple of
    128 // tile and at least FUSED_MIN_ROWS rows, as the reference's
    ``conv_pallas.train_fused_eligible`` (without its VMEM guard)."""
    return (
        training and windowed and hidden <= FUSED_MAX_H
        and k % max(128 // tile, 1) == 0 and n_rows >= FUSED_MIN_ROWS
    )


def fold_bn(weight, scale, bias, mean, var, eps: float = BN_EPS):
    """Linear weight [out, in] followed by eval batch norm -> (W [in, out],
    a, c) with bn(x W) = a * (x W) + c."""
    a = scale / torch.sqrt(var + eps)
    return weight.t().contiguous(), a, bias - mean * a


def _check_mlp(H, w0, a0, c0, w1, a1, c1):
    if H > FUSED_MAX_H:
        raise ValueError(f"hidden width {H} > {FUSED_MAX_H}")
    for name, t, shape in (
        ("w0", w0, (3, H)), ("w1", w1, (H, H)), ("a0", a0, (H,)),
        ("c0", c0, (H,)), ("a1", a1, (H,)), ("c1", c1, (H,)),
    ):
        check(t, name, torch.float32, len(shape))
        if t.shape != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")


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
    check_no_grad("point_conv_fused_infer", x, pos, w0, a0, c0, w1, a1, c1)
    B, N, H = x.shape
    check(x, "x", torch.float32, 3)
    check(pos, "pos", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    if pos.shape != (B, N, 3) or idx.shape[:2] != (B, N):
        raise ValueError(
            f"x {tuple(x.shape)}, pos {tuple(pos.shape)}, idx {tuple(idx.shape)}"
        )
    _check_mlp(H, w0, a0, c0, w1, a1, c1)
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


def point_conv_fused_strided(
    x, pos, sub_pos, idx, res, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
):
    """x [B, N, H], pos [B, N, 3], sub_pos [B, M, 3], idx [B, M, K] int32
    into N (K1's clamp semantics, bipartite geometry), res [B, N, R],
    w0 [3, H], w1 [H, H], a*/c* [H] -> (out [B, M, H], res_max [B, M, R])
    with res_max the rider's max over each point's K neighbours (zero for a
    neighbour row outside [0, N))."""
    if not on_cuda(x, pos, sub_pos, idx, res, w0, a0, c0, w1, a1, c1):
        return point_conv_fused_strided_plain(
            x, pos, sub_pos, idx, res, w0, a0, c0, w1, a1, c1, tile, pad,
            slope,
        )
    check_no_grad("point_conv_fused_strided", x, pos, sub_pos, res, w0, a0,
                  c0, w1, a1, c1)
    B, N, H = x.shape
    check(x, "x", torch.float32, 3)
    check(pos, "pos", torch.float32, 3)
    check(sub_pos, "sub_pos", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    check(res, "res", torch.float32, 3)
    M, K = idx.shape[1], idx.shape[2]
    R = res.shape[2]
    if (pos.shape != (B, N, 3) or sub_pos.shape != (B, M, 3)
            or idx.shape[0] != B or res.shape[:2] != (B, N) or R == 0):
        raise ValueError(
            f"x {tuple(x.shape)}, pos {tuple(pos.shape)}, sub_pos "
            f"{tuple(sub_pos.shape)}, idx {tuple(idx.shape)}, res "
            f"{tuple(res.shape)}"
        )
    _check_mlp(H, w0, a0, c0, w1, a1, c1)
    starts, width, front = _geometry(M, N, tile, pad, x.device)
    out = torch.empty((B, M, H), dtype=x.dtype, device=x.device)
    res_max = torch.empty((B, M, R), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        POINT_CONV_FUSED_STRIDED(
            ptr(x), ptr(pos), ptr(sub_pos), ptr(idx), ptr(starts), ptr(w0),
            ptr(a0), ptr(c0), ptr(w1), ptr(a1), ptr(c1), ptr(res), ptr(out),
            ptr(res_max), B, N, M, K, H, R, tile, width, front, float(slope),
            stream(x.device),
        )
    return out, res_max


def point_conv_fused_strided_plain(
    x, pos, sub_pos, idx, res, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
):
    """Plain PyTorch version of :func:`point_conv_fused_strided`."""
    H = x.shape[2]
    g = windowed_gather_plain(torch.cat([pos, x, res], dim=-1), idx, tile,
                              pad)
    rel = sub_pos[:, :, None, :] - g[..., :3]               # [B, M, K, 3]
    t = F.leaky_relu(a0 * (rel @ w0) + c0, negative_slope=slope)
    u = a1 * (t @ w1) + c1                                  # [B, M, K, H]
    return (u * g[..., 3:3 + H]).sum(dim=2), g[..., 3 + H:].amax(dim=2)
