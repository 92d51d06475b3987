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

import functools
import struct

import numpy as np
import torch
import torch.nn.functional as F

from crfconv_tpu_torch.cuda_build import (
    POINT_CONV_FUSED_INFER, POINT_CONV_FUSED_STRIDED,
)
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, float32_io, launch_on, on_cuda, raw_stream,
    sm_count,
)
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, _geometry, window_starts, windowed_gather_plain,
)

# K3's and K5's arguments: 26 int64s (pointers, sizes, the stream) and the
# slope as a double (csrc/point_conv.cuh::point_conv_launch)
_pack = struct.Struct("26qd").pack

# Widest hidden width and smallest row count routed to the kernel, as in
# the reference's dispatch (conv_pallas.FUSED_MAX_H, FUSED_MIN_ROWS).
FUSED_MAX_H = 32
FUSED_MIN_ROWS = 4096
BN_EPS = 1e-5
MAX_PASSES = 2     # most passes a K3/K5 block makes (block_passes)


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
    ``conv_pallas.train_fused_eligible`` (without its VMEM guard). Under a
    point-sharded step (``ops/spatial_state.py``) it stays off, as there:
    the unfused gathers carry the halo exchange."""
    return (
        training and windowed and hidden <= FUSED_MAX_H
        and k % max(128 // tile, 1) == 0 and n_rows >= FUSED_MIN_ROWS
        and spatial_state.point_ctx() is None
    )


def fold_bn(weight, scale, bias, mean, var, eps: float = BN_EPS):
    """Linear weight [out, in] followed by eval batch norm -> (W [in, out],
    a, c) with bn(x W) = a * (x W) + c."""
    a = scale / torch.sqrt(var + eps)
    return weight.t().contiguous(), a, bias - mean * a


def block_points(h: int, passes: int = 1) -> int:
    """Output points of a K3/K5 block (csrc/point_conv.cuh::pc_points):
    ``passes`` passes of 256 threads, four columns a thread at the padded
    width 8, 16 or 32."""
    hp = 8 if h <= 8 else (16 if h <= 16 else 32)
    return 256 * 4 // hp * passes


def block_passes(h: int, blocks_at_one: int, sms: int) -> int:
    """Passes a K3/K5 block makes: more passes share one staging and one
    setup among more points, where the grid stays at least two waves of
    three blocks an SM."""
    passes = 1
    while passes < MAX_PASSES and blocks_at_one >= 2 * passes * 6 * sms:
        passes *= 2
    return passes


@functools.lru_cache(maxsize=256)
def stage_rows(m_out: int, n_src: int, h: int, passes: int = 1,
               tile: int = TILE, pad: int = PAD) -> int:
    """Most source rows a K3/K5 block stages: it owns
    block_points(h, passes) consecutive output points and stages the rows
    from the least to the greatest of their clamped indices, which lie
    within the windows of its first and last tile."""
    points = block_points(h, passes)
    starts, width, _ = window_starts(m_out, n_src, tile, pad)
    i0 = np.arange(0, m_out, points)
    t0 = i0 // tile
    t1 = (np.minimum(i0 + points, m_out) - 1) // tile
    return int((starts[t1] - starts[t0] + width).max())


def _launch(kernel, x, pos, ctr, idx, w0, a0, c0, w1, a1, c1, res,
            out, res_out, b, n, m, k, h, r, tile, pad, slope):
    starts, width, front = _geometry(m, n, tile, pad, x.device)
    passes = block_passes(h, b * -(-m // block_points(h)),
                          sm_count(x.device.index))
    launch_on(x.device, kernel, _pack(
        x.data_ptr(), pos.data_ptr(), ctr.data_ptr(), idx.data_ptr(),
        starts.data_ptr(), w0.data_ptr(), a0.data_ptr(), c0.data_ptr(),
        w1.data_ptr(), a1.data_ptr(), c1.data_ptr(),
        0 if res is None else res.data_ptr(), out.data_ptr(),
        0 if res_out is None else res_out.data_ptr(), b, n, m, k, h, r, tile,
        width, front, passes, stage_rows(m, n, h, passes, tile, pad),
        raw_stream(x.device), float(slope)))


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


@float32_io("x")
def point_conv_fused_infer(
    x, pos, idx, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
) -> torch.Tensor:
    """x [B, N, H], pos [B, N, 3], idx [B, N, K] int32 (K1's clamp
    semantics), w0 [3, H], w1 [H, H], a*/c* [H] -> [B, N, H]; narrower
    floats run in float32 and the result takes x's dtype."""
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
    out = torch.empty_like(x)
    _launch(POINT_CONV_FUSED_INFER, x, pos, pos, idx, w0, a0, c0, w1, a1, c1,
            None, out, None, B, N, N, K, H, 0, tile, pad, slope)
    return out


@float32_io("x")
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


@float32_io("x", "res")
def point_conv_fused_strided(
    x, pos, sub_pos, idx, res, w0, a0, c0, w1, a1, c1,
    tile: int = TILE, pad: int = PAD, slope: float = 0.1,
):
    """x [B, N, H], pos [B, N, 3], sub_pos [B, M, 3], idx [B, M, K] int32
    into N (K1's clamp semantics, bipartite geometry), res [B, N, R],
    w0 [3, H], w1 [H, H], a*/c* [H] -> (out [B, M, H], res_max [B, M, R])
    with res_max the rider's max over each point's K neighbours (zero for a
    neighbour row outside [0, N)). Narrower floats run in float32; out
    takes x's dtype, res_max res's."""
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
    out = torch.empty((B, M, H), dtype=x.dtype, device=x.device)
    res_max = torch.empty((B, M, R), dtype=x.dtype, device=x.device)
    _launch(POINT_CONV_FUSED_STRIDED, x, pos, sub_pos, idx, w0, a0, c0, w1, a1,
            c1, res, out, res_max, B, N, M, K, H, R, tile, pad, slope)
    return out, res_max


@float32_io("x", "res")
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
