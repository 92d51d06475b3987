"""Fused CRF similarity and first message (kernel K4).

Counterpart of ``crfconv_tpu/ops/crf_sim_pallas.py``: one pass computes
s = softmax_K(-|y_i - y_j|^2) and msg = sum_k s_k z_j, so the decoder's
[B, N, K, 2H] neighbour gather never reaches device memory. At steps=1
the caller finishes with x = (z + msg C)(I + C)^-1.
"""

from __future__ import annotations

import torch

from crfconv_tpu_torch.cuda_build import CRF_SIMILARITY_MESSAGE
from crfconv_tpu_torch.ops._launch import (
    check, check_no_grad, on_cuda, ptr, stream,
)
from crfconv_tpu_torch.ops.windowed import (
    PAD, TILE, _geometry, windowed_gather_plain,
)

# As the reference's dispatch (crf_sim_pallas.SIM_MAX_H, SIM_MIN_ROWS).
SIM_MAX_H = 32
SIM_MIN_ROWS = 4096


def sim_eligible(training: bool, hidden: int, n_rows: int,
                 windowed: bool) -> bool:
    return (
        not training and windowed and hidden <= SIM_MAX_H
        and n_rows >= SIM_MIN_ROWS
    )


def crf_similarity_message(
    y: torch.Tensor, z: torch.Tensor, idx: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
):
    """y, z [B, N, H] f32, idx [B, N, K] int32 (self removed) ->
    (msg [B, N, H], s [B, N, K])."""
    if not on_cuda(y, z, idx):
        return crf_similarity_message_plain(y, z, idx, tile, pad)
    check_no_grad("crf_similarity_message", y, z)
    check(y, "y", torch.float32, 3)
    check(z, "z", torch.float32, 3)
    check(idx, "idx", torch.int32, 3)
    B, N, H = y.shape
    if z.shape != y.shape or idx.shape[:2] != (B, N):
        raise ValueError(
            f"y {tuple(y.shape)}, z {tuple(z.shape)}, idx {tuple(idx.shape)}"
        )
    if H > SIM_MAX_H:
        raise ValueError(f"hidden width {H} > {SIM_MAX_H}")
    K = idx.shape[2]
    starts, width, front = _geometry(N, N, tile, pad, y.device)
    s = torch.empty((B, N, K), dtype=y.dtype, device=y.device)
    msg = torch.empty_like(z)
    with torch.cuda.device(y.device):
        CRF_SIMILARITY_MESSAGE(
            ptr(y), ptr(z), ptr(idx), ptr(starts), ptr(s), ptr(msg), B, N, K,
            H, tile, width, front, stream(y.device),
        )
    return msg, s


def crf_similarity_message_plain(
    y: torch.Tensor, z: torch.Tensor, idx: torch.Tensor,
    tile: int = TILE, pad: int = PAD,
):
    """Plain PyTorch version of :func:`crf_similarity_message`."""
    H = y.shape[-1]
    g = windowed_gather_plain(torch.cat([y, z], dim=-1), idx, tile, pad)
    neg = -((y[:, :, None, :] - g[..., :H]) ** 2).sum(dim=-1)   # [B, N, K]
    e = torch.exp(neg - neg.amax(dim=-1, keepdim=True))
    s = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    msg = (s[..., None] * g[..., H:]).sum(dim=2)
    return msg, s
