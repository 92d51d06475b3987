"""The exact regime's device pyramid.

Counterpart of the device part of ``crfconv_tpu/data/pipeline.py``
(``build_pyramid_jax``): per scale, the exact kNN of every point
(``knn_bruteforce``, kernel K6 selecting), one random subsample shared
across the batch, and each fine point's nearest coarse points. Points keep
their input order (no Morton sort), so the exact regime gathers with plain
index gathers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import ScaleData
from crfconv_tpu_torch.ops.neighbors import knn_bruteforce

BIG_KERNEL_SIZES = (16, 16, 16, 16, 16)
BIG_RATIOS = (4, 4, 4, 4, 2)


def build_pyramid_device(
    pos,
    kernel_sizes: Sequence[int] = BIG_KERNEL_SIZES,
    ratios: Sequence[int] = BIG_RATIOS,
    *,
    k_up: int = 1,
    generator: Optional[torch.Generator] = None,
    choices: Optional[Sequence] = None,
    device="cuda",
) -> Tuple[ScaleData, ...]:
    """pos [B, N, 3] -> the multiscale pyramid, built on ``device``.

    Scale s keeps the first ``n // ratios[s]`` points of one random
    permutation of its n points, shared across the batch, drawn from
    ``generator`` (default: a generator seeded with 0 on ``device``)
    unless ``choices`` gives each scale's kept points. ``neighbor_idx`` is
    the self-inclusive kNN(min(kernel_sizes[s], n)), ``sub_idx`` its rows
    of the kept points, ``up_idx`` the ``k_up`` nearest kept points of
    every point.
    """
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    if choices is None and generator is None:
        generator = torch.Generator(device=pos.device).manual_seed(0)
    scales = []
    for s, (k, r) in enumerate(zip(kernel_sizes, ratios)):
        n = pos.shape[1]
        neighbor_idx = knn_bruteforce(pos, pos, min(k, n))
        sample_num = max(n // r, 1)
        if choices is not None:
            choice = torch.as_tensor(np.array(choices[s]), dtype=torch.int64,
                                     device=pos.device)
        else:
            choice = torch.randperm(
                n, generator=generator, device=generator.device,
            )[:sample_num].to(pos.device)
        sub_pos = pos[:, choice].contiguous()
        sub_idx = neighbor_idx[:, choice].contiguous()
        up_idx = knn_bruteforce(sub_pos, pos, k_up)
        scales.append(ScaleData(pos, neighbor_idx, sub_idx, up_idx))
        pos = sub_pos
    return tuple(scales)
