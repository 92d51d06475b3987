"""Morton (Z-order) codes for spatial locality sorting.

Counterpart of ``crfconv_tpu/ops/morton.py``, a torch version and a
numpy one (``morton_code_np``, host pipelines). Codes are computed in int64
(PyTorch has little uint32 support); the 30-bit code fits either way, so
the order is the same. The curve can be turned: fixed orientations for the
multi-view eval (``view_rotation``), random ones for train-time jitter
(``random_rotation``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

BITS = 10  # 10 bits per axis -> 30-bit codes


def _spread_bits_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton_code_np(pos: np.ndarray) -> np.ndarray:
    """Host version: [..., N, 3] float positions -> [..., N] uint64 codes."""
    pos = np.asarray(pos, np.float64)
    mn = pos.min(axis=-2, keepdims=True)
    span = np.maximum(pos.max(axis=-2, keepdims=True) - mn, 1e-9)
    q = np.clip(
        (pos - mn) / span * (2**BITS - 1), 0, 2**BITS - 1
    ).astype(np.uint64)
    return (
        _spread_bits_np(q[..., 0])
        | (_spread_bits_np(q[..., 1]) << np.uint64(1))
        | (_spread_bits_np(q[..., 2]) << np.uint64(2))
    )


def morton_order_np(pos: np.ndarray) -> np.ndarray:
    """Host version: the stable permutation into Morton order."""
    return np.argsort(morton_code_np(pos), axis=-1, kind="stable")


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(pos: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] float positions -> [..., N] int64 Morton codes."""
    mn = pos.amin(dim=-2, keepdim=True)
    span = torch.clamp(pos.amax(dim=-2, keepdim=True) - mn, min=1e-9)
    q = torch.clamp(
        (pos - mn) / span * (2**BITS - 1), 0, 2**BITS - 1
    ).to(torch.int64)
    return (
        _spread_bits(q[..., 0])
        | (_spread_bits(q[..., 1]) << 1)
        | (_spread_bits(q[..., 2]) << 2)
    )


def morton_order(
    pos: torch.Tensor, rot: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Stable argsort into Morton order along the point axis (int64).

    ``rot`` ([3, 3]) rotates the coordinates used for coding only: the
    curve walks a rotated grid while distances still see the true
    positions (multi-view eval, train-time jitter).
    """
    if rot is not None:
        rot = torch.as_tensor(rot, dtype=pos.dtype, device=pos.device)
        pos = pos @ rot.T
    return torch.argsort(morton_code(pos), dim=-1, stable=True)


def _rot45() -> np.ndarray:
    """The fixed second-view orientation: 45 degrees about z then x."""
    c = s = np.float32(np.sqrt(0.5))
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    return rz @ rx


def view_rotation(view: int) -> Optional[torch.Tensor]:
    """Fixed curve orientation for multi-view eval. View 0 = identity."""
    if view == 0:
        return None
    rz90 = np.array(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32
    )
    r = _rot45()
    for _ in range(view - 1):
        r = rz90 @ r
    return torch.from_numpy(r)


def quaternion_rotation(q: torch.Tensor) -> torch.Tensor:
    """The rotation matrix [3, 3] of the quaternion (w, x, y, z) = q / |q|
    (float32)."""
    q = q.to(torch.float32)
    w, x, y, z = (q / torch.linalg.vector_norm(q)).unbind()
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def random_rotation(generator: torch.Generator) -> torch.Tensor:
    """A uniform random rotation [3, 3] on ``generator``'s device: a normal
    4-vector drawn from ``generator``, normalised, as a quaternion. The
    JAX package draws its vector from a key, so the two packages' draws
    differ; the matrix of a given vector is the same formula."""
    q = torch.randn(4, generator=generator, device=generator.device)
    return quaternion_rotation(q)
