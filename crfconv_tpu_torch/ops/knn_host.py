"""Exact kNN on the host, the input pipeline's neighbour search.

Counterpart of ``crfconv_tpu/ops/knn_host.py``. The backend is named by
the caller: ``"native"`` (the default: the KD-tree of
``native/src/crfconv_native.cpp``, OpenMP over the queries, built on first
use by ``ops/native_build.py``; a failed build raises) or ``"scipy"``
(``cKDTree``). Both are exact and self-inclusive: where the query is the
support, column 0 is the point itself; they may order equidistant
neighbours differently.
"""

from __future__ import annotations

import numpy as np

BACKENDS = ("native", "scipy")


def knn_batch(support: np.ndarray, query: np.ndarray, k: int,
              backend: str = "native") -> np.ndarray:
    """Batched kNN: ``[B, N, 3] x [B, M, 3] -> int32 [B, M, min(k, N)]``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown kNN backend {backend!r}, not in {BACKENDS}")
    support = np.ascontiguousarray(support, dtype=np.float32)
    query = np.ascontiguousarray(query, dtype=np.float32)
    if support.ndim != 3 or query.ndim != 3:
        raise ValueError("expect [B, N, 3] support and query")
    k = min(k, support.shape[1])
    if backend == "native":
        from crfconv_tpu_torch.ops import native_build

        return native_build.knn_batch(support, query, k)

    from scipy.spatial import cKDTree

    B, M = query.shape[0], query.shape[1]
    out = np.empty((B, M, k), dtype=np.int32)
    for b in range(B):
        _, idx = cKDTree(support[b]).query(query[b], k=k, workers=-1)
        out[b] = (idx[:, None] if k == 1 else idx).astype(np.int32)
    return out


def knn(support: np.ndarray, query: np.ndarray, k: int,
        backend: str = "native") -> np.ndarray:
    """Single-cloud kNN: ``[N, 3] x [M, 3] -> int32 [M, k]``."""
    return knn_batch(support[None], query[None], k, backend)[0]
