"""Build and bind the native host-ops library.

Counterpart of ``crfconv_tpu/ops/native_build.py``: the library of
``native/src/crfconv_native.cpp`` (read in place) compiles
on first use with ``g++ -O3 -fopenmp -march=native`` into
``crfconv_tpu_torch/_build/native/`` and is bound with ctypes. Its name
hashes the source, the flags and the target that ``-march=native``
resolves to, so a changed source, or a build directory carried to another
kind of CPU, builds anew. Each build writes a temporary file and renames
it into place, so several processes may build at once. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR.parent / "native" / "src" / "crfconv_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
         "-march=native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target() -> str:
    """The CPU that ``-march=native`` resolves to (``g++ -Q``)."""
    out = subprocess.run(
        [CXX, "-march=native", "-Q", "--help=target"], capture_output=True,
        text=True, check=True,
    ).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + (_target(),)).encode())
    return BUILD_DIR / f"libcrfconv_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([CXX, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ccn_knn_batch.argtypes = [f32p, i64, i64, f32p, i64, i64, i32p]
        lib.ccn_knn_batch.restype = None
        lib.ccn_knn_batch_distance_pick.argtypes = [
            f32p, i64, i64, i64, i64, ctypes.c_uint64, f32p, i32p,
        ]
        lib.ccn_knn_batch_distance_pick.restype = None
        lib.ccn_grid_subsample.argtypes = [
            f32p, i64, ctypes.c_void_p, i64, ctypes.c_void_p,
            ctypes.c_float, f32p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ccn_grid_subsample.restype = i64
        _lib = lib
        return lib


def knn_batch(support: np.ndarray, query: np.ndarray, k: int) -> np.ndarray:
    """Exact kNN by KD-tree: [B, N, 3] x [B, M, 3] -> int32 [B, M, k]."""
    support = np.ascontiguousarray(support, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    B, N, _ = support.shape
    M = query.shape[1]
    out = np.empty((B, M, k), np.int32)
    load().ccn_knn_batch(support, B, N, query, M, k, out)
    return out


def knn_batch_distance_pick(points: np.ndarray, nqueries: int, k: int,
                            seed: int = 0):
    """Coverage-balanced queries: ``nqueries`` a cloud, each drawn (seeded
    by ``seed`` and the cloud's index) among the points its earlier
    queries' neighbourhoods covered least, and their kNN -> (queries
    [B, nqueries, 3], int32 [B, nqueries, k])."""
    points = np.ascontiguousarray(points, np.float32)
    B, N, _ = points.shape
    queries = np.empty((B, nqueries, 3), np.float32)
    idx = np.empty((B, nqueries, k), np.int32)
    load().ccn_knn_batch_distance_pick(points, B, N, nqueries, k, seed,
                                       queries, idx)
    return queries, idx


def grid_subsample(points, features=None, labels=None, grid_size=0.1):
    """One barycentre a voxel, features averaged, the majority label."""
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    # the contiguous copies stay referenced for the duration of the call
    feats = (None if features is None
             else np.ascontiguousarray(features, np.float32))
    labs = None if labels is None else np.ascontiguousarray(labels, np.int32)
    fdim = 0 if feats is None else feats.shape[1]
    out_pts = np.empty((n, 3), np.float32)
    out_feats = None if feats is None else np.empty((n, fdim), np.float32)
    out_labels = None if labs is None else np.empty((n,), np.int32)
    count = lib.ccn_grid_subsample(
        points, n, None if feats is None else feats.ctypes.data, fdim,
        None if labs is None else labs.ctypes.data, ctypes.c_float(grid_size),
        out_pts, None if out_feats is None else out_feats.ctypes.data,
        None if out_labels is None else out_labels.ctypes.data,
    )
    result = [out_pts[:count].copy()]
    if out_feats is not None:
        result.append(out_feats[:count].copy())
    if out_labels is not None:
        result.append(out_labels[:count].copy())
    return result[0] if len(result) == 1 else tuple(result)
