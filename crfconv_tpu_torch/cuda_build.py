"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and is loaded with ``ctypes``.
Libraries go to ``_build/`` inside the package, named by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one is
reused. Every missing library builds at once, one ``nvcc`` process per
source.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``, or ``NOTHING_LAUNCHED`` for an empty problem;
:class:`Kernel` raises on any other code that is not 0 and counts the
launches that succeeded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
HEADERS = ("window.cuh", "crf_rows.cuh", "point_conv.cuh", "tile_inverse.cuh",
           "crf_transpose.cuh", "warp_select.cuh")

NOTHING_LAUNCHED = -1   # an entry point's code for an empty problem
_P = ctypes.c_void_p
_I = ctypes.c_int


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} on first use"
    )


class Kernel:
    """One C entry point of one source file, and optionally more entries of
    the same library that take their arguments packed (``extra``);
    ``launches`` counts the calls of any entry that launched a kernel."""

    def __init__(
        self, name: str, source: str, symbol: str, argtypes: Sequence,
        flags: Sequence[str] = (), extra: Sequence[str] = (),
    ):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.extra = tuple(extra)
        self.launches = 0
        self._fn = None
        self._extra = {}

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for name in (self.source,) + HEADERS:
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(NVCC_FLAGS + self.flags).encode())
        return BUILD_DIR / f"{Path(self.source).stem}-{h.hexdigest()[:16]}.so"

    def build_command(self, out: Path, verbose: bool = False) -> list:
        cmd = [find_nvcc(), *NVCC_FLAGS, *self.flags]
        if verbose:
            cmd.append("-Xptxas=-v")
        return cmd + ["-o", str(out), str(CSRC / self.source)]

    def _load(self):
        path = self.library_path()
        if not path.exists():
            build([self])
        lib = ctypes.CDLL(str(path))
        for symbol in self.extra:
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_char_p]
            fn.restype = ctypes.c_int
            self._extra[symbol] = fn
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def _count(self, rc: int, symbol: str) -> None:
        if rc == NOTHING_LAUNCHED:
            return
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch of "
                               f"{symbol}")
        self.launches += 1

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._load()
        self._count(self._fn(*args), self.symbol)

    def call(self, symbol: str, packed: bytes) -> None:
        """Launch through the extra entry ``symbol``."""
        if self._fn is None:
            self._load()
        self._count(self._extra[symbol](packed), symbol)


# K1, K2, K8, K11 and K14 take their arguments packed as int64s in one
# bytes object (``struct.pack``): per call that costs the host a few
# microseconds less than ctypes' conversion of a dozen arguments.
WINDOWED_GATHER = Kernel(
    "windowed_gather", "windowed_gather.cu", "windowed_gather_f32",
    [ctypes.c_char_p],
)
WINDOW_KNN = Kernel(
    "window_knn", "window_knn.cu", "window_knn_f32", [ctypes.c_char_p],
    flags=("-fmad=false",),
)
POINT_CONV_FUSED_INFER = Kernel(
    "point_conv_fused_infer", "point_conv.cu", "point_conv_infer_f32",
    [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P],
)
CRF_SIMILARITY_MESSAGE = Kernel(
    "crf_similarity_message", "crf_sim.cu", "crf_similarity_message_f32",
    [_P] * 6 + [_I] * 7 + [_P],
)
WINDOWED_WEIGHTED_REDUCE = Kernel(
    "windowed_weighted_reduce", "windowed_weighted_reduce.cu",
    "windowed_weighted_reduce_f32", [_P] * 6 + [_I] * 8 + [_P],
)
WINDOWED_GATHER_BWD = Kernel(
    "windowed_gather_bwd", "windowed_gather_bwd.cu", "windowed_gather_bwd_f32",
    [ctypes.c_char_p],
)
CRF_OPERATOR = Kernel(
    "crf_operator", "crf_operator.cu", "crf_operator_i32",
    [_P] * 3 + [_I] * 6 + [_P],
)
CRF_ITERATE = Kernel(
    "crf_iterate", "crf_iterate.cu", "crf_iterate_f32",
    [_P] * 6 + [_I] * 4 + [_P],
)
CRF_ITERATE_BWD = Kernel(
    "crf_iterate_bwd", "crf_iterate_bwd.cu", "crf_iterate_bwd_f32",
    [ctypes.c_char_p], extra=("crf_iterate_bwd_transpose_i32",),
)
CRF_NEIGHBOR_DOT = Kernel(
    "crf_neighbor_dot", "crf_neighbor_dot.cu", "crf_neighbor_dot_f32",
    [_P] * 4 + [_I] * 5 + [_P],
)
POINT_CONV_FUSED_STRIDED = Kernel(
    "point_conv_fused_strided", "point_conv_strided.cu",
    "point_conv_strided_f32", [_P] * 14 + [_I] * 9 + [ctypes.c_float, _P],
)
DISCRETE_ITERATE = Kernel(
    "discrete_iterate", "discrete_iterate.cu", "discrete_iterate_f32",
    [_P] * 7 + [_I] * 4 + [_P],
)
DISCRETE_ITERATE_BWD = Kernel(
    "discrete_iterate_bwd", "discrete_iterate_bwd.cu",
    "discrete_iterate_bwd_f32", [ctypes.c_char_p],
    extra=("discrete_iterate_bwd_transpose_i32",),
)
SELECT_MIN_K = Kernel(
    "select_min_k", "select_min_k.cu", "select_min_k_f32",
    [_P, _P, ctypes.c_longlong, _I, _I, _I, _P],
)
LEAKY_RELU_BWD = Kernel(
    "leaky_relu_bwd", "leaky_relu_bwd.cu", "leaky_relu_bwd_f32",
    [_P] * 3 + [ctypes.c_longlong, _I, ctypes.c_longlong, ctypes.c_float,
                _P],
)
KERNELS = (
    WINDOWED_GATHER, WINDOW_KNN, POINT_CONV_FUSED_INFER,
    CRF_SIMILARITY_MESSAGE, WINDOWED_WEIGHTED_REDUCE, WINDOWED_GATHER_BWD,
    CRF_OPERATOR, CRF_ITERATE, CRF_ITERATE_BWD, CRF_NEIGHBOR_DOT,
    POINT_CONV_FUSED_STRIDED, DISCRETE_ITERATE, DISCRETE_ITERATE_BWD,
    SELECT_MIN_K, LEAKY_RELU_BWD,
)


def build(
    kernels: Optional[Iterable[Kernel]] = None, verbose: bool = False,
) -> float:
    """Compile every library of ``kernels`` (default: all) that is missing,
    one ``nvcc`` per source, all started together. Returns the seconds
    spent. ``verbose`` prints ptxas' register and shared-memory report."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for k in KERNELS if kernels is None else kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            k.build_command(tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((k, proc, tmp, out))
    errors = []
    for k, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{k.source}:\n{log}")
            continue
        if verbose and log:
            print(f"# nvcc {k.source}\n{log}", end="", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
