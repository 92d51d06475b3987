"""Argument checks and dispatch shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only for tensors that lie on the
CPU. For CUDA tensors it launches its kernel or raises; there is no
fallback.

The kernels compute in float32. A wrapper given narrower floats (the
bfloat16 activations of the bf16 compute mode) casts them to float32, runs
the same kernel (or plain version) and casts the result back, as the JAX
package's wrappers do around their Pallas kernels; so does each plain
version, so the two agree. :func:`float32_io` is that rule, put on each
wrapper and plain version.
"""

from __future__ import annotations

import ctypes
import functools
import inspect

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on one CUDA device, False if on the CPU."""
    if tensors[0].is_cuda:     # the launch path: compare device indices
        index = tensors[0].get_device()
        if all(t.is_cuda and t.get_device() == index for t in tensors[1:]):
            return True
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


NARROW = (torch.bfloat16, torch.float16)


def narrow(*tensors) -> bool:
    """True if any of the tensors is a float narrower than float32."""
    return any(isinstance(t, torch.Tensor) and t.dtype in NARROW
               for t in tensors)


def widen(t):
    """``t`` as float32 where it is a narrower float, else as it is."""
    if isinstance(t, torch.Tensor) and t.dtype in NARROW:
        return t.float()
    return t


def float32_io(*like: str):
    """Decorate a function that computes in float32. Where a tensor
    argument is a narrower float, every such argument is widened to
    float32 for the call, and each float output is cast back to the dtype
    of the argument ``like`` names (one name for every output, or one per
    output); integer outputs are left as they are. The casts are
    differentiable, so an autograd front decorated so returns its
    gradients in the inputs' dtypes."""
    def decorate(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not narrow(*args, *kwargs.values()):
                return fn(*args, **kwargs)
            given = sig.bind(*args, **kwargs).arguments
            dtypes = [given[name].dtype for name in like]
            out = fn(*map(widen, args),
                     **{k: widen(v) for k, v in kwargs.items()})
            outs = out if isinstance(out, tuple) else (out,)
            if len(dtypes) == 1:
                dtypes = dtypes * len(outs)
            outs = tuple(o.to(dtypes[i]) if o.is_floating_point() else o
                         for i, o in enumerate(outs))
            return outs if isinstance(out, tuple) else outs[0]

        return wrapper

    return decorate


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward: its output would be cut off from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or with inputs that do not require grad"
        )


def row_view(t: torch.Tensor, f: int):
    """(t as rows of ``f`` floats, the stride between them): a view where
    t's rows are evenly spaced (a slice of a wider tensor's last
    dimension, which a kernel reads in place), else a contiguous copy."""
    rows, ld = t, f
    if not t.is_contiguous():
        rows = t.reshape(-1, f)
        if f > 1 and rows.stride(1) != 1:
            rows = rows.contiguous()
        ld = rows.stride(0) if rows.shape[0] > 1 else f
    return rows, ld


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raw_stream(device: torch.device) -> int:
    """The current stream of ``device`` as the int a ctypes ``c_void_p``
    argument takes, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, for sizing
    grids."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_on(device: torch.device, kernel, *args) -> None:
    """Call ``kernel(*args)`` with ``device`` current, entering it only
    when another device is current."""
    if device.index == torch._C._cuda_getDevice():
        kernel(*args)
    else:
        with torch.cuda.device(device):
            kernel(*args)
