"""Argument checks and dispatch shared by the kernel wrappers.

A wrapper takes its plain PyTorch version only for tensors that lie on the
CPU. For CUDA tensors it launches its kernel or raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes

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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raw_stream(device: torch.device) -> int:
    """The current stream of ``device`` as the int a ctypes ``c_void_p``
    argument takes, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch_on(device: torch.device, kernel, *args) -> None:
    """Call ``kernel(*args)`` with ``device`` current, entering it only
    when another device is current."""
    if device.index == torch._C._cuda_getDevice():
        kernel(*args)
    else:
        with torch.cuda.device(device):
            kernel(*args)
