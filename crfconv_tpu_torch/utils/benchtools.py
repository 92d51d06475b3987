"""Device timing of a chained call.

Counterpart of ``crfconv_tpu/utils/benchtools.py`` with its contract: the
seconds a call of ``step`` takes, from n calls chained through a carry
(each consumes the previous one's result, so they run in turn), two trip
counts differenced, (t(2n) - t(n)) / n, which cancels the constant cost of
starting and finishing a run, each the minimum of 3 runs; where noise
swamps the difference, the upper bound t(2n) / 2n.

On a CUDA device the calls are eager PyTorch, as a user makes them: no
CUDA graph and nothing else that hides their launch cost, since the host
launching the kernels is what bounds the port's cells. ``mode="loop"``
brackets the n calls with two CUDA events and synchronises once, so the
reading is the device's clock from the first call's start to the last
one's end; ``mode="chain"`` reads the host's clock from the first call to
the readback of a scalar of the final carry. On the CPU both read the
host's clock to that readback.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


def _leaves(tree: Any) -> list:
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _leaves(item)]
    return []


def _readback(tree: Any) -> float:
    """A scalar of ``tree`` (the sum of its first four tensors) on the
    host: it waits for the work that computes them."""
    return float(sum(t.sum().float() for t in _leaves(tree)[:4]))


def device_time(
    step: Callable[..., Any],
    init: Any,
    iters: int = 10,
    warmup: bool = True,
    mode: str = "loop",
    env: Any = None,
) -> float:
    """Seconds a call of ``step`` (carry -> carry) takes.

    ``env`` (optional) holds the loop-invariant operands (the model, the
    input features, ...), passed as ``step(carry, env)``. The device is
    CUDA where a tensor of ``init`` or ``env`` lies on it, else the host.
    ``mode`` is "loop" (CUDA events, one synchronisation) or "chain" (the
    host's clock to the final carry's readback); both chain the n calls
    through the carry.
    """
    if mode not in ("loop", "chain"):
        raise ValueError(f"mode must be 'loop' or 'chain', not {mode!r}")
    if env is None:
        def call(c):
            return step(c)
    else:
        def call(c):
            return step(c, env)

    devices = [t.device for t in _leaves(init) + _leaves(env)
               if t.device.type == "cuda"]
    events = mode == "loop" and bool(devices)
    if warmup:
        _readback(call(init))

    def run(n: int) -> float:
        if devices:
            torch.cuda.synchronize(devices[0])
        c = init
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(devices[0])
            start.record(stream)
            for _ in range(n):
                c = call(c)
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            c = call(c)
        _readback(c)
        return time.perf_counter() - t0

    def timed(n: int) -> float:
        # the minimum of 3: the host's jitter can exceed a fast call's
        # whole time in one sample
        return min(run(n) for _ in range(3))

    t1 = timed(iters)
    t2 = timed(2 * iters)
    if t2 > t1:
        return (t2 - t1) / iters
    # noise swamped the difference: the upper bound, not a fictitious zero
    return t2 / (2 * iters)
