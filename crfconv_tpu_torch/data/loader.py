"""Multiscale batching loader with background prefetch.

Counterpart of ``crfconv_tpu/data/loader.py``. A batch is drawn from the
dataset and its transform with the loader's numpy generator, stacked and,
with ``emit="pyramid"``, given its host pyramid (``build_pyramid``); then
it is placed on ``device``. With ``prefetch > 0`` a producer thread does
all of this ahead of the consumer: on a CUDA device it copies each batch
from pinned host memory on a side stream of its own and records an event,
and the consumer makes its current stream wait on that event, and marks
the batch's tensors as used by that stream, before it hands the batch on.
An error in the thread, a CUDA error included, is raised in the consumer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.data.pipeline import (
    build_pyramid, make_batch, to_device,
)


@dataclasses.dataclass
class HostBatch:
    """A batch's stacked numpy arrays, before its pyramid and the device."""

    pos: np.ndarray                       # [B, N, 3] float32
    x: np.ndarray                         # [B, N, C] float32
    y: Optional[np.ndarray] = None        # [B, N]
    point_idx: Optional[np.ndarray] = None
    cloud_idx: Optional[np.ndarray] = None
    category: Optional[np.ndarray] = None


def batch_tensors(batch) -> list:
    """Every tensor of a RawBatch or PointBatch, the pyramid's included."""
    out = []
    for v in batch:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):     # the pyramid's ScaleData
            for s in v:
                out.extend(t for t in s if t is not None)
    return out


class MultiscaleLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        kernel_sizes: Sequence[int] = (16, 16, 16, 16, 16),
        ratios: Sequence[int] = (4, 4, 4, 4, 2),
        k_up: int = 1,
        dilations: Optional[Sequence[int]] = None,
        sample_method: str = "random",
        transform: Optional[Callable] = None,
        seed: int = 0,
        prefetch: int = 2,
        device: Union[str, torch.device] = "cuda",
        emit: str = "pyramid",   # 'pyramid' -> PointBatch, 'raw' -> RawBatch
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """``emit="raw"`` gives a :class:`RawBatch` for the windowed regime,
        whose pyramid the step builds on the device;
        ``emit="pyramid"`` a :class:`PointBatch` with the host pyramid of
        ``kernel_sizes``, ``ratios``, ``k_up``, ``dilations`` and
        ``sample_method``. ``num_shards``/``shard_index`` shard the input
        across processes: each draws its own stream (the seed with the
        shard index) and owns 1/num_shards of an epoch's batches;
        ``batch_size`` is the batch of one process."""
        if emit not in ("pyramid", "raw"):
            raise ValueError(f"emit must be 'pyramid' or 'raw', not {emit!r}")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.emit = emit
        self.dataset = dataset
        self.batch_size = batch_size
        self.kernel_sizes = tuple(kernel_sizes)
        self.ratios = tuple(ratios)
        self.k_up = k_up
        self.dilations = dilations
        self.sample_method = sample_method
        self.transform = transform
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, shard_index])
            if num_shards > 1
            else seed
        )
        self.prefetch = prefetch
        self.device = torch.device(device)

    def __len__(self) -> int:
        return max(len(self.dataset) // (self.batch_size * self.num_shards), 1)

    # ------------------------------------------------------------------
    def draw(self) -> HostBatch:
        """The next batch's samples, transformed and stacked on the host."""
        samples = []
        for _ in range(self.batch_size):
            s = self.dataset.get_sample(self.rng)
            if self.transform is not None:
                s = self.transform(s, self.rng)
            samples.append(s)

        def stack(key):
            return (np.stack([s[key] for s in samples])
                    if key in samples[0] else None)

        def ids(key):
            return (np.asarray([s[key] for s in samples])
                    if key in samples[0] else None)

        return HostBatch(
            pos=stack("pos").astype(np.float32),
            x=stack("x").astype(np.float32),
            y=stack("y"), point_idx=stack("point_idx"),
            cloud_idx=ids("cloud_idx"), category=ids("category"),
        )

    def place(self, h: HostBatch) -> Union[PointBatch, RawBatch]:
        """The host batch on the device, with its host pyramid where
        ``emit`` is "pyramid" (drawn from the loader's generator)."""
        if self.emit == "raw":
            def put(a, dtype):
                return None if a is None else to_device(a, self.device, dtype)

            return RawBatch(
                pos=put(h.pos, torch.float32), x=put(h.x, torch.float32),
                y=put(h.y, torch.int64), point_idx=put(h.point_idx,
                                                       torch.int64),
                cloud_idx=put(h.cloud_idx, torch.int64),
                category=put(h.category, torch.int64),
            )
        scales = build_pyramid(
            h.pos, self.kernel_sizes, self.ratios, k_up=self.k_up,
            dilations=self.dilations, method=self.sample_method,
            rng=self.rng,
        )
        return make_batch(h.x, h.y, scales, point_idx=h.point_idx,
                          cloud_idx=h.cloud_idx, category=h.category,
                          device=self.device)

    def __iter__(self) -> Iterator[Union[PointBatch, RawBatch]]:
        n = len(self)
        if self.prefetch <= 0:
            for _ in range(n):
                yield self.place(self.draw())
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        cuda = self.device.type == "cuda"

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                stream = torch.cuda.Stream(self.device) if cuda else None
                for _ in range(n):
                    if stop.is_set():
                        return
                    if cuda:
                        with torch.cuda.stream(stream):
                            batch = self.place(self.draw())
                            ready = torch.cuda.Event()
                            ready.record(stream)
                    else:
                        batch, ready = self.place(self.draw()), None
                    if not put((batch, ready)):
                        return
                put(None)
            except BaseException as e:  # raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(ready)
                    # the side stream's allocations are not reused before
                    # the work queued on this stream so far has read them
                    for tensor in batch_tensors(batch):
                        tensor.record_stream(current)
                yield batch
        finally:
            stop.set()
            t.join()


def loader_state_dict(loader: MultiscaleLoader) -> dict:
    """Checkpointable loader state: the sample-draw RNG and, where the
    dataset owns a possibility sampler, its state (its own RNG
    included)."""
    state = {"rng_state": loader.rng.bit_generator.state}
    sampler = getattr(loader.dataset, "sampler", None)
    if sampler is not None and hasattr(sampler, "state_dict"):
        state["sampler"] = sampler.state_dict()
    return state


def loader_load_state_dict(loader: MultiscaleLoader, state: dict) -> None:
    loader.rng.bit_generator.state = state["rng_state"]
    sampler = getattr(loader.dataset, "sampler", None)
    if sampler is not None and "sampler" in state:
        sampler.load_state_dict(state["sampler"])
