"""Data-parallel training across processes.

Counterpart of ``crfconv_tpu/parallel/sharding.py``. The JAX package runs
its data-parallel step as one global program over a device mesh; here a
rank is one process on one device, in a ``torch.distributed`` process group
(``nccl`` when every rank has a card of its own, ``gloo`` on the CPU or
when ranks share a card), as the JAX package's processes under
``process_count > 1``: rank r loads shard r of the input and its
``batch_size`` is per process.

The global step is kept by the step itself (``train/train_state.py``)
under :func:`data_parallel`: the batch norms' statistics are all-reduced
(``models/common.py``), the dropout mask is drawn at the global batch's
shape, the loss is each rank's numerator over the global denominator, and
the gradients are summed over the ranks in one flat bucket before the
optimizer's step. So a step on ``world`` ranks equals, up to the order of
its sums, the one-process step on the ranks' batches put together.

Point sharding (``parallel/spatial*.py``) splits each cloud's rows over a
point group instead: :func:`make_spatial_mesh` lays the ranks out as the
JAX package's 2-D (data x points) mesh, one point group and one data
group a rank, and :func:`shard_points` cuts a batch to a rank's part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch

from crfconv_tpu_torch.data.batch import batch_size_of, slice_batch
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.windowed import PAD, TILE

# how long a rank waits for the others at a collective before it fails
COLLECTIVE_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel process group."""

    world: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[object] = None    # None: the default process group
    # the global ranks of the group's members in group order (None: the
    # default group, whose ranks are their own)
    ranks: Optional[tuple] = None

    def global_rank(self, r: int) -> int:
        """The global rank of this group's rank ``r``."""
        return r if self.ranks is None else self.ranks[r]


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """This process's place in a data x points grid of ranks (the JAX
    package's 2-D mesh with axes ("data", "points")): global rank
    ``d * d_pts + p`` holds data shard d's clouds and rows [p * L,
    (p + 1) * L) of their sharded scales. ``points`` is its point group
    (the d_pts ranks of one data shard), ``data`` its data group (the d_data
    ranks of one span), None where d_data is 1."""

    world: Mesh
    points: Mesh
    data: Optional[Mesh] = None


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(
    n_devices: Optional[int] = None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device=None,
    rank: Optional[int] = None,
) -> Mesh:
    """Initialise the process group, or join the one already initialised,
    and return this rank's :class:`Mesh`.

    The world size and rank come from the group where one exists, else from
    ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    rendezvous ``env://``) where it is set, else from ``n_devices`` and
    ``rank`` (default 0) with ``init_method`` (a world of one rendezvouses
    on a free localhost port by itself). ``n_devices`` must match the world
    size. ``device`` defaults to ``cuda:<local rank>``, and the CPU is used
    only where it is asked for: a missing card raises. ``backend`` defaults
    to ``nccl`` on a card and ``gloo`` on the CPU; ranks that share one
    card must ask for ``gloo``.
    """
    import torch.distributed as dist

    env = os.environ
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    elif "WORLD_SIZE" in env and "RANK" in env and rank is None:
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if init_method is None:
            init_method = "env://"
    else:
        world = 1 if n_devices is None else int(n_devices)
        rank = 0 if rank is None else int(rank)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    local = int(env.get("LOCAL_RANK", rank))
    device = torch.device("cuda", local) if device is None else (
        torch.device(device))
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if index >= cards:
            raise RuntimeError(
                f"rank {rank} needs {device}, but this machine has {cards} "
                "CUDA devices (the CPU runs only where device='cpu' is "
                "asked for)")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        now = dist.get_backend()
        if backend is not None and backend != now:
            raise ValueError(f"the process group runs {now}, not {backend}")
        backend = now
    else:
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if init_method is None:
            if world > 1:
                raise ValueError(f"a world of {world} needs an init_method "
                                 "(or torchrun's environment)")
            init_method = f"tcp://localhost:{free_port()}"
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        )
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs a CUDA device a rank")
    return Mesh(world, rank, device, backend)


def make_spatial_mesh(
    d_data: int, d_pts: int, mesh: Optional[Mesh] = None, **mesh_kw,
) -> SpatialMesh:
    """The data x points grid over the world ``mesh`` (default:
    ``make_mesh(d_data * d_pts, **mesh_kw)``), whose size must be
    ``d_data * d_pts``. Every rank creates every subgroup, as
    ``torch.distributed.new_group`` asks."""
    import torch.distributed as dist

    if d_data < 1 or d_pts < 1:
        raise ValueError(f"spatial mesh ({d_data}, {d_pts})")
    if mesh is None:
        mesh = make_mesh(d_data * d_pts, **mesh_kw)
    if mesh.world != d_data * d_pts:
        raise ValueError(f"a ({d_data}, {d_pts}) mesh needs "
                         f"{d_data * d_pts} ranks, the group has {mesh.world}")
    d, p = divmod(mesh.rank, d_pts)
    if d_data == 1:
        return SpatialMesh(mesh, mesh)
    points = data = None
    for g in range(d_data):
        ranks = tuple(g * d_pts + q for q in range(d_pts))
        group = dist.new_group(list(ranks))
        if g == d:
            points = Mesh(d_pts, p, mesh.device, mesh.backend, group, ranks)
    for q in range(d_pts):
        ranks = tuple(g * d_pts + q for g in range(d_data))
        group = dist.new_group(list(ranks))
        if q == p:
            data = Mesh(d_data, d, mesh.device, mesh.backend, group, ranks)
    return SpatialMesh(mesh, points, data)


def point_mesh(mesh) -> Mesh:
    """The point group of a :class:`SpatialMesh`, or ``mesh`` itself."""
    return mesh.points if isinstance(mesh, SpatialMesh) else mesh


def close_mesh(mesh: Mesh) -> None:
    """Destroy the default process group ``mesh`` runs in."""
    import torch.distributed as dist

    if mesh.group is None and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """The frame context of a data-parallel step over ``mesh`` (none where
    it is None) for the block."""
    if mesh is None:
        yield
        return
    with spatial_state.activate({"data": mesh, "frames": {}}):
        yield


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; no gradient)."""
    import torch.distributed as dist

    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_reduce_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks (a new tensor)."""
    import torch.distributed as dist

    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out


def all_gather_cat(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated on axis 0
    in rank order. Gloo gathers through the host."""
    import torch.distributed as dist

    src = t.detach().contiguous()
    if mesh.backend == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=0).to(t.device)


def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in place, in one flat
    bucket a dtype."""
    import torch.distributed as dist

    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def _broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place, one flat
    bucket a dtype."""
    import torch.distributed as dist

    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src=0, group=mesh.group)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


# --------------------------------------------------------------------------
# the JAX package's placement API
# --------------------------------------------------------------------------


def shard_batch(batch, mesh: Mesh):
    """This rank's clouds of a global RawBatch or PointBatch: rows
    ``[rank * b, (rank + 1) * b)`` with ``b = B / world``, the pyramid's
    tensors included."""
    nb = batch_size_of(batch)
    if nb % mesh.world:
        raise ValueError(f"a batch of {nb} clouds does not split over "
                         f"{mesh.world} ranks")
    b = nb // mesh.world
    return slice_batch(batch, mesh.rank * b, b)


def shard_points(batch, mesh, sharded=None, tile: int = TILE,
                 pad: int = PAD):
    """This rank's part of a global PointBatch (or RawBatch) under the
    point-sharding policy: every tensor whose point axis (dim 1) has a
    sharded length (``sharded``, default
    ``parallel.spatial_forward.choose_sharded_scales`` of the batch at the
    geometry ``tile``, ``pad``) is cut to this rank's span [p * L,
    (p + 1) * L) of its point group; the others stay whole. Under a
    :class:`SpatialMesh` with a data group the clouds are cut to the data
    shard's first (``shard_batch``)."""
    from crfconv_tpu_torch.parallel.spatial_forward import (
        choose_sharded_scales,
    )

    if isinstance(mesh, SpatialMesh) and mesh.data is not None:
        batch = shard_batch(batch, mesh.data)
    pts = point_mesh(mesh)
    if sharded is None:
        sharded = choose_sharded_scales(batch, pts.world, tile, pad)

    def cut(v):
        if isinstance(v, torch.Tensor):
            if v.dim() >= 2 and v.shape[1] in sharded:
                n = v.shape[1] // pts.world
                return v[:, pts.rank * n:(pts.rank + 1) * n].contiguous()
            return v
        if isinstance(v, tuple):
            return type(v)(*map(cut, v)) if hasattr(v, "_fields") else (
                tuple(map(cut, v)))
        return v

    return cut(batch)


def replicate(state, mesh: Mesh):
    """Rank 0's state on every rank, in place: the model's parameters and
    buffers and, for a TrainState, the optimizer's momentum buffers, its
    param groups' settings, the scheduler's state and the step. Returns
    ``state``."""
    import torch.distributed as dist

    model = getattr(state, "model", state)
    tensors = list(model.state_dict().values())
    opt = getattr(state, "optimizer", None)
    if opt is not None:
        bufs = [opt.state[p]["momentum_buffer"] for g in opt.param_groups
                for p in g["params"]
                if opt.state.get(p, {}).get("momentum_buffer") is not None]
        n = torch.tensor([len(bufs), -len(bufs)], device=comm_device(mesh))
        n = all_reduce_max(n, mesh)
        if int(n[0]) != -int(n[1]):
            raise RuntimeError("the ranks' optimizers hold different state")
        tensors += bufs
    _broadcast_tensors(tensors, mesh)
    if opt is not None:
        meta = [{
            "groups": [{k: v for k, v in g.items() if k != "params"}
                       for g in opt.param_groups],
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
        }]
        dist.broadcast_object_list(meta, src=0, group=mesh.group)
        for g, g0 in zip(opt.param_groups, meta[0]["groups"]):
            g.update(g0)
        state.scheduler.load_state_dict(meta[0]["scheduler"])
        state.step = int(meta[0]["step"])
    return state


def comm_device(mesh: Mesh) -> torch.device:
    """Where a small tensor of a collective lives: the card under nccl, the
    host under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _shapes(batch) -> list:
    out = []
    for v in batch:
        if isinstance(v, torch.Tensor):
            out.extend([v.dim(), *v.shape])
        elif isinstance(v, tuple):
            for s in v:
                for t in s:
                    out.extend([-1] if t is None else [t.dim(), *t.shape])
        else:
            out.append(-1)
    return out


def make_global_batch(local_batch, mesh: Mesh):
    """This rank's shard of the global batch, as it is, once every rank's
    shapes are checked equal (a step on unequal shards would hang or
    differ)."""
    sig = _shapes(local_batch)
    v = torch.tensor([len(sig)] + sig, dtype=torch.int64,
                     device=comm_device(mesh))
    for what in (v[:1], v):      # the length first: unequal sizes hang
        both = all_reduce_max(torch.cat([what, -what]), mesh)
        if not torch.equal(both[:what.numel()], -both[what.numel():]):
            raise ValueError("the ranks' batches differ in shape")
    return local_batch


def make_parallel_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """``train_step`` (or an eval step) run data-parallel over ``mesh``:
    each call runs under :func:`data_parallel`."""
    def parallel_step(state, batch, *args, **kwargs):
        with data_parallel(mesh):
            return train_step(state, batch, *args, **kwargs)

    return parallel_step


# --------------------------------------------------------------------------
# spawning the ranks
# --------------------------------------------------------------------------


def _to_host(obj):
    """Tensors in ``obj`` (nested dicts, lists, tuples) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world, device, backend, init_method, args, results):
    try:
        mesh = make_mesh(world, backend, init_method, device=device,
                         rank=rank)
        try:
            out = _to_host(fn(mesh, *args))
        finally:
            close_mesh(mesh)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(
    fn: Callable,
    n: int,
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    args: tuple = (),
    init_method: Optional[str] = None,
    timeout_s: float = 3600.0,
) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, each a spawned process on
    ``devices[r]`` (default ``cuda:r``), and return their results in rank
    order (tensors as numpy arrays). ``fn`` and ``args`` are pickled:
    ``fn`` must be importable by name. A rank that fails, or a run longer
    than ``timeout_s``, stops every rank and raises with the traceback."""
    import multiprocessing as mp

    devices = ([f"cuda:{r}" for r in range(n)] if devices is None
               else list(devices))
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, devices[r], backend, init_method,
                               args, results))
             for r in range(n)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {n} ranks took more than "
                                       f"{timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        results.close()
    return [out[r] for r in range(n)]

