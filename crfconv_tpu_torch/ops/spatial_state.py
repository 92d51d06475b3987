"""The frame context of a parallel step (leaf module, no dependencies).

Counterpart of ``crfconv_tpu/ops/spatial_state.py``. While a context is
active, the model's batch- and point-coupled operations see the processes
they share a step with:

  * ``"data"``: the :class:`~crfconv_tpu_torch.parallel.Mesh` that the
    step's loss, gradients and metrics reduce over, or None: the
    data-parallel mesh of a data-parallel step, every rank of a
    point-sharded one. With no frames a train-mode ``MaskedBatchNorm``
    reduces its statistics over it and ``dropout`` draws its mask at the
    global batch's shape;
  * ``"frames"``: ``{point-axis length on this rank: (sharded, global
    length)}`` of a point-sharded step (``parallel/spatial_forward.py``),
    empty otherwise. While it is not empty the windowed operations of
    ``ops`` and ``models`` route to their halo-exchange forms;
  * ``"points"``: the point group's Mesh (the ranks that split a cloud's
    rows; this rank holds rows [rank * L, (rank + 1) * L) of every sharded
    scale);
  * ``"stats"``: the Mesh a sharded frame's batch statistics reduce over
    (the point group, or every rank under a data x points mesh: the JAX
    context's ``stat_axes``);
  * ``"batch"``: the data group's Mesh under a data x points mesh (the
    JAX context's ``data_axis``: a replicated frame's statistics reduce
    over it, and dropout draws the batch rows of every data rank), else
    None.

A context is entered with :func:`activate` around one step and is never
left set after it, an exception included; contexts do not nest.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

# None, or a dict with the keys above
CTX: Optional[dict] = None


def current() -> Optional[dict]:
    return CTX


def data_mesh():
    """The active context's data-parallel mesh, or None."""
    return None if CTX is None else CTX.get("data")


def point_ctx() -> Optional[dict]:
    """The active context where it is a point-sharded one, else None."""
    return CTX if CTX is not None and CTX.get("frames") else None


def frame(n: int):
    """(sharded, global length) of the frame whose length on this rank is
    ``n``, or None (no point-sharded context, or no such frame)."""
    ctx = point_ctx()
    return None if ctx is None else ctx["frames"].get(n)


def stats_mesh(n: Optional[int]):
    """(mesh, one_pass) for the batch statistics of a tensor whose point
    axis has length ``n`` on this rank: the mesh they reduce over (None:
    this rank's rows are all of them) and whether they take the one-pass
    form of a point-sharded step. A mesh of one rank is None."""
    ctx = CTX
    if ctx is None:
        return None, False
    fr = None if n is None else frame(n)
    if point_ctx() is None:
        mesh, one_pass = ctx.get("data"), False
    elif fr is not None and fr[0]:
        mesh, one_pass = ctx["stats"], True
    else:
        mesh, one_pass = ctx.get("batch"), True
    if mesh is None or mesh.world == 1:
        return None, False
    return mesh, one_pass


def dropout_layout(n: Optional[int]):
    """(batch ranks, batch rank, point span) of a dropout mask over a
    tensor whose point axis has length ``n`` on this rank: the mask is
    drawn at ``batch ranks`` times the batch and, where the frame is
    sharded, at the global point length, and this rank keeps its batch
    rows and ``span = (start, global length)`` of points (None: all)."""
    ctx = CTX
    if ctx is None:
        return 1, 0, None
    if point_ctx() is None:
        mesh, span = ctx.get("data"), None
    else:
        mesh = ctx.get("batch")
        fr = None if n is None else frame(n)
        span = None
        if fr is not None and fr[0]:
            span = (ctx["points"].rank * n, fr[1])
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    return world, rank, span


@contextmanager
def activate(ctx: dict):
    global CTX
    if CTX is not None:
        raise RuntimeError("parallel contexts do not nest")
    CTX = ctx
    try:
        yield
    finally:
        CTX = None


@contextmanager
def suspend():
    """Clear the context for the block (the computations inside it see no
    other process)."""
    global CTX
    saved, CTX = CTX, None
    try:
        yield
    finally:
        CTX = saved
