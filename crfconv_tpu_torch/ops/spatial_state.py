"""The frame context of a parallel step (leaf module, no dependencies).

Counterpart of ``crfconv_tpu/ops/spatial_state.py``. While a context is
active, the model's batch-coupled operations see the processes they share a
step with:

  * ``"data"``: the data-parallel :class:`~crfconv_tpu_torch.parallel.Mesh`
    of the step (the JAX context's ``data_axis``), or None. Under it a
    train-mode ``MaskedBatchNorm`` reduces its statistics over every rank's
    rows and ``dropout`` draws its mask at the global batch's shape;
  * ``"frames"``: ``{point-axis length: (sharded, global length)}`` of a
    point-sharded step. Point sharding is not ported, so it stays empty.

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
