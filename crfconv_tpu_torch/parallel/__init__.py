"""Data-parallel training across processes (``parallel/sharding.py``).

Counterpart of ``crfconv_tpu/parallel``: the names of its data-parallel
half. Point-sharded serving and training (``shard_points`` and the
``spatial*`` modules) are not ported yet.
"""

from crfconv_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh, all_gather_cat, all_reduce_gradients, all_reduce_max,
    all_reduce_sum, close_mesh, comm_device, data_parallel, launch,
    make_global_batch, make_mesh, make_parallel_train_step, replicate,
    shard_batch,
)
