"""Data-parallel and point-sharded serving and training across processes.

Counterpart of ``crfconv_tpu/parallel``: data parallelism
(``parallel/sharding.py``), the halo exchange and the point-sharded CRF
(``parallel/spatial.py``), the point-sharded forward
(``spatial_forward.py``), pyramid (``spatial_build.py``) and train step
(``spatial_train.py``), one process a rank.
"""

from crfconv_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh, SpatialMesh, all_gather_cat, all_reduce_gradients, all_reduce_max,
    all_reduce_sum, close_mesh, comm_device, data_parallel, launch,
    make_global_batch, make_mesh, make_parallel_train_step,
    make_spatial_mesh, replicate, shard_batch, shard_points,
)
from crfconv_tpu_torch.parallel.spatial import (  # noqa: F401
    crf_mean_field_spatial, exchange_halo,
)
from crfconv_tpu_torch.parallel.spatial_build import (  # noqa: F401
    build_pyramid_windowed_spatial,
)
from crfconv_tpu_torch.parallel.spatial_forward import (  # noqa: F401
    all_gather_points, choose_sharded_scales, forward_spatial,
    make_spatial_forward,
)
from crfconv_tpu_torch.parallel.spatial_train import (  # noqa: F401
    build_windowed_batch_spatial, make_spatial_train_step,
)
