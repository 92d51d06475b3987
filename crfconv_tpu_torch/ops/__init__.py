"""Neighbour ops and the kernel wrappers.

The nine names of ``crfconv_tpu/ops/__init__.py``; the neighbour ops take
the gather regime as a :class:`NeighborMode` argument.
"""

from crfconv_tpu_torch.ops.crf import (  # noqa: F401
    crf_mean_field, discrete_crf_update, gaussian_similarity,
)
from crfconv_tpu_torch.ops.neighbors import (  # noqa: F401
    gather_neighbors, knn_bruteforce, masked_softmax, max_pool_neighbors,
    remove_self_loop, upsample_nearest,
)
