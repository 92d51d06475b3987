"""Point-sharded training: the differentiable halo-exchanged step.

Counterpart of ``crfconv_tpu/parallel/spatial_train.py``. Each rank runs
the train step of ``train/train_state.py`` on its span of a point-sharded
batch under the frame context (``ops/spatial_state.py``): the forward of
``parallel/spatial_forward.py``, differentiated by autograd on the rank.
Each replicated value then carries this rank's part of its gradient only,
and the parts are summed in exactly three places:

  * the replicated all-gather's backward (each span's gradient summed into
    its owner) and the halo exchange's backward (each halo's gradient sent
    back and added into its owner's rows);
  * the batch norms' all-reduced statistics (``models/common.py``; one
    pass of (count, sum, sum of squares), over the point group, or every
    rank under a data x points mesh; a replicated frame reduces over the
    data group only), whose backward sums;
  * one flat bucket of the parameters' gradients, summed over every rank.

The loss is each rank's numerator over the denominator summed over every
rank, so the ranks' gradients sum to the global loss's; the loss and the
confusion matrix are summed over every rank. Dropout is drawn at the global
shape (every data rank's clouds, every point) and sliced, so a step on the
ranks equals the one-process step on the whole batch, the generator's draws
included (the JAX package folds the device index into its key instead).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.morton import morton_order, random_rotation
from crfconv_tpu_torch.parallel.sharding import point_mesh
from crfconv_tpu_torch.parallel.spatial_build import (
    RATIOS, build_pyramid_windowed_spatial, spatial_pyramid_scales,
)
from crfconv_tpu_torch.parallel.spatial_forward import (
    _check_mode, _point_axis_lengths, choose_sharded_scales, frames_of,
    spatial_context,
)


def make_spatial_train_step(
    mesh,
    example_batch,
    mode=None,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    label_offset: int = 0,
):
    """The point-sharded train step over ``mesh``: a point group's Mesh,
    or a SpatialMesh (the clouds split over its data groups, the points
    over its point groups: the JAX step's ``data_axis``).

    ``example_batch`` is the global batch (or the set of its point-axis
    lengths); the scales follow ``choose_sharded_scales`` on it, and a
    policy that shards nothing raises. ``step(state, batch, generator)``
    takes this rank's part of a built PointBatch (``shard_points``,
    ``build_pyramid_windowed_spatial``), updates the state in place and
    returns the global loss and confusion matrix. It equals the
    one-process ``make_train_step(mode, windowed=False)`` on the whole
    batch up to the order of its sums."""
    from crfconv_tpu_torch.train.train_state import make_train_step

    mode = _check_mode(mode, "point-sharded training")
    pts = point_mesh(mesh)
    lengths = _point_axis_lengths(example_batch)
    sharded = choose_sharded_scales(lengths, pts.world, mode.tile, mode.pad)
    if not sharded:
        raise ValueError("no scale satisfies the sharding policy on this "
                         f"mesh ({pts.world} ranks a cloud, point-axis "
                         f"lengths {sorted(lengths, reverse=True)})")
    ctx = spatial_context(mesh, frames_of(lengths, sharded, pts.world))
    inner = make_train_step(mode, class_weights, ignore_index,
                            windowed=False, label_offset=label_offset)

    def step(state, batch: PointBatch,
             generator: Optional[torch.Generator] = None) -> dict:
        with spatial_state.activate(ctx):
            return inner(state, batch, generator)

    step.context = ctx
    step.sharded_scales = sorted(sharded, reverse=True)
    return step


def _sorted_take(a, order):
    if a is None:
        return None
    a3 = a if a.dim() == 3 else a[..., None]
    return torch.take_along_dim(a3, order[..., None], dim=1).reshape(a.shape)


def build_windowed_batch_spatial(
    raw: RawBatch,
    mesh,
    generator: Optional[torch.Generator] = None,
    mode=None,
    kernel_sizes: Sequence[int] = (16, 16, 16, 16, 16),
    ratios: Sequence[int] = RATIOS,
    k_up: int = 1,
    curve_jitter: bool = False,
) -> PointBatch:
    """This rank's part of ``train_state.build_windowed_batch``'s batch:
    the Morton sort of the whole RawBatch (every rank of a point group
    holds it), the point-sharded pyramid, and the features, labels and ids
    cut to the rank's span. The generator's draws are the unsharded
    builder's (the curve's rotation where ``curve_jitter`` is on, then the
    subsampling offsets)."""
    mode = _check_mode(mode, "the point-sharded pyramid")
    pts = point_mesh(mesh)
    rot = None
    if curve_jitter:
        if generator is None:
            raise ValueError("curve_jitter draws its rotation from a "
                             "generator")
        rot = random_rotation(generator)
    order = morton_order(raw.pos, rot=rot)
    pos = torch.take_along_dim(raw.pos, order[..., None], dim=1)
    scales = build_pyramid_windowed_spatial(
        pos, pts, kernel_sizes, ratios, k_up=k_up, generator=generator,
        mode=mode)
    n = int(raw.pos.shape[1])
    sharded = n in spatial_pyramid_scales(n, pts.world, mode.tile, mode.pad,
                                          ratios)
    local = n // pts.world if sharded else n
    start = pts.rank * local if sharded else 0

    def take(a):
        a = _sorted_take(a, order)
        return None if a is None else a[:, start:start + local].contiguous()

    return PointBatch(x=take(raw.x), y=take(raw.y), scales=scales,
                      point_idx=take(raw.point_idx),
                      cloud_idx=raw.cloud_idx, category=raw.category)


def check_same_batch(raw: RawBatch, mesh) -> None:
    """Raise on every rank where the ranks of a point group hold different
    clouds (each must hold the whole of its data shard's batch)."""
    from crfconv_tpu_torch.parallel.sharding import all_reduce_max, comm_device

    pts = point_mesh(mesh)
    if pts.world == 1:
        return
    pos = raw.pos.double()
    sig = torch.tensor([float(pos.sum()), float(pos.square().sum()),
                        float(raw.x.double().sum()), float(pos.numel())],
                       dtype=torch.float64, device=comm_device(pts))
    both = all_reduce_max(torch.cat([sig, -sig]), pts)
    if not torch.equal(both[:4], -both[4:]):
        raise ValueError("the ranks of a point group hold different batches")
