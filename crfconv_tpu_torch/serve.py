"""Inference API: raw clouds in, per-point labels out.

Counterpart of ``crfconv_tpu/serve.py::Predictor``: Morton sort, pyramid
build (the model's own kernel sizes, ratios and up-link width), forward and
inverse permutation behind one call, on one device, or
point-sharded over the ranks of a point group (``mesh``): every rank sorts
the request and builds its span of the pyramid
(``parallel/spatial_build.py``), the model runs halo-exchanged
(``parallel/spatial_forward.py``), and the scores are gathered and
unsorted, so every rank returns the whole request's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.utils import profiling

# The serving regime: windowed, packed-key kNN selection.
SERVING_MODE = NeighborMode("windowed", knn_exact=False)
# The pyramid's defaults (``build_pyramid_windowed``'s: the flagship's)
KERNEL_SIZES = (16, 16, 16, 16, 16)
RATIOS = (4, 4, 4, 4, 2)
K_UP = 1


def check_pyramid(kernel_sizes: Sequence[int], ratios: Sequence[int],
                  k_up: int) -> None:
    """Raise ValueError for a pyramid that neither pyramid function can
    take: one kernel size a ratio, every value at least 1."""
    if not ratios or len(kernel_sizes) != len(ratios):
        raise ValueError(f"{len(kernel_sizes)} kernel sizes for "
                         f"{len(ratios)} ratios: the pyramid needs one "
                         "kernel size a scale")
    if min(*kernel_sizes, *ratios, k_up) < 1:
        raise ValueError(f"kernel sizes {tuple(kernel_sizes)}, ratios "
                         f"{tuple(ratios)} and k_up {k_up} must be >= 1")


class Predictor:
    """Windowed inference runner, on one device or point-sharded.

    Args:
      model:  a ``PointConvResNet``, ``CRFSegNet`` or ``CRFSegNet_Part``
              (any module taking (PointBatch, mode) and returning per-point
              class scores: logits, or log-probabilities for the small
              family; ``CRFSegNet_Part`` also takes each cloud's
              ``category``). It is moved to ``device`` and put in eval
              mode.
      mode:   window geometry and kNN selection; the regime is always
              windowed.
      device: where the pyramid and the forward run.
      seed:   seeds the stratified subsampling of every call, so a cloud
              always gets the same pyramid.
      mesh:   a point group's ``parallel.Mesh`` (or a ``SpatialMesh``,
              whose point group serves): the request is served
              point-sharded over its ranks, on the rank's device (the
              ``device`` argument is not used); every rank of the group
              calls with the same request and gets the whole result.
      kernel_sizes, ratios, k_up: the model's pyramid (each scale's kNN
              width and subsampling ratio, and the coarse neighbours each
              point's up-link holds: 3 for ScanNet's CRFSegNet). The
              defaults are the flagship's, ``build_pyramid_windowed``'s.
              A pyramid that cannot be built raises ValueError here.
    """

    def __init__(
        self, model: torch.nn.Module, mode: NeighborMode = SERVING_MODE,
        device="cuda", seed: int = 0, mesh=None,
        kernel_sizes: Sequence[int] = KERNEL_SIZES,
        ratios: Sequence[int] = RATIOS, k_up: int = K_UP,
    ):
        check_pyramid(kernel_sizes, ratios, k_up)
        self.kernel_sizes = tuple(int(k) for k in kernel_sizes)
        self.ratios = tuple(int(r) for r in ratios)
        self.k_up = int(k_up)
        self.mesh = None
        if mesh is not None:
            from crfconv_tpu_torch.parallel.sharding import point_mesh

            self.mesh = point_mesh(mesh)
            device = self.mesh.device
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.mode = dataclasses.replace(mode, mode="windowed")
        self.seed = seed
        self._spatial = {}     # the point-sharded forward of each length

    def prepare(
        self, pos, feats, offsets: Optional[Sequence] = None, category=None,
    ) -> Tuple[PointBatch, torch.Tensor]:
        """The request's pyramid: [B, N, 3] positions + [B, N, C_in]
        features -> (the batch in Morton order, ``order`` [B, N], the
        Morton permutation). ``offsets`` injects the per-scale subsampling
        offsets instead of drawing them; ``category`` ([B] object
        categories) rides in the batch for ``CRFSegNet_Part``."""
        with profiling.span("serve.copy_in"):
            pos = torch.as_tensor(pos, dtype=torch.float32,
                                  device=self.device)
            feats = torch.as_tensor(feats, dtype=torch.float32,
                                    device=self.device)
        gen = None
        if offsets is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        order, scales = build_pyramid_windowed(
            pos, self.kernel_sizes, self.ratios, k_up=self.k_up,
            generator=gen, offsets=offsets, tile=self.mode.tile,
            pad=self.mode.pad, knn_exact=self.mode.knn_exact,
            device=self.device,
        )
        x = torch.take_along_dim(feats, order[..., None], dim=1)
        if category is not None:
            category = torch.as_tensor(category, device=self.device)
        return PointBatch(x=x, y=None, scales=scales,
                          category=category), order

    @staticmethod
    def restore(out: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
        """Per-point rows [B, N, ...] in Morton order -> the input order.
        Sorted row i is input row order[b, i]; argsort(order) maps input
        row j back to its sorted position."""
        with profiling.span("serve.restore"):
            inv = torch.argsort(order, dim=1)
            return torch.take_along_dim(out, inv[..., None], dim=1)

    @torch.inference_mode()
    def predict_logits(
        self, pos, feats, offsets: Optional[Sequence] = None, category=None,
    ) -> torch.Tensor:
        """[B, N, 3] positions + [B, N, C_in] features -> [B, N, n_classes]
        scores (the model's output: logits or log-probabilities) in the
        input point order. ``offsets`` and ``category`` as in
        :meth:`prepare`."""
        if self.mesh is not None:
            return self._predict_spatial(pos, feats, offsets, category)
        with profiling.span("serve.request"):
            batch, order = self.prepare(pos, feats, offsets, category)
            with profiling.span("forward"):
                out = self.model(batch, self.mode)
            return self.restore(out, order)

    def prepare_spatial(
        self, pos, feats, offsets: Optional[Sequence] = None, category=None,
    ) -> Tuple[PointBatch, torch.Tensor]:
        """This rank's part of the request's pyramid under ``mesh``: the
        whole request Morton-sorted, then this rank's span of the pyramid
        (``build_pyramid_windowed_spatial``, the subsampling drawn as
        :meth:`prepare` draws it) and of the features. Returns (the local
        batch, ``order``)."""
        from crfconv_tpu_torch.ops.morton import morton_order
        from crfconv_tpu_torch.parallel.spatial_build import (
            build_pyramid_windowed_spatial, spatial_pyramid_scales,
        )

        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        gen = None
        if offsets is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        order = morton_order(pos)
        pos_s = torch.take_along_dim(pos, order[..., None], dim=1)
        scales = build_pyramid_windowed_spatial(
            pos_s, self.mesh, self.kernel_sizes, self.ratios, k_up=self.k_up,
            generator=gen, offsets=offsets, mode=self.mode)
        n, world = int(pos.shape[1]), self.mesh.world
        x = torch.take_along_dim(feats, order[..., None], dim=1)
        if n in spatial_pyramid_scales(n, world, self.mode.tile,
                                       self.mode.pad, self.ratios):
            loc = n // world
            x = x[:, self.mesh.rank * loc:(self.mesh.rank + 1) * loc]
        if category is not None:
            category = torch.as_tensor(category, device=self.device)
        return PointBatch(x=x.contiguous(), y=None, scales=scales,
                          category=category), order

    def spatial_forward(self, n: int):
        """(fn, info) of ``parallel.make_spatial_forward`` for requests of
        ``n`` points, made once a length."""
        from crfconv_tpu_torch.parallel.spatial_build import pyramid_lengths
        from crfconv_tpu_torch.parallel.spatial_forward import (
            make_spatial_forward,
        )

        if n not in self._spatial:
            self._spatial[n] = make_spatial_forward(
                self.model, self.mesh, set(pyramid_lengths(n, self.ratios)),
                self.mode)
        return self._spatial[n]

    def _predict_spatial(self, pos, feats, offsets, category):
        from crfconv_tpu_torch.parallel.spatial_forward import (
            all_gather_points,
        )

        batch, order = self.prepare_spatial(pos, feats, offsets, category)
        n = int(order.shape[1])
        fn, info = self.spatial_forward(n)
        out = fn(batch)
        if n in info["sharded_scales"]:
            out = all_gather_points(out, self.mesh)
        return self.restore(out, order)

    def predict(self, pos, feats, offsets: Optional[Sequence] = None,
                category=None):
        """[B, N, 3] + [B, N, C_in] -> [B, N] int64 class labels."""
        return self.predict_logits(pos, feats, offsets,
                                   category).argmax(dim=-1)
