"""Inference API: raw clouds in, per-point labels out.

Counterpart of ``crfconv_tpu/serve.py::Predictor`` on one device: Morton
sort, pyramid build, forward and inverse permutation behind one call.
Point-sharded (mesh) serving is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from crfconv_tpu_torch.data.batch import PointBatch
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed

# The serving regime: windowed, packed-key kNN selection.
SERVING_MODE = NeighborMode("windowed", knn_exact=False)


class Predictor:
    """Windowed inference runner for one device.

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
    """

    def __init__(
        self, model: torch.nn.Module, mode: NeighborMode = SERVING_MODE,
        device="cuda", seed: int = 0,
    ):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.mode = dataclasses.replace(mode, mode="windowed")
        self.seed = seed

    def prepare(
        self, pos, feats, offsets: Optional[Sequence] = None, category=None,
    ) -> Tuple[PointBatch, torch.Tensor]:
        """The request's pyramid: [B, N, 3] positions + [B, N, C_in]
        features -> (the batch in Morton order, ``order`` [B, N], the
        Morton permutation). ``offsets`` injects the per-scale subsampling
        offsets instead of drawing them; ``category`` ([B] object
        categories) rides in the batch for ``CRFSegNet_Part``."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=self.device)
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        gen = None
        if offsets is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        order, scales = build_pyramid_windowed(
            pos, generator=gen, offsets=offsets, tile=self.mode.tile,
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
        batch, order = self.prepare(pos, feats, offsets, category)
        return self.restore(self.model(batch, self.mode), order)

    def predict(self, pos, feats, offsets: Optional[Sequence] = None,
                category=None):
        """[B, N, 3] + [B, N, C_in] -> [B, N] int64 class labels."""
        return self.predict_logits(pos, feats, offsets,
                                   category).argmax(dim=-1)
