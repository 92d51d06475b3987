"""Train state, optimizer, and the train and eval steps.

Counterpart of ``crfconv_tpu/train/train_state.py``. The optimizer is the
reference recipe: SGD(lr, momentum 0.95, weight decay 1e-4) with the
learning rate decayed by ``gamma`` every ``steps_per_epoch`` steps (a
staircase ExponentialLR). torch's SGD folds the L2 term into the gradient
before the momentum trace, as the JAX package's optax chain does.

The steps run eagerly and update the state in place. In the windowed
regime a step takes a :class:`RawBatch` and builds its Morton-sorted
pyramid on the batch's device; otherwise it takes a :class:`PointBatch`
whose pyramid is built (the exact regime's by
``data/pipeline.py::build_pyramid_device``), and the caller names the
gather regime that pyramid was built for.

Under a data-parallel context (``parallel.data_parallel``, as
``make_parallel_train_step`` enters it) both steps run their global form:
the train step's loss is this rank's numerator over the denominator summed
over the ranks, its gradients are summed over the ranks in one flat bucket
between the backward and the optimizer's step, and both steps report the
loss and the confusion matrix of the global batch. With no context a step
is the one-process step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.ops import spatial_state
from crfconv_tpu_torch.ops.morton import random_rotation, view_rotation
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.parallel.sharding import (
    all_reduce_gradients, all_reduce_sum,
)
from crfconv_tpu_torch.train.losses import (
    segmentation_loss, segmentation_loss_parts,
)
from crfconv_tpu_torch.train.metrics import confusion_matrix_device
from crfconv_tpu_torch.utils import profiling

# The training regime of the reference bench (bench.py::measure_train):
# windowed, packed-key kNN selection.
TRAIN_MODE = NeighborMode("windowed", knn_exact=False)


class StaircaseDecay:
    """LR factor gamma ** (step // steps_per_epoch) for ``LambdaLR``; an
    object rather than a lambda so the scheduler's state dict keeps it."""

    def __init__(self, gamma: float, steps_per_epoch: int):
        self.gamma = gamma
        self.steps_per_epoch = steps_per_epoch

    def __call__(self, step: int) -> float:
        return self.gamma ** (step // self.steps_per_epoch)


def make_optimizer(
    params,
    lr: float,
    momentum: float = 0.95,
    weight_decay: float = 1e-4,
    gamma: float = 0.95,
    steps_per_epoch: int = 100,
):
    """torch SGD(momentum, weight_decay) + per-epoch staircase decay ->
    (optimizer, scheduler); step the scheduler once per optimizer step."""
    opt = torch.optim.SGD(
        params, lr=lr, momentum=momentum, dampening=0.0,
        weight_decay=weight_decay,
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, StaircaseDecay(gamma, steps_per_epoch)
    )
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """Model, optimizer, scheduler and the count of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float, **opt_kw):
        """A fresh state; ``opt_kw`` are :func:`make_optimizer`'s options."""
        return cls(model, *make_optimizer(model.parameters(), lr, **opt_kw))

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


def build_windowed_batch(
    raw: RawBatch,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[Sequence] = None,
    mode: NeighborMode = TRAIN_MODE,
    curve_rot=None,
    return_order: bool = False,
    curve_jitter: bool = False,
):
    """RawBatch -> Morton-sorted PointBatch with a windowed pyramid, built
    on the device of ``raw.pos``. The subsampling offsets are drawn from
    ``generator`` unless ``offsets`` gives them; ``curve_rot`` turns the
    Morton curve (``build_pyramid_windowed``). ``curve_jitter`` turns it by
    a random rotation instead, drawn from ``generator`` before the offsets
    (train-time augmentation: each step's windows miss other cross-tile
    neighbours). With ``return_order`` also returns the Morton
    permutation."""
    if curve_jitter:
        if generator is None:
            raise ValueError("curve_jitter draws its rotation from a "
                             "generator")
        curve_rot = random_rotation(generator)
    order, scales = build_pyramid_windowed(
        raw.pos, generator=generator, offsets=offsets, tile=mode.tile,
        pad=mode.pad, knn_exact=mode.knn_exact, curve_rot=curve_rot,
        device=raw.pos.device,
    )

    def take(a):
        if a is None:
            return None
        a3 = a if a.dim() == 3 else a[..., None]
        return torch.take_along_dim(a3, order[..., None], dim=1).reshape(
            a.shape
        )

    batch = PointBatch(
        x=take(raw.x), y=take(raw.y), scales=scales,
        point_idx=take(raw.point_idx), cloud_idx=raw.cloud_idx,
        category=raw.category,
    )
    return (batch, order) if return_order else batch


def _head(outputs, i: int) -> torch.Tensor:
    """Head ``i`` of a multi-head model's outputs, or the single output."""
    return outputs[i] if isinstance(outputs, (tuple, list)) else outputs


def _step_mode(mode: Optional[NeighborMode], windowed: bool) -> NeighborMode:
    """The gather regime of a train or eval step. A step on a built pyramid
    (``windowed=False``) must be told the regime that pyramid was built
    for: the windowed gathers over an exact pyramid, whose indices are not
    window-consistent, would give wrong results without an error."""
    if mode is not None:
        return mode
    if not windowed:
        raise ValueError(
            "windowed=False takes a built PointBatch: pass its regime as "
            "mode (NeighborMode('exact') for build_pyramid_device's)")
    return TRAIN_MODE


def make_train_step(
    mode: Optional[NeighborMode] = None,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    windowed: bool = True,
    label_offset: int = 0,
    curve_jitter: bool = False,
):
    """The train step: pyramid (windowed) -> train-mode forward -> weighted
    CE -> backward -> SGD step -> confusion matrix.

    With ``windowed`` the step takes a RawBatch and builds its pyramid in
    ``mode`` (default ``TRAIN_MODE``), else a PointBatch whose pyramid is
    built, and ``mode`` must name its regime (``NeighborMode("exact")``
    for the exact regime). ``label_offset`` is subtracted from the labels
    before the loss and the confusion matrix (the reference's ``y - 1``
    for datasets whose label 0 is unlabeled). ``curve_jitter`` turns each
    step's Morton curve by a random rotation drawn from the step's
    generator (``build_windowed_batch``); as in the JAX package it acts in
    the windowed regime only.
    """
    mode = _step_mode(mode, windowed)

    def train_step(
        state: TrainState, batch, generator: Optional[torch.Generator] = None,
        offsets: Optional[Sequence] = None,
    ) -> dict:
        """One step on ``state``, updated in place. ``generator`` (on the
        batch's device) draws the curve's rotation where ``curve_jitter``
        is on, the pyramid's subsampling offsets, unless ``offsets`` gives
        them, and then the dropout mask. Returns the loss and the [C, C]
        confusion matrix, left on the device."""
        with profiling.span("train.step"):
            return _train_step(state, batch, generator, offsets)

    def _train_step(state, batch, generator, offsets) -> dict:
        model = state.model
        model.train()
        if windowed:
            batch = build_windowed_batch(batch, generator, offsets, mode,
                                         curve_jitter=curve_jitter)
        labels = batch.y - label_offset
        with profiling.span("forward"):
            outputs = model(batch, mode, dropout_generator=generator)
        mesh = spatial_state.data_mesh()
        with profiling.span("train.loss"):
            if mesh is None:
                loss = segmentation_loss(outputs, labels, class_weights,
                                         ignore_index)
            else:
                # this rank's part of the global loss: the ranks' parts sum
                # to it, and so do their gradients
                num, den = segmentation_loss_parts(
                    outputs, labels, class_weights, ignore_index)
                loss = num / all_reduce_sum(den, mesh).clamp_min(1e-12)
        with profiling.span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                all_reduce_gradients(model.parameters(), mesh)
        with profiling.span("train.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        with profiling.span("train.metrics"):
            primary = _head(outputs, 0).detach()
            confusion = confusion_matrix_device(
                labels, primary.argmax(dim=-1), primary.shape[-1],
                ignore_index
            )
            loss = loss.detach()
            if mesh is not None:
                loss = all_reduce_sum(loss, mesh)
                confusion = all_reduce_sum(confusion, mesh)
        return {"loss": loss, "confusion": confusion}

    return train_step


def make_eval_step(
    mode: Optional[NeighborMode] = None,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    label_offset: int = 0,
    windowed: bool = True,
    eval_views: int = 1,
):
    """The eval step; ``mode``, ``windowed`` and ``label_offset`` as in
    :func:`make_train_step` (the port's default is the windowed regime; the
    JAX package's ``make_eval_step`` defaults to ``windowed=False``).

    ``eval_views > 1`` (windowed only) averages the softmax over that many
    forwards, view v on a pyramid whose Morton curve is turned by
    ``view_rotation(v)``, with its own subsampling offsets: the windows of
    different orientations miss different cross-tile neighbours. Its
    outputs are in the raw point order and its loss is the mean over the
    views. A single view's outputs are in the batch's (Morton-sorted)
    order, with the matching point ids and labels.
    """
    mode = _step_mode(mode, windowed)
    if eval_views > 1 and not windowed:
        raise ValueError("eval_views > 1 needs the windowed regime")

    def outputs_of(state, batch):
        labels = batch.y - label_offset
        outputs = state.model(batch, mode)
        primary = _head(outputs, -1)
        mesh = spatial_state.data_mesh()
        if mesh is None:
            loss = segmentation_loss(outputs, labels, class_weights,
                                     ignore_index)
        else:
            num, den = segmentation_loss_parts(outputs, labels,
                                               class_weights, ignore_index)
            parts = all_reduce_sum(torch.stack([num, den]), mesh)
            loss = parts[0] / parts[1].clamp_min(1e-12)
        return loss, primary

    def metrics(loss, probs, labels, point_idx, raw_labels) -> dict:
        preds = probs.argmax(dim=-1)
        confusion = confusion_matrix_device(labels, preds, probs.shape[-1],
                                            ignore_index)
        mesh = spatial_state.data_mesh()
        if mesh is not None:
            confusion = all_reduce_sum(confusion, mesh)
        return {
            "loss": loss,
            "confusion": confusion,
            "probs": probs,
            "preds": preds,
            "point_idx": point_idx,
            "labels": raw_labels,
        }

    @torch.no_grad()
    def eval_step(
        state: TrainState, batch, generator: Optional[torch.Generator] = None,
        offsets: Optional[Sequence] = None,
    ) -> dict:
        """Eval-mode forward. A windowed pyramid draws from ``generator``,
        or from one seeded with the state's step when neither it nor
        ``offsets`` is given; with ``eval_views > 1`` the views draw in
        turn, and ``offsets`` is a sequence of each view's offsets."""
        state.model.eval()
        if not windowed:
            loss, primary = outputs_of(state, batch)
            return metrics(loss, torch.softmax(primary, dim=-1),
                           batch.y - label_offset, batch.point_idx, batch.y)
        if generator is None and offsets is None:
            generator = torch.Generator(
                device=batch.pos.device
            ).manual_seed(state.step)
        if eval_views == 1:
            vb = build_windowed_batch(batch, generator, offsets, mode)
            loss, primary = outputs_of(state, vb)
            return metrics(loss, torch.softmax(primary, dim=-1),
                           vb.y - label_offset, vb.point_idx, vb.y)
        probs = loss = 0.0
        for v in range(eval_views):
            vb, order = build_windowed_batch(
                batch, generator, None if offsets is None else offsets[v],
                mode, curve_rot=view_rotation(v), return_order=True,
            )
            view_loss, primary = outputs_of(state, vb)
            p = torch.softmax(primary, dim=-1)
            # sorted row i is raw point order[b, i]
            probs = probs + torch.empty_like(p).scatter_(
                1, order[..., None].expand_as(p), p)
            loss = loss + view_loss
        return metrics(loss / eval_views, probs / eval_views,
                       batch.y - label_offset, batch.point_idx, batch.y)

    return eval_step
