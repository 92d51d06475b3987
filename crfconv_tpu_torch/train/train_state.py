"""Train state, optimizer, and the train and eval steps.

Counterpart of ``crfconv_tpu/train/train_state.py``. The optimizer is the
reference recipe: SGD(lr, momentum 0.95, weight decay 1e-4) with the
learning rate decayed by ``gamma`` every ``steps_per_epoch`` steps (a
staircase ExponentialLR). torch's SGD folds the L2 term into the gradient
before the momentum trace, as the JAX package's optax chain does.

The steps run eagerly and update the state in place. In the windowed
regime a step takes a :class:`RawBatch` and builds its Morton-sorted
pyramid on the batch's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from crfconv_tpu_torch.data.batch import PointBatch, RawBatch
from crfconv_tpu_torch.ops.neighbors import NeighborMode
from crfconv_tpu_torch.ops.windowed import build_pyramid_windowed
from crfconv_tpu_torch.train.losses import segmentation_loss
from crfconv_tpu_torch.train.metrics import confusion_matrix_device

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
) -> PointBatch:
    """RawBatch -> Morton-sorted PointBatch with a windowed pyramid, built
    on the device of ``raw.pos``. The subsampling offsets are drawn from
    ``generator`` unless ``offsets`` gives them."""
    order, scales = build_pyramid_windowed(
        raw.pos, generator=generator, offsets=offsets, tile=mode.tile,
        pad=mode.pad, knn_exact=mode.knn_exact, device=raw.pos.device,
    )

    def take(a):
        if a is None:
            return None
        a3 = a if a.dim() == 3 else a[..., None]
        return torch.take_along_dim(a3, order[..., None], dim=1).reshape(
            a.shape
        )

    return PointBatch(
        x=take(raw.x), y=take(raw.y), scales=scales,
        point_idx=take(raw.point_idx), cloud_idx=raw.cloud_idx,
        category=raw.category,
    )


def _head(outputs, i: int) -> torch.Tensor:
    """Head ``i`` of a multi-head model's outputs, or the single output."""
    return outputs[i] if isinstance(outputs, (tuple, list)) else outputs


def make_train_step(
    mode: NeighborMode = TRAIN_MODE,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    windowed: bool = True,
    label_offset: int = 0,
):
    """The train step: pyramid (windowed) -> train-mode forward -> weighted
    CE -> backward -> SGD step -> confusion matrix.

    With ``windowed`` the step takes a RawBatch and builds its pyramid,
    else a PointBatch whose pyramid is built. ``label_offset`` is
    subtracted from the labels before the loss and the confusion matrix
    (the reference's ``y - 1`` for datasets whose label 0 is unlabeled).
    """

    def train_step(
        state: TrainState, batch, generator: Optional[torch.Generator] = None,
        offsets: Optional[Sequence] = None,
    ) -> dict:
        """One step on ``state``, updated in place. ``generator`` (on the
        batch's device) draws the pyramid's subsampling offsets, unless
        ``offsets`` gives them, and then the dropout mask. Returns the
        loss and the [C, C] confusion matrix, left on the device."""
        model = state.model
        model.train()
        if windowed:
            batch = build_windowed_batch(batch, generator, offsets, mode)
        labels = batch.y - label_offset
        outputs = model(batch, mode, dropout_generator=generator)
        loss = segmentation_loss(outputs, labels, class_weights, ignore_index)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        primary = _head(outputs, 0).detach()
        confusion = confusion_matrix_device(
            labels, primary.argmax(dim=-1), primary.shape[-1], ignore_index
        )
        return {"loss": loss.detach(), "confusion": confusion}

    return train_step


def make_eval_step(
    mode: NeighborMode = TRAIN_MODE,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
    label_offset: int = 0,
):
    """The single-view eval step on a RawBatch (the 2-view ensemble is not
    ported); ``label_offset`` as in :func:`make_train_step`."""

    @torch.no_grad()
    def eval_step(
        state: TrainState, batch, generator: Optional[torch.Generator] = None,
        offsets: Optional[Sequence] = None,
    ) -> dict:
        """Eval-mode forward. The pyramid draws from ``generator``, or from
        one seeded with the state's step when neither it nor ``offsets`` is
        given. Outputs are in the batch's (Morton-sorted) order, with the
        matching point ids and labels."""
        model = state.model
        model.eval()
        if generator is None and offsets is None:
            generator = torch.Generator(
                device=batch.pos.device
            ).manual_seed(state.step)
        batch = build_windowed_batch(batch, generator, offsets, mode)
        labels = batch.y - label_offset
        outputs = model(batch, mode)
        primary = _head(outputs, -1)
        preds = primary.argmax(dim=-1)
        return {
            "loss": segmentation_loss(
                outputs, labels, class_weights, ignore_index
            ),
            "confusion": confusion_matrix_device(
                labels, preds, primary.shape[-1], ignore_index
            ),
            "probs": torch.softmax(primary, dim=-1),
            "preds": preds,
            "point_idx": batch.point_idx,
            "labels": batch.y,
        }

    return eval_step
