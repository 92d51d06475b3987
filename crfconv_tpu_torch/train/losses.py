"""Loss functions.

Counterpart of ``crfconv_tpu/train/losses.py``: torch ``F.cross_entropy``
semantics with per-class weights and ignore_index, i.e. the mean
normalised by the weight of each target,

    sum_i w_{y_i} * nll_i / sum_i w_{y_i},

over the points whose label is neither ignore_index nor outside [0, C).
The ``_parts`` forms give that numerator and denominator apart, so that a
data-parallel step can sum each over its ranks for the global loss.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch


def weighted_cross_entropy(
    scores: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """scores [..., C] logits (or log-probabilities), labels [...] int ->
    scalar loss, computed in at least float32."""
    num, den = weighted_cross_entropy_parts(scores, labels, class_weights,
                                            ignore_index)
    return num / den.clamp_min(1e-12)


def weighted_cross_entropy_parts(
    scores: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator sum_i w_{y_i} * nll_i, denominator sum_i w_{y_i}) of
    :func:`weighted_cross_entropy`."""
    n_classes = scores.shape[-1]
    logp = torch.log_softmax(
        scores.to(torch.promote_types(scores.dtype, torch.float32)), dim=-1
    ).reshape(-1, n_classes)
    labels = labels.reshape(-1)
    valid = (labels != ignore_index) & (labels >= 0) & (labels < n_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -logp.gather(1, safe[:, None])[:, 0]
    if class_weights is None:
        w = valid.to(logp.dtype)
    else:
        w = torch.where(valid, class_weights.to(logp.dtype)[safe],
                        torch.zeros_like(nll))
    return (nll * w).sum(), w.sum()


def segmentation_loss(
    outputs: Union[torch.Tensor, Sequence[torch.Tensor]],
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
) -> torch.Tensor:
    """Single-head CE, or the sum over heads for models that return a
    tuple of score tensors."""
    if isinstance(outputs, (tuple, list)):
        return sum(
            weighted_cross_entropy(o, labels, class_weights, ignore_index)
            for o in outputs
        )
    return weighted_cross_entropy(outputs, labels, class_weights, ignore_index)


def segmentation_loss_parts(
    outputs: Union[torch.Tensor, Sequence[torch.Tensor]],
    labels: torch.Tensor,
    class_weights: Optional[torch.Tensor] = None,
    ignore_index: int = -1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of :func:`segmentation_loss`: the heads
    share the denominator, so a multi-head loss is sum_h num_h / den."""
    heads = outputs if isinstance(outputs, (tuple, list)) else (outputs,)
    num = den = None
    for o in heads:
        n_h, d_h = weighted_cross_entropy_parts(o, labels, class_weights,
                                                ignore_index)
        num = n_h if num is None else num + n_h
        den = d_h if den is None else den
    return num, den
