"""Labeled vote-based evaluation.

Counterpart of ``crfconv_tpu/train/vote.py`` (reference trainval.py:218-327,
``test_s3dis``). The caller supplies ``vote_epoch_fn``, one pass over the
validation loader that updates ``test_probs`` (the running mean of each
point's class probabilities) in place; this module decides when the votes
cover the clouds and scores them. The confusion matrices are counted with
``np.bincount`` (:func:`confusion_matrix`), equal to scikit-learn's
``confusion_matrix(..., labels=...)`` that the JAX package calls.
"""

from __future__ import annotations

import logging
from typing import Callable, List

import numpy as np

from crfconv_tpu_torch.train.metrics import (
    iou_from_confusions, scores_from_confusion,
)
from crfconv_tpu_torch.utils.logging import LOGGER

log = logging.getLogger(LOGGER)


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """[L, L] int64 counts over ``labels`` (row: the true label's position
    in ``labels``, column: the predicted one's); a pair with a value
    outside ``labels`` on either side is not counted."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    sorter = np.argsort(labels, kind="stable")

    def index(v):
        v = np.asarray(v).reshape(-1)
        at = np.clip(np.searchsorted(labels, v, sorter=sorter), 0, n - 1)
        i = sorter[at]
        return i, labels[i] == v

    ti, t_ok = index(y_true)
    pi, p_ok = index(y_pred)
    ok = t_ok & p_ok
    counts = np.bincount(ti[ok] * n + pi[ok], minlength=n * n)
    return counts.astype(np.int64).reshape(n, n)


def labeled_vote_eval(
    ds,
    vote_epoch_fn: Callable[[], None],
    test_probs: List[np.ndarray],
    num_votes: int = 100,
    vote_delta: float = 1.0,
) -> dict:
    """Vote until coverage, then report the sub-cloud IoU (with the
    class-proportion rescaling of trainval.py:281-283) and the re-projected
    full-cloud IoU. Returns {} if coverage is not reached within the vote
    cap (the reference's early return, trainval.py:324)."""
    label_values = ds.label_values
    class_proportions = np.array(
        [
            np.sum([np.sum(l == lv) for l in ds.val_labels])
            for lv in label_values
        ],
        np.float32,
    )
    results = {}
    last_min, epoch = -0.5, 0
    while last_min < num_votes:
        vote_epoch_fn()
        new_min = float(np.min(ds.min_possibility))
        log.info("vote epoch %d, min possibility %.2f", epoch, new_min)
        if last_min + vote_delta < new_min:
            last_min += vote_delta
            # sub-cloud confusion with class-proportion rescaling
            confs = []
            for i in range(len(ds.input_labels)):
                preds = label_values[
                    np.argmax(test_probs[i], axis=1)
                ].astype(np.int32)
                confs.append(confusion_matrix(
                    ds.input_labels[i], preds, label_values))
            C = np.sum(np.stack(confs), axis=0).astype(np.float32)
            C *= np.expand_dims(
                class_proportions / (np.sum(C, axis=1) + 1e-6), 1
            )
            sub_iou = iou_from_confusions(C)
            results["sub_mIoU"] = float(np.mean(sub_iou))

            # full-cloud confusion via re-projection
            confs = []
            for i in range(len(ds.input_labels)):
                proj_probs = test_probs[i][ds.val_proj[i]]
                preds = label_values[
                    np.argmax(proj_probs, axis=1)
                ].astype(np.int32)
                confs.append(confusion_matrix(
                    ds.val_labels[i], preds, label_values))
            C = np.sum(np.stack(confs), axis=0)
            full_iou = iou_from_confusions(C)
            results["full_mIoU"] = float(np.mean(full_iou))
            results["full_IoUs"] = full_iou.tolist()
            scores, _ = scores_from_confusion(C)
            results.update(scores)
            log.info(
                "vote result: sub mIoU %.2f%%, full mIoU %.2f%%",
                results["sub_mIoU"] * 100, results["full_mIoU"] * 100,
            )
            return results
        epoch += 1
    return results
