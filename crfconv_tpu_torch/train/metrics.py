"""Segmentation metrics.

Counterpart of ``crfconv_tpu/train/metrics.py``: the confusion matrix
accumulated on the device (one [C, C] read-back per epoch instead of one
per step), and the host-side scores from it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confusion_matrix_device(
    y_true: torch.Tensor, y_pred: torch.Tensor, n_classes: int,
    ignore_index: int = -1,
) -> torch.Tensor:
    """[C, C] int64 counts, row = true class, column = predicted class;
    labels equal to ignore_index or outside [0, C) are not counted."""
    y_true = y_true.reshape(-1).long()
    y_pred = y_pred.reshape(-1).long()
    valid = (y_true >= 0) & (y_true < n_classes) & (y_true != ignore_index)
    flat = torch.where(valid, y_true * n_classes + y_pred,
                       torch.full_like(y_true, n_classes * n_classes))
    counts = torch.bincount(flat, minlength=n_classes * n_classes + 1)
    return counts[:-1].reshape(n_classes, n_classes)


def scores_from_confusion(
    hist: np.ndarray,
) -> Tuple[Dict[str, float], Dict[int, float]]:
    """OA / mean acc / FW acc / mIoU + per-class IoU from a confusion matrix."""
    hist = np.asarray(hist, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (
            hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
        )
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return (
        {
            "Overall Acc": float(acc),
            "Mean Acc": float(acc_cls),
            "FreqW Acc": float(fwavacc),
            "Mean IoU": float(mean_iu),
        },
        dict(zip(range(hist.shape[0]), iu)),
    )


class RunningScore:
    """Streaming confusion-matrix metric with ignore_index."""

    def __init__(self, n_classes: int, ignore_index: int = -1):
        self.n_classes = n_classes
        self.ignore_index = ignore_index
        self.confusion_matrix = np.zeros((n_classes, n_classes), np.float64)

    def _fast_hist(self, lt: np.ndarray, lp: np.ndarray) -> np.ndarray:
        n = self.n_classes
        mask = (lt >= 0) & (lt < n) & (lt != self.ignore_index)
        return np.bincount(
            n * lt[mask].astype(int) + lp[mask], minlength=n * n
        ).reshape(n, n)

    def update(self, label_trues, label_preds) -> None:
        lt = np.asarray(label_trues).reshape(-1)
        lp = np.asarray(label_preds).reshape(-1)
        self.confusion_matrix += self._fast_hist(lt, lp)

    def update_confusion(self, hist) -> None:
        """Accumulate a device-computed [C, C] confusion matrix."""
        if isinstance(hist, torch.Tensor):
            hist = hist.cpu().numpy()
        self.confusion_matrix += np.asarray(hist, dtype=np.float64)

    def get_scores(self):
        return scores_from_confusion(self.confusion_matrix)

    def reset(self) -> None:
        self.confusion_matrix = np.zeros(
            (self.n_classes, self.n_classes), np.float64
        )
