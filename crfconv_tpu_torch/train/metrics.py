"""Segmentation metrics.

Counterpart of ``crfconv_tpu/train/metrics.py``: the confusion matrix
accumulated on the device (one [C, C] read-back per epoch instead of one
per step), and the host-side scores from it; ShapeNet's part IoU
(``RunningScoreShapeNet``: each instance's IoU over its category's part
classes, averaged per category) and the vote test's IoU
(``iou_from_confusions``), numpy over host arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

SHAPENET_OBJ_CLASSES = {
    "Airplane": 0, "Bag": 1, "Cap": 2, "Car": 3, "Chair": 4, "Earphone": 5,
    "Guitar": 6, "Knife": 7, "Lamp": 8, "Laptop": 9, "Motorbike": 10,
    "Mug": 11, "Pistol": 12, "Rocket": 13, "Skateboard": 14, "Table": 15,
}

SHAPENET_SEG_CLASSES = {
    "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
    "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
    "Earphone": [16, 17, 18], "Guitar": [19, 20, 21], "Knife": [22, 23],
    "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
    "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
    "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
    "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
}


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


class RunningScoreShapeNet:
    """ShapeNet part IoU: per instance, the mean IoU over the part labels of
    the instance's category; averaged within each category (mpIoU) and over
    all instances (pIoU)."""

    def __init__(self):
        self.obj_classes = dict(SHAPENET_OBJ_CLASSES)
        self.seg_classes = dict(SHAPENET_SEG_CLASSES)
        self._names = {v: k for k, v in self.obj_classes.items()}
        self.category_iou = np.zeros(16, np.float64)
        self.category_num = np.zeros(16, np.int64)

    def update(self, label_trues, label_preds, category: int,
               mask: Optional[np.ndarray] = None) -> float:
        """Adds one instance of ``category``; ``mask`` keeps the points it
        marks. Returns the instance's IoU."""
        lt = np.asarray(label_trues).reshape(-1)
        lp = np.asarray(label_preds).reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            lt, lp = lt[m], lp[m]
        parts = self.seg_classes[self._names[int(category)]]
        eps = np.finfo(np.float32).eps
        iou = 0.0
        for part in parts:
            t = lt == part
            p = lp == part
            i = np.logical_and(t, p).sum() + eps
            u = np.logical_or(t, p).sum() + eps
            iou += i / u
        iou /= len(parts)
        self.category_iou[category] += iou
        self.category_num[category] += 1
        return float(iou)

    def get_scores(self):
        """(pIoU, mpIoU over the categories seen, {category name: IoU})."""
        with np.errstate(divide="ignore", invalid="ignore"):
            p_iou = self.category_iou.sum() / max(self.category_num.sum(), 1)
            per_class = self.category_iou / np.maximum(self.category_num, 1)
        mp_iou = per_class[self.category_num > 0].mean()
        cls_piou = {k: float(per_class[v]) for k, v in self.obj_classes.items()}
        return float(p_iou), float(mp_iou), cls_piou

    def reset(self) -> None:
        self.category_iou[:] = 0
        self.category_num[:] = 0


def iou_from_confusions(confusions) -> np.ndarray:
    """Per-class IoU of [..., C, C] confusion matrices (the vote test's);
    a class with no true points takes the mean IoU of the others."""
    c = np.asarray(confusions, dtype=np.float64)
    tp = np.diagonal(c, axis1=-2, axis2=-1)
    tpfn = np.sum(c, axis=-1)
    tpfp = np.sum(c, axis=-2)
    iou = tp / (tpfp + tpfn - tp + 1e-6)
    mask = tpfn < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    miou = np.sum(iou, axis=-1, keepdims=True) / (counts + 1e-6)
    iou += mask * miou
    return iou
