"""SemanticKITTI streaming evaluation.

Counterpart of ``crfconv_tpu/train/kitti_eval.py``: the benchmark's
per-sequence, per-scan protocol over ``SemanticKITTIDataset``. Each
sequence is walked in temporal order (``frames_of``), every full scan
(``get_frame``, no subsampling) goes through a caller-supplied
``predict_fn``, and the confusion accumulates in one ``RunningScore`` per
sequence and one overall.

Mapped labels are 1..num_classes with 0 unlabeled; the scores are kept in
network space (y - 1, ignore_index -1), the trainer's ``label_offset`` 1
for this dataset.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from crfconv_tpu_torch.train.metrics import RunningScore


def streaming_eval(
    dataset,
    predict_fn: Callable[[dict], np.ndarray],
    max_frames_per_seq: Optional[int] = None,
) -> Dict:
    """Per-sequence streaming eval.

    ``predict_fn(frame)`` -> [N] network-space class ids (0..num_classes-1)
    for every point of the frame (a numpy array or a tensor on any
    device). Returns {"per_sequence": {seq: scores}, "overall": scores},
    scores being RunningScore's dict (OA, mean acc, mIoU) with the
    per-class IoU and, per sequence, the number of frames.
    """
    n_cls = dataset.num_classes
    overall = RunningScore(n_cls, ignore_index=-1)
    per_seq: Dict[str, Dict] = {}
    for seq in dataset.sequences:
        score = RunningScore(n_cls, ignore_index=-1)
        idxs = dataset.frames_of(seq)
        if max_frames_per_seq is not None:
            idxs = idxs[:max_frames_per_seq]
        for idx in idxs:
            frame = dataset.get_frame(idx)
            pred = predict_fn(frame)
            if hasattr(pred, "cpu"):
                pred = pred.cpu().numpy()
            pred = np.asarray(pred).reshape(-1)
            if pred.shape[0] != frame["pos"].shape[0]:
                raise ValueError(
                    f"predict_fn returned {pred.shape[0]} labels for a "
                    f"{frame['pos'].shape[0]}-point frame"
                )
            gt = frame["y"] - 1          # 0 (unlabeled) -> -1 = ignore
            score.update(gt, pred)
            overall.update(gt, pred)
        scores, cls_iou = score.get_scores()
        scores["per_class_IoU"] = cls_iou
        scores["num_frames"] = len(idxs)
        per_seq[seq] = scores
    scores, cls_iou = overall.get_scores()
    scores["per_class_IoU"] = cls_iou
    return {"per_sequence": per_seq, "overall": scores}
