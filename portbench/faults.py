"""Faults planted in the program under test, to show that ``correct``
comes out false when the timed path is broken underneath.

Serving: ``answer_altered`` (a served point's scores have their classes
turned by one before the labels are taken, one point in seven);
``half_batch`` (only the first half of a request's clouds is computed,
and its scores are served for the second half too). Training:
``state_unchanged`` (the optimizer's step leaves the parameters as they
were); ``half_batch`` (the loss is the mean over the first half of the
batch only).
"""

from __future__ import annotations

import contextlib

import torch

SERVE = ("answer_altered", "half_batch")
TRAIN = ("state_unchanged", "half_batch")


def for_kind(kind: str) -> tuple:
    return SERVE if kind == "serve" else TRAIN


def _answer_altered(orig):
    def predict_logits(self, *args, **kwargs):
        out = orig(self, *args, **kwargs).clone()
        rows = torch.arange(out.shape[1], device=out.device) % 7 == 0
        out[:, rows] = out[:, rows].roll(1, dims=-1)
        return out
    return predict_logits


def _serve_half(orig):
    def predict_logits(self, pos, feats, *args, **kwargs):
        h = pos.shape[0] // 2
        out = orig(self, pos[:h], feats[:h], *args, **kwargs)
        return torch.cat([out, out[: pos.shape[0] - h]])
    return predict_logits


def _unchanged(orig):
    def step(self, *args, **kwargs):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g["params"]]
        out = orig(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g["params"]), before):
                p.copy_(b)
        return out
    return step


def _loss_half(orig):
    def segmentation_loss(outputs, labels, *args, **kwargs):
        h = labels.shape[0] // 2
        return orig(outputs[:h], labels[:h], *args, **kwargs)
    return segmentation_loss


@contextlib.contextmanager
def planted(name: str, kind: str):
    """The program with fault ``name`` of a ``kind`` ("serve" or "train")
    cell planted inside the block."""
    from crfconv_tpu_torch.serve import Predictor
    from crfconv_tpu_torch.train import train_state

    if kind == "serve":
        target, attr = Predictor, "predict_logits"
        make = {"answer_altered": _answer_altered,
                "half_batch": _serve_half}[name]
    elif name == "state_unchanged":
        target, attr, make = torch.optim.SGD, "step", _unchanged
    else:
        target, attr, make = train_state, "segmentation_loss", _loss_half
    orig = getattr(target, attr)
    setattr(target, attr, make(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)
